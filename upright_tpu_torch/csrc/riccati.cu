// Batched multiple-shooting Riccati backward sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel upright_tpu/solver/pallas_riccati.py
// (pallas_backward_pass -> _riccati_kernel).  Same recursion, same
// regularisation, and for nu <= 24 the same pivot clamp:
//
//   (P, p) = (Hf, gf);  for k = N-1 .. 0, with Z = [A_k | B_k] (nx x nz):
//     [PZ | Pd_p] = P [Z | d_k] + [0 | p]
//     [Q | q]     = [H_k | g_k] + Z^T [PZ | Pd_p]       (nz x (nz + 1))
//     Quu  = Q[nx:, nx:] + reg I,  Qux = Q[nx:, :nx],  Qu = q[nx:]
//     L    = chol(Quu), pivots sqrt(max(s, 1e-12))
//     [K_k | kff_k] = -Quu^-1 [Qux | Qu]
//     [P | p] = [Q[:nx, :nx] | q[:nx]] + Qux^T [K_k | kff_k],  P = sym(P)
//
// For nu > 24 the reference leaves the clamp for a relative diagonal jitter
// with a fallback (upright_tpu/solver/al.py, _backward_pass), and so does
// this kernel, per instance and per stage: with s = max(trace(Quu) / nu,
// 1e-9), factor Quu + 1e-7 s I without a clamp; if a pivot is not positive,
// factor Quu + 1e-3 s I instead; if that fails too, the stage's K and kff
// are NaN, and with them every earlier stage of that instance.
//
// What bounds it on this card.  Neither bytes nor tensor cores.  One call at
// 512 x 20 x 27 x 13 moves 85 MB and does 1.6 GFLOP, worth about 25 us each;
// the time is spent elsewhere:
//   - at batch 1 (the replan), in the latency of one block's chain: N
//     dependent stages, each three small products, a nu-step elimination
//     and a nu-step back substitution separated by barriers.  With one warp
//     per scheduler nothing hides an instruction's latency, so a stage costs
//     about its instruction count times 2 to 4 cycles;
//   - at batch 512, in the shared-memory word rate and in instruction slots: an SM
//     delivers 32 words a clock against 128 multiply-adds, so a product that
//     loads two words per multiply-add runs at an eighth of the fp32 rate,
//     and 512 blocks put fewer than four on an SM, too few to hide the chain.
// The recursion is the precision-critical phase of the solve (errors
// compound over N stages through P), so every product is full fp32 (or
// fp64) on the ordinary pipes: no TF32 mma/wgmma, which keeps three decimal
// digits.  The tensor cores are therefore not this kernel's tool.
//
// What the design does about it.
//   - One block of 128 threads owns one instance for all N stages; P, p and
//     every intermediate live in shared memory, only K and kff go out.
//   - The sizes are template parameters.  riccati_backward_kernel<T, NX, NU>
//     is instantiated for the widths of the shipped configurations (27/13
//     and 18/10, float32), where every loop unrolls and index arithmetic
//     folds (on an H100 1.2 to 1.5 times faster than the runtime-sized
//     instance at either width), and once per type with NX = NU = 0, which reads the sizes from
//     its arguments and takes every other shape (float32 and float64).  One
//     source and one library hold all instances; building one library per
//     shape with -D flags would need the build cache keyed on the flags.
//   - All three products are C += A^T B with both operands stored by depth
//     (P is kept symmetric, so P Z = P^T Z), leading dimensions padded to 4.
//     A thread owns a 4 x 4 tile of C in registers and reads 4 + 4 words as
//     two vectors per 16 multiply-adds (on an H100, 2 x 4 tiles and 256
//     threads were both slower, at batch 512 and at batch 1).  p + P d and
//     Z^T (p + P d) ride along as one more column, the Qxu block of Q that
//     nobody reads is skipped, and each entry of the new P is computed once
//     and symmetrised tile against mirror tile from shared memory.
//   - Up to 16 inputs (and in the specialised instances) the factorisation and
//     both substitutions are one elimination in registers: on the augmented
//     block [Quu | Qux | Qu] one lane holds one column, every warp that takes
//     part holds its own copy of the Quu columns, and a right-looking
//     elimination takes the pivot row off the rows below it: the row is
//     shuffled out unscaled, all entries at once, and every lane scales by
//     1 / sqrt(max(s, 1e-12)) itself (rsqrt and one Newton step; a square
//     root and a division were over half of a stage).  The forward
//     substitution falls out of the same nu steps; the back substitution is
//     nu more.  No barrier and no shared memory inside.  The warps it leaves
//     idle start the next stage's copies meanwhile.  It must unroll, so the
//     runtime-sized instance carries one copy per width and picks by nu.
//   - Wider blocks are eliminated on a copy in shared memory with all 128
//     threads, one barrier a step, as L D L^T with D = max(s, 1e-12) for nu
//     <= 24 (the same clamp, no square root on the chain) and unclamped on
//     the jitter route, then substituted back right-looking, one barrier a
//     step.  The copy keeps Quu intact for the jitter route's second attempt.
//     A step costs about 700 cycles whatever its work, so this path is five
//     to ten times slower per stage than the registers; it is the simple one.
//   - The next stage's H, g, d (and A, B when they vary by stage) are
//     fetched with cp.async into a second buffer while this stage computes:
//     16-byte copies where the row length and the addresses allow it,
//     element-sized copies otherwise.  Stage-invariant A, B (strides of 0)
//     are loaded once per block.
//   - Five block-wide barriers a stage with the elimination in registers.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so the file
// builds in seconds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

// Cycle marks for tools/riccati_phases.py.  Built with -DRICCATI_PHASE_CLOCK,
// thread 0 of a one-block launch reads the SM's clock between the phases of
// stage 3 and prints the differences; otherwise the marks are empty.
#ifdef RICCATI_PHASE_CLOCK
#include <stdio.h>
#define PHASE_CLOCK_BEGIN(k)                                                         \
  const bool phase_clock = gridDim.x == 1 && (k) == 3 && threadIdx.x == 0;           \
  long long phase_t[7];                                                              \
  PHASE_MARK(0)
#define PHASE_MARK(i) \
  if (phase_clock) phase_t[i] = clock64()
#define PHASE_CLOCK_END()                                                            \
  PHASE_MARK(6);                                                                     \
  if (phase_clock)                                                                   \
  printf("PHASES wait_and_fetch %lld product_PZ %lld product_Q %lld elimination %lld " \
         "product_P %lld symmetrise %lld stage %lld\n",                              \
         phase_t[1] - phase_t[0], phase_t[2] - phase_t[1], phase_t[3] - phase_t[2],  \
         phase_t[4] - phase_t[3], phase_t[5] - phase_t[4], phase_t[6] - phase_t[5],  \
         phase_t[6] - phase_t[0])
#else
#define PHASE_CLOCK_BEGIN(k)
#define PHASE_MARK(i)
#define PHASE_CLOCK_END()
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kClampMaxNu = 24;  // above it: jitter route instead of the pivot clamp
// The runtime-sized instance holds one unrolled register elimination per width
// up to this; wider blocks are eliminated in shared memory.  (Up to 24, nvcc
// took 80 s for this file instead of 30 s.)
constexpr int kRegisterMaxNu = 16;
constexpr long long kMaxSmemBytes = 232448;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Problem sizes: compile-time where NX, NU > 0, else read from the arguments.
template <int NX, int NU>
struct Dims {
  int nx_rt, nu_rt;
  __host__ __device__ int nx() const { return NX > 0 ? NX : nx_rt; }
  __host__ __device__ int nu() const { return NU > 0 ? NU : nu_rt; }
  __host__ __device__ int nz() const { return nx() + nu(); }
  __host__ __device__ int nxp() const { return round4(nx()); }     // leading dim of P
  __host__ __device__ int nzp() const { return round4(nz()); }     // rows of [Q | q]
  __host__ __device__ int ldz() const { return round4(nz() + 1); } // leading dim of [Z | d], [PZ | Pd_p], [Q | q]
  __host__ __device__ int ldk() const { return round4(nx() + 1); } // leading dim of [K | kff]
  // elements of shared memory; the elimination in shared memory adds its work
  // copy and inverse pivots
  __host__ __device__ long long smem_elems() const {
    long long n = (long long)nxp() * nxp() + nxp() + 2ll * nx() * ldz() + 2ll * nzp() * ldz() +
                  (long long)nxp() * ldz() + (long long)nu() * ldk();
    if (NU == 0 && nu() > kRegisterMaxNu) n += (long long)nu() * ldz() + round4(nu());
    return n;
  }
};

// four consecutive elements moved as one vector (16 bytes an instruction)
template <typename T>
struct alignas(16) Vec4 {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> load4(const T* p) {
  return *reinterpret_cast<const Vec4<T>*>(p);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
  Vec4<T> out;
#pragma unroll
  for (int c = 0; c < 4; ++c) out.v[c] = v[c];
  *reinterpret_cast<Vec4<T>*>(p) = out;
}

// The reference's pivot clamp; a NaN stays a NaN.
template <typename T>
__device__ __forceinline__ T clamp_pivot(T s) {
  const T eps = T(1e-12);
  return s < eps ? eps : s;
}

// 1 / sqrt(s) to float32 rounding: the hardware's approximation (2 ulp) and
// one Newton step, two short instructions where a square root and a division
// would be two long ones on the elimination's dependent chain.
__device__ __forceinline__ float inv_sqrt(float s) {
  const float r = rsqrtf(s);
  return r * fmaf(-0.5f * s * r, r, 1.5f);
}
__device__ __forceinline__ double inv_sqrt(double s) { return 1.0 / sqrt(s); }

// `rows` rows of `len` elements from device memory (row stride src_ld) into
// shared memory (row stride dst_ld), asynchronously, by the `nthr` threads
// that call it with thr = 0 .. nthr - 1.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, int dst_ld, const T* src, long long src_ld,
                                                int rows, int len, int thr, int nthr) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool wide = len % V == 0 && src_ld % V == 0 && dst_ld % V == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (wide) {
    const int per = len / V;
    for (int e = thr; e < rows * per; e += nthr) {
      const int r = e / per, c = (e - r * per) * V;
      cp_async<16>(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  } else {
    for (int e = thr; e < rows * len; e += nthr) {
      const int r = e / len, c = e - r * len;
      cp_async<(int)sizeof(T)>(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  }
}

// acc (4 x 4, rows i0.., columns j0..) += A^T B over `depth`, A and B stored
// by depth: A(m, i) = A[m * lda + i], B(m, j) = B[m * ldb + j]; i0, j0, lda
// and ldb are multiples of 4.
template <typename T>
__device__ __forceinline__ void tile_atb(T (&acc)[4][4], const T* A, int lda, const T* B, int ldb,
                                         int depth, int i0, int j0) {
  A += i0;
  B += j0;
#pragma unroll
  for (int m = 0; m < depth; ++m) {
    const Vec4<T> a = load4(A + m * lda);
    const Vec4<T> b = load4(B + m * ldb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fma(a.v[r], b.v[c], acc[r][c]);
  }
}

// [K | kff] = -Quu^-1 [Qux | Qu] with clamped pivots, in registers, by one
// warp for the columns q of [K | kff] it is given (`group` counts such column
// groups).  Lane < NU holds column `lane` of Quu, the other lanes one column of
// [Qux | Qu] each, so a warp takes 32 - NU of those and every warp factors Quu
// for itself.  Step j of the right-looking elimination takes row j, over its
// pivot sqrt(max(s, 1e-12)), off the rows below: the row is shuffled out
// unscaled, all entries at once, and every lane scales by 1 / pivot itself,
// so one shuffle's latency is on the chain, not two.  The forward
// substitution falls out of the same NU steps; the back substitution is NU
// more.  Everything unrolls; no barrier and no shared memory inside.
// Qu_rows: rows nx.. of [Q | q]; K_stage, kff_stage: this stage's outputs.
template <typename T, int NU>
__device__ __forceinline__ void eliminate_registers(const T* Qu_rows, int ldz, int nx, int group,
                                                    T* sK, int ldk, T* K_stage, T* kff_stage) {
  const int lane = threadIdx.x & 31;
  const int q = group * (32 - NU) + lane - NU;  // column of [K | kff]
  const bool is_rhs = lane >= NU;
  const int col = !is_rhs ? nx + lane : (q < nx ? q : nx + NU);
  T m[NU], rinv[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) m[r] = Qu_rows[r * ldz + col];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T u[NU];
#pragma unroll
    for (int i = j; i < NU; ++i) u[i] = __shfl_sync(kFullMask, m[j], i);
    rinv[j] = inv_sqrt(clamp_pivot(u[j]));
    m[j] *= rinv[j];
#pragma unroll
    for (int i = j + 1; i < NU; ++i) m[i] = fma(-(u[i] * rinv[j]), m[j], m[i]);
  }
  // lane i < NU now holds L[i][0..i-1] in m[0..i-1]; the other lanes L^-1 rhs
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    if (is_rhs) m[i] *= rinv[i];
#pragma unroll
    for (int r = 0; r < i; ++r) {
      const T l = __shfl_sync(kFullMask, m[r], i);
      if (is_rhs) m[r] = fma(-l, m[i], m[r]);
    }
  }
  if (is_rhs && q <= nx) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      sK[i * ldk + q] = -m[i];
      if (q < nx) K_stage[i * nx + q] = -m[i];
      else kff_stage[i] = -m[i];
    }
  }
}

// The same for a width known only at run time: one instantiation per width up
// to NU_MAX, picked by a chain of comparisons.
template <typename T, int NU_MAX>
__device__ __forceinline__ void eliminate_registers_any(int nu, const T* Qu_rows, int ldz, int nx,
                                                        int group, T* sK, int ldk, T* K_stage,
                                                        T* kff_stage) {
  if constexpr (NU_MAX > 0) {
    if (nu == NU_MAX)
      eliminate_registers<T, NU_MAX>(Qu_rows, ldz, nx, group, sK, ldk, K_stage, kff_stage);
    else
      eliminate_registers_any<T, NU_MAX - 1>(nu, Qu_rows, ldz, nx, group, sK, ldk, K_stage,
                                             kff_stage);
  }
}

// Forward elimination in shared memory, for the widths that have no register
// elimination, on W = [Qux | Quu | q_u] (nu rows, leading dim ldz, the Quu
// block at column nx), all threads of the block, one barrier a step: step j
// takes row j, as it stands, off the rows below it with the multipliers
// W[j][nx + i] / s_j, s_j = W[j][nx + j] the square of the Cholesky pivot,
// clamped like it if `clamp` (Quu = L D L^T with the rows left unscaled: the
// same elimination, without a square root on the chain).  Afterwards row j
// holds D L^-1 [Qux | Qu] in the outer columns, D times column j of the unit
// factor right of the diagonal, and dinv[j] = 1 / s_j.  Returns true (for
// every thread alike) if `clamp` is off and an s_j is not positive: the
// factorisation failed.  The caller synchronises before; W and dinv are
// complete on return.
template <typename T>
__device__ __forceinline__ bool eliminate_shared(T* W, T* dinv, int nx, int nu, int ldz, bool clamp) {
  const int nz = nx + nu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < nu; ++j) {
    const T* Wj = W + j * ldz;
    T s = Wj[nx + j];
    if (clamp) s = clamp_pivot(s);
    else if (!(s > T(0))) return true;
    const T dj = T(1) / s;
    if (threadIdx.x == 0) dinv[j] = dj;
    // a lane takes columns, a warp every kWarps-th row
    for (int c = lane; c <= nz; c += 32) {
      if (c >= nx && c <= nx + j) continue;
      const T wj = Wj[c] * dj;
      const T* lj = Wj + nx;
      T* wc = W + c;
      for (int i = j + 1 + warp; i < nu; i += kWarps) wc[i * ldz] = fma(-lj[i], wj, wc[i * ldz]);
    }
    __syncthreads();
  }
  return false;
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ d,
                        const T* __restrict__ grads, const T* __restrict__ hess,
                        const T* __restrict__ gf, const T* __restrict__ Hf, T* __restrict__ K,
                        T* __restrict__ kff, int N, int nx_rt, int nu_rt, long long sA_b,
                        long long sA_n, long long sB_b, long long sB_n, T reg) {
  static_assert((NX > 0) == (NU > 0), "both sizes are compile-time or neither is");
  static_assert(NU <= kClampMaxNu, "an instance with compile-time sizes takes the clamped route");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const Dims<NX, NU> dims{nx_rt, nu_rt};
  const int nx = dims.nx(), nu = dims.nu(), nz = dims.nz();
  const int nxp = dims.nxp(), nzp = dims.nzp(), ldz = dims.ldz(), ldk = dims.ldk();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;

  T* sP = reinterpret_cast<T*>(smem_raw);  // nxp x nxp   P, by depth (P = P^T)
  T* sp = sP + nxp * nxp;                  // nxp
  T* sZ = sp + nxp;                        // 2 x (nx x ldz)   [A | B | d]
  T* sQ = sZ + 2 * nx * ldz;               // 2 x (nzp x ldz)  [H | g], then [Q | q] in place
  T* sPZ = sQ + 2 * nzp * ldz;             // nxp x ldz   [PZ | Pd_p], then the unsymmetrised [P | p]
  T* sK = sPZ + nxp * ldz;                 // nu x ldk    [K | kff]
  T* sW = sK + nu * ldk;                   // nu x ldz    elimination in shared memory: its copy
  T* spiv = sW + nu * ldz;                 // nu          and 1 / s_j of its steps

  // The register elimination gives a warp 32 - nu columns of [K | kff]; the
  // warps it leaves idle fetch the next stage meanwhile.  Where it leaves
  // none, and with the elimination in shared memory, all threads fetch at the
  // top of a stage instead.
  const bool in_registers = NU > 0 || nu <= kRegisterMaxNu;
  const int elim_groups = in_registers ? (nx + 32 - nu) / (32 - nu) : kWarps;
  const int fetch_warps = elim_groups < kWarps ? kWarps - elim_groups : 0;
  static_assert((kWarps & (kWarps - 1)) == 0, "row i of [K | kff] is written by warp i & (kWarps - 1)");

  const bool z_const = (sA_n == 0 && sB_n == 0);
  const T* Ab = A + b * sA_b;
  const T* Bb = B + b * sB_b;

  // every array of stage k into buffer k & 1, by threads thr = 0 .. nthr - 1
  auto fetch_stage = [&](int k, int thr, int nthr) {
    const long long bk = b * N + k;
    T* Zb = sZ + (k & 1) * nx * ldz;
    T* Qb = sQ + (k & 1) * nzp * ldz;
    if (!z_const) {
      copy_rows_async(Zb, ldz, Ab + k * sA_n, nx, nx, nx, thr, nthr);
      copy_rows_async(Zb + nx, ldz, Bb + k * sB_n, nu, nx, nu, thr, nthr);
    }
    copy_rows_async(Zb + nz, ldz, d + bk * nx, 1, nx, 1, thr, nthr);
    copy_rows_async(Qb, ldz, hess + bk * nz * nz, nz, nz, nz, thr, nthr);
    copy_rows_async(Qb + nz, ldz, grads + bk * nz, 1, nz, 1, thr, nthr);
  };

  // terminal cost-to-go; Hf goes in transposed, the layout the first product reads
  for (int e = tid; e < nx * nx; e += kThreads) {
    const int i = e / nx, j = e - i * nx;
    sP[j * nxp + i] = Hf[b * nx * nx + e];
  }
  for (int i = tid; i < nx; i += kThreads) sp[i] = gf[b * nx + i];
  if (z_const) {
    for (int s = 0; s < 2; ++s) {
      copy_rows_async(sZ + s * nx * ldz, ldz, Ab, nx, nx, nx, tid, kThreads);
      copy_rows_async(sZ + s * nx * ldz + nx, ldz, Bb, nu, nx, nu, tid, kThreads);
    }
  }
  fetch_stage(N - 1, tid, kThreads);

  for (int k = N - 1; k >= 0; --k) {
    const long long bk = b * N + k;
    const T* Zb = sZ + (k & 1) * nx * ldz;
    T* Qb = sQ + (k & 1) * nzp * ldz;
    T* Qu_rows = Qb + nx * ldz;  // rows nx..nz-1: [Qux | Quu | Qu]

    PHASE_CLOCK_BEGIN(k);
    cp_async_wait_all();
    __syncthreads();  // stage k has landed; P, p of stage k + 1 are written
    if (fetch_warps == 0 && k > 0) fetch_stage(k - 1, tid, kThreads);

    PHASE_MARK(1);
    // ---- [PZ | Pd_p] = P^T [Z | d] + [0 | p] -------------------------------
    {
      const int ntj = ldz / 4;
      for (int t = tid; t < (nxp / 4) * ntj; t += kThreads) {
        const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
        T acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = (j0 + c == nz) ? sp[i0 + r] : T(0);
        tile_atb(acc, sP, nxp, Zb, ldz, nx, i0, j0);
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(sPZ + (i0 + r) * ldz + j0, acc[r]);
      }
    }
    __syncthreads();

    PHASE_MARK(2);
    // ---- [Q | q] = [H | g] + Z^T [PZ | Pd_p], Quu += reg I, Qxu skipped ----
    {
      const int ntj = ldz / 4;
      for (int t = tid; t < (nzp / 4) * ntj; t += kThreads) {
        const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
        if (i0 + 4 <= nx && j0 >= nx && j0 + 4 <= nz) continue;
        T acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Vec4<T> h = load4(Qb + (i0 + r) * ldz + j0);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = h.v[c] + ((i0 + r == j0 + c && i0 + r >= nx) ? reg : T(0));
        }
        tile_atb(acc, Zb, ldz, sPZ, ldz, nx, i0, j0);
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(Qb + (i0 + r) * ldz + j0, acc[r]);
      }
    }
    __syncthreads();

    PHASE_MARK(3);
    // ---- [K | kff] = -Quu^-1 [Qux | Qu] --------------------------------------
    if (in_registers) {
      // clamped pivots
      for (int g = warp; g < elim_groups; g += kWarps) {
        if constexpr (NU > 0)
          eliminate_registers<T, NU>(Qu_rows, ldz, nx, g, sK, ldk, K + bk * nu * nx, kff + bk * nu);
        else
          eliminate_registers_any<T, kRegisterMaxNu>(nu, Qu_rows, ldz, nx, g, sK, ldk,
                                                  K + bk * nu * nx, kff + bk * nu);
      }
      if (warp >= elim_groups && k > 0)
        fetch_stage(k - 1, tid - elim_groups * 32, fetch_warps * 32);
    } else {
      // In shared memory, on a copy: the last product reads Qux as it was,
      // and Quu stays intact for the jitter route's second attempt.
      const bool jitter = nu > kClampMaxNu;
      T scale = T(0);
      if (jitter) {
        for (int i = 0; i < nu; ++i) scale += Qu_rows[i * ldz + nx + i];
        scale = scale / T(nu);
        scale = scale < T(1e-9) ? T(1e-9) : scale;
      }
      bool failed = false;
      for (int attempt = 0; attempt < (jitter ? 2 : 1); ++attempt) {
        const T add = (attempt == 0 ? T(1e-7) : T(1e-3)) * scale;
        if (attempt > 0) __syncthreads();  // everyone has left the failed attempt
        for (int r = warp; r < nu; r += kWarps)
          for (int c = lane; c <= nz; c += 32)
            sW[r * ldz + c] = Qu_rows[r * ldz + c] + (c == nx + r ? add : T(0));
        __syncthreads();
        failed = eliminate_shared(sW, spiv, nx, nu, ldz, !jitter);
        if (!failed) break;
      }
      // back substitution, right-looking: step i finishes row i of [K | kff]
      // and takes it off the rows above; all threads, one barrier a step
      for (int i = nu - 1; i >= 0; --i) {
        const T di = spiv[i];
        for (int q = lane; q <= nx; q += 32) {
          const int col = q < nx ? q : nz;
          const T x = sW[i * ldz + col] * di;
          if (warp == (i & (kWarps - 1))) {
            const T out = failed ? T(nan("")) : -x;
            sK[i * ldk + q] = out;
            if (q < nx) K[(bk * nu + i) * nx + q] = out;
            else kff[bk * nu + i] = out;
          }
          const T* li = sW + nx + i;
          T* wc = sW + col;
          for (int r = warp; r < i; r += kWarps) wc[r * ldz] = fma(-li[r * ldz], x, wc[r * ldz]);
        }
        __syncthreads();
      }
    }
    __syncthreads();

    PHASE_MARK(4);
    // ---- [P | p] = [Qxx | q_x] + Qux^T [K | kff], unsymmetrised, into sPZ ----
    {
      const int ntj = ldk / 4;
      for (int t = tid; t < (nxp / 4) * ntj; t += kThreads) {
        const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
        T acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = Qb[(i0 + r) * ldz + (j0 + c < nx ? j0 + c : nz)];
        tile_atb(acc, Qu_rows, ldz, sK, ldk, nu, i0, j0);
#pragma unroll
        for (int r = 0; r < 4; ++r) store4(sPZ + (i0 + r) * ldz + j0, acc[r]);
      }
    }
    __syncthreads();

    PHASE_MARK(5);
    // ---- P = sym(P), a 4 x 4 tile and its mirror image per thread ----------------
    {
      const int nt = nxp / 4;
      for (int t = tid; t < nt * nt; t += kThreads) {
        const int ti = t / nt, i0 = ti * 4, j0 = (t - ti * nt) * 4;
        Vec4<T> a[4], bt[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = load4(sPZ + (i0 + r) * ldz + j0);
          bt[r] = load4(sPZ + (j0 + r) * ldz + i0);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          T out[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) out[c] = T(0.5) * (a[r].v[c] + bt[c].v[r]);
          store4(sP + (i0 + r) * nxp + j0, out);
        }
      }
    }
    for (int i = tid; i < nx; i += kThreads) sp[i] = sPZ[i * ldz + nx];
    PHASE_CLOCK_END();
  }
}

}  // namespace

// Host side: the launcher and the C interface.  RICCATI_DEVICE_CODE_ONLY leaves
// it out, for tools/emulate_riccati.py, which builds the device code above
// with a C++ compiler.
#ifndef RICCATI_DEVICE_CODE_ONLY

namespace {

template <typename T, int NX, int NU>
int launch(const void* A, const void* B, const void* d, const void* grads, const void* hess,
           const void* gf, const void* Hf, void* K, void* kff, int batch, int N, int nx, int nu,
           long long sA_b, long long sA_n, long long sB_b, long long sB_n, double reg,
           cudaStream_t stream) {
  const long long smem = Dims<NX, NU>{nx, nu}.smem_elems() * (long long)sizeof(T);
  if (smem > kMaxSmemBytes) return -1;
  auto kernel = riccati_backward_kernel<T, NX, NU>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<batch, kThreads, (size_t)smem, stream>>>(
      (const T*)A, (const T*)B, (const T*)d, (const T*)grads, (const T*)hess, (const T*)gf,
      (const T*)Hf, (T*)K, (T*)kff, N, nx, nu, sA_b, sA_n, sB_b, sB_n, (T)reg);
  return (int)cudaGetLastError();
}

// The instance that takes (element size, nx, nu): 0 and 1 are the specialised
// float32 shapes, 2 the runtime-sized float32 instance, 3 the float64 one.
int pick_instance(int elem_bytes, int nx, int nu, int runtime_sized) {
  if (elem_bytes == 8) return 3;
  if (!runtime_sized && nx == 27 && nu == 13) return 0;
  if (!runtime_sized && nx == 18 && nu == 10) return 1;
  return 2;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs, for the instance that
// riccati_backward picks for these arguments.
long long riccati_backward_smem_bytes(int nx, int nu, int elem_bytes, int runtime_sized) {
  switch (pick_instance(elem_bytes, nx, nu, runtime_sized)) {
    case 0: return Dims<27, 13>{nx, nu}.smem_elems() * elem_bytes;
    case 1: return Dims<18, 10>{nx, nu}.smem_elems() * elem_bytes;
    default: return Dims<0, 0>{nx, nu}.smem_elems() * elem_bytes;
  }
}

// Registers per thread, bytes of local memory per thread (spills and arrays the
// compiler could not keep in registers) and bytes of static shared memory of
// instance `which` (see pick_instance), into out[0..2].  Returns the CUDA error.
int riccati_backward_instance_attrs(int which, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&attr, riccati_backward_kernel<float, 27, 13>); break;
    case 1: e = cudaFuncGetAttributes(&attr, riccati_backward_kernel<float, 18, 10>); break;
    case 2: e = cudaFuncGetAttributes(&attr, riccati_backward_kernel<float, 0, 0>); break;
    case 3: e = cudaFuncGetAttributes(&attr, riccati_backward_kernel<double, 0, 0>); break;
    default: return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return 0;
}

// Launches on `stream` and does not synchronise.  elem_bytes 4 (float32) or 8
// (float64) for every tensor.  A, B: element strides over batch and stage (0
// broadcasts); every other tensor is contiguous batch-major.  runtime_sized
// != 0 keeps a float32 call off the specialised instances.  Returns the CUDA
// error code of the launch (0 = success), or -1 for arguments the kernel does
// not take (a shape beyond one block's shared memory included).
int riccati_backward(const void* A, const void* B, const void* d, const void* grads,
                     const void* hess, const void* gf, const void* Hf, void* K, void* kff,
                     int elem_bytes, int batch, int N, int nx, int nu, long long sA_b,
                     long long sA_n, long long sB_b, long long sB_n, double reg,
                     int runtime_sized, void* stream) {
  if (batch <= 0 || N <= 0 || nx <= 0 || nu <= 0) return -1;
  if (elem_bytes != 4 && elem_bytes != 8) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RICCATI_LAUNCH(T, NX, NU)                                                          \
  launch<T, NX, NU>(A, B, d, grads, hess, gf, Hf, K, kff, batch, N, nx, nu, sA_b, sA_n, sB_b, \
                    sB_n, reg, s)
  switch (pick_instance(elem_bytes, nx, nu, runtime_sized)) {
    case 0: return RICCATI_LAUNCH(float, 27, 13);
    case 1: return RICCATI_LAUNCH(float, 18, 10);
    case 2: return RICCATI_LAUNCH(float, 0, 0);
    default: return RICCATI_LAUNCH(double, 0, 0);
  }
#undef RICCATI_LAUNCH
}

}  // extern "C"

#endif  // RICCATI_DEVICE_CODE_ONLY
