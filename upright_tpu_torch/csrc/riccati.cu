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
//     and 512 blocks put fewer than four on an SM, too few to hide the chain
//     (the wide route takes 168 registers a thread in float32, three blocks
//     an SM: 512 blocks run in two waves; held to 128 registers it spilled
//     and was slower at every batch of 64 and below on an H100).
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
//   - Above 16 inputs the wide route (riccati_backward_wide, below) factors
//     Quu in panels of 16 columns: one warp factors a panel's diagonal block
//     in registers as above (and inverts it on the same lanes), all threads
//     apply it to the panel's rows and take the panel off the trailing
//     upper tiles as 4 x 4 tile products, the forward substitution of
//     [Qux | Qu] riding along; the back substitution runs warp by warp on
//     each warp's own columns.  Two barriers a panel and six more a stage
//     (18 at nu 93).  H and g go from device
//     memory straight into the Q product's tiles (the next stage's are asked
//     into L2 meanwhile), so shared memory holds one [Q | q], a 16-row
//     scratch and [A | B | d] once: every shipped width fits one block in
//     float64 (227,200 bytes at 27/93; in float64 at nx 27 up to nu 96).
//   - The register route fetches the next stage's H, g, d (and A, B when
//     they vary by stage) with cp.async into a second buffer while this
//     stage computes: 16-byte copies where the row length and the addresses
//     allow it, element-sized copies otherwise.  Stage-invariant A, B
//     (strides of 0) are loaded once per block.
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
#define PHASE_CLOCK_BEGIN(k)                                               \
  const bool phase_clock = gridDim.x == 1 && (k) == 3 && threadIdx.x == 0; \
  long long phase_t[8];                                                    \
  PHASE_MARK(0)
#define PHASE_MARK(i) \
  if (phase_clock) phase_t[i] = clock64()
// `last` phases, named in order by the words of `names`; one line a launch
#define PHASE_CLOCK_END(last, names)                                                  \
  PHASE_MARK(last);                                                                   \
  if (phase_clock) {                                                                  \
    printf("PHASES %s;", names);                                                      \
    for (int i = 0; i < (last); ++i) printf(" %lld", phase_t[i + 1] - phase_t[i]);   \
    printf("\n");                                                                    \
  }
#else
#define PHASE_CLOCK_BEGIN(k)
#define PHASE_MARK(i)
#define PHASE_CLOCK_END(last, names)
#endif

namespace {

constexpr int kThreads = 128;  // a block of the register route
constexpr int kWarps = kThreads / 32;
// A block of the wide route, sized for the batched solve at batch 512 (27/21):
// on an H100, 256 threads were 1.54x slower there (one block an SM) and 5-11%
// faster at batch 64 and 1, where K1 is under 1% of a closed-loop tick.
constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kClampMaxNu = 24;  // above it: jitter route instead of the pivot clamp
// The runtime-sized instance holds one unrolled register elimination per width
// up to this; wider blocks take the wide route.  (Up to 24, nvcc took 80 s for
// this file instead of 30 s.)
constexpr int kRegisterMaxNu = 16;
constexpr int kPanel = 16;  // columns of Quu factored at once on the wide route
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
  // elements of shared memory
  __host__ __device__ long long smem_elems() const {
    return (long long)nxp() * nxp() + nxp() + 2ll * nx() * ldz() + 2ll * nzp() * ldz() +
           (long long)nxp() * ldz() + (long long)nu() * ldk();
  }
};

// Layout of the wide route (riccati_backward_wide).  A row or column z of the
// nz-wide problem sits at z for z < nx (the x block) and at uo + z - nx for
// z >= nx (the u block), and q (and d, in [A | B | d]) in column qo: every
// block starts at a multiple of 4, so the products' 16-byte loads reach it.
struct WideDims {
  int nx, nu;
  __host__ __device__ int nxp() const { return round4(nx); }       // leading dim of P; uo
  __host__ __device__ int nup() const { return round4(nu); }
  __host__ __device__ int uo() const { return nxp(); }             // first row / column of u
  __host__ __device__ int qo() const { return nxp() + nup(); }     // column of q, d
  __host__ __device__ int ldz() const { return qo() + 4; }         // of [Z | d], [PZ | Pd_p], [Q | q]
  __host__ __device__ int ldk() const { return round4(nx + 1); }   // of [K | kff]
  __host__ __device__ int lds() const { return nup() + ldk(); }    // of the panel scratch
  __host__ __device__ long long smem_elems() const {
    return (long long)nxp() * nxp() + nxp()  // P, p
           + (long long)nx * ldz()           // [A | B | d]
           + (long long)nxp() * ldz()        // [PZ | Pd_p], then [P | p]
           + (long long)qo() * ldz()         // [Q | q]
           + (long long)nup() * ldk()        // -[Qux | Qu], then [K | kff]
           + (long long)kPanel * lds()       // a panel's rows after its triangular solve
           + 4;                              // failure flags of the two attempts
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

// The three products and the symmetrisation that both routes share, each by
// all `nthr` threads of the block; `dcol` / `qcol` is the column of d and
// Pd_p / of q in the layout.
// [PZ | Pd_p] = P^T [Z | d] + [0 | p], into PZ (leading dim ldz).
template <typename T>
__device__ __forceinline__ void product_pz(const T* sP, const T* sp, const T* Z, T* PZ, int nx,
                                           int nxp, int ldz, int dcol, int nthr) {
  const int ntj = ldz / 4;
  for (int t = threadIdx.x; t < (nxp / 4) * ntj; t += nthr) {
    const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = (j0 + c == dcol) ? sp[i0 + r] : T(0);
    tile_atb(acc, sP, nxp, Z, ldz, nx, i0, j0);
#pragma unroll
    for (int r = 0; r < 4; ++r) store4(PZ + (i0 + r) * ldz + j0, acc[r]);
  }
}

// [P | p] = [Qxx | q_x] + Qux^T [K | kff], unsymmetrised, into PZ: Q holds
// the x rows of [Q | q], Qu_rows its u rows (both leading dim ldz).
template <typename T>
__device__ __forceinline__ void product_p(const T* Q, const T* Qu_rows, const T* sK, T* PZ, int nx,
                                          int nu, int nxp, int ldz, int ldk, int qcol, int nthr) {
  const int ntj = ldk / 4;
  for (int t = threadIdx.x; t < (nxp / 4) * ntj; t += nthr) {
    const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
    T acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = Q[(i0 + r) * ldz + (j0 + c < nx ? j0 + c : qcol)];
    tile_atb(acc, Qu_rows, ldz, sK, ldk, nu, i0, j0);
#pragma unroll
    for (int r = 0; r < 4; ++r) store4(PZ + (i0 + r) * ldz + j0, acc[r]);
  }
}

// P = sym(P), a 4 x 4 tile and its mirror image per thread, and p, from the
// unsymmetrised [P | p] in PZ
template <typename T>
__device__ __forceinline__ void symmetrise_p(T* sP, T* sp, const T* PZ, int nx, int nxp, int ldz,
                                             int nthr) {
  const int nt = nxp / 4;
  for (int t = threadIdx.x; t < nt * nt; t += nthr) {
    const int ti = t / nt, i0 = ti * 4, j0 = (t - ti * nt) * 4;
    Vec4<T> a[4], bt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = load4(PZ + (i0 + r) * ldz + j0);
      bt[r] = load4(PZ + (j0 + r) * ldz + i0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      T out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = T(0.5) * (a[r].v[c] + bt[c].v[r]);
      store4(sP + (i0 + r) * nxp + j0, out);
    }
  }
  for (int i = threadIdx.x; i < nx; i += nthr) sp[i] = PZ[i * ldz + nx];
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
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long b = blockIdx.x;

  T* sP = reinterpret_cast<T*>(smem_raw);  // nxp x nxp   P, by depth (P = P^T)
  T* sp = sP + nxp * nxp;                  // nxp
  T* sZ = sp + nxp;                        // 2 x (nx x ldz)   [A | B | d]
  T* sQ = sZ + 2 * nx * ldz;               // 2 x (nzp x ldz)  [H | g], then [Q | q] in place
  T* sPZ = sQ + 2 * nzp * ldz;             // nxp x ldz   [PZ | Pd_p], then the unsymmetrised [P | p]
  T* sK = sPZ + nxp * ldz;                 // nu x ldk    [K | kff]

  // The register elimination gives a warp 32 - nu columns of [K | kff]; the
  // warps it leaves idle fetch the next stage meanwhile.  Where it leaves
  // none, all threads fetch at the top of a stage instead.
  const int elim_groups = (nx + 32 - nu) / (32 - nu);
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
    product_pz(sP, sp, Zb, sPZ, nx, nxp, ldz, nz, kThreads);
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
    // ---- [K | kff] = -Quu^-1 [Qux | Qu], clamped pivots ------------------------
    for (int g = warp; g < elim_groups; g += kWarps) {
      if constexpr (NU > 0)
        eliminate_registers<T, NU>(Qu_rows, ldz, nx, g, sK, ldk, K + bk * nu * nx, kff + bk * nu);
      else
        eliminate_registers_any<T, kRegisterMaxNu>(nu, Qu_rows, ldz, nx, g, sK, ldk,
                                                K + bk * nu * nx, kff + bk * nu);
    }
    if (warp >= elim_groups && k > 0) fetch_stage(k - 1, tid - elim_groups * 32, fetch_warps * 32);
    __syncthreads();

    PHASE_MARK(4);
    product_p(Qb, Qu_rows, sK, sPZ, nx, nu, nxp, ldz, ldk, nz, kThreads);
    __syncthreads();

    PHASE_MARK(5);
    symmetrise_p(sP, sp, sPZ, nx, nxp, ldz, kThreads);
    PHASE_CLOCK_END(6, "wait_and_fetch product_PZ product_Q elimination product_P symmetrise");
  }
}

// acc (4 x 4) -= A^T B, as tile_atb
template <typename T>
__device__ __forceinline__ void tile_atb_sub(T (&acc)[4][4], const T* A, int lda, const T* B,
                                             int ldb, int depth, int i0, int j0) {
  A += i0;
  B += j0;
#pragma unroll 4
  for (int m = 0; m < depth; ++m) {
    const Vec4<T> a = load4(A + m * lda);
    const Vec4<T> b = load4(B + m * ldb);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fma(-a.v[r], b.v[c], acc[r][c]);
  }
}

// Asks L2 for the `bytes` bytes from p on, one 128-byte line a call, the lines
// spread over the `nthr` threads that call it with thr = 0 .. nthr - 1.
__device__ __forceinline__ void prefetch_range_l2(const void* p, long long bytes, int thr,
                                                  int nthr) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
  const uintptr_t end = reinterpret_cast<uintptr_t>(p) + (uintptr_t)bytes;
  for (uintptr_t a = first + (uintptr_t)thr * 128; a < end; a += (uintptr_t)nthr * 128)
    prefetch_l2(reinterpret_cast<const void*>(a));
}

// One diagonal block of the wide route's factorisation, by one warp in
// registers: lane c < 16 takes column c of D (rows and columns j0 .. j0 + w - 1
// of the u block as it stands, its upper triangle read, the update by the
// previous panel's rows S taken off, `add` on the diagonal; identity where
// c or the row is w or more), lane 16 + c column c of the identity.  The
// elimination of eliminate_registers turns [D | I] into [U | L^-1], D = L L^T,
// L = U^T; lane 16 + c writes row c of U^-1 = L^-T (zeros left of the
// diagonal) over the block, rows and columns up to round4(w).  Pivots are
// clamped (sqrt(max(s, 1e-12))) or, with `jitter`, must be positive: where one
// is not, *flag becomes 1.  Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void factor_panel(T* Qu, int ldz, int uo, int j0, int w, const T* S,
                                             int lds, T add, bool jitter, T* flag) {
  const int lane = threadIdx.x & 31, c = lane & 15;
  T m[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r) {
    T v = (r == c) ? T(1) : T(0);
    if (lane < kPanel && r < w && c < w) {
      const int lo = r < c ? r : c, hi = r < c ? c : r;
      v = Qu[(j0 + lo) * ldz + uo + j0 + hi];
      if (S != nullptr) {
#pragma unroll
        for (int k = 0; k < kPanel; ++k) v = fma(-S[k * lds + r], S[k * lds + c], v);
      }
      if (r == c) v += add;
    }
    m[r] = v;
  }
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    T u[kPanel];
#pragma unroll
    for (int i = j; i < kPanel; ++i) u[i] = __shfl_sync(kFullMask, m[j], i);
    T s = u[j];
    if (jitter) bad = bad || !(s > T(0));
    else s = clamp_pivot(s);
    const T rinv = inv_sqrt(s);
    m[j] *= rinv;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) m[i] = fma(-(u[i] * rinv), m[j], m[i]);
  }
  const int wp = round4(w);
  if (lane >= kPanel && c < wp) {
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      if (r < wp) Qu[(j0 + c) * ldz + uo + j0 + r] = m[r];
  }
  if (lane == 0 && bad) *flag = T(1);
}

// The wide route: every nu above kRegisterMaxNu, float32 and float64, one
// block of kWideThreads threads per instance as riccati_backward_kernel.  Per
// stage:
//   1. [PZ | Pd_p] = P^T [Z | d] + [0 | p] in shared memory;
//   2. [Q | q] = [H | g] + Z^T [PZ | Pd_p]: a tile's H and g read from device
//      memory, all 16 loads issued before its product and added after it
//      (the next stage's H, g, d, A, B are asked into L2 at the top of this
//      one); of Quu the upper tiles only, Qxu not at all; -[Qux | Qu] also
//      into [K | kff]'s buffer;
//   3. the factorisation of Quu (+ the jitter) in panels of 16 columns, with
//      the forward substitution of [K | kff] riding along: per panel, one
//      warp factors its diagonal block in registers (factor_panel), all
//      threads apply U^-1 of it to the panel's rows right of it (into the
//      scratch S), then take S^T S off the trailing upper tiles and the rows
//      of [K | kff] below, and put S back: [K | kff]'s rows, and U12^T into
//      the lower triangle, which the back substitution reads by rows.  The
//      warp that factors the next panel updates its block itself meanwhile,
//      so a panel costs two barriers;
//   4. the back substitution, warp by warp on their own columns of [K | kff]
//      (warp barriers only), with the next stage's [A | B | d] copied in
//      meanwhile;
//   5. [P | p] and P = sym(P) as riccati_backward_kernel.
// With the jitter (nu > 24) a failed factorisation is taken again from a
// recomputed Quu (step 2 on its rows, the same numbers) with the larger
// jitter; where that fails too, K and kff are NaN.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
riccati_backward_wide(const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ d,
                      const T* __restrict__ grads, const T* __restrict__ hess,
                      const T* __restrict__ gf, const T* __restrict__ Hf, T* __restrict__ K,
                      T* __restrict__ kff, int N, int nx, int nu, long long sA_b, long long sA_n,
                      long long sB_b, long long sB_n, T reg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const WideDims dims{nx, nu};
  const int nz = nx + nu, nxp = dims.nxp(), nup = dims.nup(), uo = dims.uo(), qo = dims.qo();
  const int ldz = dims.ldz(), ldk = dims.ldk(), lds = dims.lds();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.x;
  const bool jitter = nu > kClampMaxNu;
  const int panels = (nu + kPanel - 1) / kPanel;

  T* sP = reinterpret_cast<T*>(smem_raw);  // nxp x nxp   P, by depth (P = P^T)
  T* sp = sP + nxp * nxp;                  // nxp
  T* sZ = sp + nxp;                        // nx x ldz    [A | 0 | B | 0 | d]
  T* sPZ = sZ + nx * ldz;                  // nxp x ldz   [PZ | Pd_p], then the unsymmetrised [P | p]
  T* sQ = sPZ + nxp * ldz;                 // qo x ldz    [Q | q]: x rows, then u rows from uo
  T* sK = sQ + qo * ldz;                   // nup x ldk   -[Qux | Qu], then [K | kff]
  T* sS = sK + nup * ldk;                  // 16 x lds    a panel's rows after its solve
  T* sflag = sS + kPanel * lds;            // 2           1 where an attempt failed
  T* Qu = sQ + uo * ldz;                   // the u rows: [Qux | 0 | Quu | 0 | Qu]

  const bool z_const = (sA_n == 0 && sB_n == 0);
  const T* Ab = A + b * sA_b;
  const T* Bb = B + b * sB_b;

  // [A | B | d] of stage k into sZ (with the dynamics, or d alone)
  auto fetch_z = [&](int k, bool dynamics) {
    if (dynamics) {
      copy_rows_async(sZ, ldz, Ab + k * sA_n, nx, nx, nx, tid, kWideThreads);
      copy_rows_async(sZ + uo, ldz, Bb + k * sB_n, nu, nx, nu, tid, kWideThreads);
    }
    copy_rows_async(sZ + qo, ldz, d + (b * N + k) * nx, 1, nx, 1, tid, kWideThreads);
  };
  // what stage k reads from device memory, into L2
  auto prefetch_stage = [&](int k) {
    const long long bk = b * N + k;
    prefetch_range_l2(hess + bk * nz * nz, (long long)nz * nz * sizeof(T), tid, kWideThreads);
    prefetch_range_l2(grads + bk * nz, (long long)nz * sizeof(T), tid, kWideThreads);
    prefetch_range_l2(d + bk * nx, (long long)nx * sizeof(T), tid, kWideThreads);
    if (!z_const) {
      prefetch_range_l2(Ab + k * sA_n, (long long)nx * nx * sizeof(T), tid, kWideThreads);
      prefetch_range_l2(Bb + k * sB_n, (long long)nx * nu * sizeof(T), tid, kWideThreads);
    }
  };
  // the z index of row or column i of the layout (nz for q's column; -1 in
  // the padding)
  auto z_of = [&](int i) {
    return i < nx ? i : (i >= uo && i < uo + nu) ? nx + i - uo : (i == qo ? nz : -1);
  };

  // ---- [Q | q] = [H | g] + Z^T [PZ | Pd_p], Quu += reg I: the tiles of the
  // u rows (x columns, upper tiles of Quu, q) and, unless u_only, of the x
  // rows (x columns, q); -[Qux | Qu] into sK as well
  auto q_product = [&](const T* Hk, const T* gk, bool u_only) {
    const int ntj = ldz / 4, nti = qo / 4, first = u_only ? uo / 4 : 0;
    for (int t = first * ntj + tid; t < nti * ntj; t += kWideThreads) {
      const int ti = t / ntj, i0 = ti * 4, j0 = (t - ti * ntj) * 4;
      const bool u_row = i0 >= uo, u_col = j0 >= uo && j0 < qo;
      if (u_col && (!u_row || j0 < i0)) continue;  // Qxu; the lower tiles of Quu
      // the 16 loads of H and g first, all of them (an address inside g
      // where the layout has padding), so that they are in flight together
      // while the product runs
      int zi[4], zj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) zi[e] = z_of(i0 + e), zj[e] = z_of(j0 + e);
      T h[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool inside = zi[r] >= 0 && zj[c] >= 0;
          h[r][c] = *(!inside ? gk : zj[c] == nz ? gk + zi[r] : Hk + zi[r] * nz + zj[c]);
        }
      T acc[4][4] = {};
      tile_atb(acc, sZ, ldz, sPZ, ldz, nx, i0, j0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = (zi[r] >= 0 && zj[c] >= 0 ? h[r][c] + acc[r][c] : acc[r][c]) +
                      ((i0 + r == j0 + c && u_row) ? reg : T(0));
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(sQ + (i0 + r) * ldz + j0, acc[r]);
      if (u_row && !u_col) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = i0 + r - uo;
          if (row >= nu) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = j0 + c < nx ? j0 + c : (j0 + c == qo ? nx : -1);
            if (col >= 0) sK[row * ldk + col] = -acc[r][c];
          }
        }
      }
    }
  };

  // ---- the factorisation with the forward substitution, `add` on Quu's
  // diagonal; true (for every thread alike) if a pivot was not positive
  auto factorise = [&](T add, T* flag) {
    if (warp == 0) factor_panel(Qu, ldz, uo, 0, nu < kPanel ? nu : kPanel, (const T*)nullptr, lds,
                                add, jitter, flag);
    __syncthreads();
    for (int p = 0; p < panels; ++p) {
      if (*flag != T(0)) return true;
      const int j0 = p * kPanel, w = nu - j0 < kPanel ? nu - j0 : kPanel;
      const int right = nup - j0 - kPanel > 0 ? nup - j0 - kPanel : 0;  // Quu columns right of it
      // S = U^-T [Quu(P, right) | -[Qux | Qu](P)], the panel's rows P
      {
        const int rt = round4(w) / 4, ct = right / 4 + ldk / 4;
        const T* Uinv = Qu + j0 * ldz + uo + j0;
        for (int t = tid; t < rt * ct; t += kWideThreads) {
          const int ti = t / ct, tj = t - ti * ct, r0 = ti * 4;
          const bool quu = tj < right / 4;
          T acc[4][4] = {};
          tile_atb(acc, Uinv, ldz, quu ? Uinv + kPanel : sK + j0 * ldk, quu ? ldz : ldk,
                   w < r0 + 4 ? w : r0 + 4, r0, quu ? tj * 4 : tj * 4 - right);
#pragma unroll
          for (int r = 0; r < 4; ++r) store4(sS + (r0 + r) * lds + tj * 4, acc[r]);
        }
      }
      __syncthreads();
      const int i_base = j0 + kPanel, nt = right / 4;
      if (warp == 0) {
        // the next panel's diagonal block, updated here, then factored
        if (p + 1 < panels)
          factor_panel(Qu, ldz, uo, i_base, nu - i_base < kPanel ? nu - i_base : kPanel, sS, lds,
                       add, jitter, flag);
      } else {
        const int thr = tid - 32, nthr = kWideThreads - 32;
        // the trailing update: upper tiles of Quu below and right of the
        // panel but the next panel's diagonal block, and [K | kff]'s rows
        const int n_quu = nt * nt, n_all = n_quu + nt * (ldk / 4);
        for (int t = thr; t < n_all; t += nthr) {
          T acc[4][4];
          if (t < n_quu) {
            const int a = t / nt, c = t - a * nt;
            if (c < a || (a < kPanel / 4 && c < kPanel / 4)) continue;
            T* C = Qu + (i_base + 4 * a) * ldz + uo + i_base + 4 * c;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const Vec4<T> v = load4(C + r * ldz);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) acc[r][cc] = v.v[cc];
            }
            tile_atb_sub(acc, sS, lds, sS, lds, w, 4 * a, 4 * c);
#pragma unroll
            for (int r = 0; r < 4; ++r) store4(C + r * ldz, acc[r]);
          } else {
            const int t2 = t - n_quu, a = t2 / (ldk / 4), c0 = (t2 - a * (ldk / 4)) * 4;
            T* C = sK + (i_base + 4 * a) * ldk + c0;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const Vec4<T> v = load4(C + r * ldk);
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) acc[r][cc] = v.v[cc];
            }
            tile_atb_sub(acc, sS, lds, sS + right, lds, w, 4 * a, c0);
#pragma unroll
            for (int r = 0; r < 4; ++r) store4(C + r * ldk, acc[r]);
          }
        }
        // S back: the panel's rows of [K | kff], and U12^T below the block
        for (int e = thr; e < w * ldk; e += nthr) {
          const int r = e / ldk, c = e - r * ldk;
          sK[(j0 + r) * ldk + c] = sS[r * lds + right + c];
        }
        for (int e = thr; e < (nu - i_base) * w; e += nthr) {
          const int s = e / w, r = e - s * w;
          Qu[(i_base + s) * ldz + uo + j0 + r] = sS[r * lds + s];
        }
      }
      __syncthreads();
    }
    return false;
  };

  // terminal cost-to-go; Hf goes in transposed, the layout the first product reads
  for (int e = tid; e < nx * nx; e += kWideThreads) {
    const int i = e / nx, j = e - i * nx;
    sP[j * nxp + i] = Hf[b * nx * nx + e];
  }
  for (int i = tid; i < nx; i += kWideThreads) sp[i] = gf[b * nx + i];
  for (int e = tid; e < nx * ldz; e += kWideThreads) sZ[e] = T(0);  // the padding stays 0
  __syncthreads();
  fetch_z(N - 1, true);

  for (int k = N - 1; k >= 0; --k) {
    const long long bk = b * N + k;
    const T* Hk = hess + bk * nz * nz;
    const T* gk = grads + bk * nz;

    PHASE_CLOCK_BEGIN(k);
    cp_async_wait_all();
    __syncthreads();  // [A | B | d] of stage k has landed; P, p of stage k + 1 are written
    if (k > 0) prefetch_stage(k - 1);

    PHASE_MARK(1);
    product_pz(sP, sp, sZ, sPZ, nx, nxp, ldz, qo, kWideThreads);
    __syncthreads();

    PHASE_MARK(2);
    q_product(Hk, gk, false);
    if (tid == 0) sflag[0] = sflag[1] = T(0);
    __syncthreads();

    PHASE_MARK(3);
    // ---- the factorisation, and the forward substitution of [K | kff] --------
    T scale = T(0);
    if (jitter) {
      for (int i = 0; i < nu; ++i) scale += Qu[i * ldz + uo + i];
      scale = scale / T(nu);
      scale = scale < T(1e-9) ? T(1e-9) : scale;
    }
    bool failed = factorise(jitter ? T(1e-7) * scale : T(0), sflag);
    if (failed && jitter) {
      q_product(Hk, gk, true);  // Quu and -[Qux | Qu] as they were
      __syncthreads();
      failed = factorise(T(1e-3) * scale, sflag + 1);
    }
    if (k > 0) fetch_z(k - 1, !z_const);

    PHASE_MARK(4);
    // ---- the back substitution: warp w on column groups w, w + 4, ... ----------
    if (failed) {
      for (int e = tid; e < nu * (nx + 1); e += kWideThreads) {
        const int i = e / (nx + 1), q = e - i * (nx + 1);
        sK[i * ldk + q] = T(nan(""));
        if (q < nx) K[(bk * nu + i) * nx + q] = T(nan(""));
        else kff[bk * nu + i] = T(nan(""));
      }
    } else {
      const int groups = ldk / 4, mine = (groups - warp + kWideWarps - 1) / kWideWarps;
      for (int p = panels - 1; p >= 0; --p) {
        const int j0 = p * kPanel, w = nu - j0 < kPanel ? nu - j0 : kPanel;
        const T* Uinv = Qu + j0 * ldz + uo + j0;
        // the panel's rows: X = U^-1 Y, a lane on four rows of one column
        for (int cb = 0; cb < 4 * mine; cb += 8) {
          const int ci = cb + (lane & 7), r0 = (lane >> 3) * 4;
          const int q = 4 * (warp + kWideWarps * (ci >> 2)) + (ci & 3);
          const bool active = ci < 4 * mine && r0 < w;
          T x[4] = {};
          for (int m = active ? r0 : w; m < w; ++m) {
            const T y = sK[(j0 + m) * ldk + q];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (m >= r0 + r) x[r] = fma(Uinv[(r0 + r) * ldz + m], y, x[r]);
          }
          __syncwarp();
          if (active) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = j0 + r0 + r;
              if (r0 + r >= w) continue;
              sK[i * ldk + q] = x[r];
              if (q < nx) K[(bk * nu + i) * nx + q] = x[r];
              else if (q == nx) kff[bk * nu + i] = x[r];
            }
          }
          __syncwarp();
        }
        // the rows above: Y -= U(above, P) X, U(i, j0 + m) read from U12^T
        for (int t = lane; t < (j0 / 4) * mine; t += 32) {
          const int a = t / mine, c0 = 4 * (warp + kWideWarps * (t - a * mine));
          T acc[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const Vec4<T> v = load4(sK + (4 * a + r) * ldk + c0);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[r][cc] = v.v[cc];
          }
          tile_atb_sub(acc, Qu + j0 * ldz + uo, ldz, sK + j0 * ldk, ldk, w, 4 * a, c0);
#pragma unroll
          for (int r = 0; r < 4; ++r) store4(sK + (4 * a + r) * ldk + c0, acc[r]);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    PHASE_MARK(5);
    product_p(sQ, Qu, sK, sPZ, nx, nu, nxp, ldz, ldk, qo, kWideThreads);
    __syncthreads();

    PHASE_MARK(6);
    symmetrise_p(sP, sp, sPZ, nx, nxp, ldz, kWideThreads);
    PHASE_CLOCK_END(7, "wait_and_fetch product_PZ product_Q factorisation substitution "
                       "product_P symmetrise");
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

template <typename T>
int launch_wide(const void* A, const void* B, const void* d, const void* grads, const void* hess,
                const void* gf, const void* Hf, void* K, void* kff, int batch, int N, int nx,
                int nu, long long sA_b, long long sA_n, long long sB_b, long long sB_n,
                double reg, cudaStream_t stream) {
  const long long smem = WideDims{nx, nu}.smem_elems() * (long long)sizeof(T);
  if (smem > kMaxSmemBytes) return -1;
  auto kernel = riccati_backward_wide<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<batch, kWideThreads, (size_t)smem, stream>>>(
      (const T*)A, (const T*)B, (const T*)d, (const T*)grads, (const T*)hess, (const T*)gf,
      (const T*)Hf, (T*)K, (T*)kff, N, nx, nu, sA_b, sA_n, sB_b, sB_n, (T)reg);
  return (int)cudaGetLastError();
}

// The instance that takes (element size, nx, nu), by type and width alone: 0
// and 1 are the specialised float32 shapes, 2 and 3 the runtime-sized
// register route (nu <= 16) in float32 and float64, 4 and 5 the wide route.
int pick_instance(int elem_bytes, int nx, int nu, int runtime_sized) {
  if (nu > kRegisterMaxNu) return elem_bytes == 8 ? 5 : 4;
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
    case 2:
    case 3: return Dims<0, 0>{nx, nu}.smem_elems() * elem_bytes;
    default: return WideDims{nx, nu}.smem_elems() * elem_bytes;
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
    case 4: e = cudaFuncGetAttributes(&attr, riccati_backward_wide<float>); break;
    case 5: e = cudaFuncGetAttributes(&attr, riccati_backward_wide<double>); break;
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
#define RICCATI_ARGS \
  A, B, d, grads, hess, gf, Hf, K, kff, batch, N, nx, nu, sA_b, sA_n, sB_b, sB_n, reg, s
  switch (pick_instance(elem_bytes, nx, nu, runtime_sized)) {
    case 0: return launch<float, 27, 13>(RICCATI_ARGS);
    case 1: return launch<float, 18, 10>(RICCATI_ARGS);
    case 2: return launch<float, 0, 0>(RICCATI_ARGS);
    case 3: return launch<double, 0, 0>(RICCATI_ARGS);
    case 4: return launch_wide<float>(RICCATI_ARGS);
    default: return launch_wide<double>(RICCATI_ARGS);
  }
#undef RICCATI_ARGS
}

}  // extern "C"

#endif  // RICCATI_DEVICE_CODE_ONLY
