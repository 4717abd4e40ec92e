// Batched multiple-shooting Riccati backward sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel upright_tpu/solver/pallas_riccati.py
// (pallas_backward_pass -> _riccati_kernel).  Same recursion, same
// regularisation and pivot clamp:
//
//   (P, p) = (Hf, gf);  for k = N-1 .. 0, with Z = [A_k | B_k] (nx x nz):
//     Pd_p = p + P d_k
//     Q    = H_k + Z^T P Z                      (nz x nz, nz = nx + nu)
//     q    = g_k + Z^T Pd_p
//     Quu  = Q[nx:, nx:] + reg I,  Qux = Q[nx:, :nx],  Qu = q[nx:]
//     L    = chol(Quu), pivots sqrt(max(s, 1e-12))
//     K_k  = -Quu^-1 Qux,  kff_k = -Quu^-1 Qu    (one solve of [Qux | Qu])
//     P    = sym(Q[:nx, :nx] + Qux^T K_k),  p = q[:nx] + Qux^T kff_k
//
// Design.  The Pallas grid is (batch blocks, N) with the stage axis sequential
// and (P, p) carried in scratch between grid steps.  Nothing carries between
// thread blocks here, so the stage loop sits inside the kernel: one thread
// block owns one instance for all N stages, and P, p, Z, PZ, Q, q, K, kff
// live in dynamic shared memory sized from the runtime (nx, nu) (about 20 KB
// at nx = 27, nu = 13).  The inputs are read in their public batch-major
// layout through strides; A and B take a batch and a stage stride each, and a
// stride of 0 broadcasts, so stage-invariant dynamics (one (nx, nx), (nx, nu)
// pair for the whole batch) are loaded into shared memory once per block and
// never materialised per stage.  The nu x nu factorisation is done by one
// warp (one lane per row, one __syncwarp per column); the two triangular
// substitutions run one right-hand-side column per thread.
//
// What bounds it.  Per stage-instance the kernel must read H_k, g_k, d_k and
// write K_k, kff_k (about 8.2 KB at 27/13) and does about 0.18 MFLOP in fp32
// outside the tensor cores, so by bytes and by operations a whole
// 512 x 20 call is worth tens of microseconds.  The measured time sits far
// above that: the sweep is a chain of N dependent stages, each with a
// nu-step factorisation and 2 nu substitution steps between block-wide
// barriers, so it is bound by latency, and with one 256-thread block per
// instance a 512-instance batch fills the 132 SMs only a few blocks deep.
// Several instances per block, register tiling of the Q update and wgmma are
// left to later work.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so the file
// builds in seconds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNu = 24;  // one warp factorises Quu, one lane per row
constexpr float kPivotEps = 1e-12f;

__global__ void __launch_bounds__(kThreads)
riccati_backward_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        const float* __restrict__ d, const float* __restrict__ grads,
                        const float* __restrict__ hess, const float* __restrict__ gf,
                        const float* __restrict__ Hf, float* __restrict__ K,
                        float* __restrict__ kff, int N, int nx, int nu,
                        long long sA_b, long long sA_n, long long sB_b, long long sB_n,
                        float reg) {
  extern __shared__ float smem[];
  const int nz = nx + nu;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  float* sP = smem;              // nx * nx
  float* sZ = sP + nx * nx;      // nx * nz   [A | B]
  float* sPZ = sZ + nx * nz;     // nx * nz
  float* sQ = sPZ + nx * nz;     // nz * nz
  float* sK = sQ + nz * nz;      // nu * nx
  float* sp = sK + nu * nx;      // nx
  float* sPd = sp + nx;          // nx
  float* sd = sPd + nx;          // nx
  float* sq = sd + nx;           // nz
  float* skff = sq + nz;         // nu

  // terminal cost-to-go
  for (int i = tid; i < nx * nx; i += kThreads) sP[i] = Hf[b * nx * nx + i];
  for (int i = tid; i < nx; i += kThreads) sp[i] = gf[b * nx + i];

  const bool z_const = (sA_n == 0 && sB_n == 0);
  const float* Ab = A + b * sA_b;
  const float* Bb = B + b * sB_b;
  if (z_const) {
    for (int i = tid; i < nx * nx; i += kThreads) sZ[(i / nx) * nz + (i % nx)] = Ab[i];
    for (int i = tid; i < nx * nu; i += kThreads) sZ[(i / nu) * nz + nx + (i % nu)] = Bb[i];
  }
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    const long long bk = b * N + k;
    // ---- load the stage ------------------------------------------------
    if (!z_const) {
      const float* Ak = Ab + k * sA_n;
      const float* Bk = Bb + k * sB_n;
      for (int i = tid; i < nx * nx; i += kThreads) sZ[(i / nx) * nz + (i % nx)] = Ak[i];
      for (int i = tid; i < nx * nu; i += kThreads) sZ[(i / nu) * nz + nx + (i % nu)] = Bk[i];
    }
    const float* Hk = hess + bk * nz * nz;
    for (int i = tid; i < nz * nz; i += kThreads) sQ[i] = Hk[i];
    for (int i = tid; i < nz; i += kThreads) sq[i] = grads[bk * nz + i];
    for (int i = tid; i < nx; i += kThreads) sd[i] = d[bk * nx + i];
    __syncthreads();

    // ---- PZ = P Z,  Pd_p = p + P d ---------------------------------------
    for (int e = tid; e < nx * nz; e += kThreads) {
      const int i = e / nz, j = e % nz;
      float acc = 0.f;
      for (int m = 0; m < nx; ++m) acc = fmaf(sP[i * nx + m], sZ[m * nz + j], acc);
      sPZ[e] = acc;
    }
    for (int i = tid; i < nx; i += kThreads) {
      float acc = sp[i];
      for (int m = 0; m < nx; ++m) acc = fmaf(sP[i * nx + m], sd[m], acc);
      sPd[i] = acc;
    }
    __syncthreads();

    // ---- Q = H + Z^T PZ,  q = g + Z^T Pd_p --------------------------------
    for (int e = tid; e < nz * nz; e += kThreads) {
      const int r = e / nz, c = e % nz;
      float acc = sQ[e];
      for (int m = 0; m < nx; ++m) acc = fmaf(sZ[m * nz + r], sPZ[m * nz + c], acc);
      if (r == c && r >= nx) acc += reg;  // Quu + reg I
      sQ[e] = acc;
    }
    for (int r = tid; r < nz; r += kThreads) {
      float acc = sq[r];
      for (int m = 0; m < nx; ++m) acc = fmaf(sZ[m * nz + r], sPd[m], acc);
      sq[r] = acc;
    }
    __syncthreads();

    // ---- Cholesky of Quu in place (lower triangle), warp 0 ---------------
    if (tid < 32) {
      const int i = tid;
      for (int j = 0; j < nu; ++j) {
        float s = 0.f;
        if (i >= j && i < nu) {
          s = sQ[(nx + i) * nz + nx + j];
          for (int m = 0; m < j; ++m)
            s -= sQ[(nx + i) * nz + nx + m] * sQ[(nx + j) * nz + nx + m];
        }
        const float piv = sqrtf(fmaxf(__shfl_sync(0xffffffffu, s, j), kPivotEps));
        if (i == j) sQ[(nx + i) * nz + nx + j] = piv;
        else if (i > j && i < nu) sQ[(nx + i) * nz + nx + j] = s / piv;
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- solve (L L^T) X = [Qux | Qu], one column per thread ---------------
    for (int c = tid; c <= nx; c += kThreads) {
      float y[kMaxNu];
      for (int i = 0; i < nu; ++i) {
        float s = (c < nx) ? sQ[(nx + i) * nz + c] : sq[nx + i];
        for (int m = 0; m < i; ++m) s -= sQ[(nx + i) * nz + nx + m] * y[m];
        y[i] = s / sQ[(nx + i) * nz + nx + i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        float s = y[i];
        for (int m = i + 1; m < nu; ++m) s -= sQ[(nx + m) * nz + nx + i] * y[m];
        y[i] = s / sQ[(nx + i) * nz + nx + i];
      }
      if (c < nx) {
        for (int i = 0; i < nu; ++i) {
          sK[i * nx + c] = -y[i];
          K[(bk * nu + i) * nx + c] = -y[i];
        }
      } else {
        for (int i = 0; i < nu; ++i) {
          skff[i] = -y[i];
          kff[bk * nu + i] = -y[i];
        }
      }
    }
    __syncthreads();

    // ---- P = sym(Qxx + Qux^T K),  p = Qx + Qux^T kff ----------------------
    // this phase reads Q, q, K, kff only, so P and p are overwritten in place
    for (int e = tid; e < nx * nx; e += kThreads) {
      const int i = e / nx, j = e % nx;
      float pij = sQ[i * nz + j], pji = sQ[j * nz + i];
      for (int m = 0; m < nu; ++m) {
        pij = fmaf(sQ[(nx + m) * nz + i], sK[m * nx + j], pij);
        pji = fmaf(sQ[(nx + m) * nz + j], sK[m * nx + i], pji);
      }
      sP[e] = 0.5f * (pij + pji);
    }
    for (int i = tid; i < nx; i += kThreads) {
      float acc = sq[i];
      for (int m = 0; m < nu; ++m) acc = fmaf(sQ[(nx + m) * nz + i], skff[m], acc);
      sp[i] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for (nx, nu).
long long riccati_backward_smem_bytes(int nx, int nu) {
  const long long nz = nx + nu;
  return 4ll * (nx * nx + 2ll * nx * nz + nz * nz + (long long)nu * nx + 3ll * nx + nz + nu);
}

// Launches on `stream` and does not synchronise.  A, B: element strides over
// batch and stage (0 broadcasts); every other tensor is contiguous
// batch-major.  Returns the CUDA error code of the launch (0 = success), or
// -1 for shapes the kernel does not take.
int riccati_backward_f32(const float* A, const float* B, const float* d,
                         const float* grads, const float* hess, const float* gf,
                         const float* Hf, float* K, float* kff, int batch, int N,
                         int nx, int nu, long long sA_b, long long sA_n,
                         long long sB_b, long long sB_n, float reg, void* stream) {
  if (batch <= 0 || N <= 0 || nx <= 0 || nu <= 0 || nu > kMaxNu) return -1;
  const long long smem = riccati_backward_smem_bytes(nx, nu);
  if (smem > 232448) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(riccati_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  riccati_backward_kernel<<<batch, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      A, B, d, grads, hess, gf, Hf, K, kff, N, nx, nu, sA_b, sA_n, sB_b, sB_n, reg);
  return (int)cudaGetLastError();
}

}  // extern "C"
