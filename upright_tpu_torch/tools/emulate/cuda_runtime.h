// Stand-in for <cuda_runtime.h> that lets a C++ compiler build the device code
// of csrc/riccati.cu, csrc/plant.cu and csrc/chain.cu for the CPU: one pthread
// plays one CUDA thread, a pthread barrier per block plays __syncthreads, and a
// barrier per warp plays __syncwarp and, with an exchange buffer, the shuffles.
// Only what those kernels use is here.  See ../emulate_riccati.py,
// ../emulate_plant.py and ../emulate_chain.py.

#pragma once

#include <pthread.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __grid_constant__

struct Dim3 {
  int x, y, z;
};
extern thread_local Dim3 threadIdx, blockIdx;

constexpr int kMaxEmulatedWarps = 32;
extern pthread_barrier_t g_block_barrier, g_warp_barrier[kMaxEmulatedWarps];
extern double g_exchange[kMaxEmulatedWarps][32];

inline void __syncthreads() { pthread_barrier_wait(&g_block_barrier); }

// every lane of the warp calls these (full mask), as the kernels do
inline void __syncwarp(unsigned = 0xffffffffu) {
  pthread_barrier_wait(&g_warp_barrier[threadIdx.x >> 5]);
}

template <typename T>
T __shfl_sync(unsigned, T v, int src_lane) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  g_exchange[warp][lane] = (double)v;
  pthread_barrier_wait(&g_warp_barrier[warp]);
  const T out = (T)g_exchange[warp][src_lane & 31];
  pthread_barrier_wait(&g_warp_barrier[warp]);
  return out;
}

// the value of lane + delta; a lane past the warp's end gets its own value
template <typename T>
T __shfl_down_sync(unsigned mask, T v, unsigned delta) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(mask, v, lane + (int)delta < 32 ? lane + (int)delta : lane);
}

// sin(pi x), cos(pi x) with the reduction by whole periods done exactly
template <typename T>
void sincospi_exact(T x, T* s, T* c) {
  if (!std::isfinite(x)) {
    *s = *c = (T)NAN;
    return;
  }
  const T r = x - (T)2 * std::nearbyint(x / (T)2);  // exact: r in [-1, 1]
  const long double t = (long double)r * 3.141592653589793238462643383279502884L;
  *s = (T)std::sin(t);
  *c = (T)std::cos(t);
}
inline void sincospif(float x, float* s, float* c) { sincospi_exact(x, s, c); }
inline void sincospi(double x, double* s, double* c) { sincospi_exact(x, s, c); }

inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::cos;
using std::fabs;
using std::fma;
using std::isfinite;
using std::nan;
using std::sin;
using std::sqrt;
