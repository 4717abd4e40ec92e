// Stand-in for <cuda_runtime.h> that lets a C++ compiler build the device code
// of csrc/riccati.cu and csrc/plant.cu for the CPU: one pthread plays one CUDA
// thread, a pthread barrier per block plays __syncthreads, and a barrier per
// warp with an exchange buffer plays __shfl_sync.  Only what those kernels use
// is here.  See ../emulate_riccati.py and ../emulate_plant.py.

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

struct Dim3 {
  int x, y, z;
};
extern thread_local Dim3 threadIdx, blockIdx;

constexpr int kMaxEmulatedWarps = 32;
extern pthread_barrier_t g_block_barrier, g_warp_barrier[kMaxEmulatedWarps];
extern double g_exchange[kMaxEmulatedWarps][32];

inline void __syncthreads() { pthread_barrier_wait(&g_block_barrier); }

// every lane of the warp calls it (full mask), as the kernel does
template <typename T>
T __shfl_sync(unsigned, T v, int src_lane) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  g_exchange[warp][lane] = (double)v;
  pthread_barrier_wait(&g_warp_barrier[warp]);
  const T out = (T)g_exchange[warp][src_lane];
  pthread_barrier_wait(&g_warp_barrier[warp]);
  return out;
}

inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
using std::cos;
using std::fabs;
using std::fma;
using std::isfinite;
using std::nan;
using std::sin;
using std::sqrt;
