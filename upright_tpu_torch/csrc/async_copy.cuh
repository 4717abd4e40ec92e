// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later).  A thread starts any number of copies and goes on
// computing; cp_async_wait_all() returns once all of its own copies have
// landed, and a block-wide barrier after it makes every thread's copies
// visible to the block.  And a prefetch of device memory into L2.

#pragma once

#include <stdint.h>

// One copy of BYTES (4, 8 or 16); both addresses are BYTES-aligned.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem_src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Asks the L2 cache for the 128-byte line that holds `gmem`; no register
// waits for it.
__device__ __forceinline__ void prefetch_l2(const void* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(gmem));
}
