// Stand-in for csrc/async_copy.cuh on the CPU.  On the card a copy lands at
// some time between its start and its thread's cp_async_wait_all(); here it
// lands at one end of that span: at once or, with g_copies_land_late, at the
// wait.  A kernel that reads a buffer before waiting, or refills one that is
// still being read, goes wrong in one of the two.

#pragma once

#include <cstring>
#include <vector>

struct PendingCopy {
  void* dst;
  const void* src;
  int bytes;
};
extern bool g_copies_land_late;
extern thread_local std::vector<PendingCopy> g_pending_copies;

template <int BYTES>
inline void cp_async(void* smem_dst, const void* gmem_src) {
  if (g_copies_land_late) g_pending_copies.push_back({smem_dst, gmem_src, BYTES});
  else memcpy(smem_dst, gmem_src, BYTES);
}

inline void cp_async_wait_all() {
  for (const PendingCopy& c : g_pending_copies) memcpy(c.dst, c.src, c.bytes);
  g_pending_copies.clear();
}

// An L2 prefetch changes no value: nothing to do on the CPU.
inline void prefetch_l2(const void*) {}
