// Runs kernel K2 (csrc/chain.cu) on the CPU, thread by thread.
//
//   chain_harness TYPE DIR [DIR ...]
//
// One launch per DIR, in turn.  DIR/meta holds, as text, points nq n_joints
// n_out motion motion_offset n_dir has_v has_a jacobian, then the n_joints
// kinds and the n_joints output slots.  consts (n_joints x 24), q and, where
// present, v and a ((points, nq) each) are raw float64 in C order, converted
// to the instance's type.  The result goes to DIR/out (float64): (points,
// n_out) in the value mode (jacobian 0), (n_dir, points, n_out) in the
// Jacobian mode (jacobian 1).  TYPE is f (float32) or d (float64).  The
// kernel needs no barrier, so one host thread plays every CUDA thread in
// turn.  chain.cu is csrc/chain.cu, copied beside this file so that its
// include finds the stand-in here.

#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

thread_local Dim3 threadIdx, blockIdx;
pthread_barrier_t g_block_barrier, g_warp_barrier[kMaxEmulatedWarps];
double g_exchange[kMaxEmulatedWarps][32];

#define CHAIN_DEVICE_CODE_ONLY
#include "chain.cu"

namespace {

std::vector<double> read_doubles(const std::string& path, size_t n) {
  std::vector<double> out(n);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f || fread(out.data(), sizeof(double), n, f) != n) {
    fprintf(stderr, "cannot read %zu values from %s\n", n, path.c_str());
    exit(1);
  }
  fclose(f);
  return out;
}

template <typename T>
int run(const std::string& dir) {
  FILE* f = fopen((dir + "/meta").c_str(), "r");
  if (!f) {
    fprintf(stderr, "cannot open %s/meta\n", dir.c_str());
    return 1;
  }
  SweepArgs s{};
  int has_v = 0, has_a = 0, jacobian = 0;
  if (fscanf(f, "%lld %d %d %d %d %d %d %d %d %d", &s.points, &s.nq, &s.n_joints, &s.n_out,
             &s.motion, &s.motion_offset, &s.n_dir, &has_v, &has_a, &jacobian) != 10 ||
      s.n_joints > kMaxJoints) {
    fprintf(stderr, "bad meta\n");
    return 1;
  }
  for (int j = 0; j < s.n_joints; ++j)
    if (fscanf(f, "%d", &s.kind[j]) != 1) return 1;
  for (int j = 0; j < s.n_joints; ++j)
    if (fscanf(f, "%d", &s.slot[j]) != 1) return 1;
  fclose(f);

  const size_t rows = (size_t)s.points * s.nq;
  auto load = [&](const char* name, size_t n) {
    const auto raw = read_doubles(dir + "/" + name, n);
    return std::vector<T>(raw.begin(), raw.end());
  };
  const std::vector<T> consts = load("consts", (size_t)s.n_joints * kJointConsts);
  const std::vector<T> q = load("q", rows);
  const std::vector<T> v = has_v ? load("v", rows) : std::vector<T>();
  const std::vector<T> a = has_a ? load("a", rows) : std::vector<T>();
  const int n_dir = jacobian ? s.n_dir : 1;
  std::vector<T> out((size_t)n_dir * s.points * s.n_out, (T)NAN);
  s.consts = consts.data();
  s.q = q.data();
  s.v = has_v ? v.data() : nullptr;
  s.a = has_a ? a.data() : nullptr;
  s.sq = s.sv = s.sa = s.nq;
  s.out = out.data();

  const int blocks = (int)((s.points + kBlock - 1) / kBlock);
  for (int y = 0; y < n_dir; ++y)
    for (int b = 0; b < blocks; ++b)
      for (int t = 0; t < kBlock; ++t) {
        blockIdx = {b, y, 0};
        threadIdx = {t, 0, 0};
        if (jacobian)
          k2_chain_jacobian<T>(s);
        else
          k2_chain_value<T>(s);
      }

  const std::vector<double> raw(out.begin(), out.end());
  FILE* g = fopen((dir + "/out").c_str(), "wb");
  if (!g || fwrite(raw.data(), sizeof(double), raw.size(), g) != raw.size()) {
    fprintf(stderr, "cannot write %s/out\n", dir.c_str());
    return 1;
  }
  fclose(g);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s f|d DIR [DIR ...]\n", argv[0]);
    return 2;
  }
  const std::string type = argv[1];
  if (type != "f" && type != "d") {
    fprintf(stderr, "TYPE must be f or d\n");
    return 2;
  }
  for (int i = 2; i < argc; ++i) {
    const int err = type == "f" ? run<float>(argv[i]) : run<double>(argv[i]);
    if (err != 0) return err;
  }
  return 0;
}
