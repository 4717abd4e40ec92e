// Runs one instantiation of riccati_backward_kernel on the CPU, block by block.
//
//   harness DIR INSTANCE Bt N nx nu INVARIANT REG LATE_COPIES
//
// reads A, B, d, g, H, gf, Hf from DIR (raw float64, C order; A and B without
// the batch and stage axes when INVARIANT is 1), converts them to the
// instance's type, and writes K_out and kff_out (float64).  INSTANCE is f0 or d0
// (runtime-sized, float32 or float64: the register route up to nu 16, the wide
// route above, as the launcher picks) or f2713, d2713, f1810, d1810.  With
// LATE_COPIES 1 an asynchronous copy lands when its thread waits for it, with 0
// when it is started.  riccati.cu is csrc/riccati.cu, copied beside this file
// so that its includes find the stand-ins here.

#include <cuda_runtime.h>

#include "async_copy.cuh"

#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

thread_local Dim3 threadIdx, blockIdx;
pthread_barrier_t g_block_barrier, g_warp_barrier[kMaxEmulatedWarps];
double g_exchange[kMaxEmulatedWarps][32];
bool g_copies_land_late = false;
thread_local std::vector<PendingCopy> g_pending_copies;
namespace {
constexpr size_t kSmemBytes = 1 << 18;
alignas(16) unsigned char smem_raw[kSmemBytes];
}  // namespace

#define RICCATI_DEVICE_CODE_ONLY
#include "riccati.cu"

template <typename T>
std::vector<T> read_array(const std::string& path, size_t n) {
  std::vector<double> raw(n);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f || fread(raw.data(), sizeof(double), n, f) != n) {
    fprintf(stderr, "cannot read %zu values from %s\n", n, path.c_str());
    exit(1);
  }
  fclose(f);
  return std::vector<T>(raw.begin(), raw.end());
}

template <typename T>
void write_array(const std::string& path, const std::vector<T>& v) {
  const std::vector<double> raw(v.begin(), v.end());
  FILE* f = fopen(path.c_str(), "wb");
  if (!f || fwrite(raw.data(), sizeof(double), raw.size(), f) != raw.size()) {
    fprintf(stderr, "cannot write %s\n", path.c_str());
    exit(1);
  }
  fclose(f);
}

template <typename T>
struct Launch {
  const T *A, *B, *d, *g, *H, *gf, *Hf;
  T *K, *kff;
  int N, nx, nu;
  long long sA_b, sA_n, sB_b, sB_n;
  T reg;
  int block, thread;
};

template <typename T, int NX, int NU, bool WIDE>
void* cuda_thread(void* p) {
  const auto* a = static_cast<const Launch<T>*>(p);
  threadIdx = {a->thread, 0, 0};
  blockIdx = {a->block, 0, 0};
  if constexpr (WIDE)
    riccati_backward_wide<T>(a->A, a->B, a->d, a->g, a->H, a->gf, a->Hf, a->K, a->kff, a->N,
                             a->nx, a->nu, a->sA_b, a->sA_n, a->sB_b, a->sB_n, a->reg);
  else
    riccati_backward_kernel<T, NX, NU>(a->A, a->B, a->d, a->g, a->H, a->gf, a->Hf, a->K, a->kff,
                                       a->N, a->nx, a->nu, a->sA_b, a->sA_n, a->sB_b, a->sB_n,
                                       a->reg);
  return nullptr;
}

template <typename T, int NX, int NU>
int run(const std::string& dir, int Bt, int N, int nx, int nu, bool invariant, double reg) {
  if (NX > 0 && (NX != nx || NU != nu)) {
    fprintf(stderr, "instance is compiled for %d/%d, not %d/%d\n", NX, NU, nx, nu);
    return 2;
  }
  const size_t nz = nx + nu, stages = (size_t)Bt * N;
  const auto A = read_array<T>(dir + "/A", (invariant ? 1 : stages) * nx * nx);
  const auto B = read_array<T>(dir + "/B", (invariant ? 1 : stages) * nx * nu);
  const auto d = read_array<T>(dir + "/d", stages * nx);
  const auto g = read_array<T>(dir + "/g", stages * nz);
  const auto H = read_array<T>(dir + "/H", stages * nz * nz);
  const auto gf = read_array<T>(dir + "/gf", (size_t)Bt * nx);
  const auto Hf = read_array<T>(dir + "/Hf", (size_t)Bt * nx * nx);
  std::vector<T> K(stages * nu * nx), kff(stages * nu);
  const bool wide = NX == 0 && nu > kRegisterMaxNu;
  const long long elems = wide ? WideDims{nx, nu}.smem_elems() : Dims<NX, NU>{nx, nu}.smem_elems();
  if (elems * (long long)sizeof(T) > (long long)kSmemBytes) {
    fprintf(stderr, "shape needs more shared memory than the emulation holds\n");
    return 3;
  }
  static_assert(kWarps <= kMaxEmulatedWarps && kWideWarps <= kMaxEmulatedWarps,
                "raise kMaxEmulatedWarps");
  const int threads = wide ? kWideThreads : kThreads;
  pthread_barrier_init(&g_block_barrier, nullptr, threads);
  for (int w = 0; w < threads / 32; ++w) pthread_barrier_init(&g_warp_barrier[w], nullptr, 32);
  for (int b = 0; b < Bt; ++b) {
    // all-ones bytes are NaNs: padding that leaked into a result would show
    memset(smem_raw, 0xff, sizeof(smem_raw));
    std::vector<Launch<T>> args(threads);
    std::vector<pthread_t> tids(threads);
    for (int t = 0; t < threads; ++t) {
      args[t] = {A.data(), B.data(), d.data(), g.data(), H.data(), gf.data(), Hf.data(),
                 K.data(), kff.data(), N, nx, nu,
                 invariant ? 0 : (long long)N * nx * nx, invariant ? 0 : (long long)nx * nx,
                 invariant ? 0 : (long long)N * nx * nu, invariant ? 0 : (long long)nx * nu,
                 (T)reg, b, t};
      if (pthread_create(&tids[t], nullptr,
                         wide ? cuda_thread<T, NX, NU, true> : cuda_thread<T, NX, NU, false>,
                         &args[t]) != 0) {
        fprintf(stderr, "cannot start thread %d\n", t);
        exit(1);
      }
    }
    for (int t = 0; t < threads; ++t) pthread_join(tids[t], nullptr);
  }
  write_array(dir + "/K_out", K);
  write_array(dir + "/kff_out", kff);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 10) {
    fprintf(stderr, "usage: harness DIR INSTANCE Bt N nx nu INVARIANT REG LATE_COPIES\n");
    return 2;
  }
  const std::string dir = argv[1], inst = argv[2];
  const int Bt = atoi(argv[3]), N = atoi(argv[4]), nx = atoi(argv[5]), nu = atoi(argv[6]);
  const bool inv = atoi(argv[7]) != 0;
  const double reg = atof(argv[8]);
  g_copies_land_late = atoi(argv[9]) != 0;
  if (inst == "f0") return run<float, 0, 0>(dir, Bt, N, nx, nu, inv, reg);
  if (inst == "d0") return run<double, 0, 0>(dir, Bt, N, nx, nu, inv, reg);
  if (inst == "f2713") return run<float, 27, 13>(dir, Bt, N, nx, nu, inv, reg);
  if (inst == "d2713") return run<double, 27, 13>(dir, Bt, N, nx, nu, inv, reg);
  if (inst == "f1810") return run<float, 18, 10>(dir, Bt, N, nx, nu, inv, reg);
  if (inst == "d1810") return run<double, 18, 10>(dir, Bt, N, nx, nu, inv, reg);
  fprintf(stderr, "unknown instance %s\n", inst.c_str());
  return 2;
}
