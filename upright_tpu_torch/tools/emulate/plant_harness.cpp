// Runs one instantiation of plant_kernel on the CPU, block by block.
//
//   plant_harness DIR TYPE
//
// DIR/meta holds, as text, batch n_steps n_sub n_obj n_slots s_max k_max
// stiction has_diverged, then gravity (3) k_contact c_contact v_slip max_force
// freeze dt_obj.  The float arrays (frames, slot_geom, obj_data, mass, inertia,
// mu, com_offset, r, q, v, w and, under stiction, anchors) are raw float64 in C
// order and are converted to the instance's type; slot_int and obj_int are raw
// int32, anchor_valid and diverged raw bytes.  The results are written as
// r_out, q_out, v_out, w_out, anchors_out (float64) and anchor_valid_out,
// diverged_out (bytes).  TYPE is f (float32) or d (float64).  plant.cu is
// csrc/plant.cu, copied beside this file so that its include finds the
// stand-in here.

#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

thread_local Dim3 threadIdx, blockIdx;
pthread_barrier_t g_block_barrier, g_warp_barrier[kMaxEmulatedWarps];
double g_exchange[kMaxEmulatedWarps][32];
namespace {
constexpr size_t kSmemBytes = 1 << 16;
alignas(16) unsigned char smem_raw[kSmemBytes];
}  // namespace

#define PLANT_DEVICE_CODE_ONLY
#include "plant.cu"

template <typename E>
std::vector<E> read_raw(const std::string& path, size_t n) {
  std::vector<E> out(n);
  FILE* f = fopen(path.c_str(), "rb");
  if (!f || fread(out.data(), sizeof(E), n, f) != n) {
    fprintf(stderr, "cannot read %zu values from %s\n", n, path.c_str());
    exit(1);
  }
  fclose(f);
  return out;
}

template <typename E>
void write_raw(const std::string& path, const std::vector<E>& v) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f || fwrite(v.data(), sizeof(E), v.size(), f) != v.size()) {
    fprintf(stderr, "cannot write %s\n", path.c_str());
    exit(1);
  }
  fclose(f);
}

template <typename T>
std::vector<T> read_floats(const std::string& path, size_t n) {
  const auto raw = read_raw<double>(path, n);
  return std::vector<T>(raw.begin(), raw.end());
}

template <typename T>
void write_floats(const std::string& path, const std::vector<T>& v) {
  write_raw(path, std::vector<double>(v.begin(), v.end()));
}

struct Thread {
  PlantArgs args;
  int block, thread;
};

template <typename T>
void* cuda_thread(void* p) {
  const auto* t = static_cast<const Thread*>(p);
  threadIdx = {t->thread, 0, 0};
  blockIdx = {t->block, 0, 0};
  plant_kernel<T>(t->args);
  return nullptr;
}

template <typename T>
int run(const std::string& dir) {
  PlantArgs a{};
  FILE* meta = fopen((dir + "/meta").c_str(), "r");
  if (!meta ||
      fscanf(meta, "%d %d %d %d %d %d %d %d %d", &a.batch, &a.n_steps, &a.n_sub, &a.n_obj,
             &a.n_slots, &a.s_max, &a.k_max, &a.stiction, &a.has_diverged) != 9 ||
      fscanf(meta, "%lf %lf %lf %lf %lf %lf %lf %lf %lf", &a.gravity[0], &a.gravity[1],
             &a.gravity[2], &a.k_contact, &a.c_contact, &a.v_slip, &a.max_force, &a.freeze,
             &a.dt_obj) != 9) {
    fprintf(stderr, "cannot read %s/meta\n", dir.c_str());
    return 2;
  }
  fclose(meta);
  const size_t B = a.batch, n = a.n_obj, S = a.n_slots;
  const size_t n_anchor = B * n * a.s_max * a.k_max;
  const auto frames = read_floats<T>(dir + "/frames", B * a.n_steps * kFrameDim);
  const auto slot_geom = read_floats<T>(dir + "/slot_geom", S * kSlotGeomDim);
  const auto obj_data = read_floats<T>(dir + "/obj_data", n * kObjDataDim);
  const auto slot_int = read_raw<int>(dir + "/slot_int", S * 4);
  const auto obj_int = read_raw<int>(dir + "/obj_int", n * 2);
  const auto mass = read_floats<T>(dir + "/mass", B * n);
  const auto inertia = read_floats<T>(dir + "/inertia", B * n * 9);
  const auto mu = read_floats<T>(dir + "/mu", B * n);
  const auto com_offset = read_floats<T>(dir + "/com_offset", B * n * 3);
  const auto r = read_floats<T>(dir + "/r", B * n * 3);
  const auto q = read_floats<T>(dir + "/q", B * n * 4);
  const auto v = read_floats<T>(dir + "/v", B * n * 3);
  const auto w = read_floats<T>(dir + "/w", B * n * 3);
  std::vector<T> anchors, r_out(B * n * 3), q_out(B * n * 4), v_out(B * n * 3), w_out(B * n * 3);
  std::vector<unsigned char> valid, diverged, valid_out, diverged_out;
  if (a.stiction) {
    anchors = read_floats<T>(dir + "/anchors", n_anchor * 2);
    valid = read_raw<unsigned char>(dir + "/anchor_valid", n_anchor);
  }
  std::vector<T> anchors_out = anchors;
  valid_out = valid;
  if (a.has_diverged) {
    diverged = read_raw<unsigned char>(dir + "/diverged", B * n);
    diverged_out.assign(B * n, 0);
  }
  a.frames = frames.data();
  a.slot_geom = slot_geom.data();
  a.slot_int = slot_int.data();
  a.obj_data = obj_data.data();
  a.obj_int = obj_int.data();
  a.mass = mass.data();
  a.inertia = inertia.data();
  a.mu = mu.data();
  a.com_offset = com_offset.data();
  a.r = r.data();
  a.q = q.data();
  a.v = v.data();
  a.w = w.data();
  a.anchors = anchors.data();
  a.anchor_valid = valid.data();
  a.diverged = diverged.data();
  a.r_out = r_out.data();
  a.q_out = q_out.data();
  a.v_out = v_out.data();
  a.w_out = w_out.data();
  a.anchors_out = anchors_out.data();
  a.anchor_valid_out = valid_out.data();
  a.diverged_out = diverged_out.data();

  const int threads = ((a.n_slots > a.n_obj ? a.n_slots : a.n_obj) + 31) / 32 * 32;
  if (threads > kMaxSlots || smem_bytes<T>(a.n_obj, a.n_slots) > (long long)kSmemBytes) {
    fprintf(stderr, "the shape exceeds what the kernel takes\n");
    return 3;
  }
  pthread_barrier_init(&g_block_barrier, nullptr, threads);
  for (int b = 0; b < a.batch; ++b) {
    // all-ones bytes are NaNs: shared memory read before it is written shows
    memset(smem_raw, 0xff, sizeof(smem_raw));
    std::vector<Thread> args(threads);
    std::vector<pthread_t> handles(threads);
    for (int t = 0; t < threads; ++t) {
      args[t] = {a, b, t};
      if (pthread_create(&handles[t], nullptr, cuda_thread<T>, &args[t]) != 0) {
        fprintf(stderr, "cannot start thread %d\n", t);
        exit(1);
      }
    }
    for (int t = 0; t < threads; ++t) pthread_join(handles[t], nullptr);
  }
  write_floats(dir + "/r_out", r_out);
  write_floats(dir + "/q_out", q_out);
  write_floats(dir + "/v_out", v_out);
  write_floats(dir + "/w_out", w_out);
  if (a.stiction) {
    write_floats(dir + "/anchors_out", anchors_out);
    write_raw(dir + "/anchor_valid_out", valid_out);
  }
  if (a.has_diverged) write_raw(dir + "/diverged_out", diverged_out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: plant_harness DIR TYPE\n");
    return 2;
  }
  const std::string dir = argv[1], type = argv[2];
  if (type == "f") return run<float>(dir);
  if (type == "d") return run<double>(dir);
  fprintf(stderr, "unknown type %s\n", type.c_str());
  return 2;
}
