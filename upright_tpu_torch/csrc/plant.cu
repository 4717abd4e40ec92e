// The plant's contact substeps for Hopper (sm_90a): kernel P1.
//
// Advances the balanced objects of B instances through every inner substep of
// one UprightSimulation.step (upright_tpu_torch/sim/contact.py): n_steps outer
// steps of the robot, each cut into n_sub object substeps, over which the tray
// frame is propagated from the outer step's EE motion.  It replaces
// upright_tpu/sim/simulation.py, _step_impl's object branch (:324-376) and
// _object_substep (:390).  That loop has no Pallas kernel: the JAX package runs
// it as a lax.scan that XLA fuses.  Eager PyTorch would launch about a thousand
// tensor operations per substep, 400 substeps per 100 Hz control tick, so the
// port writes the loop as one kernel.
//
// Per substep, for every contact slot (one object's vertex against one of its
// support surfaces): penetration and tangent coordinates in the parent's
// frame, a spring-damper normal force with the reference's prefiltered
// damping, friction (stiction: an anchor spring clamped to the cone, the
// anchor dragged; or regularized Coulomb), the force's torque about the
// object and, on a supporting object, the reaction.  Per object: the sum, the
// semi-implicit Euler step with the world-frame inertia solve, the quaternion
// update, and the divergence freeze with its latch.
//
// What bounds it on this card.  Not bytes and not operations: one tick of
// thing_demo moves a few kilobytes and does about 2 MFLOP per instance.  It is
// the dependent chain: n_steps * n_sub substeps in sequence, and inside each
// the path from the objects' state through the slot forces and their sum to
// the new state.  One warp per instance runs that chain with nothing to hide
// its latency, at batch 1 and, since 512 one-warp blocks give each scheduler
// of the 132 SMs about one warp, at batch 512 too.  So the design shortens the
// chain and moves what does not depend on the state off it:
//   - One block per instance, one thread per slot, padded to whole warps.  A
//     block of one warp (at most 32 slots: thing_demo, box_arch, foam_die2)
//     synchronises with __syncwarp; a larger one (blue_cups, the fixture box)
//     with __syncthreads.  Two instantiations per type and friction model.
//   - The n_sub tray frames of an outer step (R, p, v, w) are formed at its
//     start by the block's lanes together into shared memory, not by every
//     lane at every substep.  A slot on the tray reads its parent's pose from
//     the frame row, a slot on an object from that object's state row: the two
//     rows have one layout, so the choice is a pointer and not a branch.
//   - Each object's rotation matrix is kept in shared memory beside its
//     quaternion; the integrating lane writes it with the new state, so no
//     slot converts a quaternion.
//   - What does not change in a launch is computed once: 1/m, m g, the
//     inverse local inertia (the world solve is then R I^-1 R^T applied in the
//     body frame, no division),
//     each slot's prefiltered damping c_v and its dt n_eff w_v (|R vc| = |vc|
//     for a rigid body), each object's capped gains.
//   - The slot phase has no branch that diverges: padded lanes repeat a real
//     slot, and every lane also forms the inputs of its object's integration
//     that depend only on the state before the substep (the gyroscopic term,
//     the freeze test).
//   - The sums run across lanes: a segmented suffix scan with warp shuffles
//     over each piece (a run of slots of one object and surface within one
//     warp), whose first lane writes the piece's force and torque to the
//     object's rows in shared memory and, for a piece resting on an object,
//     the reaction to that object's rows.  The rows of an object are one
//     contiguous range (contact.py builds them with the tables), so its
//     integrating lane adds a few rows and scans no slots.
//   - Each object's integration runs on one lane; the others compute the same
//     or a neighbouring object's and discard it.  Sines and cosines go through
//     sincospi, whose exact reduction leaves no slow path and no stack frame.
// The sums, the solve and the reciprocals change the order of rounding only:
// float64 agrees with the plain version to 1e-10.  Division and square roots
// stay IEEE (no fast math), and _build.py compiles this file with
// -fmad=false: every product and sum is rounded on its own, as the plain
// version rounds it, because a stiff contact amplifies what a fused
// multiply-add changes until float32 blue_cups leaves the limits it is held to
// (tools/plant_data.py F32_TOL).  Clamps propagate NaN as the reference's
// minimum / maximum do, so a non-finite state trips the divergence latch as
// it does there; the substep offsets tau * dt_obj and 0.5 * (tau * dt_obj)^2
// are rounded to float32, as the reference's scan computes them.

#include <cuda_runtime.h>

// Cycle marks for tools/plant_phases.py.  Built with -DPLANT_PHASE_CLOCK,
// thread 0 of a one-block launch reads the SM's clock between the phases of
// every substep, adds the differences up per phase and prints the totals;
// otherwise the marks are empty.
#ifdef PLANT_PHASE_CLOCK
#include <stdio.h>
#define PHASE_CLOCK_BEGIN()                                                     \
  const bool phase_clock = gridDim.x == 1 && threadIdx.x == 0;                  \
  long long phase_sum[5] = {0, 0, 0, 0, 0};                                     \
  const long long phase_start = clock64();                                      \
  long long phase_t = phase_start
#define PHASE_MARK(i)                                                           \
  if (phase_clock) {                                                            \
    const long long phase_now = clock64();                                      \
    phase_sum[i] += phase_now - phase_t;                                        \
    phase_t = phase_now;                                                        \
  }
#define PHASE_CLOCK_END(substeps)                                               \
  if (phase_clock)                                                              \
  printf("PHASES frames %lld slots %lld reduction %lld integration %lld "       \
         "barriers %lld total %lld substeps %d\n",                              \
         phase_sum[0], phase_sum[1], phase_sum[2], phase_sum[3], phase_sum[4],  \
         clock64() - phase_start, (int)(substeps))
#else
#define PHASE_CLOCK_BEGIN()
#define PHASE_MARK(i)
#define PHASE_CLOCK_END(substeps)
#endif
// The layout sim/contact.py's _PlantArgs mirrors.
struct PlantArgs {
  const void* frames;     // (B, n_steps, 24): R (9, row-major), p, v, w, a, al of the EE
  const void* slot_geom;  // (n_slots, 18): point 3, normal 3, tangents 2 x 3, half extents 2,
                          //   max depth, vertex 3 (all in the parent's / object's frame)
  const int* slot_int;    // (n_slots, 4): object, parent (-1 = EE), surface, vertex
  const void* obj_data;   // (n_obj, 5): n_eff, L2, nominal CoM in the EE frame 3
  const int* obj_int;     // (n_obj, 2): first slot, slot count (not read: the pieces below)
  const void* mass;       // (B, n_obj)
  const void* inertia;    // (B, n_obj, 3, 3), local frame
  const void* mu;         // (B, n_obj)
  const void* com_offset; // (B, n_obj, 3)
  const void *r, *q, *v, *w;           // (B, n_obj, 3 / 4 / 3 / 3)
  const void* anchors;                 // (B, n_obj, s_max, k_max, 2), stiction only
  const unsigned char* anchor_valid;   // (B, n_obj, s_max, k_max), stiction only
  const unsigned char* diverged;       // (B, n_obj), when has_diverged
  void *r_out, *q_out, *v_out, *w_out, *anchors_out;
  unsigned char *anchor_valid_out, *diverged_out;
  double gravity[3];
  double k_contact, c_contact, v_slip, max_force, freeze, dt_obj;
  int batch, n_steps, n_sub, n_obj, n_slots, s_max, k_max, stiction, has_diverged;
  // the pieces (see above), built with the tables
  const int* slot_piece;  // (n_slots, 3): last slot of the slot's piece; for the first slot of
                          //   a piece its own row and its reaction row (-1: none), else -1, -1
  const int* obj_rows;    // (n_obj, 2): first row, row count
  int n_rows, max_piece, has_reactions;
};

namespace {

constexpr int kMaxSlots = 256;
constexpr int kMaxObjects = 32;
constexpr int kWarp = 32;
constexpr int kFrameDim = 24;
constexpr int kSlotGeomDim = 18;
constexpr int kObjDataDim = 5;

// A pose-and-twist row in shared memory, the same for a substep's tray frame
// and for an object's state: R (9, row-major), position, velocity, angular
// velocity; an object's row goes on with its quaternion.
enum Row { kRot = 0, kPos = 9, kVel = 12, kAng = 15, kQuat = 18, kRowStride = 24 };
// per-object constants in shared memory
enum ObjConst {
  kInvMass = 0, kWeight = 1, kInertia = 4, kInvInertia = 13, kComNom = 22, kCapK = 25,
  kCapC = 26, kMu = 27, kIMin = 28, kNeff = 29, kConstStride = 30
};
constexpr int kRowSum = 6;  // force 3, torque 3

enum Phase { kFrames = 0, kSlots = 1, kReduction = 2, kIntegration = 3, kBarriers = 4 };

// minimum / maximum that return x when it is NaN, as jnp.minimum / maximum do
template <typename T>
__device__ __forceinline__ T at_least(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T at_most(T x, T hi) { return x > hi ? hi : x; }

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ void matvec3(const T* R, const T* a, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * a[0] + R[3 * i + 1] * a[1] + R[3 * i + 2] * a[2];
}

// R^T a
template <typename T>
__device__ __forceinline__ void matTvec3(const T* R, const T* a, T* out) {
  for (int i = 0; i < 3; ++i) out[i] = R[i] * a[0] + R[3 + i] * a[1] + R[6 + i] * a[2];
}

// sin(pi x) and cos(pi x): the reduction by whole multiples of pi is exact,
// so there is no slow path for large arguments (and no stack frame)
__device__ __forceinline__ void sincos_pi(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sincos_pi(double x, double* s, double* c) { sincospi(x, s, c); }

// Rotation matrix of the unit quaternion [x, y, z, w]
template <typename T>
__device__ __forceinline__ void unit_quat_to_rot(T x, T y, T z, T w, T* R) {
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = T(1) - T(2) * (yy + zz); R[1] = T(2) * (xy - wz);         R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);         R[4] = T(1) - T(2) * (xx + zz); R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);         R[7] = T(2) * (yz + wx);         R[8] = T(1) - T(2) * (xx + yy);
}

// The EE frame at substep tau of an outer step whose start is f0 (24 words):
// R = exp([w0 dto]x) R0 (Rodrigues), p = p0 + dto v0 + h a0, v = v0 + dto a0,
// w = w0 + dto al0, with dto = tau dt_obj and h = 0.5 dto^2 rounded to float32
// as the reference's scan rounds them.  Written as a row (R, p, v, w).
template <typename T>
__device__ __forceinline__ void substep_frame(const T* f0, int tau, double dt_obj, T* row) {
  const float d32 = (float)tau * (float)dt_obj;
  const float h32 = (0.5f * d32) * d32;
  const T dto = (T)d32, h = (T)h32;
  const T w0[3] = {f0[15], f0[16], f0[17]};
  const T nw = sqrt(dot3(w0, w0));
  const T th = nw * dto;
  const T nw_safe = at_least(nw, T(1e-12));
  const T ax = w0[0] / nw_safe, ay = w0[1] / nw_safe, az = w0[2] / nw_safe;
  T s, c;
  sincos_pi(th * T(0.318309886183790671537767526745028724), &s, &c);
  const T c1 = T(1) - c;
  // K = [a]x, dR = I + s K + (1 - cos) K K, with K K = a a^T - (a . a) I
  const T dR[9] = {
      T(1) + c1 * -(az * az + ay * ay), -s * az + c1 * ax * ay, s * ay + c1 * ax * az,
      s * az + c1 * ay * ax, T(1) + c1 * -(az * az + ax * ax), -s * ax + c1 * ay * az,
      -s * ay + c1 * az * ax, s * ax + c1 * az * ay, T(1) + c1 * -(ay * ay + ax * ax)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      row[kRot + 3 * i + j] =
          dR[3 * i] * f0[j] + dR[3 * i + 1] * f0[3 + j] + dR[3 * i + 2] * f0[6 + j];
  for (int i = 0; i < 3; ++i) {
    row[kPos + i] = f0[9 + i] + dto * f0[12 + i] + h * f0[18 + i];
    row[kVel + i] = f0[12 + i] + dto * f0[18 + i];
    row[kAng + i] = w0[i] + dto * f0[21 + i];
  }
}

template <bool kOneWarp>
__device__ __forceinline__ void block_sync() {
  if (kOneWarp) __syncwarp();
  else __syncthreads();
}

// Elements of dynamic shared memory of one block (see the kernel)
__host__ __device__ inline long long smem_elems(int n_obj, int n_sub, int n_rows) {
  return (long long)n_obj * (kRowStride + kConstStride) + (long long)n_sub * kRowStride +
         (long long)n_rows * kRowSum;
}

// Sized for one block per SM: ptxas may then take up to 255 registers a
// thread, and spills nothing in any instance.
template <typename T, bool kOneWarp, bool kStiction>
__global__ void __launch_bounds__(kOneWarp ? kWarp : kMaxSlots, 1)
    plant_kernel(const PlantArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int n_obj = a.n_obj, n_slots = a.n_slots;
  const int n_threads = (n_slots + kWarp - 1) / kWarp * kWarp;  // as plant_advance launches
  T* so = reinterpret_cast<T*>(smem_raw);  // n_obj x kRowStride: the objects' state
  T* oc = so + n_obj * kRowStride;         // n_obj x kConstStride: per-object constants
  T* sf = oc + n_obj * kConstStride;       // n_sub x kRowStride: the outer step's frames
  T* sr = sf + a.n_sub * kRowStride;       // n_rows x kRowSum: the pieces' sums
  const T dt = (T)a.dt_obj;
  PHASE_CLOCK_BEGIN();

  // -- load: objects (state, parameters, capped gains, inverse inertia) -------
  if (tid < n_obj) {
    const int i = tid, bi = b * n_obj + i;
    T* o = so + i * kRowStride;
    T* k = oc + i * kConstStride;
    T q[4];
    for (int c = 0; c < 4; ++c) q[c] = ((const T*)a.q)[4 * bi + c];
    for (int c = 0; c < 3; ++c) {
      o[kPos + c] = ((const T*)a.r)[3 * bi + c];
      o[kVel + c] = ((const T*)a.v)[3 * bi + c];
      o[kAng + c] = ((const T*)a.w)[3 * bi + c];
      k[kComNom + c] = ((const T*)a.obj_data)[kObjDataDim * i + 2 + c];
    }
    for (int c = 0; c < 4; ++c) o[kQuat + c] = q[c];
    const T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    unit_quat_to_rot(q[0] / n, q[1] / n, q[2] / n, q[3] / n, o + kRot);
    const T* Il = (const T*)a.inertia + 9 * bi;
    for (int c = 0; c < 9; ++c) k[kInertia + c] = Il[c];
    // I^-1 = adj(I) / det(I)
    const T adj[9] = {Il[4] * Il[8] - Il[5] * Il[7], Il[2] * Il[7] - Il[1] * Il[8],
                      Il[1] * Il[5] - Il[2] * Il[4], Il[5] * Il[6] - Il[3] * Il[8],
                      Il[0] * Il[8] - Il[2] * Il[6], Il[2] * Il[3] - Il[0] * Il[5],
                      Il[3] * Il[7] - Il[4] * Il[6], Il[1] * Il[6] - Il[0] * Il[7],
                      Il[0] * Il[4] - Il[1] * Il[3]};
    const T inv_det = T(1) / (Il[0] * adj[0] + Il[1] * adj[3] + Il[2] * adj[6]);
    for (int c = 0; c < 9; ++c) k[kInvInertia + c] = adj[c] * inv_det;
    const T m = ((const T*)a.mass)[bi];
    k[kInvMass] = T(1) / m;
    for (int c = 0; c < 3; ++c) k[kWeight + c] = m * (T)a.gravity[c];
    k[kMu] = ((const T*)a.mu)[bi];
    k[kNeff] = ((const T*)a.obj_data)[kObjDataDim * i];
    const T L2 = ((const T*)a.obj_data)[kObjDataDim * i + 1];
    T i_min = at_least(at_most(at_most(Il[0], Il[4]), Il[8]), T(1e-12));
    const T m_eff = T(1) / (T(1) / m + L2 / i_min);
    const double omega_max = 0.3 / a.dt_obj;
    const T kc = at_most(m_eff * (T)(omega_max * omega_max), (T)a.k_contact);
    k[kCapK] = kc;
    k[kCapC] = at_most(at_most(T(2) * sqrt(kc * m), (T)a.c_contact), T(0.3) * m_eff / dt);
    k[kIMin] = i_min;
  }
  bool div = false;
  if (tid < n_obj && a.has_diverged) div = a.diverged[b * n_obj + tid] != 0;
  block_sync<kOneWarp>();

  // -- load: this lane's slot (a padded lane repeats the last slot) -----------
  const int s = tid < n_slots ? tid : n_slots - 1;
  T geom[kSlotGeomDim];
  for (int c = 0; c < kSlotGeomDim; ++c) geom[c] = ((const T*)a.slot_geom)[kSlotGeomDim * s + c];
  const int obj = a.slot_int[4 * s], parent = a.slot_int[4 * s + 1];
  const int piece_end = tid < n_slots ? a.slot_piece[3 * s] : tid;
  const int own_row = tid < n_slots ? a.slot_piece[3 * s + 1] : -1;
  const int reaction_row = tid < n_slots ? a.slot_piece[3 * s + 2] : -1;
  {
    // the vertex about the CoM, in the object's frame
    const T* off = (const T*)a.com_offset + 3 * (b * n_obj + obj);
    for (int c = 0; c < 3; ++c) geom[15 + c] -= off[c];
  }
  const T* ko = oc + obj * kConstStride;
  const T cap_k = ko[kCapK], mu = ko[kMu];
  // prefilter(g) = g / (1 + dt g n_eff w_v): the damping impulse can at most
  // cancel the relative velocity; w_v = 1/m + |lever|^2 / i_min, and |lever| =
  // |R vc| = |vc| for the whole launch
  const T w_v = ko[kInvMass] + dot3(geom + 15, geom + 15) / ko[kIMin];
  const T c_v = ko[kCapC] / (T(1) + dt * ko[kCapC] * ko[kNeff] * w_v);
  const T dt_neff_wv = dt * ko[kNeff] * w_v;
  long long anchor_at = 0;
  T anc[2] = {T(0), T(0)};
  bool valid = false;
  if (kStiction && tid < n_slots) {
    anchor_at = (((long long)b * n_obj + obj) * a.s_max + a.slot_int[4 * s + 2]) * a.k_max +
                a.slot_int[4 * s + 3];
    anc[0] = ((const T*)a.anchors)[2 * anchor_at];
    anc[1] = ((const T*)a.anchors)[2 * anchor_at + 1];
    valid = a.anchor_valid[anchor_at] != 0;
  }
  // the object this lane integrates (lanes past the last object repeat it)
  const int io = tid < n_obj ? tid : n_obj - 1;
  const int row_first = a.obj_rows[2 * io], row_count = a.obj_rows[2 * io + 1];
  const T max_force = (T)a.max_force, freeze = (T)a.freeze;
  const bool reactions = a.has_reactions != 0;

  for (int step = 0; step < a.n_steps; ++step) {
    // -- the outer step's frames, one per substep, formed together ----------
    const T* f0 = (const T*)a.frames + ((long long)b * a.n_steps + step) * kFrameDim;
    for (int tau = tid; tau < a.n_sub; tau += n_threads)
      substep_frame(f0, tau, a.dt_obj, sf + tau * kRowStride);
    block_sync<kOneWarp>();
    PHASE_MARK(kFrames);

    for (int tau = 0; tau < a.n_sub; ++tau) {
      const T* fr = sf + tau * kRowStride;
      // -- the input of this lane's integration that the state before the
      //    substep fixes: the gyroscopic term in the body frame, w_b x I w_b
      //    with w_b = R^T w, first in the source so that it fills the slot
      //    chain's waits (the slow paths of the IEEE square roots and
      //    divisions below cut the code into regions that the compiler does
      //    not schedule across) -------------------------------------------
      const T* o = so + io * kRowStride;
      const T* ki = oc + io * kConstStride;
      T gyro_b[3];
      {
        T w_b[3], Iw_b[3];
        matTvec3(o + kRot, o + kAng, w_b);
        matvec3(ki + kInertia, w_b, Iw_b);
        cross3(w_b, Iw_b, gyro_b);
      }
      // -- the slot phase: every lane --------------------------------------------
      const T* oi = so + obj * kRowStride;
      const T* op = parent < 0 ? fr : so + parent * kRowStride;  // the parent's pose
      T n_w[3], p_surf[3], t1[3], t2[3], tmp[3], p_w[3];
      matvec3(op + kRot, geom + 3, n_w);
      matvec3(op + kRot, geom + 0, tmp);
      for (int c = 0; c < 3; ++c) p_surf[c] = op[kPos + c] + tmp[c];
      matvec3(op + kRot, geom + 6, t1);
      matvec3(op + kRot, geom + 9, t2);
      matvec3(oi + kRot, geom + 15, tmp);
      T rel[3], lever[3], arm_p[3];
      for (int c = 0; c < 3; ++c) {
        p_w[c] = oi[kPos + c] + tmp[c];
        rel[c] = p_w[c] - p_surf[c];
        lever[c] = p_w[c] - oi[kPos + c];
        arm_p[c] = p_w[c] - op[kPos + c];
      }
      const T delta = -dot3(rel, n_w);
      const T tc0 = dot3(rel, t1), tc1 = dot3(rel, t2);
      const bool inside = fabs(tc0) <= geom[12] + T(1e-3) && fabs(tc1) <= geom[13] + T(1e-3);
      const bool in_contact = delta > T(0) && delta <= geom[14] && inside;

      T wl[3], wpl[3], v_rel[3], v_t[3];
      cross3(oi + kAng, lever, wl);
      cross3(op + kAng, arm_p, wpl);
      for (int c = 0; c < 3; ++c) v_rel[c] = oi[kVel + c] + wl[c] - (op[kVel + c] + wpl[c]);
      const T v_n = dot3(v_rel, n_w);
      for (int c = 0; c < 3; ++c) v_t[c] = v_rel[c] - v_n * n_w[c];
      T f_n = at_most(at_least(cap_k * delta - c_v * v_n, T(0)), max_force);
      if (!in_contact) f_n = T(0);

      T f_c[3];
      if (kStiction) {
        const bool stuck = valid && in_contact;
        const T d0 = tc0 - (stuck ? anc[0] : tc0), d1 = tc1 - (stuck ? anc[1] : tc1);
        T F_t[3];
        for (int c = 0; c < 3; ++c) F_t[c] = -(d0 * t1[c] + d1 * t2[c]) * cap_k - c_v * v_t[c];
        const T F_mag = sqrt(dot3(F_t, F_t));
        const T scale = at_most(mu * f_n / at_least(F_mag, T(1e-12)), T(1));
        for (int c = 0; c < 3; ++c) f_c[c] = f_n * n_w[c] + (in_contact ? F_t[c] * scale : T(0));
        const T d_norm = sqrt(d0 * d0 + d1 * d1);
        const T d_max = at_least(mu * at_least(delta, T(0)), T(1e-4));
        const T shrink = at_most(d_max / at_least(d_norm, T(1e-12)), T(1));
        anc[0] = in_contact ? tc0 - d0 * shrink : tc0;
        anc[1] = in_contact ? tc1 - d1 * shrink : tc1;
        valid = in_contact;
      } else {
        const T v_t_norm = sqrt(dot3(v_t, v_t)) + (T)a.v_slip;
        const T g = mu * f_n / v_t_norm;
        const T gain = g / (T(1) + g * dt_neff_wv);
        for (int c = 0; c < 3; ++c) f_c[c] = f_n * n_w[c] - gain * v_t[c];
      }
      // force, torque about the object, torque of the reaction about the parent
      T x[9];
      for (int c = 0; c < 3; ++c) x[c] = f_c[c];
      cross3(lever, f_c, x + 3);
      {
        const T neg[3] = {-f_c[0], -f_c[1], -f_c[2]};
        cross3(arm_p, neg, x + 6);
      }

      bool far = false;  // the freeze test, from the state before this substep
      if (freeze > T(0)) {
        // displacement in the EE frame
        T d[3], r_oe[3], e[3];
        for (int c = 0; c < 3; ++c) d[c] = o[kPos + c] - fr[kPos + c];
        matTvec3(fr + kRot, d, r_oe);
        for (int c = 0; c < 3; ++c) e[c] = r_oe[c] - ki[kComNom + c];
        far = sqrt(dot3(e, e)) > freeze;
      }
      PHASE_MARK(kSlots);

      // -- the sums: a segmented suffix scan over each piece -----------------
      for (int off = 1; off < a.max_piece; off <<= 1) {
        const bool add = tid + off <= piece_end;
        for (int c = 0; c < 6; ++c) {
          const T y = __shfl_down_sync(0xffffffffu, x[c], off);
          x[c] += add ? y : T(0);
        }
        if (reactions)
          for (int c = 6; c < 9; ++c) {
            const T y = __shfl_down_sync(0xffffffffu, x[c], off);
            x[c] += add ? y : T(0);
          }
      }
      if (own_row >= 0)
        for (int c = 0; c < kRowSum; ++c) sr[own_row * kRowSum + c] = x[c];
      if (reaction_row >= 0) {
        T* rr = sr + reaction_row * kRowSum;
        for (int c = 0; c < 3; ++c) {
          rr[c] = -x[c];
          rr[3 + c] = x[6 + c];
        }
      }
      PHASE_MARK(kReduction);
      block_sync<kOneWarp>();
      PHASE_MARK(kBarriers);

      // -- the integration: object io on this lane ----------------------------
      T F[3], Tq[3];
      for (int c = 0; c < 3; ++c) {
        F[c] = ki[kWeight + c];
        Tq[c] = T(0);
      }
      for (int j = row_first; j < row_first + row_count; ++j)
        for (int c = 0; c < 3; ++c) {
          F[c] += sr[j * kRowSum + c];
          Tq[c] += sr[j * kRowSum + 3 + c];
        }
      // the world solve (R I R^T) w_dot = T - w x (R I R^T w), in the body
      // frame: w_dot = R I^-1 (R^T T - w_b x I w_b)
      T r_new[3], v_new[3], w_new[3], q_new[4], rhs[3], a_b[3], w_dot[3];
      for (int c = 0; c < 3; ++c) v_new[c] = o[kVel + c] + dt * (F[c] * ki[kInvMass]);
      matTvec3(o + kRot, Tq, rhs);
      for (int c = 0; c < 3; ++c) rhs[c] -= gyro_b[c];
      matvec3(ki + kInvInertia, rhs, a_b);
      matvec3(o + kRot, a_b, w_dot);
      for (int c = 0; c < 3; ++c) {
        w_new[c] = o[kAng + c] + dt * w_dot[c];
        r_new[c] = o[kPos + c] + dt * v_new[c];
      }
      {  // q_new = exp(dt w_new / 2) q, normalised
        const T nw = sqrt(dot3(w_new, w_new));
        const T half = T(0.5) * (nw * dt);
        const T inv = T(1) / at_least(nw, T(1e-12));
        T sh, ch;
        sincos_pi(half * T(0.318309886183790671537767526745028724), &sh, &ch);
        const T x0 = w_new[0] * inv * sh, y0 = w_new[1] * inv * sh, z0 = w_new[2] * inv * sh;
        const T x1 = o[kQuat], y1 = o[kQuat + 1], z1 = o[kQuat + 2], w1 = o[kQuat + 3];
        q_new[0] = ch * x1 + x0 * w1 + y0 * z1 - z0 * y1;
        q_new[1] = ch * y1 - x0 * z1 + y0 * w1 + z0 * x1;
        q_new[2] = ch * z1 + x0 * y1 - y0 * x1 + z0 * w1;
        q_new[3] = ch * w1 - x0 * x1 - y0 * y1 - z0 * z1;
        const T n = sqrt(q_new[0] * q_new[0] + q_new[1] * q_new[1] + q_new[2] * q_new[2] +
                         q_new[3] * q_new[3]);
        const T inv_n = T(1) / n;
        for (int c = 0; c < 4; ++c) q_new[c] *= inv_n;
      }
      bool hold = false;
      if (freeze > T(0)) {
        bool finite = true;  // & and not &&: no branches
        for (int c = 0; c < 3; ++c)
          finite = finite & isfinite(r_new[c]) & isfinite(v_new[c]) & isfinite(w_new[c]);
        for (int c = 0; c < 4; ++c) finite = finite & isfinite(q_new[c]);
        div = div || !finite;
        hold = far || !finite;
      }
      T R_new[9];
      unit_quat_to_rot(q_new[0], q_new[1], q_new[2], q_new[3], R_new);
      if (tid < n_obj) {
        T* ow = so + io * kRowStride;
        for (int c = 0; c < 3; ++c) {
          ow[kVel + c] = hold ? T(0) : v_new[c];
          ow[kAng + c] = hold ? T(0) : w_new[c];
        }
        if (!hold) {
          for (int c = 0; c < 3; ++c) ow[kPos + c] = r_new[c];
          for (int c = 0; c < 4; ++c) ow[kQuat + c] = q_new[c];
          for (int c = 0; c < 9; ++c) ow[kRot + c] = R_new[c];
        }
      }
      PHASE_MARK(kIntegration);
      block_sync<kOneWarp>();
      PHASE_MARK(kBarriers);
    }
  }
  PHASE_CLOCK_END(a.n_steps * a.n_sub);

  // -- store -------------------------------------------------------------------
  if (tid < n_obj) {
    const int bi = b * n_obj + tid;
    const T* o = so + tid * kRowStride;
    for (int c = 0; c < 3; ++c) {
      ((T*)a.r_out)[3 * bi + c] = o[kPos + c];
      ((T*)a.v_out)[3 * bi + c] = o[kVel + c];
      ((T*)a.w_out)[3 * bi + c] = o[kAng + c];
    }
    for (int c = 0; c < 4; ++c) ((T*)a.q_out)[4 * bi + c] = o[kQuat + c];
    if (a.has_diverged) a.diverged_out[bi] = div ? 1 : 0;
  }
  if (kStiction && tid < n_slots) {
    ((T*)a.anchors_out)[2 * anchor_at] = anc[0];
    ((T*)a.anchors_out)[2 * anchor_at + 1] = anc[1];
    a.anchor_valid_out[anchor_at] = valid ? 1 : 0;
  }
}

}  // namespace

// Host side: the launcher and the C interface.  PLANT_DEVICE_CODE_ONLY leaves
// it out, for tools/emulate_plant.py, which builds the device code above with
// a C++ compiler.
#ifndef PLANT_DEVICE_CODE_ONLY

namespace {

using KernelFn = void (*)(const PlantArgs);

// Instance `which`: bit 0 float64, bit 1 the block-wide route, bit 2 the
// regularized friction model (0: float32, one warp, stiction: the main path).
KernelFn instance(int which) {
  switch (which) {
    case 0: return plant_kernel<float, true, true>;
    case 1: return plant_kernel<double, true, true>;
    case 2: return plant_kernel<float, false, true>;
    case 3: return plant_kernel<double, false, true>;
    case 4: return plant_kernel<float, true, false>;
    case 5: return plant_kernel<double, true, false>;
    case 6: return plant_kernel<float, false, false>;
    case 7: return plant_kernel<double, false, false>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Registers per thread, bytes of local memory per thread and bytes of static
// shared memory of instance `which` (see instance()), into out[0..2].
// Returns the CUDA error, or -1 for an unknown instance.
int plant_instance_attrs(int which, int* out) {
  const KernelFn fn = instance(which);
  if (!fn) return -1;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return 0;
}

// Bytes of dynamic shared memory one block takes.
long long plant_smem_bytes(int n_obj, int n_sub, int n_rows, int elem_bytes) {
  return smem_elems(n_obj, n_sub, n_rows) * elem_bytes;
}

// Launches on `stream` and does not synchronise.  elem_bytes 4 (float32) or 8
// (float64) for every float array.  Returns the CUDA error code of the launch
// (0 = success), or -1 for arguments the kernel does not take.
int plant_advance(const PlantArgs* args, int elem_bytes, void* stream) {
  const PlantArgs& a = *args;
  if (a.batch <= 0 || a.n_steps < 0 || a.n_sub <= 0) return -1;
  if (a.n_obj < 1 || a.n_obj > kMaxObjects || a.n_slots < a.n_obj || a.n_slots > kMaxSlots)
    return -1;
  if (!a.slot_piece || !a.obj_rows || a.n_rows < 0 || a.max_piece < 1 || a.max_piece > kWarp)
    return -1;
  if (a.stiction && (!a.anchors || !a.anchor_valid || !a.anchors_out || !a.anchor_valid_out))
    return -1;
  if (elem_bytes != 4 && elem_bytes != 8) return -1;
  const int threads = (a.n_slots + kWarp - 1) / kWarp * kWarp;
  const bool one_warp = threads == kWarp;
  const KernelFn fn =
      instance((elem_bytes == 8 ? 1 : 0) | (one_warp ? 0 : 2) | (a.stiction ? 0 : 4));
  const long long smem = plant_smem_bytes(a.n_obj, a.n_sub, a.n_rows, elem_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* params[] = {const_cast<PlantArgs*>(&a)};
  const cudaError_t e = cudaLaunchKernel((const void*)fn, dim3(a.batch), dim3(threads), params,
                                         (size_t)smem, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"

#endif  // PLANT_DEVICE_CODE_ONLY
