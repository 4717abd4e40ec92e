// The plant's contact substeps for Hopper (sm_90a): kernel P1.
//
// Advances the balanced objects of B instances through every inner substep of
// one UprightSimulation.step (upright_tpu_torch/sim/contact.py): n_steps outer
// steps of the robot, each cut into n_sub object substeps, over which the tray
// frame is propagated from the outer step's EE motion.  It carries the
// semantics of upright_tpu/sim/simulation.py, _step_impl's object branch
// (:337-376) and _object_substep (:390-644).  That loop has no Pallas kernel:
// the JAX package runs it as a lax.scan that XLA fuses.  Eager PyTorch would
// launch about a thousand tensor operations per substep, 400 substeps per 100 Hz
// control tick, so the port writes the loop as one kernel.
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
// thing_demo moves a few kilobytes and does about 3 MFLOP per instance.  The
// loop is a chain of n_steps * n_sub dependent substeps, two barriers each, and
// inside a substep a dependent chain of a few hundred instructions (two
// quaternion-to-rotation conversions, a Rodrigues rotation, three square
// roots, divisions) that one warp per instance cannot hide.  At batch 1 the
// time is that chain's latency; at a large batch, blocks share the SMs.
//
// What the design does about it (simple and right first).
//   - One block per instance, one thread per slot, the block padded to a whole
//     number of warps (thing_demo: 16 slots, one warp).  The objects' state and
//     per-object constants live in shared memory for the whole launch; each
//     slot's geometry and its stiction anchor live in that thread's registers,
//     so nothing goes to device memory between substeps.
//   - A substep is two phases split by barriers: every slot thread forms its
//     force, torque and reaction torque into shared memory; then one thread per
//     object sums its slots and the reactions of the slots it supports (in slot
//     order), integrates, and writes the new state.
//   - Every thread computes the substep's tray frame itself (Rodrigues), which
//     costs less than a barrier.  The offsets tau * dt_obj and 0.5 * (tau *
//     dt_obj)^2 are rounded to float32, as the reference's scan computes them.
//   - The 3 x 3 world-frame inertia solve is Cramer's rule (the plain version
//     and the reference use an LU solve; the two agree to rounding on these
//     well-conditioned inertias).
//   - Clamps propagate NaN as the reference's minimum / maximum do, so a
//     non-finite state trips the divergence latch as it does there.
//   - float32 and float64 instantiations; float64 is what holds the kernel to
//     its plain version at 1e-10.

#include <cuda_runtime.h>

// The layout sim/contact.py's _PlantArgs mirrors.
struct PlantArgs {
  const void* frames;     // (B, n_steps, 24): R (9, row-major), p, v, w, a, al of the EE
  const void* slot_geom;  // (n_slots, 18): point 3, normal 3, tangents 2 x 3, half extents 2,
                          //   max depth, vertex 3 (all in the parent's / object's frame)
  const int* slot_int;    // (n_slots, 4): object, parent (-1 = EE), surface, vertex
  const void* obj_data;   // (n_obj, 5): n_eff, L2, nominal CoM in the EE frame 3
  const int* obj_int;     // (n_obj, 2): first slot, slot count
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
};

namespace {

constexpr int kMaxSlots = 256;
constexpr int kMaxObjects = 32;
constexpr int kFrameDim = 24;
constexpr int kSlotGeomDim = 18;
constexpr int kObjDataDim = 5;
constexpr int kSlotOut = 9;  // force, torque, reaction torque

// per-object fields in shared memory
enum ObjField {
  kR = 0, kQ = 3, kV = 7, kW = 10, kMass = 13, kMu = 14, kK = 15, kC = 16, kImin = 17,
  kNeff = 18, kInertia = 19, kComOff = 28, kComNom = 31, kObjStride = 34
};

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

template <typename T>
__device__ __forceinline__ void quat_to_rot(const T* qin, T* R) {
  const T n = sqrt(qin[0] * qin[0] + qin[1] * qin[1] + qin[2] * qin[2] + qin[3] * qin[3]);
  const T x = qin[0] / n, y = qin[1] / n, z = qin[2] / n, w = qin[3] / n;
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  R[0] = T(1) - T(2) * (yy + zz); R[1] = T(2) * (xy - wz);         R[2] = T(2) * (xz + wy);
  R[3] = T(2) * (xy + wz);         R[4] = T(1) - T(2) * (xx + zz); R[5] = T(2) * (yz - wx);
  R[6] = T(2) * (xz - wy);         R[7] = T(2) * (yz + wx);         R[8] = T(1) - T(2) * (xx + yy);
}

// x = A^-1 b by Cramer's rule (A is a world-frame inertia: symmetric positive definite)
template <typename T>
__device__ __forceinline__ void solve3(const T* A, const T* b, T* x) {
  const T c00 = A[4] * A[8] - A[5] * A[7], c01 = A[5] * A[6] - A[3] * A[8];
  const T c02 = A[3] * A[7] - A[4] * A[6];
  const T det = A[0] * c00 + A[1] * c01 + A[2] * c02;
  const T c10 = A[2] * A[7] - A[1] * A[8], c11 = A[0] * A[8] - A[2] * A[6];
  const T c12 = A[1] * A[6] - A[0] * A[7];
  const T c20 = A[1] * A[5] - A[2] * A[4], c21 = A[2] * A[3] - A[0] * A[5];
  const T c22 = A[0] * A[4] - A[1] * A[3];
  x[0] = (c00 * b[0] + c10 * b[1] + c20 * b[2]) / det;
  x[1] = (c01 * b[0] + c11 * b[1] + c21 * b[2]) / det;
  x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) / det;
}

// The EE frame at offset dto into an outer step: R = exp([w0 dto]x) R0 (Rodrigues),
// p = p0 + dto v0 + h a0, v = v0 + dto a0, w = w0 + dto al0, with h = 0.5 dto^2.
template <typename T>
__device__ __forceinline__ void substep_frame(const T* f0, T dto, T h, T* R, T* p, T* v, T* w) {
  const T* w0 = f0 + 15;
  const T nw = sqrt(dot3(w0, w0));
  const T th = nw * dto;
  const T nw_safe = at_least(nw, T(1e-12));
  const T ax = w0[0] / nw_safe, ay = w0[1] / nw_safe, az = w0[2] / nw_safe;
  const T s = sin(th), c1 = T(1) - cos(th);
  // K = [a]x, dR = I + s K + (1 - cos) K K, with K K = a a^T - (a . a) I
  const T dR[9] = {
      T(1) + c1 * -(az * az + ay * ay), -s * az + c1 * ax * ay, s * ay + c1 * ax * az,
      s * az + c1 * ay * ax, T(1) + c1 * -(az * az + ax * ax), -s * ax + c1 * ay * az,
      -s * ay + c1 * az * ax, s * ax + c1 * az * ay, T(1) + c1 * -(ay * ay + ax * ax)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = dR[3 * i] * f0[j] + dR[3 * i + 1] * f0[3 + j] + dR[3 * i + 2] * f0[6 + j];
  for (int i = 0; i < 3; ++i) {
    p[i] = f0[9 + i] + dto * f0[12 + i] + h * f0[18 + i];
    v[i] = f0[12 + i] + dto * f0[18 + i];
    w[i] = w0[i] + dto * f0[21 + i];
  }
}

// Dynamic shared memory of one block, in bytes.
template <typename T>
__host__ __device__ long long smem_bytes(int n_obj, int n_slots) {
  return (long long)(kObjStride * n_obj + kSlotOut * n_slots) * sizeof(T) + 4LL * n_slots;
}

template <typename T>
__global__ void __launch_bounds__(kMaxSlots) plant_kernel(const PlantArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int n_obj = a.n_obj, n_slots = a.n_slots;
  T* so = reinterpret_cast<T*>(smem_raw);  // n_obj x kObjStride
  T* ss = so + n_obj * kObjStride;         // n_slots x kSlotOut
  int* sparent = reinterpret_cast<int*>(ss + n_slots * kSlotOut);
  const T dt = (T)a.dt_obj;

  // -- load: objects (state, parameters, capped gains) ---------------------
  bool div = false;
  if (tid < n_obj) {
    const int i = tid, bi = b * n_obj + i;
    T* o = so + i * kObjStride;
    for (int c = 0; c < 3; ++c) {
      o[kR + c] = ((const T*)a.r)[3 * bi + c];
      o[kV + c] = ((const T*)a.v)[3 * bi + c];
      o[kW + c] = ((const T*)a.w)[3 * bi + c];
      o[kComOff + c] = ((const T*)a.com_offset)[3 * bi + c];
      o[kComNom + c] = ((const T*)a.obj_data)[kObjDataDim * i + 2 + c];
    }
    for (int c = 0; c < 4; ++c) o[kQ + c] = ((const T*)a.q)[4 * bi + c];
    for (int c = 0; c < 9; ++c) o[kInertia + c] = ((const T*)a.inertia)[9 * bi + c];
    const T m = ((const T*)a.mass)[bi];
    o[kMass] = m;
    o[kMu] = ((const T*)a.mu)[bi];
    o[kNeff] = ((const T*)a.obj_data)[kObjDataDim * i];
    const T L2 = ((const T*)a.obj_data)[kObjDataDim * i + 1];
    T i_min = at_most(at_most(o[kInertia], o[kInertia + 4]), o[kInertia + 8]);
    i_min = at_least(i_min, T(1e-12));
    const T m_eff = T(1) / (T(1) / m + L2 / i_min);
    const double omega_max = 0.3 / a.dt_obj;
    const T k = at_most(m_eff * (T)(omega_max * omega_max), (T)a.k_contact);
    o[kK] = k;
    o[kC] = at_most(at_most(T(2) * sqrt(k * m), (T)a.c_contact), T(0.3) * m_eff / dt);
    o[kImin] = i_min;
    div = a.has_diverged ? a.diverged[bi] != 0 : false;
  }

  // -- load: this thread's slot ---------------------------------------------
  T geom[kSlotGeomDim];
  int obj = 0, parent = -1;
  long long anchor_at = 0;
  T anc[2] = {T(0), T(0)};
  bool valid = false;
  if (tid < n_slots) {
    for (int c = 0; c < kSlotGeomDim; ++c) geom[c] = ((const T*)a.slot_geom)[kSlotGeomDim * tid + c];
    obj = a.slot_int[4 * tid];
    parent = a.slot_int[4 * tid + 1];
    sparent[tid] = parent;
    if (a.stiction) {
      anchor_at = (((long long)b * n_obj + obj) * a.s_max + a.slot_int[4 * tid + 2]) * a.k_max +
                  a.slot_int[4 * tid + 3];
      anc[0] = ((const T*)a.anchors)[2 * anchor_at];
      anc[1] = ((const T*)a.anchors)[2 * anchor_at + 1];
      valid = a.anchor_valid[anchor_at] != 0;
    }
  }
  __syncthreads();

  const T grav[3] = {(T)a.gravity[0], (T)a.gravity[1], (T)a.gravity[2]};
  for (int step = 0; step < a.n_steps; ++step) {
    T f0[kFrameDim];
    const T* fsrc = (const T*)a.frames + ((long long)b * a.n_steps + step) * kFrameDim;
    for (int c = 0; c < kFrameDim; ++c) f0[c] = fsrc[c];

    for (int tau = 0; tau < a.n_sub; ++tau) {
      const float d32 = (float)tau * (float)a.dt_obj;
      const float h32 = (0.5f * d32) * d32;
      T Re[9], pe[3], ve[3], we[3];
      substep_frame(f0, (T)d32, (T)h32, Re, pe, ve, we);

      // -- phase 1: one thread per slot ---------------------------------------
      if (tid < n_slots) {
        const T* oi = so + obj * kObjStride;
        T Ri[9], Rp[9], rp[3], vp[3], wp[3];
        quat_to_rot(oi + kQ, Ri);
        if (parent < 0) {
          for (int c = 0; c < 9; ++c) Rp[c] = Re[c];
          for (int c = 0; c < 3; ++c) { rp[c] = pe[c]; vp[c] = ve[c]; wp[c] = we[c]; }
        } else {
          const T* op = so + parent * kObjStride;
          quat_to_rot(op + kQ, Rp);
          for (int c = 0; c < 3; ++c) { rp[c] = op[kR + c]; vp[c] = op[kV + c]; wp[c] = op[kW + c]; }
        }
        T n_w[3], p_surf[3], t1[3], t2[3], vc[3], p_w[3], tmp[3];
        matvec3(Rp, geom + 3, n_w);
        matvec3(Rp, geom + 0, tmp);
        for (int c = 0; c < 3; ++c) p_surf[c] = rp[c] + tmp[c];
        matvec3(Rp, geom + 6, t1);
        matvec3(Rp, geom + 9, t2);
        for (int c = 0; c < 3; ++c) vc[c] = geom[15 + c] - oi[kComOff + c];
        matvec3(Ri, vc, tmp);
        T rel[3], lever[3], arm_p[3];
        for (int c = 0; c < 3; ++c) {
          p_w[c] = oi[kR + c] + tmp[c];
          rel[c] = p_w[c] - p_surf[c];
          lever[c] = p_w[c] - oi[kR + c];
          arm_p[c] = p_w[c] - rp[c];
        }
        const T delta = -dot3(rel, n_w);
        const T tc0 = dot3(rel, t1), tc1 = dot3(rel, t2);
        const bool inside = fabs(tc0) <= geom[12] + T(1e-3) && fabs(tc1) <= geom[13] + T(1e-3);
        const bool in_contact = delta > T(0) && delta <= geom[14] && inside;

        T wl[3], wpl[3], v_t[3];
        cross3(oi + kW, lever, wl);
        cross3(wp, arm_p, wpl);
        T v_rel[3];
        for (int c = 0; c < 3; ++c) v_rel[c] = oi[kV + c] + wl[c] - (vp[c] + wpl[c]);
        const T v_n = dot3(v_rel, n_w);
        for (int c = 0; c < 3; ++c) v_t[c] = v_rel[c] - v_n * n_w[c];

        // prefilter(g) = g / (1 + dt g n_eff w_v): the damping impulse can at
        // most cancel the relative velocity
        const T w_v = T(1) / oi[kMass] + dot3(lever, lever) / oi[kImin];
        const T c_v = oi[kC] / (T(1) + dt * oi[kC] * oi[kNeff] * w_v);
        T f_n = at_least(oi[kK] * delta - c_v * v_n, T(0));
        f_n = at_most(f_n, (T)a.max_force);
        if (!in_contact) f_n = T(0);

        T f_c[3];
        if (a.stiction) {
          const bool stuck = valid && in_contact;
          const T d0 = tc0 - (stuck ? anc[0] : tc0), d1 = tc1 - (stuck ? anc[1] : tc1);
          T F_t[3];
          for (int c = 0; c < 3; ++c)
            F_t[c] = -(d0 * t1[c] + d1 * t2[c]) * oi[kK] - c_v * v_t[c];
          const T F_mag = sqrt(dot3(F_t, F_t));
          const T scale = at_most(oi[kMu] * f_n / at_least(F_mag, T(1e-12)), T(1));
          for (int c = 0; c < 3; ++c) f_c[c] = f_n * n_w[c] + (in_contact ? F_t[c] * scale : T(0));
          const T d_norm = sqrt(d0 * d0 + d1 * d1);
          const T d_max = at_least(oi[kMu] * at_least(delta, T(0)), T(1e-4));
          const T shrink = at_most(d_max / at_least(d_norm, T(1e-12)), T(1));
          anc[0] = in_contact ? tc0 - d0 * shrink : tc0;
          anc[1] = in_contact ? tc1 - d1 * shrink : tc1;
          valid = in_contact;
        } else {
          const T v_t_norm = sqrt(dot3(v_t, v_t)) + (T)a.v_slip;
          const T g = oi[kMu] * f_n / v_t_norm;
          const T gain = g / (T(1) + dt * g * oi[kNeff] * w_v);
          for (int c = 0; c < 3; ++c) f_c[c] = f_n * n_w[c] - gain * v_t[c];
        }
        T* out = ss + kSlotOut * tid;
        for (int c = 0; c < 3; ++c) out[c] = f_c[c];
        cross3(lever, f_c, out + 3);
        if (parent >= 0) {
          const T neg[3] = {-f_c[0], -f_c[1], -f_c[2]};
          T arm[3];
          for (int c = 0; c < 3; ++c) arm[c] = p_w[c] - so[parent * kObjStride + kR + c];
          cross3(arm, neg, out + 6);
        }
      }
      __syncthreads();

      // -- phase 2: one thread per object -------------------------------------
      if (tid < n_obj) {
        T* o = so + tid * kObjStride;
        T F[3], Tq[3];
        for (int c = 0; c < 3; ++c) { F[c] = o[kMass] * grav[c]; Tq[c] = T(0); }
        const int first = a.obj_int[2 * tid], count = a.obj_int[2 * tid + 1];
        for (int s = first; s < first + count; ++s)
          for (int c = 0; c < 3; ++c) { F[c] += ss[kSlotOut * s + c]; Tq[c] += ss[kSlotOut * s + 3 + c]; }
        for (int s = 0; s < n_slots; ++s)
          if (sparent[s] == tid)
            for (int c = 0; c < 3; ++c) { F[c] -= ss[kSlotOut * s + c]; Tq[c] += ss[kSlotOut * s + 6 + c]; }

        T r_new[3], v_new[3], w_new[3], q_new[4];
        for (int c = 0; c < 3; ++c) v_new[c] = o[kV + c] + dt * F[c] / o[kMass];
        T R[9], IR[9], Iw[9];  // I_w = R I R^T
        quat_to_rot(o + kQ, R);
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            IR[3 * i + j] = o[kInertia + 3 * i] * R[3 * j] + o[kInertia + 3 * i + 1] * R[3 * j + 1] +
                            o[kInertia + 3 * i + 2] * R[3 * j + 2];
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            Iw[3 * i + j] = R[3 * i] * IR[j] + R[3 * i + 1] * IR[3 + j] + R[3 * i + 2] * IR[6 + j];
        T Iww[3], wxIw[3], rhs[3], w_dot[3];
        matvec3(Iw, o + kW, Iww);
        cross3(o + kW, Iww, wxIw);
        for (int c = 0; c < 3; ++c) rhs[c] = Tq[c] - wxIw[c];
        solve3(Iw, rhs, w_dot);
        for (int c = 0; c < 3; ++c) {
          w_new[c] = o[kW + c] + dt * w_dot[c];
          r_new[c] = o[kR + c] + dt * v_new[c];
        }
        {  // q_new = exp(dt w_new / 2) q, normalised
          const T nw = sqrt(dot3(w_new, w_new));
          const T half = T(0.5) * (nw * dt);
          const T inv = T(1) / at_least(nw, T(1e-12));
          const T sh = sin(half);
          const T x0 = w_new[0] * inv * sh, y0 = w_new[1] * inv * sh, z0 = w_new[2] * inv * sh;
          const T w0 = cos(half);
          const T x1 = o[kQ], y1 = o[kQ + 1], z1 = o[kQ + 2], w1 = o[kQ + 3];
          q_new[0] = w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1;
          q_new[1] = w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1;
          q_new[2] = w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1;
          q_new[3] = w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1;
          const T n = sqrt(q_new[0] * q_new[0] + q_new[1] * q_new[1] + q_new[2] * q_new[2] +
                           q_new[3] * q_new[3]);
          for (int c = 0; c < 4; ++c) q_new[c] /= n;
        }
        bool hold = false;
        if (a.freeze > 0) {
          // displacement in the EE frame, from the state before this substep
          T d[3], r_oe[3];
          for (int c = 0; c < 3; ++c) d[c] = o[kR + c] - pe[c];
          for (int c = 0; c < 3; ++c) r_oe[c] = Re[c] * d[0] + Re[3 + c] * d[1] + Re[6 + c] * d[2];
          T e[3];
          for (int c = 0; c < 3; ++c) e[c] = r_oe[c] - o[kComNom + c];
          const T disp = sqrt(dot3(e, e));
          bool finite = true;
          for (int c = 0; c < 3; ++c)
            finite = finite && isfinite(r_new[c]) && isfinite(v_new[c]) && isfinite(w_new[c]);
          for (int c = 0; c < 4; ++c) finite = finite && isfinite(q_new[c]);
          div = div || !finite;
          hold = disp > (T)a.freeze || !finite;
        }
        for (int c = 0; c < 3; ++c) {
          if (!hold) o[kR + c] = r_new[c];
          o[kV + c] = hold ? T(0) : v_new[c];
          o[kW + c] = hold ? T(0) : w_new[c];
        }
        if (!hold)
          for (int c = 0; c < 4; ++c) o[kQ + c] = q_new[c];
      }
      __syncthreads();
    }
  }

  // -- store -------------------------------------------------------------------
  if (tid < n_obj) {
    const int bi = b * n_obj + tid;
    const T* o = so + tid * kObjStride;
    for (int c = 0; c < 3; ++c) {
      ((T*)a.r_out)[3 * bi + c] = o[kR + c];
      ((T*)a.v_out)[3 * bi + c] = o[kV + c];
      ((T*)a.w_out)[3 * bi + c] = o[kW + c];
    }
    for (int c = 0; c < 4; ++c) ((T*)a.q_out)[4 * bi + c] = o[kQ + c];
    if (a.has_diverged) a.diverged_out[bi] = div ? 1 : 0;
  }
  if (tid < n_slots && a.stiction) {
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

template <typename T>
int launch(const PlantArgs& a, cudaStream_t stream) {
  const int threads = ((a.n_slots > a.n_obj ? a.n_slots : a.n_obj) + 31) / 32 * 32;
  const long long smem = smem_bytes<T>(a.n_obj, a.n_slots);
  plant_kernel<T><<<a.batch, threads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Registers per thread, bytes of local memory per thread and bytes of static
// shared memory of instance `which` (0 float32, 1 float64), into out[0..2].
// Returns the CUDA error.
int plant_instance_attrs(int which, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (which) {
    case 0: e = cudaFuncGetAttributes(&attr, plant_kernel<float>); break;
    case 1: e = cudaFuncGetAttributes(&attr, plant_kernel<double>); break;
    default: return -1;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return 0;
}

// Launches on `stream` and does not synchronise.  elem_bytes 4 (float32) or 8
// (float64) for every float array.  Returns the CUDA error code of the launch
// (0 = success), or -1 for arguments the kernel does not take.
int plant_advance(const PlantArgs* args, int elem_bytes, void* stream) {
  const PlantArgs& a = *args;
  if (a.batch <= 0 || a.n_steps < 0 || a.n_sub <= 0) return -1;
  if (a.n_obj < 1 || a.n_obj > kMaxObjects || a.n_slots < a.n_obj || a.n_slots > kMaxSlots)
    return -1;
  if (a.stiction && (!a.anchors || !a.anchor_valid || !a.anchors_out || !a.anchor_valid_out))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) return launch<float>(a, s);
  if (elem_bytes == 8) return launch<double>(a, s);
  return -1;
}

}  // extern "C"

#endif  // PLANT_DEVICE_CODE_ONLY
