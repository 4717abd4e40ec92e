// The kinematic chain's sweep and its Jacobian for Hopper (sm_90a): kernel K2.
//
// One sweep of upright_tpu_torch/kinematics/chain.py's serial chain: from the
// world frame through every joint (a fixed transform, then an optional
// revolute or prismatic DOF), the pose, the classical velocity and the
// classical acceleration of each frame's origin in world coordinates, for P
// points (q, v, a) at once.  It replaces no TPU kernel: the JAX package's chain
// (upright_tpu/kinematics/chain.py) is tensor code that XLA fuses.  Eagerly,
// PyTorch runs some thirty operations per joint, and under the solver's
// vmap(jacfwd(...)) each revolute joint's tangent becomes two batched 3x3x3
// matrix products over P * 3 nq rows that cuBLAS gives a 32x32x8 tile each.
// So the port writes the sweep as one kernel, in two modes:
//
//   value     one thread per point.  It writes only what the caller reads: the
//             pose (R, p) of each listed frame, then the velocity, angular
//             velocity, acceleration and angular acceleration (v, w, a, al)
//             of one frame, 12 numbers a frame and 12 for the motion.
//   jacobian  one thread per (point, direction) over the directions of q, or
//             of (q, v, a).  Each thread sweeps the primal in registers and
//             carries the one tangent, and writes the derivative of every
//             number the value mode writes.  A q-direction's tangent is zero
//             up to its joint, and the thread starts carrying it there; a v-
//             or a-direction moves no pose, so its instantiation carries no
//             rotation or position tangent at all.  Directions are blocks of
//             the grid's y axis, so a warp never diverges on them.
//
// The joints (kinds and output slots) come by value in the launch's
// parameters; their constants (t_fix, R_fix, axis and axis-generator square
// K K, computed on the host in float64 as the plain version's) are a small
// array that every thread of a block reads at the same address.  The sweep
// stops after the last frame it writes.
//
// What bounds it on this card.  At the solve cell's P 327,680 (nq 9, 27
// directions, 24 numbers out) the Jacobian mode writes 27 * 24 numbers a
// point, 849 MB in float32, and does about 3,000 operations a (point,
// direction): a few hundred microseconds by bytes or operations either way.
// Each thread's rows are contiguous (J is stored direction-major, (n_dir, P,
// n_out)), which the wrapper hands on as a (P, n_out, n_dir) view that a
// matrix product takes without a copy.  The arithmetic is the plain version's,
// in the same order, in the working type, and _build.py compiles this file
// with -fmad=false: each product and sum is rounded on its own, as the plain
// sweep's elementwise operations round them.  With fused multiply-adds the
// closed loop's cold iterations, which amplify rounding, drifted further from
// the plain float32 reference on every seed tried (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxJoints = 64;
constexpr int kJointConsts = 24;  // t_fix 3, R_fix 9 (row-major), axis 3, K K 9 (row-major)
constexpr int kFixed = 0, kRevolute = 1, kPrismatic = 2;

}  // namespace

// One launch.  Mirrored by kinematics/chain.py's _SweepArgs (ctypes).
struct SweepArgs {
  const void* consts;  // (n_joints, kJointConsts)
  const void* q;       // (points, nq) rows, unit stride inside a row
  const void* v;       // the same, or null for zero
  const void* a;       // the same, or null for zero
  void* out;           // value: (points, n_out); jacobian: (n_dir, points, n_out)
  long long sq, sv, sa;  // row strides, in elements
  long long points;
  int nq;
  int n_joints;  // joints swept: through the last one written
  int n_out;
  int motion;         // joint whose (v, w, a, al) is written at motion_offset, or -1
  int motion_offset;
  int n_dir;  // jacobian: nq (q) or 3 nq (q, v, a)
  int kind[kMaxJoints];
  int slot[kMaxJoints];  // offset of the joint's (R, p) in an output row, or -1
};

namespace {

template <typename T>
__device__ __forceinline__ void matvec(const T* M, const T* x, T* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = M[3 * i] * x[0] + M[3 * i + 1] * x[1] + M[3 * i + 2] * x[2];
}

template <typename T>
__device__ __forceinline__ void matmul(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// sin and cos of a joint angle.  float32: sin and cos, as the plain sweep's
// torch.sin and torch.cos round them.  float64: through sincospi, whose exact
// reduction by whole periods leaves no slow path and so no stack frame (sin
// and cos keep a 40-byte one for the reduction of huge arguments); x / pi
// rounds once, a relative 1e-16 of the angle.
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  *s = sin(x);
  *c = cos(x);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincospi(x * 0.318309886183790671537767526745028724, s, c);
}

template <typename T>
__device__ __forceinline__ void copy3(const T* x, T* y) {
  y[0] = x[0];
  y[1] = x[1];
  y[2] = x[2];
}

// One point's sweep.  Without TANGENT it writes the values; with it, the
// derivative along direction `dir` (ROT: a q-direction, which moves poses).
template <typename T, bool TANGENT, bool ROT>
__device__ void sweep(const SweepArgs& s, long long point, int dir, T* __restrict__ row) {
  const T* __restrict__ consts = static_cast<const T*>(s.consts);
  const T* q = static_cast<const T*>(s.q) + point * s.sq;
  const T* v = s.v ? static_cast<const T*>(s.v) + point * s.sv : nullptr;
  const T* a = s.a ? static_cast<const T*>(s.a) + point * s.sa : nullptr;
  // the coordinate the tangent moves: dir = which * nq + m, which 0 q, 1 v, 2 a
  const int m = TANGENT ? dir % s.nq : -1;
  const int which = TANGENT ? dir / s.nq : -1;

  T R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  T p[3] = {0, 0, 0}, vel[3] = {0, 0, 0}, w[3] = {0, 0, 0}, acc[3] = {0, 0, 0},
    al[3] = {0, 0, 0};
  // tangents; dR and dp stay zero unless ROT
  T dR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  T dp[3] = {0, 0, 0}, dvel[3] = {0, 0, 0}, dw[3] = {0, 0, 0}, dacc[3] = {0, 0, 0},
    dal[3] = {0, 0, 0};
  bool live = false;  // the tangent is nonzero from the direction's joint on
  int k = 0;          // actuated index

  for (int j = 0; j < s.n_joints; ++j) {
    const T* cj = consts + j * kJointConsts;
    const T* t_fix = cj;
    const T* R_fix = cj + 3;
    const T* axis = cj + 12;
    const T* KK = cj + 15;

    // rigid extension by the fixed transform
    T r[3], t1[3], t2[3];
    matvec(R, t_fix, r);
    if (TANGENT && live) {
      T dr[3] = {0, 0, 0};
      if (ROT) matvec(dR, t_fix, dr);
      // dvel += dw x r + w x dr
      cross(dw, r, t1);
      cross(w, dr, t2);
      for (int i = 0; i < 3; ++i) dvel[i] += t1[i] + t2[i];
      // dacc += dal x r + al x dr + dw x (w x r) + w x (dw x r + w x dr)
      T wr[3], s1[3], s2[3], inner[3];
      cross(w, r, wr);
      cross(dal, r, t1);
      cross(al, dr, t2);
      cross(dw, wr, s1);
      for (int i = 0; i < 3; ++i) inner[i] = 0;
      cross(dw, r, s2);
      for (int i = 0; i < 3; ++i) inner[i] += s2[i];
      cross(w, dr, s2);
      for (int i = 0; i < 3; ++i) inner[i] += s2[i];
      cross(w, inner, s2);
      for (int i = 0; i < 3; ++i) dacc[i] += t1[i] + t2[i] + s1[i] + s2[i];
      if (ROT) {
        for (int i = 0; i < 3; ++i) dp[i] += dr[i];
        T tmp[9];
        matmul(dR, R_fix, tmp);
        for (int i = 0; i < 9; ++i) dR[i] = tmp[i];
      }
    }
    {
      T wr[3], wwr[3], alr[3];
      cross(w, r, wr);
      cross(w, wr, wwr);
      cross(al, r, alr);
      for (int i = 0; i < 3; ++i) {
        p[i] += r[i];
        vel[i] += wr[i];
        acc[i] = acc[i] + alr[i] + wwr[i];
      }
      T tmp[9];
      matmul(R, R_fix, tmp);
      for (int i = 0; i < 9; ++i) R[i] = tmp[i];
    }

    const int kind = s.kind[j];
    if (kind != kFixed) {
      const T qk = q[k];
      const T vk = v ? v[k] : T(0);
      const T ak = a ? a[k] : T(0);
      T ax[3], vax[3];
      matvec(R, axis, ax);
      for (int i = 0; i < 3; ++i) vax[i] = ax[i] * vk;
      if (TANGENT && k == m) live = true;
      const T dq = (TANGENT && k == m && which == 0) ? T(1) : T(0);
      const T dv = (TANGENT && k == m && which == 1) ? T(1) : T(0);
      const T da = (TANGENT && k == m && which == 2) ? T(1) : T(0);
      if (kind == kRevolute) {
        T sn, cs;
        sin_cos(qk, &sn, &cs);
        // Rj = I + sin K + (1 - cos) K K, K the axis' generator
        const T K[9] = {0, -axis[2], axis[1], axis[2], 0, -axis[0], -axis[1], axis[0], 0};
        T Rj[9];
        for (int i = 0; i < 9; ++i) Rj[i] = (i % 4 == 0 ? T(1) : T(0)) + sn * K[i] + (T(1) - cs) * KK[i];
        if (TANGENT && live) {
          T dax[3] = {0, 0, 0}, dvax[3];
          if (ROT) matvec(dR, axis, dax);
          for (int i = 0; i < 3; ++i) dvax[i] = dax[i] * vk + ax[i] * dv;
          // dal += dax ak + ax da + dw x vax + w x dvax; dw += dvax
          cross(dw, vax, t1);
          cross(w, dvax, t2);
          for (int i = 0; i < 3; ++i) {
            dal[i] += dax[i] * ak + ax[i] * da + t1[i] + t2[i];
            dw[i] += dvax[i];
          }
          if (ROT) {
            // dR = dR Rj + R dRj, dRj = dq (cos K + sin K K)
            T dRj[9], u1[9], u2[9];
            for (int i = 0; i < 9; ++i) dRj[i] = dq * (cs * K[i] + sn * KK[i]);
            matmul(dR, Rj, u1);
            matmul(R, dRj, u2);
            for (int i = 0; i < 9; ++i) dR[i] = u1[i] + u2[i];
          }
        }
        cross(w, vax, t1);
        for (int i = 0; i < 3; ++i) {
          al[i] = al[i] + ax[i] * ak + t1[i];
          w[i] += vax[i];
        }
        T tmp[9];
        matmul(R, Rj, tmp);
        for (int i = 0; i < 9; ++i) R[i] = tmp[i];
      } else if (kind == kPrismatic) {
        T d[3], wd[3], wwd[3], ald[3], wvax[3];
        for (int i = 0; i < 3; ++i) d[i] = ax[i] * qk;
        cross(w, d, wd);
        cross(w, wd, wwd);
        cross(al, d, ald);
        cross(w, vax, wvax);
        if (TANGENT && live) {
          T dax[3] = {0, 0, 0}, dd[3], dvax[3];
          if (ROT) matvec(dR, axis, dax);
          for (int i = 0; i < 3; ++i) {
            dd[i] = dax[i] * qk + ax[i] * dq;
            dvax[i] = dax[i] * vk + ax[i] * dv;
          }
          // dvel += dw x d + w x dd + dvax
          cross(dw, d, t1);
          cross(w, dd, t2);
          for (int i = 0; i < 3; ++i) dvel[i] += t1[i] + t2[i] + dvax[i];
          // dacc += dal x d + al x dd + dw x (w x d) + w x (dw x d + w x dd)
          //         + 2 (dw x vax + w x dvax) + dax ak + ax da
          T s1[3], s2[3], s3[3], inner[3];
          cross(dal, d, s1);
          cross(al, dd, s2);
          cross(dw, wd, s3);
          for (int i = 0; i < 3; ++i) {
            dacc[i] += s1[i] + s2[i] + s3[i];
            inner[i] = t1[i] + t2[i];
          }
          cross(w, inner, s1);
          cross(dw, vax, s2);
          cross(w, dvax, s3);
          for (int i = 0; i < 3; ++i)
            dacc[i] += s1[i] + T(2) * (s2[i] + s3[i]) + dax[i] * ak + ax[i] * da;
          if (ROT)
            for (int i = 0; i < 3; ++i) dp[i] += dd[i];
        }
        for (int i = 0; i < 3; ++i) {
          p[i] += d[i];
          vel[i] = vel[i] + wd[i] + vax[i];
          acc[i] = acc[i] + ald[i] + wwd[i] + T(2) * wvax[i] + ax[i] * ak;
        }
      }
      ++k;
    }

    const int slot = s.slot[j];
    if (slot >= 0) {
      T* o = row + slot;
      for (int i = 0; i < 9; ++i) o[i] = TANGENT ? dR[i] : R[i];
      for (int i = 0; i < 3; ++i) o[9 + i] = TANGENT ? dp[i] : p[i];
    }
    if (j == s.motion) {
      T* o = row + s.motion_offset;
      copy3(TANGENT ? dvel : vel, o);
      copy3(TANGENT ? dw : w, o + 3);
      copy3(TANGENT ? dacc : acc, o + 6);
      copy3(TANGENT ? dal : al, o + 9);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) k2_chain_value(const __grid_constant__ SweepArgs s) {
  const long long point = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (point >= s.points) return;
  sweep<T, false, false>(s, point, 0, static_cast<T*>(s.out) + point * s.n_out);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) k2_chain_jacobian(const __grid_constant__ SweepArgs s) {
  const long long point = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int dir = blockIdx.y;
  if (point >= s.points) return;
  T* row = static_cast<T*>(s.out) + ((long long)dir * s.points + point) * s.n_out;
  if (dir < s.nq)
    sweep<T, true, true>(s, point, dir, row);
  else
    sweep<T, true, false>(s, point, dir, row);
}

}  // namespace

// Host side: the launcher and the C interface.  CHAIN_DEVICE_CODE_ONLY leaves
// it out, for tools/emulate_chain.py, which builds the device code above with
// a C++ compiler.
#ifndef CHAIN_DEVICE_CODE_ONLY

extern "C" {

// The largest number of joints a launch takes.
int k2_chain_max_joints() { return kMaxJoints; }

// Registers per thread, bytes of local memory per thread and bytes of static
// shared memory of instance `which` (0 value float32, 1 value float64, 2
// jacobian float32, 3 jacobian float64) into out[0..2].  Returns the CUDA
// error code (0 = success), or -1 for an unknown instance.
int k2_chain_instance_attrs(int which, int* out) {
  const void* fns[] = {(const void*)k2_chain_value<float>, (const void*)k2_chain_value<double>,
                       (const void*)k2_chain_jacobian<float>,
                       (const void*)k2_chain_jacobian<double>};
  if (which < 0 || which > 3) return -1;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fns[which]);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  return 0;
}

// Launches on `stream` and does not synchronise.  elem_bytes 4 (float32) or 8
// (float64); jacobian 0 (value mode) or 1.  Returns the CUDA error code of the
// launch (0 = success), or -1 for arguments the kernel does not take.
int k2_chain(const SweepArgs* args, int elem_bytes, int jacobian, void* stream) {
  const SweepArgs& s = *args;
  if (s.points < 0 || s.nq < 0 || s.n_joints < 0 || s.n_joints > kMaxJoints || s.n_out < 0)
    return -1;
  if (elem_bytes != 4 && elem_bytes != 8) return -1;
  if (jacobian && (s.n_dir < 1 || s.n_dir > 3 * s.nq || s.n_dir > 65535)) return -1;
  if (s.points == 0 || s.n_out == 0) return 0;
  const dim3 grid((unsigned)((s.points + kBlock - 1) / kBlock), jacobian ? s.n_dir : 1);
  const void* fn;
  if (jacobian)
    fn = elem_bytes == 8 ? (const void*)k2_chain_jacobian<double> : (const void*)k2_chain_jacobian<float>;
  else
    fn = elem_bytes == 8 ? (const void*)k2_chain_value<double> : (const void*)k2_chain_value<float>;
  void* params[] = {const_cast<SweepArgs*>(&s)};
  const cudaError_t e =
      cudaLaunchKernel(fn, grid, dim3(kBlock), params, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"

#endif  // CHAIN_DEVICE_CODE_ONLY
