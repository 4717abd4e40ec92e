"""Differentiable serial kinematic chain on torch tensors.

Counterpart of ``upright_tpu/kinematics/chain.py``.  A chain is a static
sequence of joint descriptors (fixed transform followed by an optional
actuated revolute/prismatic joint).  The forward pass propagates pose,
classical velocity and classical acceleration of the frame origin in world
coordinates in one sweep: a function of (q, v, a) with any number of leading
batch dimensions, free of in-place writes and of Python control flow on
tensor values, so ``torch.func.jacfwd``/``vmap`` differentiate it.

The joint constants (fixed transforms, axes, Rodrigues generators) are kept
as numpy on the descriptor and cached as tensors per (device, dtype) at first
use, so a sweep issues no host-to-device copies.

Locked joints are folded into the fixed transforms at construction time.

Two routes, chosen by the tensors' device alone.  CPU tensors run the sweep
above in plain PyTorch (``_propagate``).  CUDA tensors go to kernel K2
(``csrc/chain.cu``) or raise: there is no fallback on the card.  K2 writes
only what the caller reads (the pose of each frame asked for, the motion of
one), and its Jacobian mode gives the derivative of the same numbers along
the directions of q or of (q, v, a), all in one launch.  ``_Sweep``, a
``torch.autograd.Function``, carries it under ``torch.func``: its ``jvp``
contracts K2's Jacobian with the tangent, its ``backward`` takes the Jacobian's
transpose, and its ``vmap`` rule folds every vmapped dimension into the point
axis, so the solver's ``vmap(jacfwd(...))`` makes one Jacobian launch per
sweep.  A second derivative through it raises.  ``PlainSweep`` is K2's
interface in plain PyTorch; a chain whose ``kernel`` attribute is set to it
takes the ``_Sweep`` route on any device, which the CPU tests use to hold the
Function's rules against the plain sweep.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from upright_tpu_torch._build import load_library
from upright_tpu_torch.core.math import cross, matvec

# joint type codes
FIXED = "fixed"
REVOLUTE = "revolute"
PRISMATIC = "prismatic"


@dataclasses.dataclass(frozen=True)
class Joint:
    """One link of the chain: fixed transform (R_fix, t_fix) from the parent
    frame, then an actuated DOF about/along ``axis`` (in the post-transform
    frame).  ``kind == FIXED`` means no DOF."""

    name: str
    kind: str
    R_fix: np.ndarray  # (3,3)
    t_fix: np.ndarray  # (3,)
    axis: Optional[np.ndarray] = None  # (3,), unit

    def __post_init__(self):
        object.__setattr__(self, "R_fix", np.asarray(self.R_fix, dtype=float))
        object.__setattr__(self, "t_fix", np.asarray(self.t_fix, dtype=float))
        if self.axis is not None:
            a = np.asarray(self.axis, dtype=float)
            object.__setattr__(self, "axis", a / np.linalg.norm(a))


def _axis_generator(axis):
    """Skew matrix K of a constant unit axis (numpy)."""
    ax = np.asarray(axis, dtype=float)
    return np.array(
        [[0.0, -ax[2], ax[1]], [ax[2], 0.0, -ax[0]], [-ax[1], ax[0], 0.0]]
    )


def _axis_rotation_np(axis, angle):
    """Rodrigues rotation about a constant unit axis (numpy, for locking)."""
    K = _axis_generator(axis)
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


@dataclasses.dataclass(frozen=True)
class FrameMotion:
    """World-frame motion of a chain frame."""

    R: torch.Tensor  # (..., 3, 3) world<-frame
    p: torch.Tensor  # (..., 3) origin position
    v: torch.Tensor  # (..., 3) linear velocity of origin
    w: torch.Tensor  # (..., 3) angular velocity
    a: torch.Tensor  # (..., 3) classical linear acceleration of origin
    al: torch.Tensor  # (..., 3) angular acceleration


def _batched(f: FrameMotion, lead) -> FrameMotion:
    """``f`` with every field given q's batch shape ``lead``: a frame before
    the first actuated joint keeps unbatched entries."""
    return FrameMotion(
        R=f.R.expand(lead + (3, 3)),
        **{n: getattr(f, n).expand(lead + (3,)) for n in ("p", "v", "w", "a", "al")},
    )


class KinematicChain:
    """Serial chain with a flat actuated-DOF vector.

    The number of actuated joints defines the last dimension of q; FIXED
    entries consume no coordinates.

    The attribute ``kernel`` is what sweeps through ``_Sweep``: None (the
    default) takes K2 for CUDA tensors and the plain sweep for CPU tensors;
    ``PlainSweep`` takes the Function with plain arithmetic on either device.
    """

    def __init__(self, joints: Sequence[Joint]):
        self.joints = tuple(joints)
        self.dof_names = [j.name for j in self.joints if j.kind != FIXED]
        self.nq = len(self.dof_names)
        self.kernel = None
        self._const_cache = {}
        self._requests = {}

    # -- construction helpers -------------------------------------------

    def lock_joints(self, locked: dict) -> "KinematicChain":
        """Fold fixed values for named joints into the chain."""
        new_joints = []
        for j in self.joints:
            if j.name in locked:
                qv = float(locked[j.name])
                if j.kind == REVOLUTE:
                    R = j.R_fix @ _axis_rotation_np(j.axis, qv)
                    new_joints.append(Joint(j.name, FIXED, R, j.t_fix))
                elif j.kind == PRISMATIC:
                    t = j.t_fix + j.R_fix @ (j.axis * qv)
                    new_joints.append(Joint(j.name, FIXED, j.R_fix, t))
                else:
                    new_joints.append(j)
            else:
                new_joints.append(j)
        return KinematicChain(new_joints)

    def _constants(self, device, dtype):
        """Per-joint (t_fix, R_fix, axis, K, K@K) tensors on (device, dtype)."""
        key = (str(device), dtype)
        if key not in self._const_cache:
            def t(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

            consts = []
            for j in self.joints:
                if j.kind == FIXED:
                    consts.append((t(j.t_fix), t(j.R_fix), None, None, None))
                else:
                    K = _axis_generator(j.axis)
                    consts.append((t(j.t_fix), t(j.R_fix), t(j.axis), t(K), t(K @ K)))
            self._const_cache[key] = (consts, torch.eye(3, dtype=dtype, device=device))
        return self._const_cache[key]

    # -- forward propagation --------------------------------------------

    def _propagate(self, q, v, a, upto=None):
        """Sweep the chain, returning FrameMotion per joint frame.

        q, v, a: (..., nq) actuated positions / velocities / accelerations.
        """
        consts, eye = self._constants(q.device, q.dtype)
        R = eye
        p = torch.zeros(3, dtype=q.dtype, device=q.device)
        vel, w, acc, al = p, p, p, p

        frames = []
        k = 0  # actuated index
        for j, (t_fix, R_fix, axis, K, KK) in zip(self.joints, consts):
            # rigid extension by the fixed transform
            r = matvec(R, t_fix)
            p = p + r
            vel = vel + cross(w, r)
            acc = acc + cross(al, r) + cross(w, cross(w, r))
            R = R @ R_fix

            if j.kind == REVOLUTE:
                qk = q[..., k, None]
                vk = v[..., k, None]
                ak = a[..., k, None]
                world_axis = matvec(R, axis)
                s = torch.sin(qk).unsqueeze(-1)
                c = torch.cos(qk).unsqueeze(-1)
                R = R @ (eye + s * K + (1.0 - c) * KK)
                al = al + world_axis * ak + cross(w, world_axis * vk)
                w = w + world_axis * vk
                k += 1
            elif j.kind == PRISMATIC:
                qk = q[..., k, None]
                vk = v[..., k, None]
                ak = a[..., k, None]
                world_axis = matvec(R, axis)
                d = world_axis * qk
                p = p + d
                vel = vel + cross(w, d) + world_axis * vk
                acc = (
                    acc
                    + cross(al, d)
                    + cross(w, cross(w, d))
                    + 2.0 * cross(w, world_axis * vk)
                    + world_axis * ak
                )
                k += 1

            frames.append(FrameMotion(R=R, p=p, v=vel, w=w, a=acc, al=al))
            if upto is not None and j.name == upto:
                break
        return frames

    def _frames(self, q, v=None, a=None, upto=None):
        """``_propagate`` with v and a zero where not given."""
        zero = torch.zeros_like(q)
        return self._propagate(q, zero if v is None else v, zero if a is None else a, upto=upto)

    # -- the kernel's route -----------------------------------------------

    def _kernel_for(self, q):
        """What sweeps ``q`` through ``_Sweep``, or None for the plain route."""
        if self.kernel is not None:
            return self.kernel
        return K2 if q.is_cuda else None

    def _sweep(self, kernel, q, v, a, frames, motion=-1):
        """Rows (..., n_out) of one sweep: the pose of each joint frame in
        ``frames``, then the motion of joint frame ``motion`` (-1: none)."""
        key = (frames, motion)
        if key not in self._requests:
            self._requests[key] = SweepRequest(self, frames, motion)
        return _Sweep.apply(q, v, a, self._requests[key], kernel)

    def _motion_of(self, index, q, v, a):
        kernel = self._kernel_for(q)
        if kernel is None:
            return _batched(self._frames(q, v, a, upto=self.joints[index].name)[index],
                            q.shape[:-1])
        rows = self._sweep(kernel, q, v, a, (index,), index)
        return FrameMotion(R=rows[..., 0:9].unflatten(-1, (3, 3)), p=rows[..., 9:12],
                           v=rows[..., 12:15], w=rows[..., 15:18], a=rows[..., 18:21],
                           al=rows[..., 21:24])

    def ee_motion(self, q, v=None, a=None) -> FrameMotion:
        """Pose/velocity/acceleration of the final (tool) frame."""
        return self._motion_of(len(self.joints) - 1, q, v, a)

    def frame_motion(self, name, q, v=None, a=None) -> FrameMotion:
        """Motion of a named joint frame; an unknown name raises ValueError."""
        return self._motion_of(self.joint_names.index(name), q, v, a)

    def frame_poses(self, q, indices) -> Tuple[torch.Tensor, torch.Tensor]:
        """Poses of the joint frames ``indices`` at zero velocity:
        (R (..., n, 3, 3), p (..., n, 3))."""
        kernel = self._kernel_for(q)
        lead = q.shape[:-1]
        if kernel is None:
            frames = self._frames(q)
            R = torch.stack([frames[i].R.expand(lead + (3, 3)) for i in indices], dim=-3)
            p = torch.stack([frames[i].p.expand(lead + (3,)) for i in indices], dim=-2)
            return R, p
        rows = self._sweep(kernel, q, None, None, tuple(indices)).unflatten(-1, (len(indices), 12))
        return rows[..., 0:9].unflatten(-1, (3, 3)), rows[..., 9:12]

    def forward(self, q) -> Tuple[torch.Tensor, torch.Tensor]:
        """EE pose only: (R, p)."""
        f = self.ee_motion(q)
        return f.R, f.p

    def link_positions(self, q) -> torch.Tensor:
        """Positions of every joint frame origin, (..., n_joints, 3)."""
        return self.frame_poses(q, range(len(self.joints)))[1]

    def _k2_constants(self, device, dtype):
        """(n_joints, 24): each joint's t_fix, R_fix, axis and K K (zero for a
        fixed joint), as K2 reads them."""
        key = ("k2", str(device), dtype)
        if key not in self._const_cache:
            rows = []
            for j in self.joints:
                axis = np.zeros(3) if j.axis is None else j.axis
                K = _axis_generator(axis)
                KK = np.zeros((3, 3)) if j.kind == FIXED else K @ K
                rows.append(np.concatenate([j.t_fix, j.R_fix.ravel(), axis, KK.ravel()]))
            self._const_cache[key] = torch.as_tensor(np.stack(rows), dtype=dtype, device=device)
        return self._const_cache[key]

    @property
    def joint_names(self):
        return [j.name for j in self.joints]


# ---------------------------------------------------------------------------
# kernel K2 and the Function that carries it under torch.func
# ---------------------------------------------------------------------------

FRAME_OUT = 12  # R (9, row-major) and p of one frame in a row of a sweep
MOTION_OUT = 12  # v, w, a, al of the motion frame, after the poses
_KINDS = {FIXED: 0, REVOLUTE: 1, PRISMATIC: 2}
_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}
MAX_JOINTS = 64  # csrc/chain.cu kMaxJoints

# Number of K2 launches (CUDA path only), by mode.
launch_count = {"value": 0, "jacobian": 0}


@dataclasses.dataclass(frozen=True, eq=False)
class SweepRequest:
    """What one sweep of ``chain`` writes in a row: the pose of each joint
    frame in ``frames``, then the motion of joint frame ``motion`` (-1: none).
    It sweeps through the last frame it writes."""

    chain: KinematicChain
    frames: Tuple[int, ...]
    motion: int = -1

    @property
    def n_out(self):
        return FRAME_OUT * len(self.frames) + (MOTION_OUT if self.motion >= 0 else 0)

    @property
    def n_joints(self):
        return 1 + max(self.frames + (self.motion,))

    @functools.cached_property
    def launch_args(self):
        """K2's launch arguments that depend on the request alone, as bytes
        of a ``_SweepArgs``."""
        joints = self.chain.joints[: self.n_joints]
        if len(joints) > MAX_JOINTS:
            raise ValueError(f"K2 sweeps at most {MAX_JOINTS} joints; this sweep has {len(joints)}")
        t = _SweepArgs()
        t.nq, t.n_joints, t.n_out = self.chain.nq, len(joints), self.n_out
        t.motion, t.motion_offset = self.motion, FRAME_OUT * len(self.frames)
        for i in range(MAX_JOINTS):
            t.slot[i] = -1
        for i, j in enumerate(joints):
            t.kind[i] = _KINDS[j.kind]
        for n, i in enumerate(self.frames):
            t.slot[i] = FRAME_OUT * n
        return bytes(t)


class _SweepArgs(ctypes.Structure):
    """``SweepArgs`` of csrc/chain.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("consts", "q", "v", "a", "out")]
        + [(n, ctypes.c_longlong) for n in ("sq", "sv", "sa", "points")]
        + [(n, ctypes.c_int) for n in ("nq", "n_joints", "n_out", "motion", "motion_offset",
                                        "n_dir")]
        + [("kind", ctypes.c_int * MAX_JOINTS), ("slot", ctypes.c_int * MAX_JOINTS)]
    )


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("chain")
        lib.k2_chain.argtypes = [ctypes.POINTER(_SweepArgs), ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        lib.k2_chain.restype = ctypes.c_int
        lib.k2_chain_max_joints.restype = ctypes.c_int
        lib.k2_chain_instance_attrs.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.k2_chain_instance_attrs.restype = ctypes.c_int
        if lib.k2_chain_max_joints() != MAX_JOINTS:
            raise RuntimeError("csrc/chain.cu and kinematics/chain.py disagree on MAX_JOINTS")
        _lib = lib
    return _lib


# K2's instantiations, in the order of csrc/chain.cu k2_chain_instance_attrs
INSTANCES = ("value float32", "value float64", "jacobian float32", "jacobian float64")


def instance_attrs():
    """Registers per thread, bytes of local memory per thread and bytes of
    static shared memory of each instantiation of K2, by name."""
    lib = _library()
    out = {}
    for which, name in enumerate(INSTANCES):
        buf = (ctypes.c_int * 3)()
        err = lib.k2_chain_instance_attrs(which, buf)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name} with CUDA error {err}")
        out[name] = {"registers": buf[0], "local_bytes": buf[1], "static_smem_bytes": buf[2]}
    return out


def _rows(t, name, q):
    """``t`` as K2 reads it: (P, nq) rows of unit inner stride, or None."""
    if t is None:
        return None
    if t.device != q.device or t.dtype != q.dtype:
        raise TypeError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} on {q.device}")
    if t.shape != q.shape:
        raise ValueError(f"{name} is {tuple(t.shape)}; q is {tuple(q.shape)}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(req, q, v, a, n_dir):
    """One K2 launch on (P, nq) rows: the value rows (P, n_out) for n_dir 0,
    else the Jacobian (P, n_out, n_dir), a view of a (n_dir, P, n_out) block."""
    if not q.is_cuda:
        raise ValueError(f"K2 runs on CUDA tensors; q is on {q.device}")
    if q.dtype not in _ELEM_BYTES:
        raise TypeError(f"q is {q.dtype}; K2 takes float32 or float64")
    q = _rows(q, "q", q)
    v, a = _rows(v, "v", q), _rows(a, "a", q)
    P, nq = q.shape
    if nq != req.chain.nq:
        raise ValueError(f"q has {nq} coordinates; the chain has {req.chain.nq}")
    lib = _library()
    args = _SweepArgs.from_buffer_copy(req.launch_args)
    consts = req.chain._k2_constants(q.device, q.dtype)
    out = torch.empty((max(n_dir, 1), P, req.n_out), dtype=q.dtype, device=q.device)
    args.consts, args.q, args.out = consts.data_ptr(), q.data_ptr(), out.data_ptr()
    args.sq, args.points, args.n_dir = q.stride(0), P, n_dir
    if v is not None:
        args.v, args.sv = v.data_ptr(), v.stride(0)
    if a is not None:
        args.a, args.sa = a.data_ptr(), a.stride(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k2_chain(ctypes.byref(args), _ELEM_BYTES[q.dtype], int(n_dir > 0), stream)
    if err != 0:
        raise RuntimeError(f"k2_chain launch failed with CUDA error {err}")
    if n_dir == 0:
        launch_count["value"] += 1
        return out[0]
    launch_count["jacobian"] += 1
    return out.permute(1, 2, 0)


class K2:
    """Kernel K2 behind the sweep interface (see ``PlainSweep``)."""

    @staticmethod
    def value(req, q, v, a):
        return _launch(req, q, v, a, 0)

    @staticmethod
    def jacobian(req, q, v, a, n_dir):
        return _launch(req, q, v, a, n_dir)


class PlainSweep:
    """K2's interface in plain PyTorch, on any device: ``value(req, q, v, a)``
    gives the rows (P, n_out) of ``req`` for (P, nq) inputs (v, a: None for
    zero), ``jacobian(req, q, v, a, n_dir)`` their Jacobian (P, n_out, n_dir)
    along the first ``n_dir`` of the 3 nq directions of (q, v, a), by
    ``torch.func.jacfwd`` of ``value``: one tangent per direction."""

    @staticmethod
    def value(req, q, v, a):
        zero = torch.zeros_like(q)
        frames = req.chain._propagate(q, zero if v is None else v, zero if a is None else a)
        lead = q.shape[:-1]
        parts = []
        for i in req.frames:
            parts += [frames[i].R.expand(lead + (3, 3)).flatten(-2),
                      frames[i].p.expand(lead + (3,))]
        if req.motion >= 0:
            f = frames[req.motion]
            parts += [t.expand(lead + (3,)) for t in (f.v, f.w, f.a, f.al)]
        return torch.cat(parts, dim=-1)

    @classmethod
    def jacobian(cls, req, q, v, a, n_dir):
        zero = torch.zeros_like(q)
        nq = q.shape[-1]
        z = torch.cat([q, zero if v is None else v, zero if a is None else a], dim=-1)

        def row(moved, held):
            z_ = torch.cat([moved, held], dim=-1)
            return cls.value(req, z_[:nq], z_[nq:2 * nq], z_[2 * nq:])

        return torch.func.vmap(torch.func.jacfwd(row))(z[:, :n_dir], z[:, n_dir:])


_SECOND_DERIVATIVE = ("K2 gives first derivatives only: a second derivative of the "
                      "kinematic chain's sweep is not implemented")


def _batch_first(info, in_dims, tensors):
    """Each tensor with the vmapped dimension first (None stays None)."""
    out = []
    for t, d in zip(tensors, in_dims):
        if t is None:
            out.append(None)
        elif d is None:
            out.append(t.expand((info.batch_size,) + tuple(t.shape)))
        else:
            out.append(t.movedim(d, 0))
    return out


def _flat(t):
    return None if t is None else t.reshape(-1, t.shape[-1])


class _Sweep(torch.autograd.Function):
    """One sweep, ``kernel.value`` on (q, v, a) of any leading shape (v, a:
    None for zero), differentiable once by ``kernel.jacobian``."""

    @staticmethod
    def forward(q, v, a, req, kernel):
        return kernel.value(req, _flat(q), _flat(v), _flat(a)).reshape(
            q.shape[:-1] + (req.n_out,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, v, a, req, kernel = inputs
        ctx.req, ctx.kernel = req, kernel
        ctx.save_for_forward(q, v, a)
        ctx.save_for_backward(q, v, a)

    @staticmethod
    def jvp(ctx, tq, tv, ta, _req, _kernel):
        q, v, a = ctx.saved_tensors
        full = tv is not None or ta is not None
        J = _SweepJacobian.apply(q, v, a, ctx.req, ctx.kernel, full)
        return _Contract.apply(J, 0, tq, *((tv, ta) if full else ()))

    @staticmethod
    def backward(ctx, g):
        q, v, a = ctx.saved_tensors
        need = ctx.needs_input_grad
        J = _SweepJacobian.apply(q, v, a, ctx.req, ctx.kernel, need[1] or need[2])
        gz = _Contract.apply(J.transpose(-1, -2), 0, g)
        nq = q.shape[-1]
        return tuple(gz[..., i * nq:(i + 1) * nq] if need[i] else None for i in range(3)) + (
            None, None)

    @staticmethod
    def vmap(info, in_dims, q, v, a, req, kernel):
        q, v, a = _batch_first(info, in_dims[:3], (q, v, a))
        return _Sweep.apply(q, v, a, req, kernel), 0


class _SweepJacobian(torch.autograd.Function):
    """``kernel.jacobian`` on (q, v, a) of any leading shape: (..., n_out,
    n_dir) along q (``full`` False) or (q, v, a).  Not differentiable."""

    @staticmethod
    def forward(q, v, a, req, kernel, full):
        nq = q.shape[-1]
        n_dir = 3 * nq if full else nq
        return kernel.jacobian(req, _flat(q), _flat(v), _flat(a), n_dir).reshape(
            q.shape[:-1] + (req.n_out, n_dir))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(_SECOND_DERIVATIVE)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_SECOND_DERIVATIVE)

    @staticmethod
    def vmap(info, in_dims, q, v, a, req, kernel, full):
        q, v, a = _batch_first(info, in_dims[:3], (q, v, a))
        return _SweepJacobian.apply(q, v, a, req, kernel, full), 0


class _Contract(torch.autograd.Function):
    """J t: J (*lead, n_out, n_dir) against tangents ``ts``, each (*extra,
    *lead, width) or None for zero, whose widths split n_dir equally, in order:
    (*extra, *lead, n_out).  ``n_extra`` counts the extra dimensions, the
    tangents' own batch (jacfwd's basis).  One batched matrix product over the
    lead dimensions, (n_out, n_dir) by (n_dir, extra), which takes J as K2
    stores it; broadcasting J over the extra dimensions instead would copy it
    once per tangent.  Not differentiable."""

    @staticmethod
    def forward(J, n_extra, *ts):
        lead, (n_out, n_dir) = J.shape[:-2], J.shape[-2:]
        t0 = next(t for t in ts if t is not None)
        extra = t0.shape[:n_extra]
        width = n_dir // len(ts)
        t = torch.cat([torch.zeros_like(t0[..., :1]).expand(t0.shape[:-1] + (width,))
                       if t is None else t for t in ts], dim=-1) if len(ts) > 1 else t0
        n_lead = math.prod(lead)
        t = t.reshape(-1, n_lead, n_dir).permute(1, 2, 0)  # (lead, n_dir, extra)
        out = torch.bmm(J.reshape(n_lead, n_out, n_dir), t)  # (lead, n_out, extra)
        return out.permute(2, 0, 1).reshape(extra + lead + (n_out,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def jvp(ctx, *tangents):
        raise RuntimeError(_SECOND_DERIVATIVE)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(_SECOND_DERIVATIVE)

    @staticmethod
    def vmap(info, in_dims, J, n_extra, *ts):
        B = info.batch_size
        if in_dims[0] is None:
            # a new batch of tangents: one more extra dimension, first
            ts = [None if t is None else t.movedim(d, 0) if d is not None
                  else t.expand((B,) + tuple(t.shape)) for t, d in zip(ts, in_dims[2:])]
            return _Contract.apply(J, n_extra + 1, *ts), 0
        # a new lead dimension, first of J's and after the tangents' extra ones
        J = J.movedim(in_dims[0], 0)
        ts = [None if t is None else t.movedim(d, n_extra) if d is not None
              else t.unsqueeze(n_extra).expand(t.shape[:n_extra] + (B,) + t.shape[n_extra:])
              for t, d in zip(ts, in_dims[2:])]
        return _Contract.apply(J, n_extra, *ts), n_extra
