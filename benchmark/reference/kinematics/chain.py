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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.core.math import cross, matvec

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
    """

    def __init__(self, joints: Sequence[Joint]):
        self.joints = tuple(joints)
        self.dof_names = [j.name for j in self.joints if j.kind != FIXED]
        self.nq = len(self.dof_names)
        self._const_cache = {}

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

    def ee_motion(self, q, v=None, a=None) -> FrameMotion:
        """Pose/velocity/acceleration of the final (tool) frame."""
        return _batched(self._frames(q, v, a)[-1], q.shape[:-1])

    def frame_motion(self, name, q, v=None, a=None) -> FrameMotion:
        """Motion of a named joint frame; an unknown name raises ValueError."""
        index = self.joint_names.index(name)
        return _batched(self._frames(q, v, a, upto=name)[index], q.shape[:-1])

    def forward(self, q) -> Tuple[torch.Tensor, torch.Tensor]:
        """EE pose only: (R, p)."""
        f = self.ee_motion(q)
        return f.R, f.p

    def link_positions(self, q) -> torch.Tensor:
        """Positions of every joint frame origin, (..., n_joints, 3)."""
        lead = q.shape[:-1]
        return torch.stack([f.p.expand(lead + (3,)) for f in self._frames(q)], dim=-2)

    @property
    def joint_names(self):
        return [j.name for j in self.joints]
