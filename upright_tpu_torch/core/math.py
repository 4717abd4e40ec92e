"""Rotation / quaternion / inertia math on torch tensors.

Counterpart of ``upright_tpu/core/math.py``.  Every tensor function takes
any number of leading batch dimensions (vectors are ``(..., 3)``, matrices
``(..., 3, 3)``) and contains no Python branch on tensor values, so it runs
unchanged on a whole ``(batch, stage)`` block and under
``torch.func.vmap`` / ``jacfwd``.  Quaternions use ``xyzw`` ordering.
The inertia helpers at the bottom are host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def _norm(x):
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def _mat(rows):
    """Stack a 2-D nested list of (...,) tensors into (..., r, c)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _mat1(rows):
    """Like :func:`_mat` for entries shaped (..., 1).

    Arithmetic between a Python number and a 0-dim tensor promotes the
    forward-mode tangent to float64 under ``torch.func.jacfwd`` (the number
    is wrapped as a float64 0-dim tensor and, between two 0-dim operands, the
    tangent formula promotes), so functions that mix numbers into their
    entries keep them 1-dim.
    """
    return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)


def cross(a, b):
    """Cross product over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def matvec(M, v):
    """(..., i, j) @ (..., j) -> (..., i)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# basic vector ops
# ---------------------------------------------------------------------------


def skew3(v):
    """Skew-symmetric matrix of a 3-vector."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _mat([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def dC_dtt(C_we, angular_vel, angular_acc):
    """Second time-derivative of a rotation matrix:
    ddC/dt^2 = (S(alpha) + S(omega) S(omega)) C."""
    S_w = skew3(angular_vel)
    S_a = skew3(angular_acc)
    return (S_a + S_w @ S_w) @ C_we


# ---------------------------------------------------------------------------
# quaternions (xyzw)
# ---------------------------------------------------------------------------


def quat_to_rot(q):
    """Quaternion [x, y, z, w] to rotation matrix."""
    q = q / _norm(q)
    # entries are kept as (..., 1) slices, never 0-dim tensors: see _mat1
    x, y, z, w = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _mat1(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
    )


def rot_to_quat(C):
    """Rotation matrix to quaternion [x, y, z, w].

    Shepperd-style: all four candidate quaternions are computed and the one
    with the largest pivot is selected by a one-hot mask (the reference
    selects with ``lax.switch``; a mask keeps the function free of
    data-dependent Python control flow, and all four candidates are finite,
    so the unselected ones do not poison a Jacobian).
    """
    d = torch.diagonal(C, dim1=-2, dim2=-1)  # (..., 3)
    t = d.sum(-1, keepdim=True)
    # [1 + tr, 1 + d0 - d1 - d2, 1 - d0 + d1 - d2, 1 - d0 - d1 + d2]
    pivots = torch.cat([1.0 + t, 1.0 + 2.0 * d - t], dim=-1)
    c01, c10 = C[..., 0, 1], C[..., 1, 0]
    c02, c20 = C[..., 0, 2], C[..., 2, 0]
    c12, c21 = C[..., 1, 2], C[..., 2, 1]
    cands = _mat(
        [
            [c21 - c12, c02 - c20, c10 - c01, pivots[..., 0]],  # w-major
            [pivots[..., 1], c01 + c10, c02 + c20, c21 - c12],  # x-major
            [c01 + c10, pivots[..., 2], c12 + c21, c02 - c20],  # y-major
            [c02 + c20, c12 + c21, pivots[..., 3], c10 - c01],  # z-major
        ]
    )
    idx = torch.argmax(pivots, dim=-1, keepdim=True)
    mask = idx == torch.arange(4, device=C.device)  # (..., 4) one-hot
    q = torch.where(mask.unsqueeze(-1), cands, torch.zeros_like(cands)).sum(-2)
    q = q / _norm(q)
    # canonical sign: w >= 0
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_multiply(q0, q1):
    """Hamilton product of two xyzw quaternions (rotation composition)."""
    x0, y0, z0, w0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    return torch.stack(
        [
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        ],
        dim=-1,
    )


def quat_integrate(q, omega, dt):
    """Integrate quaternion q forward by world-frame angular velocity omega
    over dt: the axis-angle increment exp(dt omega / 2) applied on the left.
    Entries stay (..., 1)-shaped (see _mat1)."""
    nw = _norm(omega)
    half = 0.5 * (nw * dt)
    axis = omega / torch.clamp(nw, min=1e-12)
    dq = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    q_new = quat_multiply(dq, q)
    return q_new / _norm(q_new)


def quat_slerp(q0, q1, alpha):
    """Spherical linear interpolation from q0 (alpha=0) to q1 (alpha=1)."""
    alpha = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device).unsqueeze(-1)
    q0 = q0 / _norm(q0)
    q1 = q1 / _norm(q1)
    d = (q0 * q1).sum(-1, keepdim=True)
    # take the short way around
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    # fall back to lerp for tiny angles; the inner where keeps the division
    # (and its derivative) finite on the branch that is not taken
    use_lerp = sin_theta < 1e-6
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe_sin)
    w1 = torch.where(use_lerp, alpha, torch.sin(alpha * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / _norm(q)


def orientation_error(q, qd):
    """SO(3) orientation error used by the EE pose cost:
    err = w_d * xyz - w * xyz_d - xyz_d x xyz, with q = [xyz, w] the actual
    and qd the desired orientation."""
    xyz, w = q[..., :3], q[..., 3:4]
    xyz_d, w_d = qd[..., :3], qd[..., 3:4]
    return w_d * xyz - w * xyz_d - cross(xyz_d, xyz)


# ---------------------------------------------------------------------------
# planes / support areas
# ---------------------------------------------------------------------------


def plane_span(normal):
    """Basis of the plane orthogonal to ``normal``: (..., 2, 3) with
    orthonormal rows and span @ normal = 0."""
    n = normal / _norm(normal)
    ex = n.new_tensor([1.0, 0.0, 0.0]).expand_as(n)
    ey = n.new_tensor([0.0, 1.0, 0.0]).expand_as(n)
    # pick the axis least aligned with n
    a = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    t1 = cross(n, a)
    t1 = t1 / _norm(t1)
    t2 = cross(n, t1)
    return torch.stack([t1, t2], dim=-2)


# ---------------------------------------------------------------------------
# host-side numpy helpers (problem set-up only)
# ---------------------------------------------------------------------------


def rotz_np(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def quat_to_rot_np(q):
    q = np.asarray(q, dtype=float)
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def inset_vertex(v, inset):
    """Move 2-D vertex v toward the origin by ``inset``."""
    d = np.linalg.norm(v)
    return (d - inset) * v / d


def cylinder_inertia_matrix(mass, radius, height):
    """Inertia of a z-aligned solid cylinder."""
    xx = yy = mass * (3 * radius**2 + height**2) / 12
    zz = 0.5 * mass * radius**2
    return np.diag([xx, yy, zz])


def cuboid_inertia_matrix(mass, side_lengths):
    """Inertia of a rectangular cuboid."""
    lx, ly, lz = side_lengths
    xx = ly**2 + lz**2
    yy = lx**2 + lz**2
    zz = lx**2 + ly**2
    return mass * np.diag([xx, yy, zz]) / 12.0


def sphere_inertia_matrix(mass, radius):
    """Inertia of a solid sphere."""
    xx = 0.4 * mass * radius**2
    return np.diag([xx, xx, xx])


def wedge_inertia_matrix(mass, side_lengths):
    """Inertia of a right-triangular wedge about its CoM.

    Returns (D, C): D diagonal inertia in the principal frame, C the rotation
    of the principal frame w.r.t. the object frame, so J = C @ D @ C.T.
    """
    hx, hy, hz = 0.5 * np.asarray(side_lengths)
    J = np.array(
        [
            [hy**2 / 3 + 2 * hz**2 / 9, 0, hx * hz / 9],
            [0, 2 * hx**2 / 9 + 2 * hz**2 / 9, 0],
            [hx * hz / 9, 0, 2 * hx**2 / 9 + hy**2 / 3],
        ]
    )
    d, C = np.linalg.eig(J)
    D = np.diag(d)
    return mass * D, C
