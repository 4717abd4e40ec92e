"""Rigid-body inertial parameterization.

Counterpart of ``upright_tpu/core/rigid_body.py``.  A balanced object is
summarized by the 10-vector ``[m, m*c, vech(I)]`` (mass, mass-weighted CoM,
half-vectorized inertia about the CoM, all in the end-effector frame).
All functions accept leading batch dimensions.
"""

from __future__ import annotations

import torch


def vech3(I):
    """Half-vectorization of a symmetric (..., 3, 3) matrix."""
    return torch.stack(
        [I[..., 0, 0], I[..., 0, 1], I[..., 0, 2], I[..., 1, 1], I[..., 1, 2], I[..., 2, 2]],
        dim=-1,
    )


def unvech3(v):
    """Inverse of :func:`vech3`."""
    rows = [
        torch.stack([v[..., 0], v[..., 1], v[..., 2]], dim=-1),
        torch.stack([v[..., 1], v[..., 3], v[..., 4]], dim=-1),
        torch.stack([v[..., 2], v[..., 4], v[..., 5]], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def body_to_params(mass, com, inertia):
    """Pack (m (...,), com (..., 3), I (..., 3, 3)) into (..., 10)."""
    mass = mass.unsqueeze(-1)
    return torch.cat([mass, mass * com, vech3(inertia)], dim=-1)


def params_to_body(p):
    """Unpack (..., 10) into (mass (...,), com (..., 3), inertia (..., 3, 3))."""
    mass = p[..., 0]
    com = p[..., 1:4] / p[..., 0:1]
    inertia = unvech3(p[..., 4:10])
    return mass, com, inertia
