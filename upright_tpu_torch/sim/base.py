"""Base world<->body velocity mappings.

Counterpart of ``upright_tpu/sim/base.py``.  The controller plans base
coordinates (x, y, yaw) with world-frame velocities; real mobile bases are
commanded in the body frame.  These mappings convert a commanded velocity
between the two conventions, and the nonholonomic mapping additionally
enforces the rolling constraint (zero lateral base velocity).  Every function
acts on the full joint-velocity vector (first three entries = base) with any
number of leading batch dimensions.
"""

from __future__ import annotations

import torch


def _rotate_xy(yaw, v, transpose=False):
    """[Rz(yaw) v[:2], v[2:]] (or with Rz(yaw)^T)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    if transpose:
        s = -s
    x = c * v[..., 0:1] + (-s) * v[..., 1:2]
    y = s * v[..., 0:1] + c * v[..., 1:2]
    return torch.cat([x, y, v[..., 2:]], dim=-1)


def _zero_lateral(v):
    return torch.cat([v[..., :1], torch.zeros_like(v[..., 1:2]), v[..., 2:]], dim=-1)


def fixed_forward(q, v):
    return v


def fixed_inverse(q, v):
    return v


def omnidirectional_forward(q, v_body):
    """Body-frame base velocity command -> world frame."""
    return _rotate_xy(q[..., 2:3], v_body)


def omnidirectional_inverse(q, v_world):
    return _rotate_xy(q[..., 2:3], v_world, transpose=True)


def nonholonomic_forward(q, v_body):
    """Unicycle base: zero the lateral component, then rotate to world."""
    return _rotate_xy(q[..., 2:3], _zero_lateral(v_body))


def nonholonomic_inverse(q, v_world):
    return _zero_lateral(_rotate_xy(q[..., 2:3], v_world, transpose=True))


_MAPPINGS = {
    "fixed": (fixed_forward, fixed_inverse),
    "omnidirectional": (omnidirectional_forward, omnidirectional_inverse),
    "nonholonomic": (nonholonomic_forward, nonholonomic_inverse),
}


def base_mapping(base_type: str):
    """(forward, inverse) velocity mappings for a base type string."""
    try:
        return _MAPPINGS[base_type.lower()]
    except KeyError:
        raise ValueError(f"Unknown base type {base_type!r}") from None
