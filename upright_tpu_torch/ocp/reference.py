"""Target (reference) trajectories with on-device interpolation.

Counterpart of ``upright_tpu/ocp/reference.py``.  A target is a fixed-size
array of timed waypoints ``[r(3), q(4), s(1)]`` (position, xyzw orientation,
projectile-avoidance activation flag); interpolation (linear position, slerp
orientation) takes leading batch dimensions on every argument.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from upright_tpu_torch import resolve_device
from upright_tpu_torch.core.math import quat_slerp

TARGET_DIM = 8  # r(3) + quat(4) + s(1)


def _quat_multiply_np(q0, q1):
    x0, y0, z0, w0 = q0
    x1, y1, z1, w1 = q1
    return np.array(
        [
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        ]
    )


@dataclasses.dataclass
class TargetTrajectory:
    """Timed EE pose waypoints (fixed shape; pad by repeating the last)."""

    times: torch.Tensor  # (..., n_wp)
    poses: torch.Tensor  # (..., n_wp, 8) [r, quat_xyzw, s]

    @staticmethod
    def from_waypoints(waypoints, r0, q0, device="cuda", dtype=torch.float32):
        """Build from config waypoint dicts relative to the initial EE pose:
        positions relative to r0, orientations composed in the EE body frame
        (q = q0 * q_rel)."""
        device = resolve_device(device)
        r0 = np.asarray(r0, dtype=float)
        q0 = np.asarray(q0, dtype=float)
        times, poses = [], []
        for wp in waypoints:
            t = float(wp.get("time", 0.0))
            r = r0 + np.asarray(wp.get("position", [0, 0, 0]), dtype=float)
            q_rel = np.asarray(wp.get("orientation", [0, 0, 0, 1]), dtype=float)
            q_rel = q_rel / np.linalg.norm(q_rel)
            q = _quat_multiply_np(q0, q_rel)
            s = float(wp.get("projectile_flag", 0.0))
            times.append(t)
            poses.append(np.concatenate([r, q, [s]]))
        return TargetTrajectory(
            times=torch.as_tensor(np.asarray(times), dtype=dtype, device=device),
            poses=torch.as_tensor(np.stack(poses), dtype=dtype, device=device),
        )

    def interpolate(self, t):
        """Desired (r, q, s) at time t (...,): linear in position, slerp in
        orientation, previous-value in s."""
        times, poses = self.times, self.poses
        n = times.shape[-1]
        if n == 1:
            p = poses[..., 0, :]
            return p[..., :3], p[..., 3:7], p[..., 7]

        t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        # segment index as a comparison sum (searchsorted side="right" - 1),
        # and row selection as one-hot sums: no data-dependent indexing, so
        # the function stays differentiable and vmappable
        idx = torch.clamp((times <= t.unsqueeze(-1)).sum(-1) - 1, 0, n - 2)
        ar = torch.arange(n, device=times.device)
        sel0 = (ar == idx.unsqueeze(-1)).to(times.dtype)
        sel1 = (ar == (idx + 1).unsqueeze(-1)).to(times.dtype)
        t0, t1 = (sel0 * times).sum(-1), (sel1 * times).sum(-1)
        p0 = (sel0.unsqueeze(-1) * poses).sum(-2)
        p1 = (sel1.unsqueeze(-1) * poses).sum(-2)
        alpha = torch.where(
            t1 > t0, (t - t0) / torch.clamp(t1 - t0, min=1e-9), torch.zeros_like(t0)
        )
        alpha = torch.clamp(alpha, 0.0, 1.0)

        a = alpha.unsqueeze(-1)
        r = (1.0 - a) * p0[..., :3] + a * p1[..., :3]
        q = quat_slerp(p0[..., 3:7], p1[..., 3:7], alpha)
        s = torch.where(alpha < 1.0, p0[..., 7], p1[..., 7])
        return r, q, s


def stack_targets(targets) -> TargetTrajectory:
    """B targets of one waypoint count as one batch: times (B, n_wp), poses
    (B, n_wp, 8) (the leading axis ``UprightProblem.stage_params`` and the
    device loop batch over)."""
    shapes = {tuple(t.times.shape) for t in targets}
    if len(shapes) != 1:
        raise ValueError(f"targets of different waypoint counts cannot be stacked: {sorted(shapes)}")
    return TargetTrajectory(
        times=torch.stack([t.times for t in targets]),
        poses=torch.stack([t.poses for t in targets]),
    )
