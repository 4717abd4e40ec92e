"""Trajectory toolkit: storage + interpolation (host-side numpy).

Counterpart of ``upright_tpu/solver/trajectory.py``, copied: exact
double-integrator steps, npz-saved state/input trajectories (used to
warm-start the solver as operating points and to replay offline plans), and
linear/quintic interpolators for plan tracking.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class DoubleIntegrator:
    """Exact discrete double integrator (trajectory.py:7-33): state (v, a),
    input jerk."""

    def __init__(self, dim):
        self.dim = dim

    def step(self, v, a, u, dt):
        v1 = v + dt * a + 0.5 * dt**2 * u
        a1 = a + dt * u
        return v1, a1


@dataclasses.dataclass
class StateInputTrajectory:
    """Timed (x, u) trajectory with npz persistence (trajectory.py:36-61).

    Saved plans replay through `track_plan` tooling and warm-start the solver
    (the reference's operating-points mechanism, wrappers.py:289-296)."""

    ts: np.ndarray
    xs: np.ndarray
    us: np.ndarray

    def save(self, path):
        np.savez_compressed(path, ts=self.ts, xs=self.xs, us=self.us)

    @classmethod
    def load(cls, path):
        with np.load(path) as d:
            return cls(ts=d["ts"], xs=d["xs"], us=d["us"])

    def __len__(self):
        return len(self.ts)


@dataclasses.dataclass
class StateInputMapping:
    """Split/merge x <-> (q, v, a) (trajectory.py:64-78)."""

    nq: int

    def xva(self, x):
        n = self.nq
        return x[..., :n], x[..., n : 2 * n], x[..., 2 * n : 3 * n]

    def assemble(self, q, v, a):
        return np.concatenate([q, v, a], axis=-1)


def linear_interpolate(t, t0, x0, t1, x1):
    """(trajectory.py:81-195 LinearInterpolator)."""
    if t1 <= t0:
        return x1
    alpha = np.clip((t - t0) / (t1 - t0), 0.0, 1.0)
    return (1 - alpha) * x0 + alpha * x1


class QuinticInterpolator:
    """Quintic spline between two (position, velocity, acceleration)
    boundary states (trajectory.py QuinticPoints/QuinticInterpolator)."""

    def __init__(self, t0, t1, p0, v0, a0, p1, v1, a1):
        self.t0, self.t1 = float(t0), float(t1)
        T = self.t1 - self.t0
        p0, v0, a0 = np.asarray(p0), np.asarray(v0), np.asarray(a0)
        p1, v1, a1 = np.asarray(p1), np.asarray(v1), np.asarray(a1)
        # boundary-conditioned quintic coefficients
        A = np.array(
            [
                [1, 0, 0, 0, 0, 0],
                [0, 1, 0, 0, 0, 0],
                [0, 0, 2, 0, 0, 0],
                [1, T, T**2, T**3, T**4, T**5],
                [0, 1, 2 * T, 3 * T**2, 4 * T**3, 5 * T**4],
                [0, 0, 2, 6 * T, 12 * T**2, 20 * T**3],
            ]
        )
        b = np.stack([p0, v0, a0, p1, v1, a1])
        self.coeffs = np.linalg.solve(A, b)  # (6, dim)

    def eval(self, t):
        """(p, v, a) at time t."""
        tau = np.clip(t - self.t0, 0.0, self.t1 - self.t0)
        powers = np.array([tau**k for k in range(6)])
        dpowers = np.array([0, 1, 2 * tau, 3 * tau**2, 4 * tau**3, 5 * tau**4])
        ddpowers = np.array([0, 0, 2, 6 * tau, 12 * tau**2, 20 * tau**3])
        c = self.coeffs
        return powers @ c, dpowers @ c, ddpowers @ c


class TrajectoryInterpolator:
    """Piecewise interpolation over a StateInputTrajectory for plan tracking
    (trajectory.py:81-195)."""

    def __init__(self, traj: StateInputTrajectory, nq):
        self.traj = traj
        self.mapping = StateInputMapping(nq)

    def interpolate(self, t):
        ts = self.traj.ts
        k = int(np.clip(np.searchsorted(ts, t) - 1, 0, len(ts) - 2))
        x = linear_interpolate(t, ts[k], self.traj.xs[k], ts[k + 1], self.traj.xs[k + 1])
        u = self.traj.us[min(k, len(self.traj.us) - 1)]
        return x, u
