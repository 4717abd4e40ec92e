"""Kalman filtering for the tracker loop.

Counterpart of ``upright_tpu/runtime/estimator.py`` (numpy, copied: the
filters run on the host, beside the tracking loop).  Replaces
mobile_manipulation_central's kalman_filter.h as used by the reference
tracking node (upright_ros_interface/src/mrt_node.cpp:156-237):
a linear KF on the triple-integrator robot state [q, v, a] with jerk input,
and a constant-acceleration projectile filter (gravity + optional drag) for
thrown-obstacle estimation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KalmanFilter:
    """Plain linear KF (host-side: runs in the real-time tracker, not on
    device)."""

    x: np.ndarray
    P: np.ndarray
    Q: np.ndarray  # process noise
    R: np.ndarray  # measurement noise
    A: np.ndarray
    B: np.ndarray
    H: np.ndarray

    def predict(self, u):
        self.x = self.A @ self.x + self.B @ u
        self.P = self.A @ self.P @ self.A.T + self.Q
        return self.x

    def correct(self, y):
        S = self.H @ self.P @ self.H.T + self.R
        K = np.linalg.solve(S.T, (self.P @ self.H.T).T).T
        self.x = self.x + K @ (y - self.H @ self.x)
        n = self.P.shape[0]
        self.P = (np.eye(n) - K @ self.H) @ self.P
        return self.x

    def nis(self, y):
        """Normalized innovation squared (gating, as in the reference's
        projectile estimator launch params)."""
        e = y - self.H @ self.x
        S = self.H @ self.P @ self.H.T + self.R
        return float(e @ np.linalg.solve(S, e))


def robot_kf(nq, dt, init_variance=0.1, process_variance=10.0,
             measurement_variance=1e-3, x0=None, measure_velocity=True):
    """Triple-integrator KF on [q, v, a] with jerk input (mrt_node.cpp:156-237;
    estimation settings wrappers.py:150-187)."""
    nx = 3 * nq
    I = np.eye(nq)
    Z = np.zeros((nq, nq))
    A = np.block([
        [I, dt * I, 0.5 * dt**2 * I],
        [Z, I, dt * I],
        [Z, Z, I],
    ])
    B = np.vstack([dt**3 / 6.0 * I, 0.5 * dt**2 * I, dt * I])
    if measure_velocity:
        H = np.hstack([np.eye(2 * nq), np.zeros((2 * nq, nq))])
        R = measurement_variance * np.eye(2 * nq)
    else:
        H = np.hstack([I, np.zeros((nq, 2 * nq))])
        R = measurement_variance * np.eye(nq)
    return KalmanFilter(
        x=np.zeros(nx) if x0 is None else np.asarray(x0, dtype=float).copy(),
        P=init_variance * np.eye(nx),
        Q=process_variance * np.eye(nx),
        R=R,
        A=A,
        B=B,
        H=H,
    )


def projectile_kf(dt, gravity=(0, 0, -9.81), init_variance=1.0,
                  process_variance=1.0, measurement_variance=1e-4, x0=None):
    """Constant-acceleration ballistic KF on [r, v] with known gravity;
    measurement is position (Vicon).  9-state output [r, v, g] feeds the
    controller's obstacle state (mrt_node.cpp:239-283)."""
    g = np.asarray(gravity, dtype=float)
    I3 = np.eye(3)
    Z3 = np.zeros((3, 3))
    A = np.block([[I3, dt * I3], [Z3, I3]])
    # gravity enters as a known input
    B = np.vstack([0.5 * dt**2 * I3, dt * I3])
    H = np.hstack([I3, Z3])
    # white-acceleration process model: noise drives the velocity states and
    # couples into position through the dynamics (NOT independent noise per
    # state, which would let position innovations bypass the velocity)
    q = process_variance
    Q = q * np.block(
        [
            [dt**3 / 3.0 * I3, dt**2 / 2.0 * I3],
            [dt**2 / 2.0 * I3, dt * I3],
        ]
    )
    kf = KalmanFilter(
        x=np.zeros(6) if x0 is None else np.asarray(x0, dtype=float).copy(),
        P=init_variance * np.eye(6),
        Q=Q,
        R=measurement_variance * np.eye(3),
        A=A,
        B=B,
        H=H,
    )
    kf.gravity = g
    return kf
