"""Projectile (thrown-obstacle) estimation and flight state machine.

Counterpart of ``upright_tpu/runtime/projectile.py`` (numpy, copied: it runs
on the host, beside the closed loop).  Replaces the reference's Vicon
projectile estimator + the state machine in the tracking node
(upright_ros_interface/src/mrt_node.cpp:23-30, 239-283): Preflight ->
Flight (above activation height, moving) -> Postflight (below deactivation
height).  While in Flight the controller's dynamic-obstacle
state tail gets the ballistic estimate and the target ``s`` flag is set so
the projectile-path constraint activates.
"""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np

from upright_tpu_torch.runtime.estimator import projectile_kf


class FlightPhase(Enum):
    PREFLIGHT = 0
    FLIGHT = 1
    POSTFLIGHT = 2


@dataclasses.dataclass
class ProjectileTracker:
    dt: float
    activation_height: float = 1.0  # above this + upward velocity => Flight
    deactivation_height: float = 0.2  # below this => Postflight
    gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0, -9.81])
    )
    nis_gate: float = 9.0  # reject outlier measurements
    min_flight_speed: float = 0.5  # m/s; parked balls are not projectiles
    process_variance: float = 100.0  # high gain: throws are sudden
    measurement_variance: float = 1e-6  # Vicon-grade position measurements
    reacquire_after: int = 3  # consecutive NIS rejections -> re-init track

    def __post_init__(self):
        self.kf = projectile_kf(
            self.dt, self.gravity,
            process_variance=self.process_variance,
            measurement_variance=self.measurement_variance,
        )
        self.phase = FlightPhase.PREFLIGHT
        self._initialized = False
        self._rejects = 0

    def update(self, r_measured=None):
        """One tick: KF predict (+ gated correct), then phase transitions.

        Returns (obstacle_state(9), s_flag)."""
        if self._initialized:
            # gravity only acts once the ball is actually in flight; a held
            # (pre-throw) ball is stationary
            accel = self.kf.gravity if self.phase == FlightPhase.FLIGHT else np.zeros(3)
            self.kf.predict(accel)
        if r_measured is not None:
            r_measured = np.asarray(r_measured, dtype=float)
            if not self._initialized:
                self.kf.x[:3] = r_measured
                self._initialized = True
            elif self.kf.nis(r_measured) < self.nis_gate:
                self.kf.correct(r_measured)
                self._rejects = 0
            else:
                # outlier; after several consecutive rejections assume the
                # track jumped (e.g. the throw) and re-acquire
                self._rejects += 1
                if self._rejects >= self.reacquire_after:
                    self.kf.x[:3] = r_measured
                    self.kf.x[3:] = 0.0
                    self.kf.P = np.eye(6) * 10.0
                    self._rejects = 0

        r, v = self.kf.x[:3], self.kf.x[3:]

        if self.phase == FlightPhase.PREFLIGHT:
            # in flight = high enough AND actually moving (a parked ball above
            # the activation height is not a projectile)
            if (
                self._initialized
                and r[2] > self.activation_height
                and np.linalg.norm(v) > self.min_flight_speed
            ):
                self.phase = FlightPhase.FLIGHT
        elif self.phase == FlightPhase.FLIGHT:
            if r[2] < self.deactivation_height:
                self.phase = FlightPhase.POSTFLIGHT

        s = 1.0 if self.phase == FlightPhase.FLIGHT else 0.0
        obstacle_state = np.concatenate([r, v, self.gravity])
        return obstacle_state, s


def fit_ballistic_motion(times, positions, drag=False):
    """Least-squares fit of ballistic parameters to a position track
    (reference upright_cmd/scripts/projectile/fit_projectile_motion.py).

    Without drag: r(t) = r0 + v0 t + 0.5 g t^2, solved linearly for
    (r0, v0, g_z).  With drag: iterative fit of the drag coefficient in
    v' = g - b |v| v.
    """
    times = np.asarray(times, dtype=float)
    positions = np.asarray(positions, dtype=float)
    t = times - times[0]

    # linear LS per axis: [1, t, t^2/2] @ [r0, v0, a] = r
    Amat = np.stack([np.ones_like(t), t, 0.5 * t**2], axis=1)
    coeffs, *_ = np.linalg.lstsq(Amat, positions, rcond=None)
    r0, v0, a = coeffs
    if not drag:
        return r0, v0, a

    # crude drag estimate from the residual deceleration along the velocity
    g = np.array([0.0, 0, -9.81])
    a_extra = a - g
    v_norm = np.linalg.norm(v0)
    b = float(np.linalg.norm(a_extra) / max(v_norm**2, 1e-9))
    return r0, v0, g, b
