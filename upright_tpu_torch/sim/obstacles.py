"""Dynamic (thrown / moving) obstacles for the simulation.

Counterpart of ``upright_tpu/sim/obstacles.py`` (numpy, copied): piecewise
ballistic "modes" (time, position, velocity, acceleration), evaluated
analytically; an optional velocity-servo "controlled" mode tracks the nominal
path.  Supplies the 9-D state the controller appends to x.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class ObstacleMode:
    time: float
    position: np.ndarray
    velocity: np.ndarray
    acceleration: np.ndarray


class DynamicObstacle:
    def __init__(self, modes: List[ObstacleMode], radius=0.1, controlled=False,
                 gain=10.0):
        assert modes, "Dynamic obstacle needs at least one mode"
        self.modes = sorted(modes, key=lambda m: m.time)
        self.radius = radius
        self.controlled = controlled
        self.gain = gain  # position gain of the velocity servo (reference K = 10 I)
        # servo state (controlled mode only): the obstacle tracks its nominal
        # path with a velocity servo instead of following it exactly
        # (reference simulation.py:410-435)
        self._r = np.array(self.modes[0].position, dtype=float)
        self._v = np.zeros(3)
        self._t = float(self.modes[0].time)

    @classmethod
    def from_config(cls, conf, ee_position=None):
        """Build from a config dict; relative positions offset by the initial
        EE position (reference simulation.py:334-360)."""
        offset = np.zeros(3)
        if conf.get("relative", False) and ee_position is not None:
            offset = np.asarray(ee_position, dtype=float)
        modes = [
            ObstacleMode(
                time=float(m.get("time", 0.0)),
                position=np.asarray(m.get("position", [0, 0, 0]), dtype=float) + offset,
                velocity=np.asarray(m.get("velocity", [0, 0, 0]), dtype=float),
                acceleration=np.asarray(m.get("acceleration", [0, 0, 0]), dtype=float),
            )
            for m in conf.get("modes", [])
        ]
        return cls(
            modes,
            radius=float(conf.get("radius", 0.1)),
            controlled=bool(conf.get("controlled", False)),
        )

    def _active_mode(self, t):
        mode = self.modes[0]
        for m in self.modes:
            if t >= m.time:
                mode = m
        return mode

    def _nominal_state(self, t):
        m = self._active_mode(t)
        dt = max(0.0, t - m.time)
        r = m.position + dt * m.velocity + 0.5 * dt**2 * m.acceleration
        v = m.velocity + dt * m.acceleration
        if t < self.modes[0].time:
            return np.concatenate([m.position, np.zeros(3), np.zeros(3)])
        return np.concatenate([r, v, m.acceleration])

    def reset(self, t0=None):
        """Re-initialize the controlled-mode servo state."""
        m0 = self.modes[0]
        self._r = np.array(m0.position, dtype=float)
        self._v = np.zeros(3)
        self._t = float(m0.time if t0 is None else t0)

    def step(self, t):
        """Advance the velocity-servo state to time t (controlled mode;
        reference simulation.py:410-435: cmd_vel = K (rd - r) + vd applied as
        the obstacle's velocity each sim step).  No-op when uncontrolled."""
        if not self.controlled:
            return
        dt = t - self._t
        if dt <= 0.0:
            return
        nominal = self._nominal_state(t)
        rd, vd = nominal[:3], nominal[3:6]
        cmd = self.gain * (rd - self._r) + vd
        self._r = self._r + dt * cmd
        self._v = cmd
        self._t = t

    def state(self, t):
        """9-D obstacle state [r, v, a] at time t.  Uncontrolled obstacles
        follow their piecewise-ballistic modes exactly; controlled obstacles
        report the servo-integrated state (call ``step`` to advance it)."""
        nominal = self._nominal_state(t)
        if not self.controlled or t < self.modes[0].time:
            return nominal
        return np.concatenate([self._r, self._v, nominal[6:9]])

    def position(self, t):
        return self.state(t)[:3]


def build_dynamic_obstacles(sim_conf, ee_position=None):
    dyn = sim_conf.get("dynamic_obstacles", {})
    if not dyn or not dyn.get("enabled", False):
        return []
    return [
        DynamicObstacle.from_config(c, ee_position=ee_position)
        for c in dyn.get("obstacles", [])
    ]
