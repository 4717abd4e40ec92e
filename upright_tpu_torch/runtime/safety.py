"""Safety monitor: gate every tracked command on limit violations.

Counterpart of ``upright_tpu/runtime/safety.py``: the limit checks are numpy
on the host; the EE-box check runs the port's forward kinematics on
``device``.  Replaces the reference SafetyMonitor
(upright_ros_interface/include/upright_ros_interface/safety.h:15-103):
state/input limit checks with configurable margins plus an EE-position box
via forward kinematics.  A violation aborts tracking and brakes the robot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch import resolve_device


@dataclasses.dataclass
class SafetyMonitor:
    state_lower: Optional[np.ndarray] = None
    state_upper: Optional[np.ndarray] = None
    input_lower: Optional[np.ndarray] = None
    input_upper: Optional[np.ndarray] = None
    ee_lower: Optional[np.ndarray] = None
    ee_upper: Optional[np.ndarray] = None
    state_margin: float = 0.1
    input_margin: float = 1.0
    ee_margin: float = 0.1
    enforce_state: bool = True
    enforce_input: bool = False
    enforce_ee: bool = False
    robot: object = None  # RobotModel for FK (EE box check)
    device: str = "cuda"  # where the EE-box check runs the kinematics

    @classmethod
    def from_config(cls, ctrl_conf, robot=None, device="cuda"):
        tracking = ctrl_conf.get("tracking", {})
        limits = ctrl_conf.get("limits", {})
        ee_box = ctrl_conf.get("end_effector_box_constraint", {})
        kw = dict(
            state_margin=float(tracking.get("state_violation_margin", 0.1)),
            input_margin=float(tracking.get("input_violation_margin", 1.0)),
            ee_margin=float(tracking.get("ee_position_violation_margin", 0.1)),
            enforce_state=bool(tracking.get("enforce_state_limits", True)),
            enforce_input=bool(tracking.get("enforce_input_limits", False)),
            enforce_ee=bool(tracking.get("enforce_ee_position_limits", False)),
            robot=robot,
            device=device,
        )
        if "state" in limits:
            kw["state_lower"] = cfg.parse_array(limits["state"]["lower"])
            kw["state_upper"] = cfg.parse_array(limits["state"]["upper"])
        if "input" in limits:
            kw["input_lower"] = cfg.parse_array(limits["input"]["lower"])
            kw["input_upper"] = cfg.parse_array(limits["input"]["upper"])
        if ee_box.get("enabled", False):
            kw["ee_lower"] = np.asarray(ee_box["xyz_lower"], dtype=float)
            kw["ee_upper"] = np.asarray(ee_box["xyz_upper"], dtype=float)
        return cls(**kw)

    def state_limits_violated(self, x) -> bool:
        if not self.enforce_state or self.state_lower is None:
            return False
        x = np.asarray(x)[: len(self.state_lower)]
        return bool(
            (x < self.state_lower - self.state_margin).any()
            or (x > self.state_upper + self.state_margin).any()
        )

    def input_limits_violated(self, u) -> bool:
        if not self.enforce_input or self.input_lower is None:
            return False
        u = np.asarray(u)[: len(self.input_lower)]
        return bool(
            (u < self.input_lower - self.input_margin).any()
            or (u > self.input_upper + self.input_margin).any()
        )

    def ee_position_violated(self, q, r_des=None) -> bool:
        if not self.enforce_ee or self.ee_lower is None or self.robot is None:
            return False
        q = torch.as_tensor(np.asarray(q, dtype=float), dtype=torch.float64,
                            device=resolve_device(self.device))
        _, r_ee = self.robot.ee_pose(q)
        r_ee = r_ee.cpu().numpy()
        ref = np.zeros(3) if r_des is None else np.asarray(r_des)
        return bool(
            (r_ee - ref < self.ee_lower - self.ee_margin).any()
            or (r_ee - ref > self.ee_upper + self.ee_margin).any()
        )

    def check(self, x, u, r_des=None):
        """Returns (ok, reason)."""
        if self.state_limits_violated(x):
            return False, "state limits violated"
        if self.input_limits_violated(u):
            return False, "input limits violated"
        if self.robot is not None and self.enforce_ee:
            q = np.asarray(x)[: self.robot.nq]
            if self.ee_position_violated(q, r_des):
                return False, "EE position box violated"
        return True, ""
