"""Robot models: mobile manipulator ("Thing" = Ridgeback + UR10) kinematics.

Counterpart of ``upright_tpu/kinematics/robot.py`` on torch tensors.

Replaces the reference's URDF/xacro -> Pinocchio pipeline
(upright_control/src/upright_control/robot.py:10-42, util.h:16-66).  The chain
is specified directly in numbers (from the public UR10 kinematic parameters +
configurable mount/tool calibration transforms, mirroring the xacro arguments
in upright_cmd/config/robots/thing.yaml) rather than parsed from URDF — the
whole model is ~20 lines of data, transparent, and overridable from YAML.

Base types (reference dynamics/base_type.h:7-39):
  fixed           arm only; base pose folded into the chain as a constant
  omnidirectional planar PX/PY/RZ joints prepended
  nonholonomic    same chain as omnidirectional (differences live in the
                  dynamics, not the kinematics)
  floating        rejected with an error, same effective support as the
                  reference: base_type.h:11 declares the enum value but no
                  FloatingDynamics exists anywhere in upright_control — the
                  string parses and nothing can consume it
"""

from __future__ import annotations

import dataclasses

import numpy as np

import benchmark.reference.config as cfg_mod
from benchmark.reference.core.balance import EEState
from benchmark.reference.kinematics.chain import (
    FIXED,
    PRISMATIC,
    REVOLUTE,
    Joint,
    KinematicChain,
)


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


# UR10 kinematic chain, constructed directly from the official Universal
# Robots DH parameters (d1=0.1273, a2=-0.612, a3=-0.5723, d4=0.163941,
# d5=0.1157, d6=0.0922, alpha=[pi/2,0,0,pi/2,-pi/2,0]) regrouped into
# URDF-style joints (fixed origin, then rotation about local z): joint i's
# origin is TransX(a_{i-1}) RotX(alpha_{i-1}) TransZ(d_i), so the chain's
# forward kinematics equal the standard-DH flange map with theta == q —
# the same convention the ROS Universal Robots packages (ur_description) use, so reference
# home configurations keep their meaning.  Cross-checked joint-by-joint
# against an independent DH implementation in tests/test_fk_oracle.py.
_UR10_JOINTS = [
    ("ur10_arm_shoulder_pan_joint", [0, 0, 0.1273], [0, 0, 0], [0, 0, 1]),
    ("ur10_arm_shoulder_lift_joint", [0, 0, 0], [np.pi / 2, 0, 0], [0, 0, 1]),
    ("ur10_arm_elbow_joint", [-0.612, 0, 0], [0, 0, 0], [0, 0, 1]),
    ("ur10_arm_wrist_1_joint", [-0.5723, 0, 0.163941], [0, 0, 0], [0, 0, 1]),
    ("ur10_arm_wrist_2_joint", [0, -0.1157, 0], [np.pi / 2, 0, 0], [0, 0, 1]),
    ("ur10_arm_wrist_3_joint", [0, 0.0922, 0], [-np.pi / 2, 0, 0], [0, 0, 1]),
]

# Nominal mount of the UR10 base on the Ridgeback chassis.  The reference gets
# this from mobile_manipulation_central's thing_no_wheels.urdf.xacro (not in
# the repo); it is configurable via robot.arm_mount in our configs.
DEFAULT_ARM_MOUNT = {"xyz": [0.27, 0.01, 0.653], "rpy": [0.0, 0.0, np.pi]}

# Tool (gripper -> tray/gripped-object) transform.  Translation from the
# reference sim calibration (upright_cmd/config/robots/calibration/
# tray_transforms_sim.yaml); rotation calibrated so the tray is exactly level
# at the reference home configuration (wrist_3 = 0.417pi: the 0.083pi roll
# complement cancels the wrist-3 azimuth, the -pi/2 pitch turns the flange
# axis upright) — the reference achieves the same via its own calibrated
# tray transforms.
DEFAULT_TOOL_TRANSFORM = {
    "xyz": [0.036712437868118286, -0.0004053786105941981, 0.308562308549881],
    "rpy": [1.083 * np.pi, -np.pi / 2, 0.0],
}


@dataclasses.dataclass
class RobotModel:
    """Kinematic robot model + OCP dimension bookkeeping."""

    chain: KinematicChain
    base_type: str
    nq: int  # actuated DOF (== nv == nu for the triple integrator)
    joint_names: list

    @property
    def nv(self):
        return self.nq

    @property
    def nx(self):
        return 3 * self.nq

    @property
    def nu(self):
        return self.nq

    # -- state unpacking (triple-integrator state [q, v, a]) -------------

    def split_state(self, x):
        q = x[..., : self.nq]
        v = x[..., self.nq : 2 * self.nq]
        a = x[..., 2 * self.nq : 3 * self.nq]
        return q, v, a

    def ee_state(self, x) -> EEState:
        """EE frame motion from the OCP state x (..., 3 nq) (reference
        robot.py:220-244 forward_xu; jerk input does not enter the
        kinematics)."""
        q, v, a = self.split_state(x)
        f = self.chain.ee_motion(q, v, a)
        return EEState(C_we=f.R, r_ew_w=f.p, v_ew_w=f.v, w_ew_w=f.w, a_ew_w=f.a, alpha_ew_w=f.al)

    def ee_pose(self, q):
        return self.chain.forward(q)

    def link_positions(self, q):
        return self.chain.link_positions(q)


def build_robot_model(robot_conf) -> RobotModel:
    """Construct a RobotModel from a robot config dict.

    Config keys: base_type, base_pose (fixed base), locked_joints,
    arm_mount {xyz, rpy}, tool_transform {xyz, rpy}.
    """
    base_type = robot_conf.get("base_type", "omnidirectional").lower()
    mount = robot_conf.get("arm_mount", DEFAULT_ARM_MOUNT)
    tool = robot_conf.get("tool_transform", DEFAULT_TOOL_TRANSFORM)

    joints = []

    if base_type in ("omnidirectional", "nonholonomic"):
        joints += [
            Joint("x_to_world_joint", PRISMATIC, np.eye(3), np.zeros(3), [1, 0, 0]),
            Joint("y_to_x_joint", PRISMATIC, np.eye(3), np.zeros(3), [0, 1, 0]),
            Joint("base_to_y_joint", REVOLUTE, np.eye(3), np.zeros(3), [0, 0, 1]),
        ]
    elif base_type == "fixed":
        # base pose [x, y, yaw] folded in as a constant transform
        # (reference util.h:31-42)
        bp = np.asarray(robot_conf.get("base_pose", [0.0, 0.0, 0.0]), dtype=float)
        R = _rpy_matrix([0, 0, bp[2]])
        joints.append(Joint("base_pose", FIXED, R, [bp[0], bp[1], 0.0]))
    else:
        raise ValueError(f"Unsupported base type: {base_type}")

    # arm mounted on the chassis
    joints.append(
        Joint("arm_mount", FIXED, _rpy_matrix(mount["rpy"]), mount["xyz"])
    )
    for name, xyz, rpy, axis in _UR10_JOINTS:
        joints.append(Joint(name, REVOLUTE, _rpy_matrix(rpy), xyz, axis))

    # tool: gripper/tray transform to the EE ("gripped_object") frame
    joints.append(
        Joint(
            "gripped_object_joint",
            FIXED,
            _rpy_matrix(tool["rpy"]),
            tool["xyz"],
        )
    )

    chain = KinematicChain(joints)
    locked = robot_conf.get("locked_joints", {})
    if locked:
        # values may use the config literal grammar ("0.5pi", parsing.py:63-91)
        locked = {k: cfg_mod.parse_number(v) for k, v in locked.items()}
        chain = chain.lock_joints(locked)

    return RobotModel(
        chain=chain,
        base_type=base_type,
        nq=chain.nq,
        joint_names=chain.dof_names,
    )
