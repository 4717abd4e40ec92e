"""Balance-model physics: friction cones + per-object Newton-Euler residuals.

Counterpart of ``upright_tpu/core/balance.py``.  The model is a plain
dataclass of stacked tensors and every constraint is a function that takes
any number of leading batch dimensions on its per-solve arguments (forces,
EE state, object parameters), so one call evaluates a whole
``(batch, stage)`` block.

Conventions (matching the reference):
  - all quantities expressed in the end-effector (EE) frame unless suffixed _w
  - contact normals point INTO the first object of the pair
  - the EE itself ("fixture" objects) carries no dynamics constraints
"""

from __future__ import annotations

import dataclasses
import math

import torch

from upright_tpu_torch.core.math import cross, dC_dtt, matvec
from upright_tpu_torch.core.rigid_body import params_to_body

NUM_FRICTION_CONSTRAINTS_PER_CONTACT = 2
NUM_LINEARIZED_FRICTION_CONSTRAINTS_PER_CONTACT = 5
NUM_DYNAMICS_CONSTRAINTS_PER_OBJECT = 6


@dataclasses.dataclass
class EEState:
    """Pose, classical velocity and classical acceleration of the EE frame
    in the world; each field may carry leading batch dimensions."""

    C_we: torch.Tensor  # (..., 3, 3) world<-EE rotation
    r_ew_w: torch.Tensor  # (..., 3) position
    v_ew_w: torch.Tensor  # (..., 3) linear velocity
    w_ew_w: torch.Tensor  # (..., 3) angular velocity (world frame)
    a_ew_w: torch.Tensor  # (..., 3) linear (classical) acceleration
    alpha_ew_w: torch.Tensor  # (..., 3) angular acceleration


@dataclasses.dataclass
class BalanceModel:
    """Stacked balance model: n_obj dynamic objects, n_c contact points.

    ``S1``/``S2`` are +1 incidence matrices selecting, for each object, the
    contacts whose force acts on it from the first/second side of the pair; a
    contact whose first object is the EE (or another fixture) has a zero row.
    ``params`` may carry leading batch dimensions (per-scenario parameters).
    """

    params: torch.Tensor  # (..., n_obj, 10) [m, m*c, vech(I)] per object
    mu: torch.Tensor  # (n_c,)
    normal: torch.Tensor  # (n_c, 3) into first object
    span: torch.Tensor  # (n_c, 2, 3) tangent basis, span @ normal = 0
    r1: torch.Tensor  # (n_c, 3) contact point in EE frame (object-1 side)
    r2: torch.Tensor  # (n_c, 3) contact point in EE frame (object-2 side)
    S1: torch.Tensor  # (n_obj, n_c)
    S2: torch.Tensor  # (n_obj, n_c)

    @property
    def num_objects(self):
        return self.params.shape[-2]

    @property
    def num_contacts(self):
        return self.mu.shape[0]

    @staticmethod
    def empty(device="cpu", dtype=torch.float64):
        def z(*shape):
            return torch.zeros(shape, device=device, dtype=dtype)

        return BalanceModel(
            params=z(0, 10), mu=z(0), normal=z(0, 3), span=z(0, 2, 3),
            r1=z(0, 3), r2=z(0, 3), S1=z(0, 0), S2=z(0, 0),
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# friction cones
# ---------------------------------------------------------------------------


def expand_frictionless_forces(model: BalanceModel, forces):
    """Scalar normal-force magnitudes (..., n_c) -> 3-D forces
    (..., n_c, 3): f_i = s_i * n_i."""
    return forces.unsqueeze(-1) * model.normal


def contact_force_constraints_linearized(model: BalanceModel, forces):
    """Linearized friction cone, 5 rows per contact: ``f_n >= 0`` and
    ``mu f_n +- f_t1 +- f_t2 >= 0``.  forces: (..., n_c, 3) in the EE frame;
    returns (..., 5 n_c)."""
    f_n = (model.normal * forces).sum(-1)  # (..., n_c)
    f_t = (model.span * forces.unsqueeze(-2)).sum(-1)  # (..., n_c, 2)
    mf = model.mu * f_n
    t0, t1 = f_t[..., 0], f_t[..., 1]
    rows = torch.stack(
        [f_n, mf - t0 - t1, mf - t0 + t1, mf + t0 - t1, mf + t0 + t1], dim=-1
    )
    return rows.flatten(-2)


# ---------------------------------------------------------------------------
# object wrenches + Newton-Euler residuals
# ---------------------------------------------------------------------------


def compute_object_wrenches(model: BalanceModel, forces):
    """Net contact wrench on each object about its CoM (incidence-matrix
    form): forces act positively on object 1 of each pair, negatively on
    object 2, with lever arm (r_contact - com).

    forces: (..., n_c, 3).  Returns (F (..., n_obj, 3), M (..., n_obj, 3)).
    """
    coms = model.params[..., 1:4] / model.params[..., 0:1]  # (..., n_obj, 3)

    m1 = cross(model.r1, forces)  # moments about the EE origin
    m2 = cross(model.r2, forces)

    F = model.S1 @ forces - model.S2 @ forces
    # torque about com_j: sum_i s_ij cross(r_i - com_j, f_i)
    #                  = sum_i s_ij cross(r_i, f_i) - cross(com_j, sum_i s_ij f_i)
    M = model.S1 @ m1 - model.S2 @ m2 - cross(coms, F)
    return F, M


def object_dynamics_constraints(model: BalanceModel, forces, ee_state: EEState,
                                gravity, normalize=True):
    """Newton-Euler equality residual, 6 rows per object.

    forces: (..., n_c, 3) contact forces in the EE frame.  Residuals are
    mass-normalized, and (by default) scaled by 1/sqrt(6 n_obj) to match the
    reference's conditioning trick.  Returns (..., 6 n_obj).
    """
    wrench_F, wrench_M = compute_object_wrenches(model, forces)

    C_ew = ee_state.C_we.transpose(-1, -2)
    ddC_we = dC_dtt(ee_state.C_we, ee_state.w_ew_w, ee_state.alpha_ew_w)
    w_e = matvec(C_ew, ee_state.w_ew_w)
    alpha_e = matvec(C_ew, ee_state.alpha_ew_w)

    m, com, I = params_to_body(model.params)  # (..., n_obj), (..., n_obj, 3), (..., n_obj, 3, 3)
    m = m.unsqueeze(-1)
    lin = matvec(C_ew, ee_state.a_ew_w - gravity).unsqueeze(-2)  # (..., 1, 3)
    # C_ew @ (ddC_we @ com_j) for every object j
    ang = com @ (C_ew @ ddC_we).transpose(-1, -2)  # (..., n_obj, 3)
    gi_force = m * (lin + ang)
    Iw = matvec(I, w_e.unsqueeze(-2))
    inertial_torque = cross(w_e.unsqueeze(-2).expand_as(Iw), Iw) + matvec(I, alpha_e.unsqueeze(-2))
    c_force = (gi_force - wrench_F) / m
    c_torque = (inertial_torque - wrench_M) / m
    residuals = torch.cat([c_force, c_torque], dim=-1).flatten(-2)
    if normalize:
        residuals = residuals / math.sqrt(
            NUM_DYNAMICS_CONSTRAINTS_PER_OBJECT * model.num_objects * 1.0
        )
    return residuals
