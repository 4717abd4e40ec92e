"""Post-hoc verification of planned trajectories under inertial uncertainty.

Counterpart of ``upright_tpu/robust/verification.py`` (numpy, host side);
the regressor takes its rotation derivative from the port's ``core/math.py``.

Re-design of the reference's SDP verification pipeline
(upright_robust/scripts/process_sim_runs.py:87-270): for each planned state,
maximize the balance-constraint violation over the feasible set of inertial
parameters.

Structure exploited (the reference does this through a regressor matrix Y
from rigeo): with theta = [m, m*c, vech(I_o)] — inertia taken about the EE
origin — the gravito-inertial wrench about the EE origin is exactly LINEAR
in theta:

    F_gi   = C_ew (m a_E + ddC (m c) - m g)
    tau_gi = I_o alpha_e + w_e x (I_o w_e) + (m c) x C_ew(a_E - g)

Hence the worst case of each CWC face a^T Y theta over
  - an explicit vertex/sample set  -> max over vertices (exact),
  - a box in theta                 -> interval arithmetic (exact),
  - an ellipsoid in theta          -> mu^T c + |E^T mu| (exact),
with no SDP solver required for these set classes.  (The reference's
moment-SDP handles density-realizability constraints; for the CoM-box
scenarios used in its experiments the vertex form below is the exact same
set.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from upright_tpu_torch.core.math import dC_dtt
from upright_tpu_torch.robust.modelling import skew3

# failure threshold on object displacement (process_sim_runs.py:23)
FAILURE_DISPLACEMENT = 0.5


def theta_from_body(mass, com, inertia_com):
    """[m, m*c, vech(I_o)] with I_o about the EE origin (parallel axis)."""
    m = float(mass)
    c = np.asarray(com, dtype=float)
    Sc = skew3(c)
    I_o = np.asarray(inertia_com, dtype=float) - m * Sc @ Sc
    vech = np.array([I_o[0, 0], I_o[0, 1], I_o[0, 2], I_o[1, 1], I_o[1, 2], I_o[2, 2]])
    return np.concatenate([[m], m * c, vech])


def inertial_regressor(C_we, w_w, alpha_w, a_w, gravity):
    """Y(state) with wrench_gi(about EE origin, EE frame) = Y theta."""
    C_we = np.asarray(C_we, dtype=float)
    C_ew = C_we.T

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=torch.float64)

    ddC = dC_dtt(t64(C_we), t64(w_w), t64(alpha_w)).numpy()
    w_e = C_ew @ np.asarray(w_w)
    al_e = C_ew @ np.asarray(alpha_w)
    b = C_ew @ (np.asarray(a_w) - np.asarray(gravity))  # body "gravity-compensated" accel

    Y = np.zeros((6, 10))
    # force rows
    Y[:3, 0] = b
    Y[:3, 1:4] = C_ew @ ddC
    # torque rows: (m c) x b  +  I_o al_e + w_e x I_o w_e
    Y[3:, 1:4] = -skew3(b)  # (mc) x b = -b x (mc)
    for k, (i, j) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]):
        E = np.zeros((3, 3))
        E[i, j] = 1.0
        E[j, i] = 1.0
        Y[3:, 4 + k] = E @ al_e + np.cross(w_e, E @ w_e)
    return Y


@dataclasses.dataclass
class ParameterSet:
    """Feasible set of inertial parameters theta (10-vectors)."""

    center: np.ndarray
    box_half: Optional[np.ndarray] = None  # (10,)
    ellipsoid: Optional[np.ndarray] = None  # (10, 10): theta = c + E u, |u| <= 1
    vertices: Optional[np.ndarray] = None  # (k, 10) explicit scenario list

    def max_linear(self, mu):
        """Exact max of mu^T theta over the set."""
        mu = np.asarray(mu, dtype=float)
        if self.vertices is not None:
            return float(np.max(self.vertices @ mu))
        val = float(mu @ self.center)
        if self.box_half is not None:
            val += float(np.abs(mu) @ self.box_half)
        if self.ellipsoid is not None:
            val += float(np.linalg.norm(self.ellipsoid.T @ mu))
        return val

    @classmethod
    def from_com_box(cls, mass, com, inertia_com, com_half_extents,
                     inertia_scales=(1.0,)):
        """CoM anywhere in a box (x inertia scalings): the exact vertex set
        in theta space — the reference's primary uncertainty model
        (robust parsing bounds, planning_sim_loop.py:513-534)."""
        from upright_tpu_torch.robust.scenarios import box_vertices

        com = np.asarray(com, dtype=float)
        verts = box_vertices(com_half_extents, com)
        thetas = []
        for s in inertia_scales:
            for v in verts:
                thetas.append(theta_from_body(mass, v, s * np.asarray(inertia_com)))
        return cls(center=theta_from_body(mass, com, inertia_com),
                   vertices=np.asarray(thetas))


def max_face_violations(face_form_A, Y, param_set: ParameterSet):
    """Worst-case value of each CWC face constraint a_j^T Y theta over theta
    (positive = some feasible parameters violate the face)."""
    M = face_form_A @ Y  # (n_faces, 10)
    return np.array([param_set.max_linear(m) for m in M])


def verify_plan(face_form_A, ee_states, gravity, param_set: ParameterSet):
    """Worst-case violation per planned state; ee_states iterable of
    (C_we, w_w, alpha_w, a_w).  The per-step quantity the reference gets
    from MOSEK (process_sim_runs.py:134-250)."""
    out = []
    for C_we, w_w, alpha_w, a_w in ee_states:
        Y = inertial_regressor(C_we, w_w, alpha_w, a_w, gravity)
        out.append(float(np.max(max_face_violations(face_form_A, Y, param_set))))
    return np.asarray(out)


def count_failures(displacements, threshold=FAILURE_DISPLACEMENT):
    """A run fails if any object moved more than `threshold` meters in the
    tray frame (process_sim_runs.py:23).  A non-finite displacement (the
    plant diverged — e.g. a parameter combination outside the integrator's
    stability envelope) is unconditionally a failure, never a silent skip."""
    d = np.atleast_2d(np.asarray(displacements))
    worst = np.max(d, axis=-1)
    return int(np.sum((worst > threshold) | ~np.isfinite(worst)))
