"""Scenario generation for robust (inertially uncertain) planning.

Counterpart of ``upright_tpu/robust/scenarios.py``.  The reference's robust
mode rewrites the config so one physical box becomes 8 controller objects,
one per CoM-box vertex, all sharing the arrangement, so that one OCP must
balance every scenario at once (upright_robust/scripts/planning_sim_loop.py
:513-534).

Inertial parameters are runtime parameters of the OCP (the 10-vector per
object), so scenarios are a batch axis: the port's solver is batch-first, and
``robust_solve_fn`` solves a batch of sampled parameter sets as one batched
solve.  The parameter sets themselves are made on the host with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from upright_tpu_torch import resolve_device
from upright_tpu_torch.solver.al import solve


def box_vertices(half_extents, center=None):
    """8 vertices of an axis-aligned box."""
    h = np.asarray(half_extents, dtype=float)
    c = np.zeros(3) if center is None else np.asarray(center, dtype=float)
    signs = np.array(
        [[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)],
        dtype=float,
    )
    return c + signs * h


def com_vertex_params(base_params, com_half_extents):
    """Vertex-scenario parameter sets: for each object, place the CoM at each
    vertex of its uncertainty box.

    base_params: (n_obj, 10); com_half_extents: (n_obj, 3).
    Returns (8, n_obj, 10) numpy: scenario s moves every object's CoM to its
    s-th box vertex.
    """
    base = np.asarray(base_params, dtype=float)
    out = np.tile(base[None], (8, 1, 1))
    for j in range(base.shape[0]):
        m = base[j, 0]
        com = base[j, 1:4] / m
        out[:, j, 1:4] = m * box_vertices(com_half_extents[j], com)
    return out


def sample_inertial_params(base_params, rng, n_samples, com_half_extents=None,
                           mass_range=(1.0, 1.0), inertia_scale_range=(1.0, 1.0)):
    """Monte-carlo scenario parameters from a numpy ``Generator``: CoM uniform
    in its box, mass and inertia scaled uniformly.  The draws are made in the
    reference's order, so one seed gives both packages the same sets.

    Returns (n_samples, n_obj, 10) numpy.
    """
    base = np.asarray(base_params, dtype=float)
    out = np.tile(base[None], (n_samples, 1, 1))
    for j in range(base.shape[0]):
        m0 = base[j, 0]
        com0 = base[j, 1:4] / m0
        I0 = base[j, 4:10]

        m = m0 * rng.uniform(*mass_range, size=n_samples)
        if com_half_extents is not None:
            com = com0 + rng.uniform(-1, 1, size=(n_samples, 3)) * np.asarray(
                com_half_extents[j]
            )
        else:
            com = np.tile(com0, (n_samples, 1))
        s_I = rng.uniform(*inertia_scale_range, size=n_samples)

        out[:, j, 0] = m
        out[:, j, 1:4] = m[:, None] * com
        out[:, j, 4:10] = s_I[:, None] * I0
    return out


def stack_vertex_scenarios_in_model(model, com_half_extents):
    """The reference's in-OCP robust mode: every object replicated 8x (one
    per CoM-box vertex) inside ONE balance model, each scenario with its own
    copy of the contact points, so the shared decision variables are the
    motion and the contact forces grow 8x.  Returns a BalanceModel on the
    device and in the dtype of ``model``.
    """
    params = model.params.detach().cpu().numpy().astype(float)
    n_obj = params.shape[0]
    scen = com_vertex_params(params, com_half_extents)  # (8, n_obj, 10)

    def t(a):
        return torch.as_tensor(a, dtype=model.params.dtype, device=model.params.device)

    eye8 = np.eye(8)
    # block-diagonal incidence: scenario i's objects see scenario i's
    # contact copies only
    return model.replace(
        params=t(scen.reshape(8 * n_obj, 10)),
        mu=model.mu.repeat(8),
        normal=model.normal.repeat(8, 1),
        span=model.span.repeat(8, 1, 1),
        r1=model.r1.repeat(8, 1),
        r2=model.r2.repeat(8, 1),
        S1=t(np.kron(eye8, model.S1.cpu().numpy())),
        S2=t(np.kron(eye8, model.S2.cpu().numpy())),
    )


def robust_solve_fn(ocp, al_cfg, device="cuda", dtype=torch.float32):
    """Scenario solve: one OCP, a batch of inertial parameter sets, as ONE
    batched solve (the reference vmaps a single solve).

    Returns f(params_template, scen_obj_params (S, n_obj, 10), x0 (nx,),
    states (batch-first, S instances)).  ``params_template`` is one
    problem's ``stage_params`` (no batch axis); its ``obj_params`` are
    replaced by each scenario's.
    """
    dev = resolve_device(device)

    def batched(params, obj_p, x0, states):
        obj_p = torch.as_tensor(obj_p, dtype=dtype, device=dev)
        S, N = obj_p.shape[0], ocp.N
        stage = {k: v.expand((S,) + tuple(v.shape)) for k, v in params["stage"].items()}
        final = {k: v.expand((S,) + tuple(v.shape)) for k, v in params["final"].items()}
        stage["obj_params"] = obj_p[:, None].expand((S, N) + tuple(obj_p.shape[1:]))
        final["obj_params"] = obj_p
        x0s = torch.as_tensor(x0, dtype=dtype, device=dev).expand(S, ocp.nx)
        return solve(ocp, al_cfg, {"stage": stage, "final": final}, x0s, states,
                     device=device, dtype=dtype)

    return batched
