"""Soft-constraint degradation on the port: the cases of
tests/test_infeasible.py with the originals' limits, through the port's
``solve`` (batch 1) and closed-loop script in float64 on the CPU.

An infeasible inequality group (a degenerate EE box, lower > upper) must give
a finite, bounded solution at the analytic least violation (half the box
gap) without poisoning the other groups; an unreachable waypoint must
degrade gracefully in closed loop.
"""

import copy

import numpy as np
import pytest
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start

CPU64 = dict(device="cpu", dtype=torch.float64)


def _ur10_config():
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    return copy.deepcopy(cfg.load_config(path))


@pytest.fixture(scope="module")
def infeasible_solution():
    config = _ur10_config()
    # degenerate box: lower > upper on every axis, so the least-violating
    # point (EE at the desired position) still violates by 0.1 per axis
    config["controller"]["end_effector_box_constraint"] = {
        "enabled": True,
        "xyz_lower": [0.1, 0.1, 0.1],
        "xyz_upper": [-0.1, -0.1, -0.1],
    }
    # zero-displacement waypoint: the analytic minimum is attainable at
    # every stage
    config["controller"]["waypoints"] = [
        {"time": 0, "position": [0.0, 0.0, 0.0], "orientation": [0, 0, 0, 1]}
    ]
    prob = build_problem(config, **CPU64)
    params = broadcast_params(prob.stage_params(0.0), 1)
    x0 = prob.x0[None]
    sol = solve(prob.ocp, ALConfig(iterations=60), params, x0,
                zeros_warm_start(prob.ocp, x0, **CPU64), **CPU64)
    return prob, sol


def test_infeasible_box_stays_finite(infeasible_solution):
    _, sol = infeasible_solution
    assert bool(torch.isfinite(sol.state.X).all())
    assert bool(torch.isfinite(sol.state.U).all())
    # bounded compromise, not a runaway trajectory
    assert float(sol.state.X.abs().max()) < 50.0


def test_infeasible_box_least_violation(infeasible_solution):
    """Converges to (near) the analytic minimum violation of 0.1: the EE
    parked at the box centre."""
    _, sol = infeasible_solution
    v = float(sol.ineq_viol[0])
    assert 0.099 <= v < 0.105, v


def test_infeasible_box_does_not_poison_other_groups(infeasible_solution):
    """Balance equalities and shooting defects still converge despite the
    infeasible inequality group."""
    _, sol = infeasible_solution
    assert float(sol.eq_viol[0]) < 1e-2
    assert float(sol.defect[0]) < 1e-6


@pytest.mark.slow
def test_unreachable_target_stays_bounded():
    """An unreachable waypoint (beyond the arm's workspace) degrades
    gracefully: bounded joint velocities, finite states, the object kept
    balanced (the lam_max safeguard against dual windup)."""
    from upright_tpu_torch.scripts.mpc_sim import run_closed_loop

    config = _ur10_config()
    # the UR10 home pose is near full extension; +y moves out of reach
    config["controller"]["waypoints"] = [
        {"time": 0, "position": [-0.2, 0.4, 0.2], "orientation": [0, 0, 0, 1]}
    ]
    sim, state, ctrl, logger = run_closed_loop(config, duration=2.0, ctrl_rate=50.0, **CPU64)
    v = state.v.numpy()
    assert np.isfinite(state.q.numpy()).all()
    assert np.abs(v).max() < 5.0, f"joint velocities ran away: {np.abs(v).max()}"
    disp = sim.object_displacements(state)
    assert (disp < 0.05).all(), f"object lost during graceful stop: {disp}"
