"""The golden-trajectory solve-quality gate on the port: the cases of
tests/test_solve_quality.py with the originals' limits, run through the
port's batch-first AL-SQP ``solve`` (batch 1) in float64 on the CPU, where
the Riccati wrapper runs its plain version.

The oracle is a deeply converged solve (200 iterations from zeros) of the
flagship problem; the production path (the warm-started 1-iteration SQP of
the replan) must stay within 1e-3 of it in x and u, and the converged
constraint violation must be below 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import zeros_warm_start

CPU64 = dict(device="cpu", dtype=torch.float64)
LS8 = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)


def _load(demo):
    return cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": demo}))


def _solver(prob, al_cfg):
    return lambda p, x, s: solve(prob.ocp, al_cfg, p, x, s, **CPU64)


def _converged_oracle(prob, iterations=200):
    params = broadcast_params(prob.stage_params(0.0), 1)
    x0 = prob.x0[None]
    sol = _solver(prob, ALConfig(iterations=iterations))(
        params, x0, zeros_warm_start(prob.ocp, x0, **CPU64))
    return params, sol


@pytest.fixture(scope="module")
def ur10_oracle():
    prob = build_problem(_load("demos/ur10_demo.yaml"), **CPU64)
    params, sol = _converged_oracle(prob)
    return prob, params, sol


def _max_abs(a, b):
    return float((a - b).abs().max())


def test_converged_eq_viol_below_1e3_ur10(ur10_oracle):
    _, _, sol = ur10_oracle
    assert float(sol.eq_viol[0]) < 1e-3
    assert float(sol.ineq_viol[0]) < 1e-6
    assert float(sol.defect[0]) < 1e-9


def test_mpc_path_within_1e3_of_oracle_ur10(ur10_oracle):
    """The production warm-started 1-iteration re-solve sequence stays
    within 1e-3 of the converged solution in x and u."""
    prob, params, oracle = ur10_oracle
    jsolve = _solver(prob, ALConfig(iterations=1))
    x0 = prob.x0[None]
    st = oracle.state
    for _ in range(5):
        sol = jsolve(params, x0, st)
        dX = _max_abs(sol.state.X, oracle.state.X)
        dU = _max_abs(sol.state.U, oracle.state.U)
        assert dX < 1e-3, dX
        assert dU < 1e-3, dU
        st = sol.state


def test_line_search_4_equals_8_ur10(ur10_oracle):
    """The 4-candidate line search is bit-identical to the full 8-candidate
    ladder on the nominal (warm-started tracking) workload."""
    prob, params, oracle = ur10_oracle
    ls8 = ALConfig(iterations=1, line_search_steps=LS8)
    ls4 = dataclasses.replace(ls8, line_search_steps=LS8[:4])
    x0 = prob.x0[None]
    s8 = _solver(prob, ls8)(params, x0, oracle.state)
    s4 = _solver(prob, ls4)(params, x0, oracle.state)
    assert bool(torch.equal(s4.state.X, s8.state.X))
    assert bool(torch.equal(s4.state.U, s8.state.U))
    assert bool(torch.equal(s4.K, s8.K))


def test_line_search_2_matches_8_replanned_ur10(ur10_oracle):
    """The 2-candidate line search tracks the full 8-candidate ladder to
    float-reassociation noise over a replanned MPC sequence with plant
    drift: on the warm-started nominal workload alpha = 1 always wins."""
    prob, params, oracle = ur10_oracle

    def run(nls, steps=12):
        js = _solver(prob, ALConfig(iterations=1, line_search_steps=LS8[:nls]))
        st = oracle.state
        rng = np.random.default_rng(7)
        x0 = prob.x0.numpy()
        xs = []
        for _ in range(steps):
            sol = js(params, torch.as_tensor(x0)[None], st)
            st = sol.state
            x0 = st.X[0, 1].numpy() + 1e-4 * rng.standard_normal(prob.ocp.nx)
            xs.append(st.X[0].numpy())
        return np.stack(xs)

    X8 = run(8)
    X2 = run(2)
    assert float(np.abs(X2 - X8).max()) < 1e-12


@pytest.mark.slow
def test_golden_gate_thing():
    """Same gate on the full mobile-manipulator flagship (thing_demo)."""
    prob = build_problem(_load("demos/thing_demo.yaml"), **CPU64)
    params, oracle = _converged_oracle(prob)
    assert float(oracle.eq_viol[0]) < 1e-3
    jsolve = _solver(prob, ALConfig(iterations=1))
    x0 = prob.x0[None]
    st = oracle.state
    for _ in range(5):
        sol = jsolve(params, x0, st)
        assert _max_abs(sol.state.X, oracle.state.X) < 1e-3
        assert _max_abs(sol.state.U, oracle.state.U) < 1e-3
        st = sol.state
