"""The port's MPC manager (``upright_tpu_torch/solver/mpc.py``) and closed-loop
script against the JAX package's, on ur10_demo in float64 on the CPU.

Both managers own a problem of N = 5 stages (the JAX side compiles its two
solve paths once per manager), start from the same state and see the same
observations, made with numpy from a seed.  Tolerance 1e-8: the same
algorithm in float64 (see test_torch_solve.py), with the 12-iteration cold
solve and the chained replans amplifying the summation-order differences.
The replan gating (which calls replan, and when) must agree exactly.
"""

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver.mpc import ControllerManager as JManager
from upright_tpu.solver.trajectory import StateInputTrajectory as JTraj
from upright_tpu_torch.core.logging import DataLogger
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.scripts.mpc_sim import run_closed_loop
from upright_tpu_torch.solver.mpc import ControllerManager, MPCSettings
from upright_tpu_torch.solver.trajectory import StateInputTrajectory

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TOL = dict(rtol=1e-8, atol=1e-8)


def ur10_config():
    return jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    )


@pytest.fixture(scope="module")
def managers():
    """(JAX manager, port manager) on the same N = 5 problem."""
    config = ur10_config()
    return JManager(jbuild(config, N=N)), ControllerManager(tbuild(config, N=N, **CPU64))


def assert_solutions_equal(tm, jm, label):
    for f in ("X", "U", "lam", "mu", "lam_f"):
        np.testing.assert_allclose(getattr(tm.state, f)[0].numpy(), getattr(jm.state, f),
                                   err_msg=f"{label} {f}", **TOL)
    np.testing.assert_allclose(tm.solution.K[0].numpy(), jm.solution.K,
                               err_msg=f"{label} K", **TOL)


def test_manager_matches_reference(managers):
    """warmstart, then steps at 10 ms (replan), 15 ms (no replan: inside the
    100 Hz interval, the policy interpolates) and 30 ms (replan), then the
    policy at 40 ms."""
    jm, tm = managers
    jm.reset()
    tm.reset()
    rng = np.random.default_rng(0)
    x0 = np.asarray(jm.problem.x0) + 0.01 * rng.standard_normal(jm.problem.ocp.nx)
    jm.warmstart(0.0, x0)
    tm.warmstart(0.0, x0)
    assert_solutions_equal(tm, jm, "warmstart")
    n0 = len(tm.replanning_durations)
    for t in (0.01, 0.015, 0.03):
        x = x0 + 0.003 * rng.standard_normal(x0.shape)
        xd_j, u_j = jm.step(t, x)
        xd_t, u_t = tm.step(t, x)
        assert tm.last_plan_time == jm.last_plan_time
        assert len(tm.replanning_durations) == len(jm.replanning_durations)
        np.testing.assert_allclose(xd_t, np.asarray(xd_j), err_msg=f"t={t} xd", **TOL)
        np.testing.assert_allclose(u_t, np.asarray(u_j), err_msg=f"t={t} u", **TOL)
        assert_solutions_equal(tm, jm, f"t={t}")
    assert len(tm.replanning_durations) - n0 == 2
    x = x0 + 0.003 * rng.standard_normal(x0.shape)
    for a, b in zip(tm.evaluate_policy(0.04, x), jm.evaluate_policy(0.04, x)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_plan_matches_reference(managers):
    """plan() over 0.05 s at the replan cadence: the rolled-out trajectory."""
    jm, tm = managers
    jm.reset()
    tm.reset()
    jt = jm.plan(timestep=0.01, duration=0.05)
    tt = tm.plan(timestep=0.01, duration=0.05)
    assert isinstance(tt, StateInputTrajectory) and len(tt) == len(jt) == 6
    np.testing.assert_allclose(tt.ts, jt.ts, rtol=0, atol=0)
    np.testing.assert_allclose(tt.xs, jt.xs, **TOL)
    np.testing.assert_allclose(tt.us, jt.us, **TOL)


def test_operating_points_from_saved_trajectory(managers, tmp_path):
    """A plan saved by the JAX package, loaded by the port's trajectory
    class, seeds both managers' cold solve identically; the port's seed
    guess holds the saved states (row 0 pinned to the measurement)."""
    jm, tm = managers
    jm.reset()
    jt = jm.plan(timestep=0.1, duration=0.6)
    path = tmp_path / "plan.npz"
    jt.save(path)
    loaded = StateInputTrajectory.load(path)
    np.testing.assert_array_equal(loaded.xs, jt.xs)
    x0 = jt.xs[0] + 1e-3

    for mgr, traj in ((jm, JTraj.load(path)), (tm, loaded)):
        mgr.reset()
        mgr.set_operating_points(traj)
        mgr.warmstart(0.0, x0)
    guess = tm._initial_guess(0.0, torch.as_tensor(x0)[None])
    np.testing.assert_allclose(guess.X[0, 1:].numpy(), jt.xs[1 : N + 1], atol=1e-12)
    np.testing.assert_allclose(guess.X[0, 0].numpy(), x0, atol=1e-12)
    assert_solutions_equal(tm, jm, "operating points")
    for mgr in (jm, tm):
        mgr.set_operating_points(None)


def test_settings_from_config():
    conf = ur10_config()["controller"]
    s = MPCSettings.from_config(conf)
    cfg = s.al_config()
    assert cfg.iterations == s.iterations and cfg.dual_reset_violation == s.dual_reset_violation
    assert cfg.line_search_steps == tuple(s.line_search_steps)


def test_closed_loop_logs_match_reference():
    """The port's run_closed_loop for 3 control ticks (full horizon), logging
    every tick: the logged constraint values and diagnostics equal the JAX
    problem's evaluate_constraints and diagnostics at the same (x, u, t),
    and the plant and the controller stay finite."""
    config = ur10_config()
    logger = DataLogger(timestep=0.0)
    sim, state, ctrl, logger = run_closed_loop(config, duration=3 / 125.0, log=logger, **CPU64)
    data = logger.as_arrays()
    assert len(data["t"]) == 3
    jp = jbuild(config)
    for i, t in enumerate(data["t"]):
        x, u = data["x"][i], data["u"][i]
        cons = jp.evaluate_constraints(x, u, t, jp.target)
        diag = jp.diagnostics(x, u, t, jp.target)
        np.testing.assert_allclose(data["constraint_eq"][i], np.asarray(cons["equality"]),
                                   rtol=0, atol=1e-10)
        for name, _n in ctrl.problem.ineq_groups:
            np.testing.assert_allclose(data[name][i], np.asarray(cons[name]), rtol=0, atol=1e-10)
        for name in ("orn_err", "ddC_we_norm", "cost"):
            np.testing.assert_allclose(data[name][i], float(diag[name]), rtol=1e-10, atol=1e-12,
                                       err_msg=name)
        np.testing.assert_allclose(data["contact_forces"][i], np.asarray(diag["contact_forces"]),
                                   rtol=1e-10, atol=1e-12)
    tc = ctrl.problem.evaluate_constraints(data["x"][0], data["u"][0], data["t"][0])
    np.testing.assert_allclose(tc["ee_pose_error"].numpy(),
                               np.asarray(jp.evaluate_constraints(
                                   data["x"][0], data["u"][0], data["t"][0])["ee_pose_error"]),
                               rtol=0, atol=1e-10)
    assert np.isfinite(data["x"]).all() and np.isfinite(data["u"]).all()
    assert np.isfinite(data["object_displacement"]).all()
    assert (data["object_displacement"] < 0.01).all()
    # ticks at 0, 8 and 16 ms: the warm start, then one replan (at 16 ms)
    assert len(ctrl.replanning_durations) == 2
