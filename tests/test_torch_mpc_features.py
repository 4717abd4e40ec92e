"""The port's MPC manager on a problem with a dynamic obstacle in x
(ral23/sudden_obstacle/sudden_t1.0.yaml) against the JAX package's, in
float64 on the CPU: ``step`` and ``plan`` to 1e-8, as tests/test_torch_mpc.py
holds them on ur10_demo.  Both managers own a problem of N = 5 stages.
"""

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver.mpc import ControllerManager as JManager
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.solver.mpc import ControllerManager

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TOL = dict(rtol=1e-8, atol=1e-8)


SUDDEN = "ral23/sudden_obstacle/sudden_t1.0.yaml"


@pytest.fixture(scope="module")
def managers():
    """(JAX manager, port manager) on sudden_t1.0 with N = 5."""
    config = jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": SUDDEN}))
    return JManager(jbuild(config, N=N)), ControllerManager(tbuild(config, N=N, **CPU64))


def assert_solutions_equal(tm, jm, label):
    for f in ("X", "U", "lam", "mu", "lam_f"):
        np.testing.assert_allclose(getattr(tm.state, f)[0].numpy(), getattr(jm.state, f),
                                   err_msg=f"{label} {f}", **TOL)
    np.testing.assert_allclose(tm.solution.K[0].numpy(), jm.solution.K,
                               err_msg=f"{label} K", **TOL)


def test_manager_matches_reference_with_obstacle(managers):
    """warmstart, then steps at 10 ms (replan), 15 ms (no replan) and 30 ms
    (replan) with the obstacle's state in x moving between the steps."""
    jm, tm = managers
    jm.reset()
    tm.reset()
    assert tm.problem.dims.num_obstacles == 1 and tm.problem.ocp.nx == 36
    rng = np.random.default_rng(1)
    x0 = np.asarray(jm.problem.x0) + 0.01 * rng.standard_normal(jm.problem.ocp.nx)
    jm.warmstart(0.0, x0)
    tm.warmstart(0.0, x0)
    assert_solutions_equal(tm, jm, "warmstart")
    for t in (0.01, 0.015, 0.03):
        x = x0 + 0.003 * rng.standard_normal(x0.shape)
        x[27:30] += [-0.25 * t, 0.5 * t, 0.0]  # the chair slides toward its new place
        xd_j, u_j = jm.step(t, x)
        xd_t, u_t = tm.step(t, x)
        assert tm.last_plan_time == jm.last_plan_time
        np.testing.assert_allclose(xd_t, np.asarray(xd_j), err_msg=f"t={t} xd", **TOL)
        np.testing.assert_allclose(u_t, np.asarray(u_j), err_msg=f"t={t} u", **TOL)
        assert_solutions_equal(tm, jm, f"t={t}")


def test_plan_matches_reference_with_obstacle(managers):
    """plan() integrates the obstacle states with the robot's: the
    rolled-out trajectory equals the reference's."""
    jm, tm = managers
    jm.reset()
    tm.reset()
    x0 = np.asarray(jm.problem.x0).copy()
    x0[30:33] = [0.2, -0.1, 0.0]  # a moving obstacle
    jt = jm.plan(timestep=0.01, duration=0.03, x0=x0)
    tt = tm.plan(timestep=0.01, duration=0.03, x0=x0)
    assert len(tt) == len(jt) == 4
    np.testing.assert_allclose(tt.xs, jt.xs, **TOL)
    np.testing.assert_allclose(tt.us, jt.us, **TOL)
    np.testing.assert_allclose(tt.xs[-1, 27:30], x0[27:30] + 0.03 * x0[30:33], rtol=0,
                               atol=1e-12)
