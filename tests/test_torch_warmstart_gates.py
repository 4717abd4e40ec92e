"""The warm-start shift/heal gates of the port (``UprightProblem
.shift_warm_start`` / ``heal_warm_start``), the cases of
tests/test_warmstart_gates.py with the originals' limits, on ur10_demo in
float64 on the CPU.

The gates act on the port's own converged state (its manager's cold solve);
each case also applies the JAX package's gate to the same state and inputs
and holds the port to it at 1e-12 (the same arithmetic, elementwise).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as cfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu_torch.convert import solver_state_to_numpy
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.solver.mpc import ControllerManager

CPU64 = dict(device="cpu", dtype=torch.float64)
SAME = dict(rtol=0, atol=1e-12)
FIELDS = ("X", "U", "lam", "mu")


@pytest.fixture(scope="module")
def ur10_config():
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    return cfg.load_config(path)


@pytest.fixture(scope="module")
def warm(ur10_config):
    """A converged solver state to perturb, and the JAX problem."""
    mgr = ControllerManager.from_config(ur10_config, **CPU64)
    sol = mgr.warmstart()
    return mgr.problem, sol.state, jbuild(ur10_config)


def as_jax(state):
    return JState(**{k: jnp.asarray(v[0]) for k, v in solver_state_to_numpy(state).items()})


def assert_matches_reference(out, jout):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f)[0].numpy(), np.asarray(getattr(jout, f)),
                                   err_msg=f, **SAME)


def _jump_x0(problem, state, size):
    """x0 displaced from the plan head by ``size`` in joint-position norm."""
    nq = problem.dims.robot_q
    x0 = state.X[0, 0].numpy().copy()
    direction = np.ones(nq) / np.sqrt(nq)
    x0[:nq] += size * direction
    return x0


def heal(problem, state, x0):
    return problem.heal_warm_start(state, torch.as_tensor(x0)[None])


@pytest.mark.parametrize("size", [0.0, 0.05, 0.19])
def test_heal_keeps_plan_below_threshold(warm, size):
    """Below the gate the stored (near-optimal) robot trajectory is kept
    verbatim: healing must not touch it during normal tracking drift."""
    problem, state, jp = warm
    x0 = _jump_x0(problem, state, size)
    healed = heal(problem, state, x0)
    np.testing.assert_array_equal(healed.X.numpy(), state.X.numpy())
    assert_matches_reference(healed, jp.heal_warm_start(as_jax(state), jnp.asarray(x0)))


@pytest.mark.parametrize("size", [0.21, 0.5, 1.5])
def test_heal_rerolls_plan_above_threshold(warm, size):
    """Above the gate the state trajectory is re-rolled from x0 through the
    stored inputs: head pinned at x0, tail dynamically consistent."""
    problem, state, jp = warm
    x0 = _jump_x0(problem, state, size)
    healed = heal(problem, state, x0)
    X = healed.X[0].numpy()
    np.testing.assert_allclose(X[0], x0, atol=1e-12)
    # every stage satisfies the (exact) dynamics through the stored inputs
    for k in range(problem.ocp.N):
        x_next = problem.ocp.dynamics(healed.X[:, k], state.U[:, k], None)[0].numpy()
        np.testing.assert_allclose(X[k + 1], x_next, atol=1e-9)
    # inputs/multipliers are untouched by healing
    np.testing.assert_array_equal(healed.U.numpy(), state.U.numpy())
    assert_matches_reference(healed, jp.heal_warm_start(as_jax(state), jnp.asarray(x0)))


def test_heal_gate_boundary_is_sharp(warm):
    """The gate flips exactly at the configured threshold: 0.2-eps keeps,
    0.2+eps re-rolls (the default threshold is 0.2 rad)."""
    problem, state, jp = warm
    assert problem.heal_jump_threshold == pytest.approx(0.2)
    eps = 1e-6
    kept = heal(problem, state, _jump_x0(problem, state, 0.2 - eps))
    rolled = heal(problem, state, _jump_x0(problem, state, 0.2 + eps))
    np.testing.assert_array_equal(kept.X.numpy(), state.X.numpy())
    assert not np.allclose(rolled.X.numpy(), state.X.numpy())
    x0 = _jump_x0(problem, state, 0.2 + eps)
    assert_matches_reference(rolled, jp.heal_warm_start(as_jax(state), jnp.asarray(x0)))


def test_heal_threshold_from_config(ur10_config):
    """controller.mpc.heal_jump_threshold moves the gate."""
    config = copy.deepcopy(ur10_config)
    config["controller"].setdefault("mpc", {})["heal_jump_threshold"] = 0.6
    problem = build_problem(config, **CPU64)
    assert problem.heal_jump_threshold == pytest.approx(0.6)
    assert jbuild(config).heal_jump_threshold == problem.heal_jump_threshold

    mgr = ControllerManager(problem)
    state = mgr.warmstart().state
    # a 0.4 jump would re-roll at the default 0.2 gate but is kept at 0.6
    x0 = _jump_x0(problem, state, 0.4)
    healed = heal(problem, state, x0)
    np.testing.assert_array_equal(healed.X.numpy(), state.X.numpy())
    # ... and 0.8 still re-rolls
    x0_big = _jump_x0(problem, state, 0.8)
    healed = heal(problem, state, x0_big)
    np.testing.assert_allclose(healed.X[0, 0].numpy(), x0_big, atol=1e-12)


def test_shift_zero_is_identity(warm):
    problem, state, jp = warm
    shifted = problem.shift_warm_start(state, 0.0)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(shifted, f).numpy(), getattr(state, f).numpy(),
                                   atol=1e-12)
    assert_matches_reference(shifted, jp.shift_warm_start(as_jax(state), 0.0))


def test_shift_integer_rows(warm):
    """An integer shift moves rows up with tail clamping (OCS2 interpolates
    the previous solution at the new query times; beyond the horizon the
    last stage extrapolates flat)."""
    problem, state, jp = warm
    shifted = problem.shift_warm_start(state, 2.0)
    X, U = state.X[0].numpy(), state.U[0].numpy()
    Xs, Us = shifted.X[0].numpy(), shifted.U[0].numpy()
    N = U.shape[0]
    np.testing.assert_allclose(Xs[: N - 1], X[2 : N + 1], atol=1e-12)
    np.testing.assert_allclose(
        Xs[N - 1 :], np.broadcast_to(X[N], (2, X.shape[1])), atol=1e-12
    )  # clamped tail
    np.testing.assert_allclose(Us[: N - 2], U[2:], atol=1e-12)
    np.testing.assert_allclose(
        Us[N - 2 :], np.broadcast_to(U[N - 1], (2, U.shape[1])), atol=1e-12
    )
    assert_matches_reference(shifted, jp.shift_warm_start(as_jax(state), 2.0))


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75])
def test_shift_fractional_interpolates(warm, frac):
    """A fractional shift is the linear interpolation of the two integer
    shifts: the property that makes replan cadence independent of dt."""
    problem, state, jp = warm
    lo = problem.shift_warm_start(state, 1.0)
    hi = problem.shift_warm_start(state, 2.0)
    mid = problem.shift_warm_start(state, 1.0 + frac)
    for field in FIELDS:
        a = getattr(lo, field).numpy()
        b = getattr(hi, field).numpy()
        m = getattr(mid, field).numpy()
        np.testing.assert_allclose(m, (1 - frac) * a + frac * b, atol=1e-9)
    assert_matches_reference(mid, jp.shift_warm_start(as_jax(state), 1.0 + frac))


def test_shift_negative_clamps_to_zero(warm):
    """Negative shifts (clock skew) clamp to the unshifted plan."""
    problem, state, jp = warm
    shifted = problem.shift_warm_start(state, -0.3)
    np.testing.assert_allclose(shifted.X.numpy(), state.X.numpy(), atol=1e-12)
    assert_matches_reference(shifted, jp.shift_warm_start(as_jax(state), -0.3))


@pytest.mark.slow
def test_closed_loop_brake_reengage_near_threshold(ur10_config):
    """Closed loop with a brake/re-engage whose jump lands right at the
    gate: the loop must recover for jumps on both sides of the threshold."""
    from upright_tpu_torch.sim.simulation import UprightSimulation

    for bump in (0.18, 0.25):  # straddle the 0.2 gate
        config = copy.deepcopy(ur10_config)
        sim = UprightSimulation(config["simulation"], **CPU64)
        ctrl = ControllerManager.from_config(config, **CPU64)
        state = sim.initial_state()
        nq = sim.robot.nq
        a_state = np.zeros(nq)
        dt_ctrl = 1.0 / 50.0
        n_sub = max(1, int(round(dt_ctrl / sim.timestep)))

        t = 0.0
        bumped = False
        for _ in range(int(4.0 / dt_ctrl)):
            q, v = state.q[0].numpy(), state.v[0].numpy()
            x = np.concatenate([q, v, a_state])
            xd, u = ctrl.step(t, x)
            assert np.all(np.isfinite(u)), f"non-finite input at t={t}, bump={bump}"
            v_cmd = v + dt_ctrl * a_state + 0.5 * dt_ctrl**2 * u[:nq]
            a_state = a_state + dt_ctrl * u[:nq]
            state = sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub)
            t += dt_ctrl
            if not bumped and t >= 1.0:
                dq = torch.zeros(nq, dtype=torch.float64)
                dq[0] = bump
                state = state.replace(q=state.q + dq)
                bumped = True

        target_r = ctrl.target.poses[0, :3].numpy()
        _, r_ew = sim.ee_pose(state)
        assert np.linalg.norm(r_ew[0] - target_r) < 0.1, f"bump={bump}"
        assert float(ctrl.solution.eq_viol[0]) < 1e-2, f"bump={bump}"
