"""The port's native real-time executor (``upright_tpu_torch/cpp/executor.cpp``
through ``runtime/native.py``), the cases of tests/test_native_executor.py
with the originals' limits.

The executor is the JAX package's C++ source, copied; the port builds it with
g++ into its own ``build/``.  Where a case is deterministic (explicit ticks),
the same calls go to the JAX package's executor and the commands and state
estimates agree to 1e-12.  The closed loop drives the port's plant and
manager on the CPU in float64.
"""

import time

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.runtime.native import NativeExecutor as JExecutor
from upright_tpu_torch.runtime.native import NativeExecutor

CPU64 = dict(device="cpu", dtype=torch.float64)
SAME = dict(rtol=0, atol=1e-12)


def make_policy(nq, N=10, dt=0.1, jerk=0.0, gain=0.0):
    nx = 3 * nq
    X = np.zeros((N + 1, nx))
    U = jerk * np.ones((N, nq))
    K = np.zeros((N, nq, nx))
    if gain:
        for k in range(N):
            K[k, :, :nq] = gain * np.eye(nq)
    return X, U, K


def both(nq, **kw):
    return NativeExecutor(nq, **kw), JExecutor(nq, **kw)


def test_tick_produces_command():
    nq = 3
    ex, jex = both(nq, rate=125.0)
    X, U, K = make_policy(nq, jerk=1.0)
    for e in (ex, jex):
        e.post_policy(0.0, 0.1, X, U, K)
        e.post_observation(0.0, np.zeros(nq), np.zeros(nq))
        e.tick(0.0)
    v_cmd, t = ex.get_command()
    assert v_cmd is not None
    # v_cmd = v + dt a + 0.5 dt^2 u with v = a = 0 -> 0.5 dt^2 * 1
    dt = 1.0 / 125.0
    assert np.allclose(v_cmd, 0.5 * dt**2 * 1.0, atol=1e-6)
    np.testing.assert_allclose(v_cmd, jex.get_command()[0], **SAME)
    ex.close()
    jex.close()


def test_kf_tracks_measurements():
    nq = 2
    ex, jex = both(nq, rate=100.0, kf_meas_var=1e-6)
    X, U, K = make_policy(nq)
    q = np.array([0.3, -0.2])
    v = np.array([0.1, 0.05])
    for e in (ex, jex):
        e.post_policy(0.0, 0.1, X, U, K)
        for i in range(50):
            e.post_observation(i * 0.01, q, v)
            e.tick(i * 0.01)
    x = ex.state_estimate()
    assert np.allclose(x[:nq], q, atol=1e-3)
    assert np.allclose(x[nq : 2 * nq], v, atol=1e-3)
    np.testing.assert_allclose(x, jex.state_estimate(), **SAME)
    ex.close()
    jex.close()


def test_feedback_gain_applied():
    nq = 2
    ex, jex = both(nq, rate=100.0, kf_meas_var=1e-8, kf_init_var=1e3)
    X, U, K = make_policy(nq, gain=-2.0)  # u = -2 (q - 0)
    q = np.array([1.0, 0.0])
    for e in (ex, jex):
        e.post_policy(0.0, 0.1, X, U, K)
        for i in range(30):
            e.post_observation(i * 0.01, q, np.zeros(nq))
            e.tick(i * 0.01)
    v_cmd, _ = ex.get_command()
    # u ~ -2 -> v_cmd ~ 0.5 dt^2 * (-2) (v and a estimates near zero)
    assert v_cmd[0] < 0
    assert abs(v_cmd[1]) < abs(v_cmd[0])
    np.testing.assert_allclose(v_cmd, jex.get_command()[0], **SAME)
    ex.close()
    jex.close()


def test_safety_brake_latches():
    nq = 2
    nx = 3 * nq
    ex = NativeExecutor(nq, rate=100.0, kf_meas_var=1e-8, kf_init_var=1e3)
    ex.set_state_limits(-0.5 * np.ones(nx), 0.5 * np.ones(nx), margin=0.0)
    X, U, K = make_policy(nq, jerk=1.0)
    ex.post_policy(0.0, 0.1, X, U, K)
    for i in range(20):
        ex.post_observation(i * 0.01, np.array([2.0, 0.0]), np.zeros(nq))
        ex.tick(i * 0.01)
    assert ex.braked
    v_cmd, _ = ex.get_command()
    assert np.allclose(v_cmd, 0.0)
    ex.close()


def test_realtime_thread_rate():
    nq = 2
    rate = 250.0
    ex = NativeExecutor(nq, rate=rate)
    X, U, K = make_policy(nq)
    ex.post_policy(0.0, 0.1, X, U, K)
    ex.post_observation(0.0, np.zeros(nq), np.zeros(nq))
    ex.start()
    time.sleep(0.5)
    ex.stop()
    stats = ex.stats()
    expected = 0.5 * rate
    assert stats["ticks"] == pytest.approx(expected, rel=0.25)
    # each tick fast and few overruns on an idle box
    assert stats["max_tick_seconds"] < 0.004
    ex.close()


def test_policy_switch_counting():
    nq = 2
    ex = NativeExecutor(nq, rate=100.0)
    X, U, K = make_policy(nq)
    ex.post_observation(0.0, np.zeros(nq), np.zeros(nq))
    for i in range(5):
        ex.post_policy(float(i), 0.1, X, U, K)
        ex.tick(i * 0.01)
    assert ex.stats()["policy_switches"] == 5
    ex.close()


def run_executor_loop(ctrl, sim, ex, ticks, replan_every=5, to_numpy=np.asarray):
    """The executor closed loop of the original test: the planner at
    125 / replan_every Hz posts policies, the executor (sim-time ticks) turns
    them into the velocity commands the plant runs.  Returns the plant state
    and the commands."""
    nq = sim.robot.nq
    state = sim.initial_state()
    dt = 1.0 / 125.0
    t = 0.0
    cmds = []
    for i in range(ticks):
        ex.post_observation(t, to_numpy(state.q).reshape(-1), to_numpy(state.v).reshape(-1))
        if i % replan_every == 0:
            ctrl.step(t, ex.state_estimate())  # replan from the executor's estimate
            sol = ctrl.solution
            X, U, K = (to_numpy(a).reshape(a.shape[-ndim:]) for a, ndim in (
                (sol.state.X, 2), (sol.state.U, 2), (sol.K, 3)))
            ex.post_policy(ctrl.last_plan_time, ctrl.problem.dt, X[:, : 3 * nq], U[:, :nq],
                           K[:, :nq, : 3 * nq])
        ex.tick(t)
        v_cmd, _ = ex.get_command()
        cmds.append(v_cmd)
        state = sim.step(state, v_cmd, n_steps=8)
        t += dt
    return state, np.asarray(cmds)


def test_executor_closed_loop_matches_reference():
    """20 ticks of the pipeline below at N = 5: the port's manager, executor
    and plant against the JAX package's, from the same start; the commands
    and the joints agree to 1e-8 (tests/test_torch_mpc.py's tolerance)."""
    from upright_tpu.ocp.problem import build_problem as jbuild
    from upright_tpu.sim.simulation import UprightSimulation as JSim
    from upright_tpu.solver.mpc import ControllerManager as JManager
    from upright_tpu_torch.ocp.problem import build_problem as tbuild
    from upright_tpu_torch.sim.simulation import UprightSimulation
    from upright_tpu_torch.solver.mpc import ControllerManager

    conf = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    sim, jsim = UprightSimulation(conf["simulation"], **CPU64), JSim(conf["simulation"])
    nq = sim.robot.nq
    x0 = np.concatenate([sim.initial_state().q[0].numpy(), np.zeros(2 * nq)])
    runs = []
    for ctrl, plant, executor, to_numpy in (
        (ControllerManager(tbuild(conf, N=5, **CPU64)), sim, NativeExecutor, lambda a: a.numpy()),
        (JManager(jbuild(conf, N=5)), jsim, JExecutor, np.asarray),
    ):
        ex = executor(nq, rate=125.0, kf_meas_var=1e-6, x0=x0)
        state, cmds = run_executor_loop(ctrl, plant, ex, ticks=20, to_numpy=to_numpy)
        runs.append((to_numpy(state.q).reshape(-1), cmds, ex.state_estimate()))
        ex.close()
    (q, cmds, x_est), (jq, jcmds, jx_est) = runs
    np.testing.assert_allclose(cmds, jcmds, rtol=0, atol=1e-8)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-8)
    np.testing.assert_allclose(x_est, jx_est, rtol=0, atol=1e-8)
    assert np.abs(cmds).max() > 1e-4  # the robot moves


def test_executor_closed_loop_with_sim():
    """Full pipeline: the port's planner posts policies to the native
    executor, the executor (sim-time ticks) produces velocity commands
    driving the port's plant: the mpc_node/mrt_node split.  The JAX
    package's case runs 250 ticks (2 s) and asks for an EE error below
    0.15 m; this one runs 100 (0.8 s), because the port's plain plant takes
    0.4 s a tick on the CPU, and asks the EE to close in on the waypoint by
    5 cm.  The test above holds 20 ticks of this loop to the JAX package's."""
    from upright_tpu_torch.sim.simulation import UprightSimulation
    from upright_tpu_torch.solver.mpc import ControllerManager

    path = jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    conf = jcfg.load_config(path)
    sim = UprightSimulation(conf["simulation"], **CPU64)
    ctrl = ControllerManager.from_config(conf, **CPU64)
    nq = sim.robot.nq
    target = ctrl.target.poses[0, :3].numpy()

    state = sim.initial_state()
    err0 = float(np.linalg.norm(sim.ee_pose(state)[1][0] - target))
    x0 = np.concatenate([state.q[0].numpy(), np.zeros(2 * nq)])
    ex = NativeExecutor(nq, rate=125.0, kf_meas_var=1e-6, x0=x0)

    replan_every = 5  # planner at 25 Hz, tracker at 125 Hz
    dt = 1.0 / 125.0
    t = 0.0
    for i in range(100):  # 0.8 seconds
        ex.post_observation(t, state.q[0].numpy(), state.v[0].numpy())
        if i % replan_every == 0:
            ctrl.step(t, ex.state_estimate())  # replan from the executor's estimate
            sol = ctrl.solution
            ex.post_policy(
                ctrl.last_plan_time, ctrl.problem.dt,
                sol.state.X[0, :, : 3 * nq].numpy(),
                sol.state.U[0, :, :nq].numpy(),
                sol.K[0, :, :nq, : 3 * nq].numpy(),
            )
        ex.tick(t)
        v_cmd, _ = ex.get_command()
        state = sim.step(state, torch.as_tensor(v_cmd), n_steps=8)
        t += dt

    assert not ex.braked
    # EE closing in on the waypoint
    _, r_ew = sim.ee_pose(state)
    err = float(np.linalg.norm(r_ew[0] - target))
    assert err < err0 - 0.05, f"EE error {err0:.3f} -> {err:.3f}"
    # bottle stayed balanced
    disp = sim.object_displacements(state)
    assert (disp < 0.05).all()

