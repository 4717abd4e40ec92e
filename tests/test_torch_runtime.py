"""The port's runtime layer (``upright_tpu_torch/runtime/``: the Kalman
filters, the projectile tracker, the safety monitor, the policy, the tracking
controller and the asynchronous planner) against the JAX package's, in float64
on the CPU.

Each case of tests/test_runtime.py runs on the port with the original's
limits, and the same inputs, made with numpy from the original's seeds, go
through the JAX package's counterpart.  The filters, the tracker and the
policy are the same numpy code on both sides: they agree to 1e-12.  The
asynchronous planner publishes the port's solution of ur10_demo at N = 5; it
is held to the JAX planner's on the same observations at 1e-8, the tolerance
of tests/test_torch_mpc.py.
"""

import time

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.runtime import estimator as jest
from upright_tpu.runtime import projectile as jproj
from upright_tpu.runtime import safety as jsafety
from upright_tpu.runtime import tracker as jtracker
from upright_tpu.solver import trajectory as jtraj
from upright_tpu.solver.mpc import ControllerManager as JManager
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.runtime.estimator import projectile_kf, robot_kf
from upright_tpu_torch.runtime.projectile import FlightPhase, ProjectileTracker, fit_ballistic_motion
from upright_tpu_torch.runtime.safety import SafetyMonitor
from upright_tpu_torch.runtime.tracker import AsyncPlanner, Policy, TrackingController
from upright_tpu_torch.solver.mpc import ControllerManager

CPU64 = dict(device="cpu", dtype=torch.float64)
SAME = dict(rtol=0, atol=1e-12)
N = 5


def test_robot_kf_converges():
    """KF tracks a triple-integrator trajectory from noisy measurements."""
    nq, dt = 2, 0.008
    rng = np.random.default_rng(0)
    kf, jkf = robot_kf(nq, dt, measurement_variance=1e-4), jest.robot_kf(nq, dt, measurement_variance=1e-4)

    q = np.zeros(nq)
    v = np.zeros(nq)
    a = np.zeros(nq)
    for i in range(500):
        u = np.array([np.sin(0.01 * i), np.cos(0.01 * i)])
        q = q + dt * v + 0.5 * dt**2 * a + dt**3 / 6 * u
        v = v + dt * a + 0.5 * dt**2 * u
        a = a + dt * u
        y = np.concatenate([q, v]) + 1e-3 * rng.standard_normal(2 * nq)
        for f in (kf, jkf):
            f.predict(u)
            f.correct(y)
        np.testing.assert_allclose(kf.x, jkf.x, **SAME)

    np.testing.assert_allclose(kf.P, jkf.P, **SAME)
    assert np.allclose(kf.x[:nq], q, atol=5e-3)
    assert np.allclose(kf.x[nq : 2 * nq], v, atol=5e-3)
    assert np.allclose(kf.x[2 * nq :], a, atol=5e-2)


def test_projectile_kf_tracks_ballistic():
    dt = 0.01
    kf, jkf = projectile_kf(dt), jest.projectile_kf(dt)
    g = np.array([0, 0, -9.81])
    r = np.array([0.0, 0, 2.0])
    v = np.array([1.0, 0.5, 3.0])
    for f in (kf, jkf):
        f.x[:3] = r
        f.x[3:] = v
    for _ in range(100):
        r = r + dt * v + 0.5 * dt**2 * g
        v = v + dt * g
        y = r + 1e-4 * np.random.default_rng(1).standard_normal(3)
        for f in (kf, jkf):
            f.predict(f.gravity)
            f.correct(y)
        assert kf.nis(y) == pytest.approx(jkf.nis(y), rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(kf.x, jkf.x, **SAME)
    assert np.allclose(kf.x[:3], r, atol=1e-2)
    assert np.allclose(kf.x[3:], v, atol=5e-2)


def test_projectile_tracker_state_machine():
    dt = 0.01
    tracker = ProjectileTracker(dt, activation_height=1.0, deactivation_height=0.2)
    jtrk = jproj.ProjectileTracker(dt, activation_height=1.0, deactivation_height=0.2)
    assert tracker.phase == FlightPhase.PREFLIGHT

    # ball thrown upward from z=0.1
    g = np.array([0, 0, -9.81])
    r = np.array([0.0, 0, 0.1])
    v = np.array([0.5, 0, 6.0])
    phases = []
    for _ in range(150):
        r = r + dt * v + 0.5 * dt**2 * g
        v = v + dt * g
        obs_state, s = tracker.update(r)
        j_state, j_s = jtrk.update(r)
        np.testing.assert_allclose(obs_state, j_state, **SAME)
        assert (tracker.phase.value, s) == (jtrk.phase.value, j_s)
        phases.append((tracker.phase, s))
    seen = [p for p, _ in phases]
    assert FlightPhase.FLIGHT in seen
    assert phases[-1][0] == FlightPhase.POSTFLIGHT
    # s flag was 1 only during flight
    s_during = [s for p, s in phases if p == FlightPhase.FLIGHT]
    assert all(s == 1.0 for s in s_during)
    assert phases[-1][1] == 0.0


@pytest.mark.parametrize("drag", [False, True])
def test_fit_ballistic_motion(drag):
    t = np.linspace(0, 1, 50)
    r0 = np.array([1.0, 2.0, 0.5])
    v0 = np.array([0.5, -1.0, 4.0])
    g = np.array([0, 0, -9.81])
    pos = r0[None] + t[:, None] * v0[None] + 0.5 * t[:, None] ** 2 * g[None]
    fit = fit_ballistic_motion(t, pos, drag=drag)
    for a, b in zip(fit, jproj.fit_ballistic_motion(t, pos, drag=drag)):
        np.testing.assert_allclose(a, b, **SAME)
    r0_fit, v0_fit, a_fit = fit[:3]
    assert np.allclose(r0_fit, r0, atol=1e-8)
    assert np.allclose(v0_fit, v0, atol=1e-8)
    assert np.allclose(a_fit, g, atol=1e-6)


def test_safety_monitor():
    kw = dict(
        state_lower=np.array([-1.0, -1.0]),
        state_upper=np.array([1.0, 1.0]),
        input_lower=np.array([-5.0]),
        input_upper=np.array([5.0]),
        state_margin=0.1,
        input_margin=0.5,
        enforce_state=True,
        enforce_input=True,
    )
    mon, jmon = SafetyMonitor(**kw), jsafety.SafetyMonitor(**kw)
    ok, _ = mon.check(np.array([0.5, 0.0]), np.array([1.0]))
    assert ok
    ok, reason = mon.check(np.array([1.2, 0.0]), np.array([1.0]))
    assert not ok and "state" in reason
    ok, reason = mon.check(np.array([0.0, 0.0]), np.array([6.0]))
    assert not ok and "input" in reason
    # within margin: allowed
    ok, _ = mon.check(np.array([1.05, 0.0]), np.array([5.2]))
    assert ok
    rng = np.random.default_rng(2)
    for _ in range(200):
        x, u = rng.uniform(-1.3, 1.3, 2), rng.uniform(-6.0, 6.0, 1)
        assert mon.check(x, u) == jmon.check(x, u)


def test_safety_ee_box_through_the_port_kinematics():
    """The EE-position box of ur10_demo's controller config, checked through
    the port's forward kinematics on the CPU, decides as the JAX monitor
    does at joint positions around home."""
    config = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    ctrl_conf = dict(config["controller"])
    ctrl_conf["tracking"] = {**ctrl_conf.get("tracking", {}), "enforce_ee_position_limits": True}
    ctrl_conf["end_effector_box_constraint"] = {
        "enabled": True, "xyz_lower": [-0.2, -0.2, -0.1], "xyz_upper": [0.2, 0.2, 0.1]}
    jp = jbuild(config, N=N)
    tp = tbuild(config, N=N, **CPU64)
    mon = SafetyMonitor.from_config(ctrl_conf, robot=tp.robot, device="cpu")
    jmon = jsafety.SafetyMonitor.from_config(ctrl_conf, robot=jp.robot)
    _, r0 = tp.robot.ee_pose(tp.x0[: tp.dims.robot_q])
    rng = np.random.default_rng(3)
    nq = tp.dims.robot_q
    decisions = []
    for _ in range(20):
        q = tp.x0[:nq].numpy() + rng.uniform(-0.3, 0.3, nq)
        decision = mon.ee_position_violated(q, r0.numpy())
        assert decision == jmon.ee_position_violated(q, r0.numpy())
        decisions.append(decision)
    assert any(decisions) and not all(decisions)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SafetyMonitor.from_config(ctrl_conf, robot=tp.robot).ee_position_violated(
            tp.x0[:nq].numpy())


def test_policy_evaluation_and_tracker_tick():
    nq = 2
    N_ = 5
    dt = 0.1
    X = np.zeros((N_ + 1, 3 * nq))
    X[:, 0] = np.linspace(0, 1, N_ + 1)  # q_0 ramps up
    U = np.ones((N_, nq))
    K = np.zeros((N_, nq, 3 * nq))
    pol = Policy(t0=0.0, dt=dt, X=X, U=U, K=K)

    xd, u = pol.evaluate(0.05, X[0])
    assert np.isclose(xd[0], 0.1)  # halfway interpolation
    assert np.allclose(u, 1.0)

    # feedback: K nonzero responds to state error
    K[:, 0, 0] = -2.0
    x_off = X[0].copy()
    x_off[0] += 0.5
    _, u_fb = pol.evaluate(0.0, x_off)
    assert np.isclose(u_fb[0], 1.0 - 1.0)

    trk = TrackingController(nq=nq, rate=125, use_kf=True)
    v_cmd, x_est, u_cmd = trk.tick(0.0, np.zeros(nq), np.zeros(nq), pol)
    assert v_cmd.shape == (nq,)
    assert not trk.braked

    # the port's policy and tracker against the JAX package's, over ticks
    # with feedback, extra PD gains and noisy measurements
    rng = np.random.default_rng(4)
    jpol = jtracker.Policy(t0=0.0, dt=dt, X=X, U=U, K=K)
    kw = dict(nq=nq, rate=125, kp=0.5, kv=0.2, ka=0.1)
    trk, jtrk = TrackingController(**kw), jtracker.TrackingController(**kw)
    for i in range(40):
        t = i / 125.0
        q, v = rng.standard_normal(nq) * 0.1, rng.standard_normal(nq) * 0.1
        for a, b in zip(trk.tick(t, q, v, pol), jtrk.tick(t, q, v, jpol)):
            np.testing.assert_allclose(a, b, **SAME)
        for a, b in zip(pol.evaluate(t, x_off), jpol.evaluate(t, x_off)):
            np.testing.assert_allclose(a, b, **SAME)

    # safety braking
    mon = SafetyMonitor(
        state_lower=-0.1 * np.ones(3 * nq), state_upper=0.1 * np.ones(3 * nq),
        state_margin=0.0, enforce_state=True,
    )
    trk2 = TrackingController(nq=nq, rate=125, safety=mon)
    v_cmd, _, _ = trk2.tick(0.0, 5 * np.ones(nq), np.zeros(nq), pol)
    assert trk2.braked
    assert np.allclose(v_cmd, 0.0)


def test_trajectory_toolkit(tmp_path):
    from upright_tpu_torch.solver.trajectory import (
        DoubleIntegrator,
        QuinticInterpolator,
        StateInputMapping,
        StateInputTrajectory,
        TrajectoryInterpolator,
    )

    di = DoubleIntegrator(2)
    v, a = di.step(np.zeros(2), np.ones(2), np.zeros(2), 0.1)
    assert np.allclose(v, 0.1) and np.allclose(a, 1.0)

    ts = np.linspace(0, 1, 11)
    xs = np.stack([np.full(6, t) for t in ts])
    us = np.zeros((10, 2))
    traj = StateInputTrajectory(ts=ts, xs=xs, us=us)
    traj.save(tmp_path / "plan.npz")
    loaded = StateInputTrajectory.load(tmp_path / "plan.npz")
    assert np.allclose(loaded.xs, xs)

    interp = TrajectoryInterpolator(loaded, nq=2)
    x, u = interp.interpolate(0.55)
    assert np.allclose(x, 0.55, atol=1e-9)
    jx, ju = jtraj.TrajectoryInterpolator(jtraj.StateInputTrajectory.load(tmp_path / "plan.npz"),
                                          nq=2).interpolate(0.55)
    np.testing.assert_allclose(x, jx, **SAME)
    np.testing.assert_allclose(u, ju, **SAME)

    m = StateInputMapping(2)
    q, v, a = m.xva(np.arange(6.0))
    assert np.allclose(q, [0, 1]) and np.allclose(a, [4, 5])

    # quintic hits its boundary conditions
    quin = QuinticInterpolator(0, 1, [0.0], [0.0], [0.0], [1.0], [0.0], [0.0])
    p0, v0, a0 = quin.eval(0.0)
    p1, v1, a1 = quin.eval(1.0)
    assert np.isclose(p0[0], 0) and np.isclose(p1[0], 1)
    assert np.isclose(v1[0], 0, atol=1e-9) and np.isclose(a1[0], 0, atol=1e-8)
    pm, _, _ = quin.eval(0.5)
    assert np.isclose(pm[0], 0.5)
    jquin = jtraj.QuinticInterpolator(0, 1, [0.0], [0.0], [0.0], [1.0], [0.0], [0.0])
    for s in (0.1, 0.5, 0.9):
        for a_, b_ in zip(quin.eval(s), jquin.eval(s)):
            np.testing.assert_allclose(a_, b_, **SAME)


@pytest.fixture(scope="module")
def planners():
    """(JAX planner, port planner) on ur10_demo at N = 5."""
    config = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    return (jtracker.AsyncPlanner(JManager(jbuild(config, N=N))),
            AsyncPlanner(ControllerManager(tbuild(config, N=N, **CPU64))))


def test_async_planner_publishes_the_reference_policy(planners):
    """The warm start and two replans from the same observations: each
    published policy (host arrays) equals the JAX planner's, and so does
    Policy.evaluate at times between the nodes."""
    jplanner, planner = planners
    rng = np.random.default_rng(5)
    x0 = np.asarray(jplanner.ctrl.problem.x0) + 0.01 * rng.standard_normal(
        jplanner.ctrl.problem.ocp.nx)
    assert not planner.solve_once()  # no observation yet
    for t in (0.0, 0.01, 0.03):
        x = x0 + (0.003 * rng.standard_normal(x0.shape) if t else 0.0)
        for p in (jplanner, planner):
            p.set_observation(t, x)
            assert p.solve_once()
        pol, jpol = planner.get_policy(), jplanner.get_policy()
        ocp = planner.ctrl.problem.ocp
        assert isinstance(pol.X, np.ndarray) and pol.K.shape == (N, ocp.nu, ocp.nx)
        assert (pol.t0, pol.dt) == (jpol.t0, jpol.dt)
        for f in ("X", "U", "K"):
            np.testing.assert_allclose(getattr(pol, f), np.asarray(getattr(jpol, f)),
                                       rtol=1e-8, atol=1e-8, err_msg=f"t={t} {f}")
        for tau in (0.0, 0.004, 0.013, 0.25):
            xq = x + 0.002 * rng.standard_normal(x.shape)
            for a, b in zip(pol.evaluate(t + tau, xq), jpol.evaluate(t + tau, xq)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-8)
    assert len(planner.ctrl.replanning_durations) == 3


def test_async_planner_thread_replans(planners):
    """The background thread replans from the newest observation and
    publishes new policies until stopped."""
    _, planner = planners
    x = planner.ctrl.problem.x0.numpy()
    n0 = len(planner.ctrl.replanning_durations)
    planner.set_observation(0.05, x)
    planner.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(planner.ctrl.replanning_durations) < n0 + 3 and time.monotonic() < deadline:
            planner.set_observation(0.05 + 0.01 * (len(planner.ctrl.replanning_durations) - n0), x)
            time.sleep(0.01)
    finally:
        planner.stop()
    assert planner.error is None
    assert len(planner.ctrl.replanning_durations) >= n0 + 3
    assert planner.get_policy().t0 >= 0.05


@pytest.mark.slow
def test_launch_stack_closed_loop():
    """The planner as a separate OS process (``runtime/launch.py``
    PlannerNode, on the CPU) and a short closed loop against the port's plant
    and the native executor: the mpc_node / mrt_node split as real processes
    (tests/test_launch.py on the port)."""
    from upright_tpu_torch.runtime.launch import PlannerNode
    from upright_tpu_torch.runtime.native import NativeExecutor
    from upright_tpu_torch.sim.simulation import UprightSimulation

    path = jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    config = jcfg.load_config(path)
    sim = UprightSimulation(config["simulation"], **CPU64)
    nq = sim.robot.nq
    state = sim.initial_state()
    x0 = np.concatenate([state.q[0].numpy(), np.zeros(2 * nq)])

    planner = PlannerNode(path, min_update_time=0.01, device="cpu")
    try:
        planner.set_observation(0.0, x0)
        planner.wait_ready(timeout=600.0)
        assert planner.compile_seconds > 0

        pol = planner.get_policy()
        deadline = time.monotonic() + 30.0
        while pol is None and time.monotonic() < deadline:
            time.sleep(0.05)
            pol = planner.get_policy()
        assert pol is not None, "no policy after ready"

        scale = 0.02  # slow motion: CPU planner replans keep up
        executor = NativeExecutor(nq, rate=125.0, x0=x0, time_scale=scale)
        executor.post_policy(pol.t0, pol.dt, pol.X[:, : 3 * nq],
                             pol.U[:, :nq], pol.K[:, :nq, : 3 * nq])
        executor.start(t_now=0.0)
        try:
            dt = 1.0 / 125.0
            t = 0.0
            t_wall0 = time.perf_counter()
            switches = 0
            while t < 1.0:
                executor.post_observation(t, state.q[0].numpy(), state.v[0].numpy())
                planner.set_observation(t, executor.state_estimate())
                new_pol = planner.get_policy()
                if new_pol is not None and new_pol is not pol:
                    pol = new_pol
                    switches += 1
                    executor.post_policy(pol.t0, pol.dt, pol.X[:, : 3 * nq],
                                         pol.U[:, :nq], pol.K[:, :nq, : 3 * nq])
                v_cmd, _ = executor.get_command()
                if v_cmd is None:
                    v_cmd = np.zeros(nq)
                state = sim.step(state, torch.as_tensor(v_cmd),
                                 n_steps=max(1, int(dt / sim.timestep)))
                t += dt
                lag = (t_wall0 + t / scale) - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
        finally:
            executor.stop()

        assert switches > 0, "planner process produced no new policies"
        disp = sim.object_displacements(state)
        assert (disp < 0.05).all(), disp
        assert planner.alive
    finally:
        planner.stop()


def test_runtime_demo_runs_on_the_cpu():
    """scripts/runtime_demo.run_demo on ur10_demo at N = 5 in slow motion:
    the planner thread replans, the executor ticks once a plant step of
    simulated time without overruns, and the plant stays finite."""
    from upright_tpu_torch.scripts.runtime_demo import run_demo

    config = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    config["controller"].setdefault("mpc", {})["time_horizon"] = 0.5
    out = run_demo(config, duration=0.04, time_scale=0.05, device="cpu")
    stats = out["executor"]
    assert stats["overruns"] == 0 and stats["ticks"] > 0
    assert out["replan_s"].size > 0 and out["busy_s"].size == 5
    assert np.isfinite(out["ee_error"]) and np.isfinite(out["object_displacement"]).all()


def test_launch_stack_script_runs_on_the_cpu():
    """scripts/launch_stack.run_stack with the planner process on the CPU."""
    from upright_tpu_torch.scripts.launch_stack import run_stack

    path = jcfg.resolve_package_path({"package": "configs", "path": "demos/ur10_demo.yaml"})
    out = run_stack(path, duration=0.04, time_scale=0.05, device="cpu")
    assert out["startup_s"] > 0 and out["first_policy"] is not None and out["planner_alive"]
    assert out["executor"]["overruns"] == 0
    assert np.isfinite(out["object_displacement"]).all()
