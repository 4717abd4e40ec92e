"""The port's closed-loop script and device loop on the obstacle course, in
float64 on the CPU:

- the closed-loop script on ral23/static_obstacles/full_bottle_point1.yaml
  logs collision rows, cones and limits equal to the JAX problem's at the
  same (x, u, t), feeds a sudden obstacle's state into the tail of x, and
  runs the projectile tracker as the JAX script does;
- the device loop equals the port's host loop on full_bottle_point1, tick
  for tick.

The problems have N = 5 stages (a horizon of 0.5 s), and the cold solve of
full_bottle_point1 takes 12 iterations instead of the config's 150, to keep
the CPU runs short; both sides of each comparison run the same settings.
The slow tests port the JAX package's closed-loop checks of obstacle
avoidance (tests/test_obstacles.py) and of a frictional box
(tests/test_frictional.py) at the configs' own settings.
"""

import copy

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu_torch.core.logging import DataLogger
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.runtime.device_loop import build_device_loop
from upright_tpu_torch.scripts.mpc_sim import run_closed_loop
from upright_tpu_torch.sim.obstacles import build_dynamic_obstacles
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.mpc import ControllerManager, MPCSettings

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
COLD_ITERATIONS = 12


def load(path, horizon=None):
    conf = jcfg.load_config(jcfg.resolve_package_path({"package": "configs", "path": path}))
    if horizon is not None:
        conf["controller"].setdefault("mpc", {})["time_horizon"] = horizon
    conf["controller"].setdefault("solver", {})["warmstart_iterations"] = COLD_ITERATIONS
    return conf


SUDDEN = "ral23/sudden_obstacle/sudden_t1.0.yaml"
FULL_BOTTLE = "ral23/static_obstacles/full_bottle_point1.yaml"


def test_closed_loop_logs_collision_rows():
    """run_closed_loop on full_bottle_point1 for 3 ticks, logging every
    tick: the logged collision rows, cones and limits equal the JAX
    problem's evaluate_constraints at the same (x, u, t)."""
    config = load(FULL_BOTTLE, horizon=0.5)
    logger = DataLogger(timestep=0.0)
    sim, state, ctrl, logger = run_closed_loop(config, duration=3 / 125.0, log=logger, **CPU64)
    data = logger.as_arrays()
    assert len(data["t"]) == 3
    groups = dict(ctrl.problem.ineq_groups)
    assert groups["collision_pair_distances"] == 36 and groups["contact_force_constraints"] == 20
    jp = jbuild(config)
    assert jp.ocp.N == ctrl.problem.ocp.N == N
    for i, t in enumerate(data["t"]):
        cons = jp.evaluate_constraints(data["x"][i], data["u"][i], t, jp.target)
        for name in groups:
            np.testing.assert_allclose(data[name][i], np.asarray(cons[name]), rtol=0, atol=1e-10,
                                       err_msg=name)
        np.testing.assert_allclose(data["constraint_eq"][i], np.asarray(cons["equality"]),
                                   rtol=0, atol=1e-10)
    assert (data["collision_pair_distances"] > 0).all()
    assert np.isfinite(data["object_displacement"]).all()


def test_closed_loop_feeds_sudden_obstacle_state():
    """For a dynamic obstacle without the projectile constraint, each tick
    appends the simulated obstacle's state to the controller's x."""
    config = load(SUDDEN, horizon=0.5)
    logger = DataLogger(timestep=0.0)
    sim, state, ctrl, logger = run_closed_loop(config, duration=2 / 125.0, log=logger, **CPU64)
    data = logger.as_arrays()
    obstacle = build_dynamic_obstacles(config["simulation"])[0]
    assert data["x"].shape == (2, 36)
    for i, t in enumerate(data["t"]):
        # logged after the tick: x was measured at the tick's start
        np.testing.assert_allclose(data["x"][i, 27:], obstacle.state(t - 1 / 125.0),
                                   rtol=0, atol=1e-12)


class NoLog(DataLogger):
    """A logger that takes no sample: the loops skip their logging step."""

    def ready(self, t):
        return False


def test_projectile_closed_loop_matches_reference(monkeypatch):
    """run_closed_loop on ral23/projectile/projectile_head_on.yaml against
    the JAX package's scripts/mpc_sim.py, with the throw moved from 1.0 s to
    0.05 s on both sides so that 16 ticks at 125 Hz cover it: the tracker's
    estimate and flag every tick (the same numpy on both sides, 1e-10), the
    activation flag of the target the controller ends with (set when the
    tracker enters its flight phase), the joints (1e-8) and the plan
    (1e-7)."""
    from pathlib import Path

    from upright_tpu.runtime import projectile as jproj
    from upright_tpu_torch.runtime import projectile as tproj
    from upright_tpu_torch.scripts import mpc_sim as tsim

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1] / "scripts"))
    import mpc_sim as jsim

    config = load("ral23/projectile/projectile_head_on.yaml", horizon=0.5)
    config["simulation"]["dynamic_obstacles"]["obstacles"][0]["modes"][0]["time"] = 0.05
    ticks = 16
    runs = {}
    for name, module, base, run in (("port", tsim, tproj.ProjectileTracker,
                                     lambda c: run_closed_loop(c, ticks / 125.0, log=NoLog(), **CPU64)),
                                    ("jax", jproj, jproj.ProjectileTracker,
                                     lambda c: jsim.run_closed_loop(c, ticks / 125.0, log=NoLog()))):
        seen = []

        class Recording(base):
            def update(self, r_measured=None):
                out = super().update(r_measured)
                seen.append((out[0].copy(), out[1], self.phase.value))
                return out

        monkeypatch.setattr(module, "ProjectileTracker", Recording)
        sim, state, ctrl, _ = run(copy.deepcopy(config))
        runs[name] = (seen, np.asarray(state.q).reshape(-1), np.asarray(ctrl.target.poses)[:, 7],
                      np.asarray(ctrl.state.X).reshape(-1, ctrl.problem.ocp.nx))
    (seen, q, flag, X), (jseen, jq, jflag, jX) = runs["port"], runs["jax"]
    assert len(seen) == len(jseen) == ticks
    for (obs, s, phase), (jobs, js, jphase) in zip(seen, jseen):
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-10)
        assert (s, phase) == (js, jphase)
    phases = [p for _, _, p in seen]
    assert phases[0] == 0 and phases[-1] == 1, phases  # preflight, then flight
    np.testing.assert_array_equal(flag, jflag)
    assert (flag == 1.0).all()
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-8)
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-7)


def test_device_loop_matches_host_loop_on_obstacle_course():
    """full_bottle_point1 (frictional cones, 36 collision rows, nu = 21) on
    the device loop and on the host loop (ControllerManager.step +
    UprightSimulation.step), from the manager's cold solve, over 3 ticks at
    100 Hz: the tolerances of tests/test_torch_device_loop.py."""
    ticks, rate = 3, 100.0
    dt = 1.0 / rate
    config = load(FULL_BOTTLE)
    prob = tbuild(config, N=N, **CPU64)
    settings = MPCSettings.from_config(config["controller"])
    assert settings.warmstart_iterations == COLD_ITERATIONS
    ctrl = ControllerManager(prob, settings)
    sim = UprightSimulation(config["simulation"], **CPU64)
    state = sim.initial_state()
    nq = sim.robot.nq
    a_state = np.zeros(nq)
    ctrl.warmstart(0.0, np.concatenate([state.q[0].numpy(), state.v[0].numpy(), a_state]))
    init_carry, run = build_device_loop(prob, sim, al_cfg=settings.al_config(), ctrl_rate=rate)
    carry, metrics = run(init_carry(t0=dt, solver_state=ctrl.state), ticks)

    n_sub = max(1, int(round(dt / sim.timestep)))
    t = dt
    for _ in range(ticks):
        q, v = sim.measure(state)
        x = np.concatenate([q[0].numpy(), v[0].numpy(), a_state])
        _xd, u = ctrl.step(t, x)
        v_cmd = v[0].numpy() + dt * a_state + 0.5 * dt**2 * u[:nq]
        a_state = a_state + dt * u[:nq]
        state = sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub)
        t += dt
    np.testing.assert_allclose(carry.sim.q[0].numpy(), state.q[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(carry.a_state[0].numpy(), a_state, rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.solver.X.numpy(), ctrl.state.X.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(carry.sim.objects.r.numpy(), state.objects.r.numpy(),
                               rtol=0, atol=1e-8)
    assert torch.isfinite(metrics.cost).all() and torch.isfinite(metrics.eq_viol).all()


@pytest.mark.slow
def test_closed_loop_obstacle_avoidance():
    """The Thing drives across the course without entering any obstacle
    (tests/test_obstacles.py on the port)."""
    config = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/thing_obstacle_demo.yaml"}))
    sim, state, ctrl, logger = run_closed_loop(config, duration=6.0, ctrl_rate=50.0, **CPU64)
    prob = ctrl.problem
    target_r = prob.target.poses[0, :3].numpy()
    _, r_ew = sim.ee_pose(state)
    assert np.linalg.norm(r_ew[0] - target_r) < 0.15
    assert (sim.object_displacements(state) < 0.05).all()
    sol = ctrl.solution
    params = prob.stage_params(ctrl.last_plan_time)
    h = prob.ocp.ineq(sol.state.X[0, :-1], sol.state.U[0], params["stage"])
    assert float(h[:, -36:].min()) > -0.05


@pytest.mark.slow
def test_frictional_closed_loop():
    """The MPC moves the EE laterally while the low-friction box stays on
    the tray (tests/test_frictional.py on the port)."""
    config = jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_friction_demo.yaml"}))
    sim, state, ctrl, logger = run_closed_loop(config, duration=4.0, ctrl_rate=50.0, **CPU64)
    target_r = ctrl.problem.target.poses[0, :3].numpy()
    _, r_ew = sim.ee_pose(state)
    assert np.linalg.norm(r_ew[0] - target_r) < 0.1
    disp = sim.object_displacements(state)
    assert (disp < 0.03).all(), f"box slid: {disp}"
