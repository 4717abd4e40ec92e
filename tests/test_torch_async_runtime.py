"""The port's asynchronous runtime demo against the JAX package's
scripts/mpc_runtime_demo.py, replayed on a virtual wall clock, in float64 on
the CPU.

Both demos run three clocks at once: the plant loop, paced to the scaled
wall clock; the executor's thread, which ticks at ``rate`` wall Hz with its
time slaved to the latest observation (t = t_obs + time_scale x the wall
seconds since it was posted); and the planner thread, whose policy lands when
its solve ends.  How they interleave depends on the host, so no two threaded
runs repeat.  ``replay`` runs the demo's plant-loop tick (the port's
``runtime_demo.plant_tick``; for the JAX package the body of its demo's
loop) on a virtual wall clock instead: a plant tick takes ``plant_s`` wall
seconds, a replan ``replan_s``, each drawn within +-20% from one seed, the
executor ticks at its wall rate from a seeded phase, and a solve starts on
the latest observation as soon as the planner is free (after its 10 ms
minimum gap).  The same schedule drives each package's planner and plant;
the executor is the port's library, whose source is the JAX package's
(tests/test_torch_native_executor.py holds the two to 1e-12).

The slow case is the witness for the runtime demo's dropped bottle: at the
timing the card measured beside the plant (a replan of about 0.25 s, a
plant tick of about 25 ms) and time scale 0.1, the JAX package's planner and
plant drop the bottle just as the port's do.
"""

import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.runtime.tracker import AsyncPlanner as JPlanner
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu.solver.mpc import ControllerManager as JManager
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.runtime.native import NativeExecutor
from upright_tpu_torch.runtime.tracker import AsyncPlanner
from upright_tpu_torch.scripts import runtime_demo
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.mpc import ControllerManager

CPU64 = dict(device="cpu", dtype=torch.float64)
RATE = 125.0


def load():
    return jcfg.load_config(jcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))


def jax_plant_tick(sim, state, t, executor, planner, n_sub):
    """The body of the loop of the JAX package's scripts/mpc_runtime_demo.py."""
    nq = sim.robot.nq
    executor.post_observation(t, np.asarray(state.q), np.asarray(state.v))
    planner.set_observation(t, executor.state_estimate())

    pol = planner.get_policy()
    if pol is not None:
        executor.post_policy(pol.t0, pol.dt, pol.X[:, : 3 * nq],
                             pol.U[:, :nq], pol.K[:, :nq, : 3 * nq])

    v_cmd, _ = executor.get_command()
    if v_cmd is None:
        v_cmd = np.zeros(nq)
    return sim.step(state, v_cmd, n_steps=n_sub)


class VirtualPlanner:
    """The planner thread on the virtual clock: the plant loop sees the
    policy of the last solve that has landed, not the one in flight."""

    def __init__(self, planner):
        self.planner = planner
        self.policy = planner.get_policy()

    def set_observation(self, t, x):
        self.planner.set_observation(t, x)

    def get_policy(self):
        return self.policy


def replay(side, conf, ticks, time_scale, replan_s, plant_s, N=None, seed=0):
    """Run ``ticks`` plant ticks of one package's runtime demo on the
    virtual clock; returns the joints after each tick, the bottle's largest
    displacement, the number of solves that landed and the executor's final
    estimate."""
    if side == "port":
        sim = UprightSimulation(conf["simulation"], **CPU64)
        ctrl = (ControllerManager.from_config(conf, **CPU64) if N is None
                else ControllerManager(tbuild(conf, N=N, **CPU64)))
        planner, tick = AsyncPlanner(ctrl, min_update_time=0.01), runtime_demo.plant_tick
        q_of = lambda s: s.q[0].numpy().copy()
        disp_of = lambda s: float(sim.object_displacements(s)[0].max())
    else:
        sim = JSim(conf["simulation"])
        ctrl = JManager.from_config(conf) if N is None else JManager(jbuild(conf, N=N))
        planner, tick = JPlanner(ctrl, min_update_time=0.01), jax_plant_tick
        q_of = lambda s: np.array(s.q)
        disp_of = lambda s: float(np.max(sim.object_displacements(s)))
    rng = np.random.default_rng(seed)
    nq = sim.robot.nq
    state = sim.initial_state()
    x0 = np.concatenate([q_of(state), np.zeros(2 * nq)])
    executor = NativeExecutor(nq, rate=RATE, x0=x0, time_scale=time_scale)
    planner.set_observation(0.0, x0)
    planner.solve_once()  # the warm start
    planner.solve_once()  # one replan
    runtime_demo.post(executor, planner.get_policy(), nq)
    virtual = VirtualPlanner(planner)

    dt, period = 1.0 / RATE, 1.0 / RATE  # the executor ticks at RATE wall Hz
    n_sub = max(1, int(dt / sim.timestep))
    w_plant, w_exec, w_plan = 0.0, rng.uniform(0.0, period), 0.0
    landing, obs = None, None  # (wall time, policy); (t, wall time) of the last observation
    t, qs, disp, landed = 0.0, [], 0.0, 0
    while len(qs) < ticks:
        w = min(w_plant, w_exec, w_plan, np.inf if landing is None else landing[0])
        if landing is not None and w == landing[0]:
            virtual.policy, landing, landed = landing[1], None, landed + 1
        elif w == w_plant:
            state = tick(sim, state, t, executor, virtual, n_sub)
            obs = (t, w)
            t += dt
            qs.append(q_of(state))
            disp = max(disp, disp_of(state))
            w_plant = max(t / time_scale, w + plant_s * rng.uniform(0.8, 1.2))
        elif w == w_exec:
            if obs is not None:  # the thread's clock, slaved to the observation
                executor.tick(obs[0] + time_scale * (w - obs[1]))
            w_exec += period
        else:
            planner.solve_once()
            landing = (w + replan_s * rng.uniform(0.8, 1.2), planner.get_policy())
            w_plan = landing[0] + 0.01
    x_est = executor.state_estimate()
    executor.close()
    return np.asarray(qs), disp, landed, x_est


def test_async_demo_matches_reference():
    """30 ticks of the demo at N = 5, time scale 0.1, a replan of 0.25 s
    and a plant tick of 25 ms: the same solves land, and the joints after
    every tick and the executor's estimate agree to 1e-8."""
    conf = load()
    kw = dict(ticks=30, time_scale=0.1, replan_s=0.25, plant_s=0.025, N=5)
    q, _, landed, x_est = replay("port", conf, **kw)
    jq, _, jlanded, jx_est = replay("jax", conf, **kw)
    assert landed == jlanded >= 5
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-8)
    np.testing.assert_allclose(x_est, jx_est, rtol=0, atol=1e-8)
    assert np.abs(q[-1] - q[0]).max() > 1e-3  # the robot moves


@pytest.mark.slow
def test_async_demo_drops_the_bottle_as_the_reference_does():
    """The witness: 2 s of the demo at the config's own horizon, time scale
    0.1 and the card's timing beside the plant.  The JAX package's planner
    and plant drop the bottle (more than 0.05 m) on this schedule, and so do
    the port's, by as much within 1e-3 m; their joints agree to 1e-6 at every
    tick (the bottle does not act on the robot, which is velocity-commanded).
    Slow: the port's plain plant takes 0.4 s a tick on the CPU."""
    conf = load()
    kw = dict(ticks=250, time_scale=0.1, replan_s=0.25, plant_s=0.025)
    q, disp, _, _ = replay("port", conf, **kw)
    jq, jdisp, _, _ = replay("jax", conf, **kw)
    print(f"bottle displacement: port {disp:.4f} m, JAX package {jdisp:.4f} m")
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-6)
    assert jdisp > 0.05 and disp > 0.05
    assert abs(disp - jdisp) < 1e-3
