"""Runtime demo: asynchronous planner + native real-time executor + plant,
paced to the wall clock.

Counterpart of ``scripts/mpc_runtime_demo.py``.  The reference achieves this
with two ROS nodes (mpc_node + mrt_node, launch/mpc_mrt_simulation.launch);
here the planner (``AsyncPlanner``) runs in a background thread on a stream
of its own, the C++ executor (``NativeExecutor``) owns the 125 Hz loop, and
this thread steps the plant.

    python -m upright_tpu_torch.scripts.runtime_demo --config configs/demos/ur10_demo.yaml --duration 2 --time-scale 0.1

It runs on the card (float32); ``--device cpu`` runs it on the CPU in float64.
``--time-scale`` is simulated seconds per wall second: below 1 the whole
pipeline runs in slow motion, for a plant that cannot keep real time.  As in
the reference, the executor still ticks at ``rate`` wall Hz and integrates
each command over time-scale x one tick of simulated time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.runtime.native import NativeExecutor
from upright_tpu_torch.runtime.tracker import AsyncPlanner
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.mpc import ControllerManager


def post(executor, pol, nq):
    """Hand a policy's robot part to the executor."""
    executor.post_policy(pol.t0, pol.dt, pol.X[:, : 3 * nq], pol.U[:, :nq],
                         pol.K[:, :nq, : 3 * nq])


def plant_tick(sim, state, t, executor, planner, n_sub):
    """One tick of the plant loop at simulated time ``t``: post the
    observation, hand the planner's latest policy to the executor, read the
    executor's command and step the plant; returns the plant's new state."""
    nq = sim.robot.nq
    executor.post_observation(t, state.q[0].cpu().numpy(), state.v[0].cpu().numpy())
    planner.set_observation(t, executor.state_estimate())

    pol = planner.get_policy()
    if pol is not None:
        post(executor, pol, nq)

    v_cmd, _ = executor.get_command()
    if v_cmd is None:
        v_cmd = np.zeros(nq)
    return sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub)


def run_demo(config, duration=5.0, rate=125.0, time_scale=1.0, device="cuda"):
    """Run the demo; returns a dict of what it measured: the executor's
    stats, the planner's replan times (s, the warm start left out), the plant
    loop's busy time per tick and how far it fell behind the scaled wall
    clock (s), the EE error and the object displacements."""
    dtype = torch.float64 if device == "cpu" else torch.float32
    sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    ctrl = ControllerManager.from_config(config, device=device, dtype=dtype)
    nq = sim.robot.nq

    state = sim.initial_state()
    x0 = np.concatenate([state.q[0].cpu().numpy(), np.zeros(2 * nq)])
    executor = NativeExecutor(nq, rate=rate, x0=x0, time_scale=time_scale)

    planner = AsyncPlanner(ctrl, min_update_time=0.01)
    planner.set_observation(0.0, x0)
    planner.solve_once()  # the warm start
    planner.solve_once()  # one replan
    post(executor, planner.get_policy(), nq)

    planner.start()
    executor.start(t_now=0.0)  # align the executor clock with sim time

    dt = 1.0 / rate
    n_sub = max(1, int(dt / sim.timestep))
    t = 0.0
    behind, busy = [], []
    t_wall0 = time.perf_counter()
    try:
        while t < duration:
            t_tick = time.perf_counter()
            state = plant_tick(sim, state, t, executor, planner, n_sub)
            t += dt
            # pace to the wall clock (scaled: 1 sim second = 1/scale wall seconds)
            now = time.perf_counter()
            busy.append(now - t_tick)
            lag = (t_wall0 + t / time_scale) - now
            behind.append(-lag)
            if lag > 0:
                time.sleep(lag)
            if planner.error is not None:
                raise planner.error
    finally:
        planner.stop()
        executor.stop()
    if planner.error is not None:
        raise planner.error

    _, r_ew = sim.ee_pose(state)
    target = ctrl.target.poses[0, :3].cpu().numpy()
    return {
        "executor": executor.stats(),
        "braked": executor.braked,
        "replan_s": np.asarray(ctrl.replanning_durations[1:]),
        "busy_s": np.asarray(busy),
        "behind_s": np.asarray(behind),
        "wall_s": time.perf_counter() - t_wall0,
        "ee_error": float(np.linalg.norm(r_ew[0] - target)),
        "object_displacement": sim.object_displacements(state)[0] if sim.n_obj else np.zeros(0),
    }


def report(out):
    """Print a run's results as the reference demo does."""
    stats = out["executor"]
    durations = out["replan_s"] if out["replan_s"].size else np.zeros(1)
    behind = out["behind_s"]
    print(f"executor: {stats['ticks']} ticks, {stats['overruns']} overruns, "
          f"{stats['policy_switches']} policy switches, "
          f"max tick {stats['max_tick_seconds']*1e3:.3f} ms")
    print(f"planner: {out['replan_s'].size} replans, mean {durations.mean()*1e3:.1f} ms, "
          f"p99 {np.percentile(durations, 99)*1e3:.1f} ms")
    print(f"plant loop: median {np.median(out['busy_s'])*1e3:.2f} ms busy per tick; behind the "
          f"scaled wall clock by at most {behind.max()*1e3:.1f} ms, {behind[-1]*1e3:.1f} ms at "
          f"the end ({out['wall_s']:.1f} s of wall time)")
    print(f"EE error: {out['ee_error']:.4f} m")
    if out["object_displacement"].size:
        print(f"object displacement: {np.round(out['object_displacement'], 4)} m")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--duration", type=float, default=5.0)
    parser.add_argument("--rate", type=float, default=125.0)
    parser.add_argument("--time-scale", type=float, default=1.0,
                        help="sim seconds per wall second (below 1: slow motion)")
    parser.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = parser.parse_args()
    config = cfg.load_config(args.config)
    print("warm-starting the planner...", flush=True)
    report(run_demo(config, args.duration, args.rate, args.time_scale, args.device))


if __name__ == "__main__":
    main()
