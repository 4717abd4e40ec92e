"""Launch the full stack as separate OS processes (launch-file equivalent).

Counterpart of ``scripts/launch_stack.py``.  The reference
(upright_ros_interface/launch/mpc_mrt_simulation.launch) starts mpc_node,
mrt_node and the simulation as separate ROS nodes.  Here:

  * the planner process (``PlannerNode``) owns its device and replans
    continuously from the latest observation (mpc_node);
  * this process runs the plant and the native C++ real-time executor
    (mrt_node + sim), exchanging observations and policies over a Pipe.

    python -m upright_tpu_torch.scripts.launch_stack --config configs/demos/ur10_demo.yaml --duration 2 --time-scale 0.1

Both processes use the card (float32); ``--device cpu`` runs both on the CPU
in float64.  ``--time-scale`` is as in ``runtime_demo``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.runtime.launch import PlannerNode
from upright_tpu_torch.runtime.native import NativeExecutor
from upright_tpu_torch.scripts.runtime_demo import post
from upright_tpu_torch.sim.simulation import UprightSimulation


def run_stack(config_path, duration=5.0, rate=125.0, time_scale=1.0, device="cuda"):
    """Run the stack; returns a dict: the planner's start-up time (its first
    two solves), the first policy and the number of new ones that followed
    it, the executor's stats, the final EE position and the object
    displacements."""
    config = cfg.load_config(config_path)
    dtype = torch.float64 if device == "cpu" else torch.float32
    sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    nq = sim.robot.nq
    state = sim.initial_state()
    x0 = np.concatenate([state.q[0].cpu().numpy(), np.zeros(2 * nq)])

    planner = PlannerNode(config_path, min_update_time=0.01, device=device)
    try:
        planner.set_observation(0.0, x0)
        planner.wait_ready()
        pol = planner.get_policy()
        deadline = time.monotonic() + 30.0
        while pol is None:  # the first policy follows "ready" on the pipe
            if time.monotonic() > deadline:
                raise TimeoutError("no policy from the planner process after 'ready'")
            time.sleep(0.01)
            pol = planner.get_policy()
        first, switches = pol, 0

        executor = NativeExecutor(nq, rate=rate, x0=x0, time_scale=time_scale)
        post(executor, pol, nq)
        executor.start(t_now=0.0)
        dt = 1.0 / rate
        n_sub = max(1, int(dt / sim.timestep))
        t = 0.0
        t_wall0 = time.perf_counter()
        try:
            while t < duration:
                executor.post_observation(t, state.q[0].cpu().numpy(), state.v[0].cpu().numpy())
                planner.set_observation(t, executor.state_estimate())
                new_pol = planner.get_policy()
                if new_pol is not None and new_pol is not pol:
                    pol = new_pol
                    switches += 1
                    post(executor, pol, nq)

                v_cmd, _ = executor.get_command()
                if v_cmd is None:
                    v_cmd = np.zeros(nq)
                state = sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub)
                t += dt
                lag = (t_wall0 + t / time_scale) - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
        finally:
            executor.stop()
        alive = planner.alive
    finally:
        planner.stop()

    _, r_ew = sim.ee_pose(state)
    return {
        "startup_s": planner.compile_seconds,
        "first_policy": first,
        "switches": switches,
        "planner_alive": alive,
        "executor": executor.stats(),
        "ee_position": r_ew[0],
        "object_displacement": sim.object_displacements(state)[0] if sim.n_obj else np.zeros(0),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--duration", type=float, default=5.0)
    parser.add_argument("--rate", type=float, default=125.0)
    parser.add_argument("--time-scale", type=float, default=1.0,
                        help="sim seconds per wall second (below 1: slow motion)")
    parser.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = parser.parse_args()

    print("starting the planner process...", flush=True)
    out = run_stack(args.config, args.duration, args.rate, args.time_scale, args.device)
    stats = out["executor"]
    print(f"planner ready after {out['startup_s']:.1f} s (its first two solves)")
    print(f"executor: {stats['ticks']} ticks, {stats['overruns']} overruns, "
          f"{stats['policy_switches']} policy switches ({out['switches']} received after the first), "
          f"max tick {stats['max_tick_seconds']*1e3:.3f} ms")
    print(f"EE position: {np.round(out['ee_position'], 4)}")
    if out["object_displacement"].size:
        print(f"object displacement: {np.round(out['object_displacement'], 4)} m")


if __name__ == "__main__":
    main()
