"""Closed-loop MPC simulation on the port.

Counterpart of ``scripts/mpc_sim.py``.  Each control cycle: measure the joints
(with noise when a seed is given), append the dynamic obstacles' states to
the controller's state (for the projectile path constraint, the estimate of a
``ProjectileTracker`` fed the simulated ball's position, whose flight phase
also sets the target's activation flag), MPC step (replan gated at
min_policy_update_time), jerk double integration into a velocity command,
plant step, log.

    python -m upright_tpu_torch.scripts.mpc_sim --config configs/demos/thing_projectile_demo.yaml --duration 2.0

It runs on the card (float32); ``--device cpu`` runs it on the CPU in float64.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.core.logging import DataLogger
from upright_tpu_torch.core.math import rot_to_quat
from upright_tpu_torch.runtime.projectile import ProjectileTracker
from upright_tpu_torch.sim.obstacles import build_dynamic_obstacles
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver.mpc import ControllerManager


def run_closed_loop(config, duration=None, ctrl_rate=125.0, log=None, verbose=False,
                    seed=None, device="cuda", dtype=torch.float32):
    """Run the closed loop; returns (sim, state, controller, logger).

    ``seed`` enables the configured measurement/process noise through a
    ``torch.Generator`` on the plant's device; with seed=None the loop is
    deterministic and noise-free regardless of config."""
    sim_conf = config["simulation"]
    sim = UprightSimulation(sim_conf, device=device, dtype=dtype)
    ctrl = ControllerManager.from_config(config, device=device, dtype=dtype)
    num_ctrl_obs = ctrl.problem.dims.num_obstacles
    generator = None
    if seed is not None:
        generator = torch.Generator(device=sim.device)
        generator.manual_seed(int(seed))

    duration = float(duration or sim_conf.get("duration", 5.0))
    dt_ctrl = 1.0 / ctrl_rate
    n_sub = max(1, int(round(dt_ctrl / sim.timestep)))

    state = sim.initial_state()
    nq = sim.robot.nq
    a_state = np.zeros(nq)  # the controller's acceleration state (triple-integrator belief)

    # dynamic obstacles: simulated balls whose states the controller reads
    # directly (sudden/controlled obstacles); the ones it does not model
    # still advance with the clock
    _, r_ee0 = sim.ee_pose(state)
    dyn_obstacles = build_dynamic_obstacles(sim_conf, ee_position=r_ee0[0])
    # projectile estimation only applies to ballistic obstacles with the
    # path constraint enabled; sudden/controlled obstacles feed their state
    # directly
    use_projectile = bool(
        config["controller"].get("projectile_path_constraint", {}).get("enabled")
    )
    tracker = (ProjectileTracker(dt_ctrl) if (dyn_obstacles and num_ctrl_obs and use_projectile)
               else None)
    s_target = float(ctrl.target.poses[0, 7])  # the target's activation flag, on the host

    logger = log if log is not None else DataLogger(timestep=0.05)
    robot_x = ctrl.problem.dims.robot_x

    t = 0.0
    steps = int(round(duration / dt_ctrl))
    for i in range(steps):
        q_meas, v_meas = sim.measure(state, generator=generator)
        v_meas = v_meas[0].cpu().numpy()
        x = np.concatenate([q_meas[0].cpu().numpy(), v_meas, a_state])
        if tracker is not None:
            # the ball's estimate into the obstacle tail, and its flight
            # phase into the target's activation flag (column 7 of poses)
            obs_state, s_flag = tracker.update(dyn_obstacles[0].position(t))
            x = np.concatenate([x, obs_state] + [np.zeros(9)] * (num_ctrl_obs - 1))
            if s_target != s_flag:
                poses = ctrl.target.poses.clone()
                poses[:, 7] = s_flag
                ctrl.target = dataclasses.replace(ctrl.target, poses=poses)
                s_target = s_flag
        elif num_ctrl_obs:
            tails = [dyn_obstacles[i].state(t) if i < len(dyn_obstacles) else np.zeros(9)
                     for i in range(num_ctrl_obs)]
            x = np.concatenate([x] + tails)
        if np.isnan(x).any():
            raise FloatingPointError(f"NaN in the controller state at t = {t}")

        xd, u = ctrl.step(t, x)
        u_cmd = u[:nq]

        # double-integrate jerk into the velocity command
        v_cmd = v_meas + dt_ctrl * a_state + 0.5 * dt_ctrl**2 * u_cmd
        a_state = a_state + dt_ctrl * u_cmd

        state = sim.step(state, torch.as_tensor(v_cmd), n_steps=n_sub, generator=generator)
        t += dt_ctrl
        for obs in dyn_obstacles:
            obs.step(t)

        if logger.ready(t):
            R_we, r_ew = sim.ee_pose(state)
            cons = ctrl.problem.evaluate_constraints(x, u, t, ctrl.target)
            diag = ctrl.problem.diagnostics(x, u, t, ctrl.target)
            ee = ctrl.problem.robot.ee_state(
                torch.as_tensor(x[:robot_x], dtype=ctrl.dtype, device=ctrl.device)
            )
            rd, qd, _s = ctrl.target.interpolate(t)
            ineq = cons["inequality"].cpu().numpy()
            entry = {
                "t": t,
                "x": x,
                "xd": xd,
                "u": u,
                "cmd_vel": v_cmd,
                "r_ew_w": r_ew[0],
                "r_ew_w_d": rd.cpu().numpy(),
                "Q_we": rot_to_quat(torch.as_tensor(R_we[0])).numpy(),
                "Q_we_d": qd.cpu().numpy(),
                "v_ew_w": ee.v_ew_w.cpu().numpy(),
                "w_ew_w": ee.w_ew_w.cpu().numpy(),
                "constraint_eq": cons["equality"].cpu().numpy(),
                "constraint_ineq_min": float(ineq.min()) if ineq.shape[0] else 0.0,
                "solve_time": ctrl.replanning_durations[-1] if ctrl.replanning_durations else 0.0,
                "orn_err": float(diag["orn_err"]),
                "ddC_we_norm": float(diag["ddC_we_norm"]),
                "cost": float(diag["cost"]),
            }
            if ctrl.problem.dims.f:
                entry["contact_forces"] = diag["contact_forces"].cpu().numpy()
            for name, _n in ctrl.problem.ineq_groups:
                entry[name] = cons[name].cpu().numpy()
            if tracker is not None:
                entry["projectile_position"] = dyn_obstacles[0].position(t)
                entry["projectile_phase"] = tracker.phase.value
            if sim.n_obj:
                r_obj, _q_obj = sim.object_poses(state)
                entry["r_ow_w"] = r_obj[0]
                entry["object_displacement"] = sim.object_displacements(state)[0]
            logger.append_dict(entry)

        if verbose and i % 25 == 0:
            _, r_ew = sim.ee_pose(state)
            print(f"t={t:6.2f}s  r_ee={np.round(r_ew[0], 3)}", flush=True)

    # the run's dynamic obstacles, for callers that check where they went
    run_closed_loop.last_obstacles = dyn_obstacles
    return sim, state, ctrl, logger


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--log", default=None, help="directory to save the npz log")
    parser.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = parser.parse_args()

    config = cfg.load_config(args.config)
    dtype = torch.float64 if args.device == "cpu" else torch.float32
    t0 = time.time()
    sim, state, ctrl, logger = run_closed_loop(config, args.duration, verbose=True,
                                               device=args.device, dtype=dtype)
    wall = time.time() - t0

    durations = np.asarray(ctrl.replanning_durations[1:])  # skip the warm start
    print(f"\nwall time: {wall:.1f}s on {sim.device}")
    if durations.size:
        print(
            f"solve time: mean {durations.mean()*1e3:.2f} ms, "
            f"max {durations.max()*1e3:.2f} ms, p99 {np.percentile(durations, 99)*1e3:.2f} ms"
        )
    if sim.n_obj:
        disp = sim.object_displacements(state)[0]
        print(f"final object displacement: {np.round(disp, 4)} m")
    if args.log:
        logger.save(args.log, config)


if __name__ == "__main__":
    main()
