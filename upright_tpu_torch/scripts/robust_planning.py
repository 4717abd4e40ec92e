"""Robust planning experiment script.

Counterpart of ``scripts/robust_planning.py``, with the same flags and
``--device``: the reference's planning_sim_loop.py + process_sim_runs.py as
one batched program:

  1. solve the offline robust plan (CoM-box vertex scenarios in one OCP)
  2. track it under a grid of true inertial parameters, the whole sweep one
     batched loop over control ticks (one plant-kernel launch a tick)
  3. report failures (object displacement > 0.5 m) and the closed-form
     worst-case constraint analysis

Usage:
  python -m upright_tpu_torch.scripts.robust_planning \
      --config configs/demos/ur10_demo.yaml --com-box 0.02 0.02 0.04 --duration 3.0
  (on the card, float32; ``--device cpu`` runs in float64 on the CPU)
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.robust.planning import (
    make_param_sweep,
    plan_robust,
    ral25_protocol,
    tracking_sweep,
    verify_offline_plan,
)
from upright_tpu_torch.robust.verification import count_failures
from upright_tpu_torch.sim.simulation import UprightSimulation


def run(config, com_box=None, duration=None, iterations=60, com_grid=5,
        inertia_scales=(0.5, 1.0, 2.0), kp=10.0, realizable=False, parallel_scan=False,
        protocol=None, device="cuda", dtype=torch.float32, verbose=False):
    """The script's work on a loaded config; returns its JSON-able result."""
    if protocol == "ral25":
        com_boxes = [com_box] if com_box else None
        # leaf configs may pin the planner's CoM model (the ral25 real
        # box{1,2,3} matrix: controller.robust.com_variant)
        com_variant = config["controller"].get("robust", {}).get("com_variant", "robust")
        return ral25_protocol(
            config, com_half_extents=com_boxes, duration=duration, iterations=iterations,
            kp=kp, use_parallel_scan=parallel_scan, com_variant=com_variant,
            device=device, dtype=dtype,
        )

    com_boxes = [com_box] if com_box else None  # single-object experiments
    if verbose:
        print("solving offline plan...", flush=True)
    prob, sol, plan = plan_robust(
        config, com_half_extents=com_boxes, duration=duration, iterations=iterations,
        use_parallel_scan=parallel_scan, device=device, dtype=dtype,
    )
    if verbose:
        print(f"  eq violation {float(sol.eq_viol):.2e}, "
              f"ineq violation {float(sol.ineq_viol):.2e}", flush=True)

    # parameter sweep grid (reference: 15 CoM x 3 inertia scales)
    sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    if com_box:
        hx, hy, _ = com_box
        grid = np.linspace(-1, 1, com_grid)
        com_offsets = [[gx * hx, gy * hy, 0.0] for gx in grid for gy in grid]
    else:
        com_offsets = [[0.0, 0, 0]]
    sweep = make_param_sweep(sim, com_offsets=com_offsets, inertia_scales=inertia_scales)
    n_runs = len(com_offsets) * len(inertia_scales)
    if verbose:
        print(f"tracking sweep: {n_runs} parameter sets (one batched loop)...", flush=True)
    disp = tracking_sweep(sim, plan, sweep, kp=kp)
    failures = count_failures(disp)

    out = {
        "runs": n_runs,
        "failures": failures,
        "max_displacement_m": float(disp.max()),
        "plan_eq_violation": float(sol.eq_viol),
    }
    # worst-case CWC verification of the plan (without a CoM box, over the
    # nominal parameters alone), and with --realizable over the
    # density-realizable set: every mass density on the object's bounding box
    # with the CoM in the CoM box (one batched barrier solve)
    out.update(verify_offline_plan(prob, plan, [com_box or [0.0, 0.0, 0.0]],
                                   realizable=realizable))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--com-box", nargs=3, type=float, default=None,
                        help="CoM uncertainty half extents (x y z)")
    parser.add_argument("--duration", type=float, default=None)
    parser.add_argument("--iterations", type=int, default=60)
    parser.add_argument("--com-grid", type=int, default=5,
                        help="CoM offsets per axis in the sweep")
    parser.add_argument("--inertia-scales", nargs="*", type=float, default=[0.5, 1.0, 2.0])
    parser.add_argument("--kp", type=float, default=10.0)
    parser.add_argument("--realizable", action="store_true",
                        help="also verify over the density-realizable parameter set")
    parser.add_argument("--parallel-scan", action="store_true",
                        help="use the log-depth backward pass (long horizons)")
    parser.add_argument("--protocol", choices=["ral25"], default=None,
                        help="run a canned experiment protocol: ral25 = 15 CoM x 3 inertia x "
                             "waypoints with worst-case inertia synthesis")
    parser.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = parser.parse_args()

    dtype = torch.float64 if args.device == "cpu" else torch.float32
    out = run(
        cfg.load_config(args.config), com_box=args.com_box, duration=args.duration,
        iterations=args.iterations, com_grid=args.com_grid,
        inertia_scales=args.inertia_scales, kp=args.kp, realizable=args.realizable,
        parallel_scan=args.parallel_scan, protocol=args.protocol, device=args.device,
        dtype=dtype, verbose=True,
    )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
