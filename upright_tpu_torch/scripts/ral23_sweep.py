"""Run ral23 experiment families end to end on the port and record the
results table.

Counterpart of ``scripts/ral23_sweep.py``: closed-loop MPC over every leaf of
``configs/ral23/<family>/``, each experiment group's waypoints run as ONE
closed loop batched over targets (``runtime/device_loop.py`` with a stack of
targets: replan, policy and plant of all the group's leaves in one tick, one
Riccati kernel and one contact kernel launch per SQP iteration and tick).

Metrics per run: final EE error to the commanded waypoint, max balanced-object
displacement in the tray frame (failure if > 7 cm, half the tray), and the max
balance-constraint violation the solver reported along the way.

Writes the results JSON to ``--out`` (default ``logs/ral23_results.json``,
git-ignored), the markdown table beside it and, for a per-leaf-default run
named ``ral23_results``, the stiction mirror beside it; it writes nothing
else.

Usage: python -m upright_tpu_torch.scripts.ral23_sweep
       [--families static_obstacles,freespace] [--groups full_bottle,...]
       [--device cpu --dtype float64] [--out logs/ral23_results.json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.core.math import rot_to_quat
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.ocp.reference import TargetTrajectory, stack_targets
from upright_tpu_torch.runtime.device_loop import build_device_loop
from upright_tpu_torch.scripts.ral25_study import REPO, _git_hash
from upright_tpu_torch.sim import contact
from upright_tpu_torch.sim.simulation import UprightSimulation
from upright_tpu_torch.solver import riccati
from upright_tpu_torch.solver.mpc import MPCSettings

FAIL_DISP_M = 0.07  # half the tray half-extent: the object is gone
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def discover_groups(family_dir: Path):
    """Group leaves by experiment stem: ``<variant>_<arr>_point{k}`` leaves
    form one batched group; other leaves (arm_only, sudden-obstacle times)
    are single-run groups."""
    leaves = sorted(
        p for p in glob.glob(str(Path(family_dir) / "*.yaml"))
        if not Path(p).name.startswith("_")
    )
    groups = collections.defaultdict(list)
    for p in leaves:
        m = re.match(r"(.+)_point(\d+)$", Path(p).stem)
        key = m.group(1) if m else Path(p).stem
        groups[key].append(p)
    return dict(groups)


def run_group(name, paths, ctrl_rate=100.0, friction_model=None, duration=None,
              device="cuda", dtype=torch.float32, stats=None):
    """Run the group's leaves as one closed loop batched over their targets
    and return one row per leaf.

    ``duration`` (s) defaults to the first leaf's own.  ``stats``, a dict if
    given, receives the seconds of the cold solve and of the loop, the ticks,
    the batch, the K1 width (nx, nu), whether every cost was finite, and the
    rows' numbers before rounding: each leaf's EE error (``ee_err_m``) and
    its objects' displacements (``obj_disp_m``)."""
    config = cfg.load_config(paths[0])
    if friction_model:
        config["simulation"]["friction_model"] = friction_model
    prob = build_problem(config, device=device, dtype=dtype)
    sim = UprightSimulation(config["simulation"], device=device, dtype=dtype)
    # the ControllerManager's replan ALConfig, dual_reset_violation included:
    # it bounds multiplier windup on the unreachable arm_only waypoints
    settings = MPCSettings.from_config(config["controller"])
    init_carry, run = build_device_loop(
        prob, sim, al_cfg=settings.al_config(), ctrl_rate=ctrl_rate,
        use_feedback_policy=settings.use_feedback_policy,
    )

    # one target per leaf, built as build_problem builds the problem's own
    nq = prob.dims.robot_q
    R0, r0 = prob.robot.ee_pose(prob.x0[:nq])
    r0, q0 = r0.cpu().numpy(), rot_to_quat(R0).cpu().numpy()
    targets = [
        TargetTrajectory.from_waypoints(
            cfg.load_config(p)["controller"].get("waypoints", [{"time": 0.0}]), r0, q0,
            device=device, dtype=dtype,
        )
        for p in paths
    ]
    stack = stack_targets(targets)

    if duration is None:
        duration = float(config["simulation"].get("duration", 5.0))
    n_replans = int(round(duration * ctrl_rate))

    t0 = time.time()
    carry = init_carry(target=stack)  # one batched 12-iteration cold solve
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    t1 = time.time()
    final, metrics = run(carry, n_replans, target=stack)
    disps = sim.object_displacements(final.sim)  # (B, n_obj), one read at the end
    wall = time.time() - t0

    r_last = metrics.r_ew_w[-1].cpu().numpy()  # (B, 3)
    eq_max = metrics.eq_viol.amax(0).cpu().numpy()  # (B,)
    goal = stack.poses[:, -1, :3].cpu().numpy()
    rows, ee_errs = [], []
    for b, path in enumerate(paths):
        disp = disps[b] if sim.n_obj else np.zeros(1)
        worst = float(disp.max())
        ee_err = float(np.linalg.norm(r_last[b] - goal[b]))
        ee_errs.append(ee_err)
        # a non-finite displacement is the plant diverging after the object
        # left the tray: a failure, not a measurement
        rows.append({
            "leaf": str(Path(path).relative_to(Path(path).parents[2])),
            "ee_err_m": round(ee_err, 4),
            "max_obj_disp_m": round(worst, 4) if np.isfinite(worst) else "diverged",
            "failed": bool(worst > FAIL_DISP_M or not np.isfinite(worst)),
            "max_eq_viol": float(eq_max[b]),
        })
    finite = [r["max_obj_disp_m"] for r in rows if isinstance(r["max_obj_disp_m"], float)]
    n_div = sum(1 for r in rows if r["max_obj_disp_m"] == "diverged")
    print(
        f"  {name}: {len(paths)} runs in {wall:.0f}s, "
        f"max disp {max(finite) if finite else float('nan'):.3f} m"
        + (f" ({n_div} diverged)" if n_div else ""),
        flush=True,
    )
    if stats is not None:
        stats.update(wall_s=wall, cold_s=t1 - t0, loop_s=wall - (t1 - t0), ticks=n_replans,
                     batch=len(paths), nx=prob.ocp.nx, nu=prob.ocp.nu,
                     costs_finite=bool(torch.isfinite(metrics.cost).all()),
                     ee_err_m=ee_errs, obj_disp_m=disps.tolist())
    return rows


def markdown_lines(results, device_name):
    fm = results["_provenance"]["friction_model"]
    prov = results["_provenance"]
    lines = [
        "# ral23 experiment sweep (the PyTorch port)",
        "",
        "Generated by `upright_tpu_torch/scripts/ral23_sweep.py`: every leaf of each family",
        "run closed-loop (100 Hz replanning, full duration), each experiment group",
        f"one closed loop batched over its targets, on {device_name} ({prov['dtype']}).",
        f"failure = balanced object displaced > {FAIL_DISP_M * 100:.0f} cm in the tray frame.",
        f"Plant friction model: **{fm}**.  Matmul precision: **{prov['matmul_precision']}**.",
        f"Generated at git `{prov['git_hash']}`, {prov['generated_utc']}.",
        "",
        "The JAX package's record (`docs/ral23_results.md`) explains the failures:",
        "`none_*` / `upward_*` are ablations, `aligned_*` plans at zero friction",
        "margin, and `*_arm_only` waypoints lie outside the fixed arm's reach.",
        "",
    ]
    for family, rows in results.items():
        if family == "_provenance":
            continue
        n_fail = sum(r["failed"] for r in rows)
        lines += [
            f"## {family} — {len(rows)} runs, {n_fail} failures",
            "",
            "| leaf | EE err (m) | max obj disp (m) | failed |",
            "|---|---|---|---|",
        ]
        for r in rows:
            disp = r["max_obj_disp_m"]
            disp_s = f"{disp:.3f}" if isinstance(disp, float) else disp
            lines.append(
                f"| {Path(r['leaf']).name} | {r['ee_err_m']:.3f} "
                f"| {disp_s} | {'X' if r['failed'] else ''} |"
            )
        lines.append("")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="static_obstacles,freespace")
    ap.add_argument("--groups", default=None, help="comma-separated group-name filter")
    ap.add_argument("--friction-model", default=None, choices=["regularized", "stiction"],
                    help="override the plant friction model for every leaf (default: each "
                         "leaf's configured model, stiction unless the leaf opts out)")
    ap.add_argument("--ctrl-rate", type=float, default=100.0)
    ap.add_argument("--out", default=None,
                    help="output JSON (default logs/ral23_results.json, or "
                         "logs/ral23_results_<model>.json under --friction-model)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    if args.out is None:
        stem = "ral23_results" + (f"_{args.friction_model}" if args.friction_model else "")
        args.out = str(REPO / "logs" / f"{stem}.json")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    dtype = DTYPES[args.dtype]

    root = REPO / "configs" / "ral23"
    wanted = args.groups.split(",") if args.groups else None
    results, group_stats = {}, {}
    for family in args.families.split(","):
        print(f"family {family}:", flush=True)
        fam_rows = []
        for name, paths in sorted(discover_groups(root / family).items()):
            if wanted and name not in wanted:
                continue
            stats = {}
            launches0 = riccati.launch_count, contact.launch_count
            fam_rows.extend(run_group(
                name, paths, ctrl_rate=args.ctrl_rate, friction_model=args.friction_model,
                device=args.device, dtype=dtype, stats=stats,
            ))
            stats.update(k1_launches=riccati.launch_count - launches0[0],
                         p1_launches=contact.launch_count - launches0[1],
                         ms_per_tick=stats["loop_s"] * 1e3 / max(stats["ticks"], 1))
            print(f"    {stats['nx']}/{stats['nu']}, B {stats['batch']}: "
                  f"{stats['ms_per_tick']:.2f} ms per tick, cold solve {stats['cold_s']:.2f} s, "
                  f"K1 {stats['k1_launches']} and P1 {stats['p1_launches']} launches", flush=True)
            group_stats[f"{family}/{name}"] = stats
        results[family] = fam_rows

    device_name = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                   else "cpu")
    # provenance stamp: a stale artifact is detectable from the JSON itself.
    # The port has no matmul-precision flag: every float32 product runs at
    # full precision with TF32 off
    results["_provenance"] = {
        "script": "upright_tpu_torch/scripts/ral23_sweep.py",
        "git_hash": _git_hash(),
        "device": device_name,
        "dtype": str(dtype),
        "matmul_precision": "full float32 (TF32 off)" if dtype == torch.float32 else "float64",
        "friction_model": args.friction_model or "per-leaf default (stiction)",
        "ctrl_rate_hz": args.ctrl_rate,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        # per group: host seconds of the cold solve and of the loop, ms per
        # tick, the K1 width, the kernels' launches (0 on the CPU)
        "groups": group_stats,
    }
    out.write_text(json.dumps(results, indent=2))
    print(f"saved {out}")
    lines = markdown_lines(results, device_name)
    md = out.with_suffix(".md")
    md.write_text("\n".join(lines))
    print(f"saved {md}")

    # the plant's default friction model is stiction (configs/simulation.yaml),
    # so a per-leaf-default run is the stiction table as well: mirror it under
    # that name, the mirroring recorded in the provenance
    if args.friction_model is None and out.stem == "ral23_results":
        default_model = cfg.load_config(str(REPO / "configs" / "simulation.yaml")).get(
            "friction_model", "regularized")
        if default_model == "stiction":
            results["_provenance"] = dict(
                results["_provenance"], friction_model="stiction (per-leaf default)",
                mirror_of=out.name,
            )
            mirror = out.with_name("ral23_results_stiction.json")
            mirror.write_text(json.dumps(results, indent=2))
            mirror.with_suffix(".md").write_text(
                "\n".join(lines) + f"\n(Mirror of `{md.name}`: the per-leaf default friction "
                "model resolves to stiction for every leaf.)\n"
            )
            print(f"saved {mirror} (+.md mirror)")
    return results


if __name__ == "__main__":
    main()
