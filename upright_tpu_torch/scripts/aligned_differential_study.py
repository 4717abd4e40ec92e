"""Aligned-ablation differential under hardware-scale disturbances, on the
port.

Counterpart of ``scripts/aligned_differential_study.py``.  The RA-L'23
freespace ablation shows the inertial-alignment heuristic dropping the
stacked foam dice where the full balancing controller holds them.  In a
noise-free simulation both hold; this study ramps one of the plant's noise
knobs on the dice leaf for both controllers:

  --knob process      perturbs the executed velocity command (tracking error)
                      while both controllers keep clean state beliefs;
  --knob measurement  perturbs the controller's state belief as well.

The noise is drawn from a ``torch.Generator`` seeded per run, not from the
JAX package's PRNG keys, so one realisation differs between the packages:
read the study by its ordering over seeds.

Writes the results JSON to ``--out`` (default
``logs/aligned_differential.json``, git-ignored) and the markdown table
beside it; it writes nothing else.

Usage: python -m upright_tpu_torch.scripts.aligned_differential_study
       [--levels 0.0,0.002] [--seeds 3] [--device cpu --dtype float32]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.scripts.mpc_sim import run_closed_loop
from upright_tpu_torch.scripts.ral23_sweep import DTYPES, REPO, _git_hash


def run_leaf(variant, v_std, seed, duration=4.0, ctrl_rate=100.0, knob="process",
             device="cuda", dtype=torch.float32):
    """Worst object displacement (m) of ``<variant>_dice_point1`` after
    ``duration`` s with velocity noise ``v_std`` (rad/s); inf if the plant
    diverged."""
    config = copy.deepcopy(
        cfg.load_config(str(REPO / "configs" / "ral23" / "freespace" / f"{variant}_dice_point1.yaml"))
    )
    noise = config["simulation"].setdefault("robot", {}).setdefault("noise", {})
    if knob == "measurement":
        noise["measurement"] = {"q_std_dev": 0.0, "v_std_dev": float(v_std)}
    elif knob == "process":
        noise["process"] = {"v_std_dev": float(v_std)}
    else:
        raise ValueError(knob)
    sim, state, _, _ = run_closed_loop(
        config, duration=duration, ctrl_rate=ctrl_rate,
        seed=None if v_std == 0.0 else seed, device=device, dtype=dtype,
    )
    worst = float(np.asarray(sim.object_displacements(state)).max())
    return worst if np.isfinite(worst) else float("inf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--levels", default="0.0,0.002,0.005,0.01")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--variants", default="full,aligned")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--ctrl-rate", type=float, default=100.0)
    ap.add_argument("--knob", default="process", choices=["process", "measurement"],
                    help="'process' perturbs the executed velocity command; 'measurement' "
                         "perturbs the controller's state belief as well")
    ap.add_argument("--out", default=None,
                    help="output JSON (default logs/aligned_differential.json)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    out = Path(args.out or REPO / "logs" / "aligned_differential.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    dtype = DTYPES[args.dtype]
    levels = [float(s) for s in args.levels.split(",")]

    rows = []
    for v_std in levels:
        seeds = [0] if v_std == 0.0 else list(range(args.seeds))
        for variant in args.variants.split(","):
            disps = []
            for seed in seeds:
                t0 = time.time()
                worst = run_leaf(variant, v_std, seed, duration=args.duration,
                                 ctrl_rate=args.ctrl_rate, knob=args.knob,
                                 device=args.device, dtype=dtype)
                print(f"  {variant:8s} v_std={v_std:5.3f} seed={seed}: max disp {worst:.4f} m "
                      f"({time.time() - t0:.0f}s)", flush=True)
                disps.append(worst)
            rows.append({
                "variant": variant,
                "v_std_rad_s": v_std,
                "seeds": len(seeds),
                "max_disp_m": max(disps),
                "median_disp_m": float(np.median(disps)),
                "all_disp_m": [round(d, 4) for d in disps],
            })

    device_name = (torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda"
                   else "cpu")
    results = {
        "rows": rows,
        "_provenance": {
            "script": "upright_tpu_torch/scripts/aligned_differential_study.py",
            "noise_knob": args.knob,
            "noise_stream": "torch.Generator seeded per run (not the JAX package's keys)",
            "device": device_name,
            "dtype": str(dtype),
            "git_hash": _git_hash(),
            "duration_s": args.duration,
            "ctrl_rate_hz": args.ctrl_rate,
            "friction_model": "per-leaf default",
            "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        },
    }
    out.write_text(json.dumps(results, indent=2))
    print(f"saved {out}")

    prov = results["_provenance"]
    lines = [
        "# Aligned-ablation differential under disturbance (the PyTorch port)",
        "",
        "Generated by `upright_tpu_torch/scripts/aligned_differential_study.py` on "
        f"{device_name} ({prov['dtype']}): the RA-L'23 freespace dice ablation (aligned vs",
        f"full) rerun closed-loop with increasing joint-velocity noise (knob: **{args.knob}**).",
        "max/median over seeds of the worst balanced-object displacement after "
        f"{args.duration:g} s;",
        "`inf` = plant divergence latch (object left the tray and tumbled).",
        f"Generated at git `{prov['git_hash']}`, {prov['generated_utc']}.",
        "",
        "| v noise (rad/s) | variant | median disp (m) | max disp (m) |",
        "|---|---|---|---|",
    ]
    for r in rows:
        med, mx = r["median_disp_m"], r["max_disp_m"]
        lines.append(
            f"| {r['v_std_rad_s']:.3f} | {r['variant']} "
            f"| {f'{med:.4f}' if np.isfinite(med) else 'inf'} "
            f"| {f'{mx:.4f}' if np.isfinite(mx) else 'inf'} |"
        )
    lines.append("")
    md = out.with_suffix(".md")
    md.write_text("\n".join(lines))
    print(f"saved {md}")
    return results


if __name__ == "__main__":
    main()
