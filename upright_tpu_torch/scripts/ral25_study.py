"""The full ral25 robust-balancing study, end to end, on the port.

Counterpart of ``scripts/ral25_study.py``: the reference's headline robust
experiment (upright_robust/scripts/planning_sim_loop.py:410-655 +
process_sim_runs.py) on the mobile manipulator.  A 1 kg, 15x15xH cm box with
an uncertain CoM (+-6 cm laterally, +-H/2 vertically) is balanced at mu = 0.2
while the base drives about 2 m to each of the three paper waypoints.  For
each planning variant of the reference's --com flag

  center / top / bottom : nominal plan with the CoM pinned at the box
                          centroid / +z / -z extreme
  robust                : one OCP over the 8 CoM-vertex scenarios

each waypoint's offline plan is tracked under the 15-CoM x 3-inertia grid of
true parameters (per-CoM worst-case inertias), 135 runs per variant, each
waypoint's 45 runs as one batched tracking loop.

Writes the results JSON to ``--out`` (default
``logs/ral25_results_h<height>.json``, git-ignored) and a markdown
table beside it, and with ``--verify`` the verification table; it writes
nothing else.

Usage: python -m upright_tpu_torch.scripts.ral25_study [--height 20]
       [--variants robust,center] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.robust.planning import ral25_protocol

# the three goal displacements from the paper (planning_sim_loop.py:447)
WAYPOINTS = [[-2.0, 1.0, 0.0], [2.0, 0.0, -0.25], [0.0, -2.0, 0.25]]
MU = 0.2
COM_XY = 0.06  # lateral CoM-box half extent (planning_sim_loop.py:453)
REPO = Path(__file__).resolve().parents[2]


def build_study_config(height_m: float) -> dict:
    """thing_demo with the study's box (1 kg, 15 x 15 x height) as the one
    balanced object, on the tray at mu 0.2, and the three waypoints."""
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/thing_demo.yaml"})
    config = cfg.load_config(path)

    box = {
        "mass": 1.0,
        "shape": "cuboid",
        "com_offset": [0.0, 0.0, 0.0],
        "side_lengths": [0.15, 0.15, height_m],
    }
    arrangement = {
        "objects": [{"name": "box", "type": "ral25_box", "parent": "ee"}],
        "contacts": [{"first": "ee", "second": "box", "mu": MU, "support_area_inset": 0.0}],
    }
    for section in ("controller", "simulation"):
        config[section].setdefault("objects", {})["ral25_box"] = copy.deepcopy(box)
        config[section].setdefault("arrangements", {})["ral25"] = copy.deepcopy(arrangement)
    config["controller"]["balancing"]["arrangement"] = "ral25"
    config["simulation"]["arrangement"] = "ral25"
    config["controller"]["waypoints"] = [
        {"time": 0, "position": wp, "orientation": [0, 0, 0, 1]} for wp in WAYPOINTS
    ]
    return config


def _git_hash():
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=20, help="box height (cm)")
    ap.add_argument("--variants", default="center,top,bottom,robust")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--kp", type=float, default=10.0)
    ap.add_argument("--out", default=None,
                    help="output JSON (default logs/ral25_results_h<height>.json)")
    ap.add_argument("--verify", action="store_true",
                    help="post-hoc worst-case CWC certification of every offline plan over the "
                         "inertial ambiguity set; writes the verification table beside --out")
    ap.add_argument("--verify-realizable", action="store_true",
                    help="also verify over the density-realizable parameter set")
    ap.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = ap.parse_args()

    out_path = Path(args.out or REPO / "logs" / f"ral25_results_h{args.height}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    dtype = torch.float64 if args.device == "cpu" else torch.float32
    h = args.height / 100.0
    com_box = [[COM_XY, COM_XY, h / 2]]
    study = {
        "protocol": "ral25",
        "height_cm": args.height,
        "mu": MU,
        "com_half_extents": com_box[0],
        "waypoints": WAYPOINTS,
        "grid": "15 CoM x 3 inertia scales (worst-case inertias)",
        "failure_threshold_m": 0.5,
        "variants": {},
    }
    for variant in args.variants.split(","):
        t0 = time.time()
        out = ral25_protocol(
            build_study_config(h), com_half_extents=com_box, duration=args.duration,
            iterations=args.iterations, kp=args.kp, com_variant=variant, verify=args.verify,
            verify_realizable=args.verify_realizable, device=args.device, dtype=dtype,
        )
        out["wall_s"] = round(time.time() - t0, 1)
        study["variants"][variant] = out
        print(f"{variant}: {out['failures']}/{out['runs']} failures ({out['wall_s']}s)",
              flush=True)

    device_name = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
                   else "cpu")
    study["_provenance"] = {
        "script": "upright_tpu_torch/scripts/ral25_study.py",
        "git_hash": _git_hash(),
        "device": device_name,
        "dtype": str(dtype),
        "verify": bool(args.verify),
        "verify_realizable": bool(args.verify_realizable),
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    out_path.write_text(json.dumps(study, indent=2))
    print(f"saved {out_path}")

    md = out_path.with_suffix(".md")
    lines = [
        "# ral25 robust-balancing study (the PyTorch port)",
        "",
        f"Generated by `upright_tpu_torch/scripts/ral25_study.py --height {args.height}` on "
        f"{device_name} ({dtype}): 1 kg 15x15x{args.height} cm box, CoM box "
        f"+-{COM_XY*100:.0f} cm lateral / +-{args.height/2:.0f} cm vertical, mu = {MU}, three "
        "~2 m waypoints, 15 CoM x 3 inertia-scale true-parameter grid per waypoint "
        "(135 runs per variant; failure = object displacement > 0.5 m).",
        "",
        "| planner CoM variant | failures / runs | max displacement (m) |",
        "|---|---|---|",
    ]
    for variant, out in study["variants"].items():
        max_disp = max(w["max_displacement_m"] for w in out["waypoints"])
        lines.append(f"| {variant} | {out['failures']} / {out['runs']} | {max_disp:.3f} |")
    lines += ["", f"Generated at git `{study['_provenance']['git_hash']}`, "
              f"{study['_provenance']['generated_utc']}.", ""]
    md.write_text("\n".join(lines))
    print(f"saved {md}")

    if args.verify:
        vmd = out_path.parent / f"{out_path.stem}_verification.md"
        vlines = [
            "# ral25 post-hoc worst-case verification (the PyTorch port)",
            "",
            "Every offline plan's states certified against the full CoM-box x inertia-scale "
            "ambiguity set (exact vertex form of the contact-wrench-cone faces"
            + (", and the density-realizable set" if args.verify_realizable else "")
            + "); positive violation = some feasible parameters break balance at a planned "
            "state.",
            "",
            "| variant | waypoint | worst-case CWC violation | states in violation | sim failures |",
            "|---|---|---|---|---|",
        ]
        for variant, out in study["variants"].items():
            for w in out["waypoints"]:
                v = w.get("verification", {})
                extra = ""
                if "worst_case_cwc_violation_realizable" in v:
                    extra = f" (realizable {v['worst_case_cwc_violation_realizable']:.3f})"
                vlines.append(
                    f"| {variant} | {w['waypoint']} | "
                    f"{v.get('worst_case_cwc_violation', float('nan')):.3f}{extra} | "
                    f"{v.get('violation_steps', '?')} / {v.get('n_states', '?')} | "
                    f"{w['failures']} / {w['runs']} |"
                )
        vlines.append("")
        vmd.write_text("\n".join(vlines))
        print(f"saved {vmd}")


if __name__ == "__main__":
    main()
