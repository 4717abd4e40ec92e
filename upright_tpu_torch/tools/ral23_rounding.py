#!/usr/bin/env python3
"""The knife-edge ral23 leaf ``freespace/robust_arch_arm_only`` run again
from starts that differ by rounding-sized amounts, to tell an outcome that
rounding decides from one that it does not.

    python3 upright_tpu_torch/tools/ral23_rounding.py [--seeds 0,1,2]
        [--device cuda] [--dtype float32]

Realisation ``s`` moves each joint of the plant's home pose
(``simulation.robot.home``) by ``HOME_EPS`` rad times a standard normal draw
of numpy seed ``s`` (about one float32 rounding step at these angles);
realisation 0 is the config as it stands.  Each runs the leaf's group through
``scripts/ral23_sweep.py`` ``run_group`` at full length and prints one JSON
line a realisation: per leaf, ``failed``, the EE error and the largest
object displacement.  Start several processes with different ``--seeds`` to
run realisations side by side.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import upright_tpu_torch.config as cfg  # noqa: E402

FAMILY = Path(__file__).resolve().parents[2] / "configs" / "ral23" / "freespace"
GROUP = "robust_arch_arm_only"
HOME_EPS = 1e-7


def perturb_home(config, seed):
    """``config`` (a leaf's dict, changed in place) with its plant's home pose
    moved by HOME_EPS x a standard normal draw of ``seed``; seed 0 leaves it."""
    if seed:
        robot = config["simulation"]["robot"]
        home = cfg.parse_array(robot["home"])
        robot["home"] = (home + HOME_EPS * np.random.default_rng(seed).standard_normal(
            home.shape)).tolist()
    return config


def perturbed_loader(load, seed):
    """``load_config`` whose experiment leaves (depth 0) start from the home
    pose of realisation ``seed``."""

    def load_perturbed(path, *args, **kwargs):
        config = load(path, *args, **kwargs)
        if kwargs.get("depth", 0) == 0 and "simulation" in config:
            perturb_home(config, seed)
        return config

    return load_perturbed


def main(argv=None):
    from upright_tpu_torch.scripts import ral23_sweep

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0", help="comma-separated realisations")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    args = ap.parse_args(argv)
    paths = ral23_sweep.discover_groups(FAMILY)[GROUP]
    load = cfg.load_config
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    out = []
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            ral23_sweep.cfg.load_config = perturbed_loader(load, seed)
            stats = {}
            rows = ral23_sweep.run_group(GROUP, paths, device=args.device,
                                         dtype=getattr(torch, args.dtype), stats=stats)
            line = {"group": GROUP, "seed": seed, "home_eps": HOME_EPS,
                    "device": card, "dtype": args.dtype, "wall_s": stats["wall_s"],
                    "leaves": [{"leaf": r["leaf"], "failed": r["failed"],
                                "ee_err_m": stats["ee_err_m"][b],
                                "max_obj_disp_m": float(max(stats["obj_disp_m"][b]))}
                               for b, r in enumerate(rows)]}
            print("REALISATION " + json.dumps(line), flush=True)
            out.append(line)
    finally:
        ral23_sweep.cfg.load_config = load
    return out


if __name__ == "__main__":
    main()
