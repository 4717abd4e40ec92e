#!/usr/bin/env python3
"""Where the plant kernel P1 spends its cycles, at batch 1.

    python3 upright_tpu_torch/tools/plant_phases.py [--work DIR]

Copies the package into ``--work`` (default ``_parent/plant_phases`` under
the checkout, a git-ignored place), builds the copy's ``csrc/plant.cu`` with
``-DPLANT_PHASE_CLOCK``, which turns the source's phase marks into
``clock64()`` reads by thread 0 of a one-block launch, and launches it once
per case, float32, one tick of 10 outer steps.  Prints one JSON line: SM
cycles per phase summed over the tick as thread 0 sees them (the frames of
each outer step with their barrier; the slot phase with the integration's
inputs; the reduction; the integration with its stores; the waits at the
two barriers of a substep), the total, the number of substeps, cycles per
substep, and the SM clock that nvidia-smi read just after, so that cycles per
substep times the substeps of a tick estimate the tick's time from its chain.

The clock reads cost a few tens of cycles each and keep the compiler from
moving work across them: read the split, not the last percent.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# (label, demo, arrangement)
LAUNCHES = [
    ("thing_demo", "thing_demo", None),
    ("box_arch", "ur10_demo", "box_arch"),
    ("blue_cups", "ur10_demo", "blue_cups"),
    ("foam_die2", "ur10_demo", "foam_die2"),
]

LAUNCHER = """
import sys, json, torch
sys.path.insert(0, {work!r})
from upright_tpu_torch import _build
from upright_tpu_torch.sim import contact
from upright_tpu_torch.tools.plant_data import objects_to, plant_for, tick_inputs
_build.load_library("plant", extra_flags=("-DPLANT_PHASE_CLOCK",))
dev = torch.device("cuda")
for label, demo, arrangement in json.loads({launches!r}):
    sim = plant_for(demo, arrangement)
    frames, objects, params = tick_inputs(sim, 1, seed=1)
    contact.advance_objects(sim.tables.to(device=dev, dtype=torch.float32), sim.contact,
                            frames.to(dev, torch.float32), objects_to(objects, dev, torch.float32),
                            {{k: v.to(dev, torch.float32) for k, v in params.items()}})
    torch.cuda.synchronize()
    print("LAUNCHED " + label, flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=str(REPO / "_parent" / "plant_phases"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("plant_phases: no CUDA device is available", file=sys.stderr)
        return 2
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "upright_tpu_torch", work / "upright_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(REPO / "configs", work / "configs")
    code = LAUNCHER.format(work=str(work), launches=json.dumps(LAUNCHES))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(work))
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    # each launch prints its line when the device's buffer is flushed at the
    # synchronise, before the launcher's LAUNCHED line
    out, pending = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("PHASES "):
            pending = {k: int(v) for k, v in re.findall(r"(\w+) (\d+)", line[7:])}
        elif line.startswith("LAUNCHED ") and pending is not None:
            pending["cycles_per_substep"] = pending["total"] / pending["substeps"]
            out[line[9:]] = pending
            pending = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "cycles": out}), flush=True)
    return 0 if len(out) == len(LAUNCHES) else 1


if __name__ == "__main__":
    sys.exit(main())
