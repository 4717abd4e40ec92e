#!/usr/bin/env python3
"""Where one stage of the Riccati kernel spends its cycles, at batch 1.

    python3 upright_tpu_torch/tools/riccati_phases.py [--work DIR]

Copies the package into ``--work`` (default ``_parent/phases`` under the
checkout, a git-ignored place), builds the copy's ``csrc/riccati.cu`` with
``-DRICCATI_PHASE_CLOCK``, which turns the source's phase marks into
``clock64()`` reads (thread 0 of a one-block launch, stage 3), and launches it
once per instance at batch 1.  Prints one JSON line: SM cycles per phase, as
thread 0 sees them, each phase ending at the barrier that closes it (on the
wide route, nu > 16, the elimination is two phases: the factorisation with the
forward substitution, and the back substitution).  At batch 1 the kernel's
time is N times such a stage.

The clock reads cost a few tens of cycles each and keep the compiler from
moving memory operations across them: read the split, not the last percent.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# (label, dtype, nx, nu, runtime-sized instance)
LAUNCHES = [
    ("float32 nx=27 nu=13", "float32", 27, 13, False),
    ("float32 nx=18 nu=10", "float32", 18, 10, False),
    ("float32 runtime-sized 27/13", "float32", 27, 13, True),
    ("float32 runtime-sized 18/10", "float32", 18, 10, True),
    ("float64 runtime-sized 27/13", "float64", 27, 13, False),
    # the wide route (nu > 16): one panel and more, float32 and float64
    ("float32 wide 27/21", "float32", 27, 21, False),
    ("float32 wide 27/45", "float32", 27, 45, False),
    ("float32 wide 27/93", "float32", 27, 93, False),
    ("float64 wide 27/57", "float64", 27, 57, False),
    ("float64 wide 27/93", "float64", 27, 93, False),
    ("float64 wide 18/90", "float64", 18, 90, False),
]

LAUNCHER = """
import sys, json, torch
sys.path.insert(0, {work!r})
from upright_tpu_torch import _build
from upright_tpu_torch.solver import riccati
from upright_tpu_torch.tools.stage_data import stage_data
_build.load_library("riccati", extra_flags=("-DRICCATI_PHASE_CLOCK",))
for label, dtype, nx, nu, runtime_sized in json.loads({launches!r}):
    inp = tuple(torch.as_tensor(a, dtype=getattr(torch, dtype), device="cuda")
                for a in stage_data(1, 20, nx, nu, 1, True))
    riccati._riccati_backward_cuda(*inp, 1e-6, runtime_sized=runtime_sized)
    torch.cuda.synchronize()
    print("LAUNCHED " + label, flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=str(REPO / "_parent" / "phases"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("riccati_phases: no CUDA device is available", file=sys.stderr)
        return 2
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(REPO / "upright_tpu_torch", work / "upright_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = LAUNCHER.format(work=str(work), launches=json.dumps(LAUNCHES))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    # each launch prints its line when the device's buffer is flushed at the
    # synchronise, before the launcher's LAUNCHED line
    out, pending = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("PHASES "):
            names, cycles = line[7:].split(";")
            pending = dict(zip(names.split(), map(int, cycles.split())))
            pending["stage"] = sum(pending.values())
        elif line.startswith("LAUNCHED ") and pending is not None:
            out[line[9:]] = pending
            pending = None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "cycles_per_stage": out}), flush=True)
    return 0 if len(out) == len(LAUNCHES) else 1


if __name__ == "__main__":
    sys.exit(main())
