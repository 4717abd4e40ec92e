#!/usr/bin/env python3
"""Time the plant kernel P1 of one checkout on the card, case by case.

    python3 upright_tpu_torch/tools/plant_times.py [--root DIR] [--reps 20]
                                           [--ptxas] [--out FILE] [--brief]

Builds ``csrc/plant.cu`` of the checkout at ``--root`` (default: the one this
file is in), makes one control tick's inputs with that checkout's
``tools/plant_data.py`` (numpy seeds, the objects settled and moving), checks
the float64 kernel against the float64 plain version of the same checkout
(1e-10), and prints median times (CUDA events) of the float32 kernel, two per
case: ``ms``, the device time of one launch (a CUDA graph of 5 launches back
to back, replayed, over 5), and ``single_call_ms``, one eager call of the
wrapper between two events on an idle card, which adds the host's time from
the first event to the launch.  ``--brief`` prints one short line instead, for
a log that keeps only the end of a job's output.  To compare two commits,
unpack the other one into a git-ignored directory and run this file once per
checkout within one job on one card, in turns (other, this, this, other).

The cases: thing_demo (the main path: 1 object, 16 slots, 40 substeps an
outer step) at batch 1 and 512, box_arch (3 stacked objects, 32 slots, one
warp) and blue_cups (7 objects, 112 slots, four warps) at batch 1; one tick
of 10 outer steps each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[2]

# (label, demo, arrangement, batch); batch 512 is the batch-64 tick repeated
CASES = [
    ("thing_b1", "thing_demo", None, 1),
    ("thing_b512", "thing_demo", None, 512),
    ("box_arch_b1", "ur10_demo", "box_arch", 1),
    ("blue_cups_b1", "ur10_demo", "blue_cups", 1),
]
F64_TOL = 1e-10


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(OWN_ROOT),
                    help="checkout whose upright_tpu_torch is built and timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true", help="print what ptxas -v says of the build")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--brief", action="store_true", help="print one short line, not the JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("plant_times: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from upright_tpu_torch import _build
    from upright_tpu_torch.sim import contact
    from upright_tpu_torch.tools.plant_data import max_errors, objects_to, plant_for, tick_inputs

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.load_library("plant", extra_flags=("-Xptxas", "-v") if args.ptxas else (),
                        verbose=args.ptxas)

    def median_ms(fn, reps):
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def launch_ms(fn, reps, inner=5):
        """Device time of one launch: `inner` launches captured back to back."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        graph.replay()
        return median_ms(graph.replay, reps) / inner

    def on_card(frames, objects, params, dtype, repeat=1):
        def rep(t):
            return None if t is None else t.repeat((repeat,) + (1,) * (t.ndim - 1))

        o = objects_to(objects, dev, dtype)
        o = o.replace(**{k: rep(getattr(o, k)) for k in
                         ("r", "q", "v", "w", "anchors", "anchor_valid", "diverged")})
        return (rep(frames.to(dev, dtype)), o,
                {k: rep(v.to(dev, dtype)) for k, v in params.items()})

    out = {"root": root.name, "card": card, "reps": args.reps,
           "ms": {}, "single_call_ms": {}, "err_f64_vs_plain": {}}
    for label, demo, arrangement, batch in CASES:
        sim = plant_for(demo, arrangement)
        made = min(batch, 64)
        frames, objects, params = tick_inputs(sim, made, seed=made)
        tables64 = sim.tables.to(device=dev)
        tables32 = tables64.to(dtype=torch.float32)
        inp64 = on_card(frames, objects, params, torch.float64, batch // made)
        ref = contact.advance_objects_plain(tables64, sim.contact, *inp64)
        got = contact.advance_objects(tables64, sim.contact, *inp64)
        torch.cuda.synchronize()
        err, same = max_errors(got, ref)
        if not (same and max(err.values()) <= F64_TOL):
            raise AssertionError(f"{label}: float64 kernel differs from the plain version: {err}")
        out["err_f64_vs_plain"][label] = max(err.values())
        inp = on_card(frames, objects, params, torch.float32, batch // made)
        call = lambda: contact.advance_objects(tables32, sim.contact, *inp)  # noqa: E731
        out["ms"][label] = launch_ms(call, args.reps)
        out["single_call_ms"][label] = median_ms(call, args.reps)
    line = json.dumps(out)
    if args.brief:
        cells = " ".join(f"{label} {out['ms'][label]:.4f}/{out['single_call_ms'][label]:.4f}"
                         for label, *_ in CASES)
        print(f"PLANT_TIMES {root.name} {card} launch/single ms, median of {args.reps}: {cells}",
              flush=True)
    else:
        print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
