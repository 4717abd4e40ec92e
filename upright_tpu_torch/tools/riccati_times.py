#!/usr/bin/env python3
"""Time the Riccati kernel of one checkout on the card, shape by shape.

    python3 upright_tpu_torch/tools/riccati_times.py [--root DIR] [--reps 50]
                                             [--ptxas] [--out FILE] [--brief]

Builds ``csrc/riccati.cu`` of the checkout at ``--root`` (default: the one
this file is in), checks each case against the float64 plain version of the
same checkout, and prints one JSON line of median times (CUDA events), two per
case: ``ms``, the device time of one launch (a CUDA graph of 20 launches back
to back, replayed, over 20), and ``single_call_ms``, one eager call of the
wrapper between two events on an idle card, which adds the host's time from
the first event to the launch (allocation of K and kff, argument checks).
``--brief`` prints one short line instead (case, ms / single-call ms), for a
log that keeps only the end of a job's output.  To compare two commits, unpack
the other one into a git-ignored directory and run this file once per checkout
within one job on one card, in turns (other, this, this, other): times from
different cards or jobs do not compare.

Another checkout may not take every case (a dtype, a width, the runtime-sized
option): there such a case is reported as null with the reason.  On this
checkout every case must run.
"""

from __future__ import annotations

import argparse
import json
import runpy
import statistics
import subprocess
import sys
from pathlib import Path

OWN_ROOT = Path(__file__).resolve().parents[2]

# (label, Bt, N, nx, nu, stage-invariant A and B, dtype, runtime-sized instance);
# a_ / b_: per-stage / stage-invariant dynamics, _rt: the runtime-sized instance
CASES = [
    ("b_512x20x27x13", 512, 20, 27, 13, True, "float32", False),
    ("a_512x20x27x13", 512, 20, 27, 13, False, "float32", False),
    ("b_1x20x27x13", 1, 20, 27, 13, True, "float32", False),
    ("b_512x20x27x13_rt", 512, 20, 27, 13, True, "float32", True),
    ("b_1x20x27x13_rt", 1, 20, 27, 13, True, "float32", True),
    ("b_512x20x18x10", 512, 20, 18, 10, True, "float32", False),
    ("b_1x20x18x10", 1, 20, 18, 10, True, "float32", False),
    ("b_512x20x18x10_rt", 512, 20, 18, 10, True, "float32", True),
    ("b_1x20x18x10_rt", 1, 20, 18, 10, True, "float32", True),
    ("b_512x20x27x13_f64", 512, 20, 27, 13, True, "float64", False),
    ("b_64x20x27x45", 64, 20, 27, 45, True, "float32", False),
    ("b_64x200x27x13", 64, 200, 27, 13, True, "float32", False),
    # the widths above 16 of the ral23 configs (chip_smoke.py phase 11) and of
    # the robust plans (phase 16), at their batches there
    ("b_512x20x27x21", 512, 20, 27, 21, True, "float32", False),
    ("b_64x20x27x17", 64, 20, 27, 17, True, "float32", False),
    ("b_64x20x27x25", 64, 20, 27, 25, True, "float32", False),
    ("b_64x20x27x33", 64, 20, 27, 33, True, "float32", False),
    ("b_64x20x27x37", 64, 20, 27, 37, True, "float32", False),
    ("b_64x20x27x57", 64, 20, 27, 57, True, "float32", False),
    ("b_64x20x27x93", 64, 20, 27, 93, True, "float32", False),
    ("b_64x20x18x22", 64, 20, 18, 22, True, "float32", False),
    ("b_64x20x18x34", 64, 20, 18, 34, True, "float32", False),
    ("b_64x20x18x54", 64, 20, 18, 54, True, "float32", False),
    ("b_64x20x18x90", 64, 20, 18, 90, True, "float32", False),
    ("b_1x100x27x41", 1, 100, 27, 41, True, "float32", False),
    ("b_1x30x18x38", 1, 30, 18, 38, True, "float32", False),
    ("b_64x20x27x57_f64", 64, 20, 27, 57, True, "float64", False),
    ("b_64x20x27x93_f64", 64, 20, 27, 93, True, "float64", False),
    ("b_64x20x18x90_f64", 64, 20, 18, 90, True, "float64", False),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(OWN_ROOT),
                    help="checkout whose upright_tpu_torch is built and timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--ptxas", action="store_true", help="print what ptxas -v says of the build")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--brief", action="store_true", help="print one short line, not the JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("riccati_times: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    # the generator beside this file, by path: the package imported below is
    # --root's, which may be an older checkout without it
    stage_data = runpy.run_path(str(Path(__file__).with_name("stage_data.py")))["stage_data"]
    sys.path.insert(0, str(root))
    from upright_tpu_torch import _build
    from upright_tpu_torch.solver import riccati

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.load_library("riccati", extra_flags=("-Xptxas", "-v") if args.ptxas else (),
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

    def launch_ms(fn, reps, inner=20):
        """Device time of one launch: `inner` launches captured back to back."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        graph.replay()
        return median_ms(graph.replay, reps) / inner

    out = {"root": root.name, "card": card, "reps": args.reps,
           "ms": {}, "single_call_ms": {}, "rel_err_vs_plain_f64": {}, "skipped": {}}
    for label, Bt, N, nx, nu, invariant, dtype, runtime_sized in CASES:
        arrays = stage_data(Bt, N, nx, nu, seed=1, invariant=invariant)
        inp = tuple(torch.as_tensor(a, dtype=getattr(torch, dtype), device=dev) for a in arrays)
        if runtime_sized:
            call = lambda: riccati._riccati_backward_cuda(*inp, 1e-6, runtime_sized=True)  # noqa: E731
        else:
            call = lambda: riccati.riccati_backward(*inp, reg=1e-6)  # noqa: E731
        try:
            K, kff = call()
        except (NotImplementedError, TypeError, ValueError) as e:
            if root == OWN_ROOT:
                raise
            out["ms"][label] = None
            out["skipped"][label] = f"{type(e).__name__}: {e}"
            continue
        torch.cuda.synchronize()
        K_ref, kff_ref = riccati.riccati_backward_plain(*(t.double() for t in inp), reg=1e-6)
        scale = max(1.0, float(K_ref.abs().max()))
        err = max(float((K.double() - K_ref).abs().max()),
                  float((kff.double() - kff_ref).abs().max())) / scale
        tol = 1e-4 if dtype == "float32" else 1e-10
        if not err <= tol:
            raise AssertionError(f"{label}: kernel differs from the plain version by {err:.3e}")
        out["rel_err_vs_plain_f64"][label] = err
        out["ms"][label] = launch_ms(call, args.reps)
        out["single_call_ms"][label] = median_ms(call, args.reps)
    line = json.dumps(out)
    if args.brief:
        cells = " ".join(
            f"{label} {out['ms'][label]:.4f}/{out['single_call_ms'][label]:.4f}"
            if out["ms"][label] is not None else f"{label} -"
            for label, *_ in CASES)
        print(f"TIMES {root.name} {card} launch/single ms, median of {args.reps}: {cells}",
              flush=True)
    else:
        print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
