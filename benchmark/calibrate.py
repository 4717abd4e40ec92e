"""Readings that the limits of a cell's numbers are set from.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --units 24 --samples 40 --out readings.json

For each seed, in one process: the cell's set-up at its own size, ``--units``
units of its timed path (untimed), and the check of ``check.py`` on
``--units`` x ``--samples`` sampled instance-units (as many as a run's
window judges); for each control seed, the same check with the control (the
reference in float32 with TF32 products in the program's place).  Prints one
JSON line per seed and writes them all to ``--out``.  Runs on the card only.
"""

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, generator, registry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--units", type=int, default=24)
    ap.add_argument("--samples", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    from upright_tpu_torch import _build

    _build.build(list(_build.SOURCES))
    cell = registry.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        wl = generator.make(cell, seed, samples=args.samples)
        wl.setup()
        for _ in range(args.units):
            wl.unit()
        torch.cuda.synchronize()
        nonfinite = int(wl.nonfinite)
        wl.release()
        gc.collect()
        torch.cuda.empty_cache()
        row = {"seed": seed, "nonfinite": nonfinite}
        if seed in seeds:
            row["program"], row["info"] = check.check(cell, wl)
        if seed in controls:
            row["control"], _ = check.check(cell, wl, control=True)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del wl
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "units": args.units,
                       "samples": args.samples, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
