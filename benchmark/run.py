"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks for.
Set-up (imports, CUDA, the kernels' libraries, the problem, the inputs from
the seed, the cold solve, the warm-up units) is timed from the start of this
module; then the window runs the cell's units back to back for ``--seconds``,
and with ``--trace 1`` a few more units under the profiler.  Once the window
has closed, the reference judges the sampled units (``check.py``).  The last
line of standard output is one JSON object; the last lines of standard error
are the numbers compared, each with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import guard, registry  # noqa: E402

def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_state():
    """The card's name, power limit, clocks and temperature from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, trace_on=False, device="cuda"):
    """Set up the cell, run its window and judge it: (exit code, result
    dict or None, lines for standard error).  ``device`` is the card; the
    tests drive the same path on the CPU, where nothing is timed on a
    device clock and the kernels are the program's plain versions."""
    import torch

    from benchmark import check, generator, trace

    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        log(f"card: {card_state()}")
    wl = generator.make(cell, seed, device=device)
    t_build = time.perf_counter()
    from upright_tpu_torch import _build
    from upright_tpu_torch.solver import riccati

    if on_card:
        _build.build(list(_build.SOURCES))
    log(f"kernel libraries built or found in {time.perf_counter() - t_build:.3f} s")
    wl.setup()
    _sync(device)
    setup_s = time.perf_counter() - T_START

    # -- the window ------------------------------------------------------------
    k1_start = riccati.launch_count
    wl.start_window()
    dispatch = []
    t0 = time.perf_counter()
    while True:
        dispatch.append(wl.unit())
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    units = wl.units
    # a unit's time: the card's clock between the events around its program
    # call (the host's, the dispatch, where there is no card)
    unit_s = [a.elapsed_time(b) * 1e-3 for a, b in wl.marks] if on_card else list(dispatch)
    wl.marks = None
    k1_launches = riccati.launch_count - k1_start

    traced = trace.capture(wl.unit, int(cell.traffic["trace_units"])) if trace_on else None
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    nonfinite = int(wl.nonfinite)
    found = guard.forbidden_modules()
    if found:
        return 5, None, [f"benchmark: forbidden modules loaded: {found}"]

    ctx = {
        "kind": wl.kind, "batch": wl.B, "units": units, "window_s": window_s,
        "unit_s": unit_s, "dispatch_s": dispatch, "setup_s": setup_s, "trace": traced,
        "config": cell.config, "traffic": cell.traffic,
        "dims": {"N": wl.prob.ocp.N, "nx": wl.prob.ocp.nx, "nu": wl.prob.ocp.nu},
        "linear_dynamics": bool(wl.prob.ocp.linear_dynamics),
        "sqp_iterations": wl.iterations_per_unit(),
    }
    log(f"window: {units} units of {wl.B} in {window_s:.3f} s; {k1_launches} K1 launches "
        f"({k1_launches / max(units, 1):.3f} a unit, {ctx['sqp_iterations']} SQP iteration(s) "
        f"a unit); peak device memory {memory_peak} bytes; dispatch "
        f"{1e3 * sum(dispatch) / len(dispatch):.2f} ms a unit, longest {1e3 * max(dispatch):.2f} ms; "
        f"longest unit {1e3 * max(unit_s):.2f} ms")

    wl.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, info = check.check(cell, wl)
    log(f"reference check of {info['pairs']} sampled instance-units in "
        f"{time.perf_counter() - t_check:.1f} s (line-search ties {info['ties']}, "
        f"judged against a tied outcome {info['off_best']})")
    correct, rows, lines = check.verdict(numbers, cell.limits, nonfinite)
    if on_card:  # the plain version on the CPU launches nothing
        per_it = k1_launches / max(units * ctx["sqp_iterations"], 1)
        rows.append(("k1_launches_per_iteration", per_it, 1.0))
        lines.append(f"check k1_launches_per_iteration: {per_it!r} (limit 1.0, exactly)")
        correct = correct and per_it == 1.0

    metrics = {}
    for m in cell.per_layer if trace_on else cell.end_to_end:
        value = registry.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": units * wl.B, "failed": nonfinite,
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.device_ops(),
                               "idle_gaps": traced.idle_gaps()}
        log(f"traced {traced.units} units: {traced.launches} launch calls, busy "
            f"{traced.busy_s:.4f} s of {traced.window_s:.4f} s; card: {card_state()}")
    result["checked"] = check.as_table(rows)
    found = guard.forbidden_modules()
    if found:
        return 5, None, [f"benchmark: forbidden modules loaded: {found}"]
    return 0, result, lines


def main(argv=None):
    args = parse_args(argv)
    cell = registry.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    code, result, lines = run(cell, args.seed, args.seconds, bool(args.trace))
    for line in lines:
        log(line)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
