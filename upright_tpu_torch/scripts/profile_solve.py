"""Per-phase solve-time breakdown of the flagship batched solve, read from
the solver's spans.

Counterpart of ``scripts/profile_solve.py``.  Builds thing_demo, solves a
batch once from a cold start (x0 perturbed by 0.01, numpy seed 0), then runs
warm solves from that start under torch.profiler and prints each ``al.*``
span of ``solver/al.py`` (``tracing.py``): its host ms, from the profiler's
events, and on the card its card ms, from the spans' CUDA events
(``tracing.card_ms()``).  ``chip_smoke.py --breakdown`` calls
``span_breakdown`` on its own problems.

    python -m upright_tpu_torch.scripts.profile_solve [--batch 512] [--trace out.json]
        [--device cuda|cpu]

Runs on the card (float32) by default; ``--device cpu`` runs the plain
versions in float64 and reads no card time.  ``--trace`` writes the Chrome
trace, where the spans are ``cpu_op`` events named ``al.*``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.profiler import ProfilerActivity

import upright_tpu_torch.config as cfg
from upright_tpu_torch import tracing
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import batch_warm_starts, broadcast_params
from upright_tpu_torch.solver.al import ALConfig, solve

PHASES = ("al.linearize", "al.backward", "al.line_search", "al.update")


def span_breakdown(ocp, al_cfg, p, x0, st, label="", log=print, n_prof=3, trace_path=None):
    """Run ``n_prof`` solves of ``ocp`` from the warm start ``st`` under
    torch.profiler, after one untraced warm-up, and read the solver's spans.
    Returns {"solve_ms": host ms of ``al.solve`` a solve, "phases_ms": {span
    name: host ms a solve}}, and on the card "card_ms": {span name: card ms
    a solve}, ``al.solve`` among them.  The Chrome trace goes to
    ``trace_path`` when given."""
    cuda = ocp.device.type == "cuda"
    dev_kw = dict(device=ocp.device, dtype=ocp.dtype)
    solve(ocp, al_cfg, p, x0, st, **dev_kw)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    tracing.reset()
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n_prof):
            solve(ocp, al_cfg, p, x0, st, **dev_kw)
        if cuda:
            torch.cuda.synchronize()
    if trace_path:
        prof.export_chrome_trace(str(trace_path))
    host = dict.fromkeys(("al.solve",) + PHASES, 0.0)
    for evt in prof.events():
        if evt.name in host:
            host[evt.name] += evt.time_range.elapsed_us() * 1e-3 / n_prof
    out = {"solve_ms": host.pop("al.solve"), "phases_ms": host}
    card = {name: sum(ms) / n_prof for name, ms in tracing.card_ms().items()}
    parent = tracing.parents()
    if card:
        out["card_ms"] = card
    if tracing.dropped:
        log(f"    {tracing.dropped} span(s) past tracing.MAX_RECORDS were not timed")
    tracing.reset()

    def row(name, host_ms):
        line = f"{host_ms:.2f} ms host ({100 * host_ms / out['solve_ms']:.1f}% of al.solve)"
        if name in card:
            line += f", {card[name]:.2f} ms card"
            if parent.get(name) in card:
                line += f" ({100 * card[name] / card[parent[name]]:.1f}% of {parent[name]})"
        return line

    log(f"  [{label}] one solve, profiler on: {row('al.solve', out['solve_ms'])}")
    for name, host_ms in host.items():
        log(f"    {name}: {row(name, host_ms)}")
    return out


def profile(batch=512, device="cuda", dtype=torch.float32, trace_path=None, log=print, N=None):
    """The span breakdown at ``batch``; ``N`` cuts the horizon (the config's
    20 by default)."""
    path = cfg.resolve_package_path({"package": "configs", "path": "demos/thing_demo.yaml"})
    prob = build_problem(cfg.load_config(path), N=N, device=device, dtype=dtype)
    ocp = prob.ocp
    al_cfg = ALConfig(iterations=1, line_search_steps=(1.0, 0.5, 0.25, 0.1))
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(prob.x0.cpu().numpy()[None, :]
                          + 0.01 * rng.standard_normal((batch, ocp.nx)),
                          dtype=dtype, device=ocp.device)
    params = broadcast_params(prob.stage_params(0.0), batch)
    states = batch_warm_starts(ocp, x0s, device=ocp.device, dtype=dtype)
    warm = solve(ocp, al_cfg, params, x0s, states, device=ocp.device, dtype=dtype).state
    where = torch.cuda.get_device_name(ocp.device) if ocp.device.type == "cuda" else "the CPU"
    log(f"thing_demo, batch {batch} on {where}")
    return span_breakdown(ocp, al_cfg, params, x0s, warm, label=f"thing_demo, batch {batch}",
                          log=log, trace_path=trace_path)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--trace", default=None, help="write a Chrome trace of the solves here")
    parser.add_argument("--device", default="cuda", help="cuda (float32) or cpu (float64)")
    args = parser.parse_args(argv)
    dtype = torch.float64 if args.device == "cpu" else torch.float32
    return profile(args.batch, device=args.device, dtype=dtype, trace_path=args.trace)


if __name__ == "__main__":
    main()
