"""The comparison that decides ``correct``.

After the window has closed, the reference (``benchmark/reference``, plain
PyTorch, float64) recomputes every sampled unit of work from what went into
it, and each number below is the widest gap, over the sampled instances and
units, between what the program's timed path produced and what the
reference produces.  Gaps of tensors are relative: the largest entry of the
difference over ``max(1, largest entry of the reference)``, per instance.

A cell whose ``gap`` is ``over_plain`` holds each instance-unit's gap
against the plain reference's own: the same frozen code in the
configuration's precision (TF32 off), on the same inputs, departs from
float64 by ``g_plain`` there, and the number is the largest of
``g / (g_plain + median(g_plain))``.  An instance ill-conditioned enough
that float32 itself departs far reads about 1; a sound instance reads about
the program's rounding over the plain code's; no instance is left out.

The reference follows the program unit by unit from the program's own
state: a closed loop in float32 leaves its float64 path by rounding, more
with every tick, and an iterated solve in float32 takes another line-search
outcome than in float64 wherever two merits lie within rounding, after which
the iterates part by a whole step.  The stage before the window, set-up's
cold solve, is checked apart in the same way, iteration by iteration from
the seed's x0 and a zero warm start (``cold``).

Where the line search's outcomes tie within ``steps.TIE_RTOL`` of the merit,
the program's outcome is judged against the tied outcome nearest to it.

The control (``control=True``) puts the reference computed in float32 with
TF32 products in the program's place on the same inputs: the precision one
step below the configuration's float32 with TF32 off.

A side is what is judged: ``program`` (the records of the timed path),
``control``, or ``plain`` (the reference in the configuration's precision).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


F64 = torch.float64
DTYPES = {"float32": torch.float32, "float64": F64}


@contextlib.contextmanager
def tf32(on):
    """TF32 products on or off for float32 matmuls inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def rel(a, b):
    """Per instance: the largest entry of |a - b| over max(1, largest |b|)."""
    a, b = a.to(F64), b.to(F64)
    if a.ndim == 1:
        return (a - b).abs() / torch.clamp(b.abs(), min=1.0)
    d = (a - b).abs().flatten(1).amax(1)
    return d / torch.clamp(b.abs().flatten(1).amax(1), min=1.0)


def _cat(trees):
    """Concatenate a list of equal trees (dicts of tensors) along dim 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _cat([t[k] for t in trees]) for k in first}
    if first is None:
        return None
    if first.ndim == 0:
        return torch.stack(trees)
    return torch.cat(trees)


def _to(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to(v, dtype, device) for k, v in tree.items()}
    if tree is None:
        return None
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else tree.dtype)


def al_config(al_mod, traffic_al):
    al = dict(traffic_al)
    al["line_search_steps"] = tuple(al["line_search_steps"])
    return al_mod.ALConfig(**al)


def controller_config(al_mod, ctrl):
    """The replan ALConfig and feedback flag of a controller configuration
    (the port's ``MPCSettings.from_config(...).al_config()``, frozen)."""
    sqp, solver = ctrl.get("sqp", {}), ctrl.get("solver", {})
    cfg = al_mod.ALConfig(
        iterations=int(sqp.get("sqp_iteration", 1)),
        rho_eq=float(solver.get("rho_eq", 10.0)),
        rho_ineq=float(solver.get("rho_ineq", 10.0)),
        lam_max=float(solver.get("lam_max", 1e3)),
        dual_reset_violation=float(solver.get("dual_reset_violation", 10.0)),
        line_search_steps=(1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001),
    )
    return cfg, bool(sqp.get("use_feedback_policy", True))


def _pick_nearest(out, opts):
    """Per instance, the admissible outcome nearest the produced state."""
    n_o = opts.merit.shape[0]
    gap = torch.stack([torch.stack([rel(out[f], getattr(opts, f)[o])
                                    for f in ("X", "U", "lam", "mu", "lam_f")]).amax(0)
                       for o in range(n_o)])
    gap = torch.where(opts.admissible, gap, torch.full_like(gap, float("inf")))
    return torch.argmin(gap, dim=0)


def _gaps(out, sel, fields):
    return torch.stack([rel(out[f], sel[f]) for f in fields]).amax(0)


class _Judge:
    """The reference for one configuration on ``device``."""

    def __init__(self, cell, device):
        self.conf = cell.config["config"]
        self.dtype = DTYPES[cell.config["dtype"]]
        self.device = torch.device(device)
        self._problems = {}

    def problem(self, dtype):
        from benchmark.reference.ocp.problem import build_problem

        if dtype not in self._problems:
            self._problems[dtype] = build_problem(self.conf, device=self.device, dtype=dtype)
        return self._problems[dtype]

    def targets(self, prob, offsets, rows, dtype):
        """The stacked targets of instances ``rows``: the configuration's
        waypoints moved by each instance's offset."""
        from benchmark.reference.ocp.reference import TargetTrajectory

        base = prob.target
        n = rows.shape[0]
        poses = base.poses.unsqueeze(0).repeat(n, 1, 1)
        poses[:, :, :3] += offsets[rows].to(device=self.device, dtype=dtype).unsqueeze(1)
        return TargetTrajectory(times=base.times.expand(n, base.times.shape[-1]).contiguous(),
                                poses=poses)


def _info(opts, pick):
    return {"pairs": int(pick.shape[0]), "ties": int((opts.admissible.sum(0) > 1).sum()),
            "off_best": int((pick != opts.chosen).sum())}


def _broadcast(params, n):
    return {k: _broadcast(v, n) if isinstance(v, dict) else v.expand((n,) + tuple(v.shape))
            for k, v in params.items()}


def _lower(judge, side):
    """(dtype, TF32 on) of a side computed by the reference."""
    return (torch.float32, True) if side == "control" else (judge.dtype, False)


def _judge_solves(judge, records, cfg_of, params_of, side):
    """Gaps of one-iteration solve records (unit, instances, inputs with x0,
    outputs), grouped by the ALConfig ``cfg_of(record)`` that produced them.
    ``params_of(problem, records, dtype)`` gives the stacked parameters.
    Returns ({number: gap per sampled instance-unit}, info)."""
    from benchmark.reference.solver.ocp import SolverState
    from benchmark.reference.steps import sqp_options

    groups = {}
    for r in records:
        groups.setdefault(cfg_of(r), []).append(r)
    parts, info = [], {"pairs": 0, "ties": 0, "off_best": 0}
    for cfg, recs in groups.items():
        before = _to(_cat([r[2] for r in recs]), F64, judge.device)
        x0 = before.pop("x0")
        after = _to(_cat([r[3] for r in recs]), F64, judge.device)

        def options(dtype):
            prob = judge.problem(dtype)
            return sqp_options(prob.ocp, cfg, params_of(prob, recs, dtype), x0.to(dtype),
                               SolverState(**_to(before, dtype, judge.device)))

        ref = options(F64)
        if side == "program":
            out = dict(after["state"], K=after["K"])
            out.update({k: after[k] for k in ("cost", "eq_viol") if k in after})
        else:
            dtype, on = _lower(judge, side)
            with tf32(on):
                c = options(dtype)
                out = {k: v.to(F64) for k, v in c.take(c.chosen).items()}
        pick = _pick_nearest(out, ref)
        sel = ref.take(pick)
        gaps = {"gain": rel(out["K"], ref.K), "trajectory": _gaps(out, sel, ("X", "U")),
                "multipliers": _gaps(out, sel, ("lam", "mu", "lam_f"))}
        if "cost" in out:
            gaps["cost"] = _gaps(out, sel, ("cost", "eq_viol"))
        parts.append(gaps)
        for k, v in _info(ref, pick).items():
            info[k] += v
    return {k: torch.cat([g[k] for g in parts]) for k in parts[0]}, info


def _worst_field(gaps):
    """Per instance-unit, the largest of the given gaps."""
    return torch.stack(list(gaps.values())).amax(0)


def check_solve(cell, wl, side="program"):
    """The numbers of a ``solve`` cell: gain, trajectory, multipliers and
    cost of the window's calls, and cold, the largest of the first three
    over set-up's cold solve, iteration by iteration."""
    from benchmark.reference.solver import al as ref_al

    judge = _Judge(cell, wl.device)
    cfg = al_config(ref_al, cell.traffic["al"])

    def params_of(prob, recs, dtype):
        return _broadcast(prob.stage_params(0.0), sum(r[1].shape[0] for r in recs))

    numbers, info = _judge_solves(judge, wl.records, lambda r: cfg, params_of, side)
    cold, _ = _judge_solves(judge, wl.cold_records, lambda r: cfg, params_of, side)
    numbers["cold"] = _worst_field(cold)
    return numbers, info


def check_loop(cell, wl, side="program"):
    """The numbers of a ``loop`` cell: trajectory, multipliers, cost (the
    replan), input (the policy's command, which the plant integrates into the
    robot's joints), ee and object_r (the plant after the tick), and cold,
    the largest gap of the loop's cold solve, iteration by iteration."""
    from benchmark.reference.sim.simulation import ObjectsState, UprightSimulation
    from benchmark.reference.solver import al as ref_al
    from benchmark.reference.solver.ocp import SolverState
    from benchmark.reference.steps import loop_tick

    judge = _Judge(cell, wl.device)
    dev = judge.device
    cfg, use_fb = controller_config(ref_al, judge.conf["controller"])
    rate = float(cell.traffic["ctrl_rate"])
    offsets = torch.as_tensor(wl.offsets, dtype=F64)

    def tick(dtype, pick_for):
        prob = judge.problem(dtype)
        sim = UprightSimulation(judge.conf["simulation"], device=dev, dtype=dtype)
        params = [prob.stage_params(float(r[2]["t"]),
                                    judge.targets(prob, offsets, r[1].cpu(), dtype))
                  for r in wl.records]
        params = _cat([{"stage": {k: v.contiguous() for k, v in p["stage"].items()},
                        "final": {k: v.contiguous() for k, v in p["final"].items()}}
                       for p in params])
        before = _to(_cat([r[2] for r in wl.records]), dtype, dev)
        carry = {"sim_t": before["sim"]["t"], "q": before["sim"]["q"], "v": before["sim"]["v"],
                 "a_state": before["a_state"], "objects": ObjectsState(**before["sim"]["objects"]),
                 "solver": SolverState(**before["solver"])}
        return loop_tick(prob, sim, cfg, rate, use_fb, carry, params, pick_for)

    def produced(c, objects_r):
        return {"X": c["X"], "U": c["U"], "lam": c["lam"], "mu": c["mu"], "lam_f": c["lam_f"],
                "cost": c["cost"], "eq_viol": c["eq_viol"], "a_state": c["a_state"],
                "q": c["q"], "r_ew": c["r_ew"], "obj_r": objects_r}

    if side == "program":
        after = _to(_cat([r[3] for r in wl.records]), F64, dev)
        out = produced(dict(after["solver"], cost=after["cost"], eq_viol=after["eq_viol"],
                            a_state=after["a_state"], q=after["sim"]["q"], r_ew=after["r_ew"]),
                       after["sim"]["objects"]["r"])
    else:
        dtype, on = _lower(judge, side)
        with tf32(on):
            _, _, c = tick(dtype, lambda o: o.chosen)
        out = _to(produced(c, c["objects"].r), F64, dev)
    picked = {}

    def pick(opts):
        picked["p"] = _pick_nearest(out, opts)
        return picked["p"]

    ref_opts, _, ref = tick(F64, pick)
    ref = dict(ref, obj_r=ref["objects"].r)
    numbers = {
        "trajectory": _gaps(out, ref, ("X", "U")),
        "multipliers": _gaps(out, ref, ("lam", "mu", "lam_f")),
        "cost": _gaps(out, ref, ("cost", "eq_viol")),
        "input": rel(out["a_state"], ref["a_state"]),
        "ee": rel(out["r_ew"], ref["r_ew"]),
        "object_r": rel(out["obj_r"], ref["obj_r"]),
    }
    info = _info(ref_opts, picked["p"])

    # the start: the cold solve, the watchdog before its first iteration only
    plain = dataclasses.replace(cfg, dual_reset_violation=None)

    def params_of(prob, recs, dtype):
        rows = torch.cat([r[1] for r in recs]).cpu()
        return prob.stage_params(0.0, judge.targets(prob, offsets, rows, dtype))

    cold, _ = _judge_solves(judge, wl.cold_records, lambda r: cfg if r[0] == 0 else plain,
                            params_of, side)
    numbers["cold"] = _worst_field(cold)
    return numbers, info


CHECKS = {"solve": check_solve, "loop": check_loop}


def over_plain(gaps, plain, eps):
    """Each instance-unit's gap over the plain reference's own gap there plus
    its median (at least ``eps``, the precision's unit roundoff)."""
    return gaps.to(F64) / (plain.to(F64) + max(float(plain.median()), eps))


def check(cell, wl, control=False):
    """(numbers, info) of the cell's comparison: each number the largest,
    over the sampled instance-units, of its gap or, where the cell's ``gap``
    is ``over_plain``, of its gap over the plain reference's; ``info`` also
    holds the largest absolute gap of each."""
    kind = cell.traffic["kind"]
    gaps, info = CHECKS[kind](cell, wl, "control" if control else "program")
    info["max"] = {k: float(v.max()) for k, v in gaps.items()}
    if cell.gap == "over_plain":
        plain, _ = CHECKS[kind](cell, wl, "plain")
        info["plain_max"] = {k: float(v.max()) for k, v in plain.items()}
        eps = float(torch.finfo(DTYPES[cell.config["dtype"]]).eps) / 2
        gaps = {k: over_plain(v, plain[k], eps) for k, v in gaps.items()}
    elif cell.gap != "absolute":
        raise ValueError(f"unknown gap {cell.gap!r}")
    return {k: float(v.max()) for k, v in gaps.items()}, info


def verdict(numbers, limits, nonfinite):
    """(correct, lines): every number within its limit and no non-finite
    output; one line per number with its limit, for standard error."""
    rows = [("nonfinite", float(nonfinite), 0.0)]
    rows += [(k, v, limits.get(k)) for k, v in numbers.items()]
    ok = all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    lines = [f"check {k}: {v!r} (limit {lim!r})" for k, v, lim in rows]
    return ok, rows, lines


def as_table(rows):
    return {k: {"value": v, "limit": lim} for k, v, lim in rows}

