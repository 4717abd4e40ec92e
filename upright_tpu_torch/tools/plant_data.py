"""Inputs of the plant's contact kernel, made from a seed with numpy.

One control tick of a shipped configuration, as the closed loop hands it to
``sim/contact.py`` ``advance_objects``: the objects settled on a tray that
has started to move, nudged, with per-instance parameters spread as a robust
sweep spreads them, and the tray frames of the tick's outer steps.  Made on
the CPU in float64 (the plain version settles the objects), so the CPU tests,
the emulated kernel and the card see the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

import upright_tpu_torch.config as cfg
from upright_tpu_torch.sim.contact import advance_objects_plain
from upright_tpu_torch.sim.simulation import UprightSimulation

CPU64 = dict(device="cpu", dtype=torch.float64)

# The float32 kernel is held to a witness: the plain version run in float32
# on the same float32 inputs.  Rounding the float64 state to float32 alone
# moves one stiff tick (k up to 3e4 N/m, 400 substeps) by up to 2e-2 rad/s in
# w and 1.6e-3 m/s in v from the float64 result, as much as a wrong kernel
# would, and the witness moves exactly so; kernel and witness differ only in
# the order of their operations.  Each limit sits about three times above
# the most the kernel shows against the witness on an H100 and three times
# below the least the control shows against it: the plain version with
# every object's inertia 10% off (`inertia_control`), a kernel that is wrong
# in one term.  PERF.md keeps both readings (chip_smoke.py phase 7).
F32_TOL = {"r": 1e-6, "q": 2e-6, "anchors": 2e-6, "v": 1e-4, "w": 1e-3}


def inertia_control(params, factor=1.1):
    """``params`` with every object's inertia scaled by ``factor``: the
    control that the float32 limits must reject."""
    return dict(params, inertia=params["inertia"] * factor)


def float32_witness(tables, consts, frames, objects, params):
    """(witness, control) of the float32 check: the plain version on the
    inputs cast to float32 on their device, and the same with the inertia
    10% off."""
    def f32(prm):
        return (frames.float(), objects_to(objects, frames.device, torch.float32),
                {k: v.float() for k, v in prm.items()})

    tables32 = tables.to(dtype=torch.float32)
    return (advance_objects_plain(tables32, consts, *f32(params)),
            advance_objects_plain(tables32, consts, *f32(inertia_control(params))))


def plant_for(demo, arrangement=None, friction_model=None, **kw):
    """The port's plant of ``configs/demos/<demo>.yaml`` (CPU, float64 unless
    ``device``/``dtype`` are given), with the arrangement or friction model
    replaced when asked."""
    conf = cfg.load_config(
        cfg.resolve_package_path({"package": "configs", "path": f"demos/{demo}.yaml"}))
    sc = dict(conf["simulation"])
    if arrangement is not None:
        sc["arrangement"] = arrangement
    if friction_model is not None:
        sc["friction_model"] = friction_model
    return UprightSimulation(sc, **{**CPU64, **kw})


def tick_start(sim, batch, seed=0, spread=True, diverge=()):
    """(state, command, params) at the start of one tick for ``batch``
    instances of the CPU float64 plant ``sim``: the state settled for 8 outer
    steps under a small command, its objects nudged, and the next command.

    ``spread``: mass and mu per instance and object within +-20% of their
    defaults, the CoM shifted horizontally within +-5 mm.  ``diverge``: the
    instances whose first object starts with a NaN velocity (they trip the
    divergence latch)."""
    rng = np.random.default_rng(seed)
    n, nq = sim.n_obj, sim.robot.nq

    def normal(scale, *shape):
        return torch.as_tensor(scale * rng.standard_normal((batch,) + shape))

    params = sim.default_params(batch)
    if spread:
        params["mass"] = params["mass"] * torch.as_tensor(rng.uniform(0.8, 1.2, (batch, n)))
        params["mu"] = params["mu"] * torch.as_tensor(rng.uniform(0.8, 1.2, (batch, n)))
        params["com_offset"] = torch.as_tensor(
            rng.uniform(-5e-3, 5e-3, (batch, n, 3)) * np.array([1.0, 1.0, 0.0]))
    cmd = normal(0.02, nq)
    state = sim.step(sim.initial_state(batch), cmd, n_steps=8, params=params)
    o = state.objects
    v = o.v + normal(1e-3, n, 3)
    for b in diverge:
        v[b, 0] = float("nan")
    state = state.replace(objects=o.replace(v=v, w=o.w + normal(1e-2, n, 3)))
    cmd = cmd + normal(0.01, nq)
    if sim.v_limit is not None:
        cmd = torch.clamp(cmd, -sim.v_limit, sim.v_limit)
    return state, cmd, params


def tick_inputs(sim, batch, seed=0, n_steps=10, spread=True, diverge=()):
    """(frames, objects, params) of one tick of ``n_steps`` outer steps from
    ``tick_start``: the arguments of ``advance_objects``."""
    state, cmd, params = tick_start(sim, batch, seed, spread, diverge)
    _t, _q, _v, frames = sim.robot_steps(state, cmd, n_steps)
    return frames, state.objects, params


def objects_to(objects, device, dtype):
    """An ObjectsState on another device, its float fields as ``dtype``."""
    def f(t):
        return None if t is None else t.to(device=device, dtype=dtype)

    def b(t):
        return None if t is None else t.to(device=device)

    return objects.replace(r=f(objects.r), q=f(objects.q), v=f(objects.v), w=f(objects.w),
                           anchors=f(objects.anchors), anchor_valid=b(objects.anchor_valid),
                           diverged=b(objects.diverged))


def max_errors(out, ref):
    """Largest absolute difference per field between two ObjectsStates, and
    whether the contact and latch flags are identical."""
    fields = ("r", "q", "v", "w") + (("anchors",) if ref.anchors is not None else ())
    err = {f: float((getattr(out, f).double() - getattr(ref, f).double()).abs().max())
           for f in fields}
    same = True
    if ref.anchors is not None:
        same = same and bool((out.anchor_valid.cpu() == ref.anchor_valid.cpu()).all())
    if ref.diverged is not None:
        same = same and bool((out.diverged.cpu() == ref.diverged.cpu()).all())
    return err, same
