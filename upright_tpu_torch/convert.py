"""Carry problem data and solver state across as plain numpy arrays.

This system has no learned weights.  What the JAX package and the port must
share to compute the same thing is the problem data, the solver state and
the plant's state.  Each function takes plain numpy arrays (as ``np.asarray``
gives them from the other package's ``SolverState``, parameter tree,
``BalanceModel`` or ``SimState``) and returns the port's dataclasses on
``device`` as ``dtype``, adding the leading batch axis where the port is
batch-first; the ``*_to_numpy`` functions go back.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from upright_tpu_torch import resolve_device
from upright_tpu_torch.core.balance import BalanceModel
from upright_tpu_torch.solver.ocp import SolverState

_STATE_FIELDS = ("X", "U", "lam", "mu", "lam_f")
_STATE_NDIM = {"X": 2, "U": 2, "lam": 2, "mu": 2, "lam_f": 1}
_MODEL_FIELDS = ("params", "mu", "normal", "span", "r1", "r2", "S1", "S2")


def _tensor(a, device, dtype):
    return torch.tensor(np.array(a), dtype=dtype, device=resolve_device(device))


def solver_state_from_numpy(arrays, device="cuda", dtype=torch.float32):
    """dict {X, U, lam, mu, lam_f} of arrays -> batch-first SolverState.

    Arrays of a single instance (X: (N+1, nx) ...) get a leading batch axis
    of 1; arrays that already carry one (X: (B, N+1, nx) ...) are kept.
    """
    out = {}
    for name in _STATE_FIELDS:
        t = _tensor(arrays[name], device, dtype)
        if t.ndim == _STATE_NDIM[name]:
            t = t.unsqueeze(0)
        elif t.ndim != _STATE_NDIM[name] + 1:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        out[name] = t
    return SolverState(**out)


def solver_state_to_numpy(state: SolverState):
    """Batch-first SolverState -> dict of numpy arrays (batch axis kept)."""
    return {n: getattr(state, n).detach().cpu().numpy() for n in _STATE_FIELDS}


def params_from_numpy(params, batch=None, device="cuda", dtype=torch.float32):
    """The ``{"stage": ..., "final": ...}`` parameter tree of ``stage_params``
    as numpy arrays -> the same tree of tensors.

    With ``batch`` given, the tree is of one instance (stage leaves (N, ...))
    and is lifted onto a leading batch axis of that size; with ``batch=None``
    the leaves already carry it.
    """
    tree = {
        part: {k: _tensor(v, device, dtype) for k, v in params[part].items()}
        for part in ("stage", "final")
    }
    if batch is not None:
        tree = {
            part: {k: v.expand((batch,) + tuple(v.shape)) for k, v in leaves.items()}
            for part, leaves in tree.items()
        }
    return tree


def balance_model_from_numpy(arrays, device="cuda", dtype=torch.float32):
    """dict of the BalanceModel's stacked arrays -> BalanceModel of tensors."""
    return BalanceModel(**{n: _tensor(arrays[n], device, dtype) for n in _MODEL_FIELDS})


def _anchor_counts(sim):
    return [(len(sp.surfaces), len(sp.vertices_local)) for sp in sim.specs]


def sim_state_from_numpy(arrays, sim, device="cuda", dtype=torch.float32):
    """The plant's state as numpy arrays -> the port's batch-first SimState.

    ``arrays`` is ``{"t", "q", "v", "objects": {"r", "q", "v", "w",
    "anchors", "anchor_valid", "diverged"}}`` of one instance, as the JAX
    package's ``SimState`` gives them (``anchors``/``anchor_valid``: tuples
    of per-object (n_surf_i, k_i, 2) / (n_surf_i, k_i) arrays, or None;
    ``diverged`` (n_obj,) or None).  The result has a batch axis of 1, with
    the anchors padded into ``(1, n_obj, s_max, k_max, 2)``.  ``sim`` is the
    port's ``UprightSimulation`` of the same config.
    """
    from upright_tpu_torch.sim.simulation import ObjectsState, SimState

    dev = resolve_device(device)
    objs = arrays["objects"]

    def t(a):
        return _tensor(a, dev, dtype).unsqueeze(0)

    anchors = anchor_valid = None
    if objs.get("anchors") is not None:
        shape = (1, sim.n_obj, sim.tables.s_max, sim.tables.k_max)
        anchors = torch.zeros(shape + (2,), dtype=dtype, device=dev)
        anchor_valid = torch.zeros(shape, dtype=torch.bool, device=dev)
        for i, (S, K) in enumerate(_anchor_counts(sim)):
            anchors[0, i, :S, :K] = _tensor(objs["anchors"][i], dev, dtype)
            anchor_valid[0, i, :S, :K] = torch.as_tensor(np.asarray(objs["anchor_valid"][i]),
                                                         device=dev)
    diverged = None
    if objs.get("diverged") is not None:
        diverged = torch.as_tensor(np.asarray(objs["diverged"], dtype=bool), device=dev)[None]
    objects = ObjectsState(r=t(objs["r"]), q=t(objs["q"]), v=t(objs["v"]), w=t(objs["w"]),
                           anchors=anchors, anchor_valid=anchor_valid, diverged=diverged)
    return SimState(t=t(arrays["t"]).reshape(1), q=t(arrays["q"]), v=t(arrays["v"]),
                    objects=objects)


def sim_state_to_numpy(state, sim, index=0):
    """Instance ``index`` of the port's SimState -> the numpy arrays of
    ``sim_state_from_numpy`` (the anchors as per-object tuples again)."""
    objs = state.objects

    def a(x):
        return x[index].detach().cpu().numpy()

    out = {"r": a(objs.r), "q": a(objs.q), "v": a(objs.v), "w": a(objs.w),
           "anchors": None, "anchor_valid": None, "diverged": None}
    if objs.anchors is not None:
        counts = _anchor_counts(sim)
        out["anchors"] = tuple(a(objs.anchors[:, i, :S, :K]) for i, (S, K) in enumerate(counts))
        out["anchor_valid"] = tuple(a(objs.anchor_valid[:, i, :S, :K])
                                    for i, (S, K) in enumerate(counts))
    if objs.diverged is not None:
        out["diverged"] = a(objs.diverged)
    return {"t": a(state.t), "q": a(state.q), "v": a(state.v), "objects": out}


_PLANT_PARAMS = ("mass", "inertia", "mu", "com_offset")


def plant_params_from_numpy(params, device="cuda", dtype=torch.float32):
    """The plant's runtime parameters (``default_params``: mass, inertia, mu,
    com_offset) as numpy arrays -> tensors, with or without a batch axis."""
    return {k: _tensor(params[k], resolve_device(device), dtype) for k in _PLANT_PARAMS}


def plant_params_to_numpy(params):
    return {k: params[k].detach().cpu().numpy() for k in _PLANT_PARAMS}
