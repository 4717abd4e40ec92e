"""Carry problem data and solver state across as plain numpy arrays.

This system has no learned weights.  What the JAX package and the port must
share to compute the same thing is the problem data and the solver state.
Each function takes plain numpy arrays (as ``np.asarray`` gives them from the
other package's ``SolverState``, parameter tree or ``BalanceModel``) and
returns the port's dataclasses on ``device`` as ``dtype``, adding the leading
batch axis where the port is batch-first.  Nothing here imports JAX.
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
