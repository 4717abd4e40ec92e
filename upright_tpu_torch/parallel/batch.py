"""Batched MPC solving.

Counterpart of ``upright_tpu/parallel/batch.py`` (``batch_solve_fn``,
``broadcast_params``, ``batch_warm_starts``).  The port's solver is
batch-first, so batching is the leading axis of every tensor rather than a
``vmap`` of a single solve; these helpers lift one problem's parameters and
initial states onto that axis.
"""

from __future__ import annotations

import torch

from upright_tpu_torch import resolve_device
from upright_tpu_torch.solver.al import ALConfig, solve
from upright_tpu_torch.solver.ocp import OCP, zeros_warm_start


def batch_solve_fn(ocp: OCP, cfg: ALConfig, device="cuda", dtype=torch.float32):
    """Batched solver: (params_batched, x0s, states) -> Solution batch.

    All leaves of params must carry the leading batch axis; use
    `broadcast_params` to lift shared parameters.  The OCP must have been
    built on ``device`` with ``dtype``.
    """
    dev = resolve_device(device)
    if ocp.device.type != dev.type or ocp.dtype != dtype:
        raise ValueError(
            f"the OCP was built on {ocp.device} as {ocp.dtype}; batch_solve_fn "
            f"was asked for device={dev}, dtype={dtype}"
        )

    def batched_solve(params, x0s, states):
        return solve(ocp, cfg, params, x0s, states, device=device, dtype=dtype)

    return batched_solve


def broadcast_params(params, batch: int):
    """Lift a single-problem parameter tree onto a new leading batch axis
    (an expanded view: shared parameters are not copied)."""
    if isinstance(params, dict):
        return {k: broadcast_params(v, batch) for k, v in params.items()}
    return params.expand((batch,) + tuple(params.shape))


def batch_warm_starts(ocp: OCP, x0s, device="cuda", dtype=torch.float32):
    """Cold-start SolverState for a batch of initial states (B, nx)."""
    return zeros_warm_start(ocp, x0s, device=device, dtype=dtype)
