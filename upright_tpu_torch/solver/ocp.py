"""Optimal-control-problem definition consumed by the AL-SQP solver.

Counterpart of ``upright_tpu/solver/ocp.py``.  A problem is a handful of
functions plus static dimensions.  The port is batch-first: every function
takes any number of leading batch dimensions on (x, u) and on the leaves of
its parameter dict, and the solver state carries a leading instance axis.

Cost structure: each stage cost is
    l(x, u) = quadratic(x, u) + 1/2 * r(x, u)^T W r(x, u)
where r stacks the nonlinear residuals (EE pose error).  The solver uses
exact gradients and Gauss-Newton Hessians J^T W J.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from upright_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class IneqBoxRows:
    """Box-row block description for OCP.ineq (see OCP.ineq_smooth)."""

    n_pre: int  # smooth rows before the box block
    nx_box: int  # boxed leading state entries (0 if no state box)
    nu_box: int  # boxed input entries (0 if no input box)

    @property
    def n_box(self):
        return 2 * (self.nx_box + self.nu_box)


@dataclasses.dataclass(frozen=True)
class OCP:
    """Static problem description.

    ``params`` passed to the solver is a dict with:
      - ``stage``: dict of tensors with leading axes (B, N) fed to stage functions
      - ``final``: dict of tensors with leading axis (B,) for the terminal functions
    Stage functions receive (x (..., nx), u (..., nu), p); terminal functions
    receive (x, p_f).  The functions close over constants that live on
    ``device`` with ``dtype``.
    """

    N: int  # number of stages (shooting intervals)
    nx: int
    nu: int
    n_eq: int  # equality rows per stage
    n_ineq: int  # inequality rows per stage (h(x,u) >= 0)
    n_feq: int  # terminal equality rows

    dynamics: Callable  # (x, u, p_k) -> x_next  (exact discrete step)
    stage_cost: Callable  # (x, u, p_k) -> (...,)
    eq: Callable  # (x, u, p_k) -> (..., n_eq)
    ineq: Callable  # (x, u, p_k) -> (..., n_ineq)
    # the terminal cost is identically zero in every problem the port builds
    # so far, so the OCP carries terminal equality rows only
    final_eq: Callable  # (x, p_f) -> (..., n_feq)

    # Gauss-Newton decomposition of the stage cost:
    # stage_cost == quad + 1/2 r^T W r.
    stage_residuals: Optional[Callable] = None  # (x, u, p_k) -> (r, W)
    stage_quad: Optional[Callable] = None  # (x, u, p_k) -> (...,)
    # analytic derivatives of stage_quad: (x, u, p_k) ->
    # (grad (..., nx+nu), H (nx+nu, nx+nu) constant)
    stage_quad_derivs: Optional[Callable] = None

    # input box bounds, enforced by clamping in the forward rollout (box-DDP
    # style); tensors of shape (nu,) or None
    u_lb: Optional[Any] = None
    u_ub: Optional[Any] = None

    # dynamics are linear in (x, u): A, B are computed once per solve and
    # handed to the Riccati kernel as one stage-invariant pair
    linear_dynamics: bool = False

    # Analytic split of the inequality stack: row order of ``ineq`` is
    #   [smooth_pre (n_pre rows) | x_lo | x_hi | u_lo | u_hi | smooth_post]
    # with ``ineq_smooth`` = [smooth_pre | smooth_post]; the box rows have
    # constant +/-identity Jacobians and enter the stage derivatives as index
    # adds instead of through the traced Jacobian.
    ineq_smooth: Optional[Callable] = None  # (x, u, p_k) -> (..., n_ineq - n_box)
    ineq_box: Optional[IneqBoxRows] = None

    device: Any = None
    dtype: Any = None


@dataclasses.dataclass
class SolverState:
    """Warm-startable solver state: trajectories + AL multipliers, batch-first."""

    X: torch.Tensor  # (B, N+1, nx)
    U: torch.Tensor  # (B, N, nu)
    lam: torch.Tensor  # (B, N, n_eq) equality multipliers
    mu: torch.Tensor  # (B, N, n_ineq) inequality multipliers (>= 0)
    lam_f: torch.Tensor  # (B, n_feq) terminal equality multipliers

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Solution:
    """Solver output: optimal trajectories + time-varying feedback policy."""

    state: SolverState
    K: torch.Tensor  # (B, N, nu, nx) feedback gains about the optimal trajectory
    cost: torch.Tensor  # (B,) objective (without AL terms)
    eq_viol: torch.Tensor  # (B,) max |g|
    ineq_viol: torch.Tensor  # (B,) max(0, -h) max
    defect: torch.Tensor  # (B,) max dynamics defect after the solve


def zeros_warm_start(ocp: OCP, x0, device="cuda", dtype=torch.float32):
    """Cold-start trajectories: hold x0 (B, nx), zero inputs and multipliers."""
    device = resolve_device(device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    if x0.ndim != 2:
        raise ValueError(f"x0 must be (batch, nx); got {tuple(x0.shape)}")
    B = x0.shape[0]

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SolverState(
        X=x0.unsqueeze(1).repeat(1, ocp.N + 1, 1),
        U=z(B, ocp.N, ocp.nu),
        lam=z(B, ocp.N, ocp.n_eq),
        mu=z(B, ocp.N, ocp.n_ineq),
        lam_f=z(B, ocp.n_feq),
    )
