"""Augmented-Lagrangian SQP trajectory optimizer with Riccati backward pass.

Counterpart of ``upright_tpu/solver/al.py``, batch-first: every tensor
carries a leading instance axis (``X: (B, N+1, nx)`` ...), so one solve
linearizes, sweeps and line-searches the whole batch at once and the Riccati
kernel (``solver/riccati.py``) sees the batch in one launch.  A single
instance is ``B = 1``.

Each SQP iteration has three phases:
  - stage linearization: ``torch.func.jacfwd`` (or ``jacrev``) of the
    stacked [residuals; eq; smooth ineq] rows, vmapped over (instance,
    stage), with the box rows added analytically;
  - the Riccati backward pass (the CUDA kernel on the card);
  - the forward rollouts of the fixed line-search candidates, a Python loop
    over stages on (candidate, instance) blocks, then accept/reject and the
    clipped dual update per instance.

The call runs in the span ``al.solve`` and each iteration in four that tile
it, ``al.linearize``, ``al.backward``, ``al.line_search`` and ``al.update``
(``tracing.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch.func import jacfwd, jacrev, vmap

from upright_tpu_torch import check_on_device
from upright_tpu_torch.solver.ocp import OCP, Solution, SolverState
from upright_tpu_torch.solver.pscan import parallel_backward_pass
from upright_tpu_torch.solver.riccati import riccati_backward
from upright_tpu_torch.tracing import span


@dataclasses.dataclass(frozen=True)
class ALConfig:
    """Static solver configuration."""

    iterations: int = 1  # SQP (inner) iterations per solve
    rho_eq: float = 10.0  # equality penalty
    rho_ineq: float = 10.0  # inequality penalty
    reg: float = 1e-6  # Levenberg regularization on Quu
    line_search_steps: Tuple[float, ...] = (
        1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001,
    )
    mu_max: float = 1e6  # inequality-multiplier safeguard
    # equality-multiplier safeguard (bounded multipliers): under persistent
    # infeasibility unbounded lam ratchets across warm-started MPC replans
    lam_max: float = 1e3
    # divergence watchdog: if the warm-start trajectory's constraint
    # violation exceeds this, the incoming multipliers are stale and are
    # zeroed (per instance) before solving.  None disables.
    dual_reset_violation: float | None = None
    update_multipliers: bool = True  # AL dual update at end of solve
    # dual safeguarding: several primal steps per multiplier update, damped
    dual_update_every: int = 1  # primal iterations per dual update
    dual_step: float = 1.0  # damping factor on the multiplier step
    defect_penalty: float = 100.0  # multiple-shooting merit weight on |f(x_k,u_k) - x_{k+1}|
    # Riccati backward pass, with the reference's names:
    #   "scan", "pallas"  riccati_backward: the kernel K1 on the card
    #   "pscan"           the log-depth ladder of solver/pscan.py (long horizons)
    backward: str = "scan"


# ---------------------------------------------------------------------------
# augmented-Lagrangian stage objective
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def _al_stage_terms(ocp: OCP, cfg: ALConfig, x, u, p, lam, mu):
    """AL stage cost plus the intermediates the solver reuses downstream.

    Returns (al, l, g, h): the PHR merit term
    l + lam'g + rho/2|g|^2 + rho/2|max(0, mu/rho - h)|^2, the plain stage
    cost l, and the eq/ineq constraint values at the same point (None when
    the problem has none).  All arguments carry the same leading dimensions.
    """
    l = ocp.stage_cost(x, u, p)
    al = l
    g = h = None
    if ocp.n_eq > 0:
        g = ocp.eq(x, u, p)
        al = al + _dot(lam, g) + 0.5 * cfg.rho_eq * _dot(g, g)
    if ocp.n_ineq > 0:
        h = ocp.ineq(x, u, p)
        psi = torch.clamp(mu / cfg.rho_ineq - h, min=0.0)
        al = al + 0.5 * cfg.rho_ineq * _dot(psi, psi)
    return al, l, g, h


def _al_final_terms(ocp: OCP, cfg: ALConfig, x, p_f, lam_f):
    """(al, l, gf): AL final cost, plain final cost, final-eq values."""
    l = x.new_zeros(x.shape[:-1])  # no terminal cost term (see OCP)
    al = l
    gf = None
    if ocp.n_feq > 0:
        gf = ocp.final_eq(x, p_f)
        al = al + _dot(lam_f, gf) + 0.5 * cfg.rho_eq * _dot(gf, gf)
    return al, l, gf


# ---------------------------------------------------------------------------
# stage linearization (gradients + Gauss-Newton Hessians)
# ---------------------------------------------------------------------------


def _flatten_lead(lead_ndim, *trees):
    """Merge the first ``lead_ndim`` axes of every tensor of the given
    tensors / dicts of tensors into one."""

    def flat(t):
        # the leading size is given, not inferred: a leaf may hold no elements
        # (the object parameters of a problem without objects)
        return t.reshape((math.prod(t.shape[:lead_ndim]),) + tuple(t.shape[lead_ndim:]))

    return [
        {k: flat(v) for k, v in t.items()} if isinstance(t, dict) else flat(t)
        for t in trees
    ]


def _stage_derivatives(ocp: OCP, cfg: ALConfig, x, u, p, lam, mu):
    """Gradient and GN Hessian of the AL stage cost w.r.t. z = (x, u).

    x: (..., nx), u: (..., nu) with one or more leading dimensions shared by
    every leaf of p, lam and mu.  Returns (grad (..., nz), H (..., nz, nz)).

    The Jacobian of the stacked [residuals; eq; smooth ineq] vector, vmapped
    over the leading dimensions, by one of three modes (``OCP.x_jac_blocks``,
    ``OCP.jac_mode``): one jacfwd over x and one over u (the constraint
    families share the kinematic-chain tangents; the u-columns never enter
    the chain); one jacfwd per block of x-columns; or one jacrev over (x,
    u).  The gradient is assembled analytically from the same Jacobian.
    State/input limit rows have constant +/-identity Jacobians and
    contribute index adds on the diagonal instead.
    """
    if ocp.stage_residuals is None or ocp.stage_quad_derivs is None:
        raise NotImplementedError(
            "the solver needs the Gauss-Newton decomposition of the stage cost"
            " (OCP.stage_residuals and OCP.stage_quad_derivs)"
        )
    nx = ocp.nx
    lead = x.shape[:-1]
    x, u, p, lam, mu = _flatten_lead(len(lead), x, u, p, lam, mu)

    grad, H_quad = ocp.stage_quad_derivs(x, u, p)
    r, W = ocp.stage_residuals(x, u, p)
    n_r = r.shape[-1]

    # Analytic box-row split: keep the limit rows out of the traced Jacobian
    box = ocp.ineq_box if ocp.ineq_smooth is not None else None
    ineq_fn = ocp.ineq_smooth if box is not None else ocp.ineq

    def stacked(x_, u_, p_):
        parts = [ocp.stage_residuals(x_, u_, p_)[0]]
        if ocp.n_eq > 0:
            parts.append(ocp.eq(x_, u_, p_))
        if ocp.n_ineq > 0:
            s_ = ineq_fn(x_, u_, p_)
            if s_.shape[-1] > 0:
                parts.append(s_)
        return torch.cat(parts, dim=-1)

    if ocp.x_jac_blocks is not None:
        # one jacfwd per block of x-columns, the rest of x held constant
        cols, lo = [], 0
        for width in ocp.x_jac_blocks:
            hi = lo + width

            def f_block(xb, x_, u_, p_, lo=lo, hi=hi):
                return stacked(torch.cat([x_[..., :lo], xb, x_[..., hi:]], dim=-1), u_, p_)

            cols.append(vmap(jacfwd(f_block))(x[:, lo:hi], x, u, p))
            lo = hi
        cols.append(vmap(jacfwd(stacked, argnums=1))(x, u, p))
        J = torch.cat(cols, dim=-1)
    elif ocp.jac_mode == "rev":
        def f_z(z_, p_):
            return stacked(z_[..., :nx], z_[..., nx:], p_)

        J = vmap(jacrev(f_z))(torch.cat([x, u], dim=-1), p)
    else:
        J_x = vmap(jacfwd(stacked, argnums=0))(x, u, p)
        J_u = vmap(jacfwd(stacked, argnums=1))(x, u, p)
        J = torch.cat([J_x, J_u], dim=-1)  # (M, rows, nz)

    def JtJ(Ja, Jb):
        return Ja.transpose(-1, -2) @ Jb

    def Jtv(Ja, v):
        return (Ja.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)

    J_r = J[:, :n_r]
    grad = grad + Jtv(J_r, r @ W.T)
    H = H_quad + JtJ(J_r, W @ J_r)

    off = n_r
    if ocp.n_eq > 0:
        g = ocp.eq(x, u, p)
        J_g = J[:, off : off + ocp.n_eq]
        grad = grad + Jtv(J_g, lam + cfg.rho_eq * g)
        H = H + cfg.rho_eq * JtJ(J_g, J_g)
        off += ocp.n_eq
    if ocp.n_ineq > 0:
        psi_full = torch.clamp(mu / cfg.rho_ineq - ocp.ineq(x, u, p), min=0.0)
        J_h = J[:, off:]
        if box is None:
            psi = psi_full
        else:
            # smooth rows = [pre | post] around the box block
            b0 = box.n_pre
            b1 = b0 + box.n_box
            psi = torch.cat([psi_full[:, :b0], psi_full[:, b1:]], dim=-1)
        if J_h.shape[1] > 0:
            grad = grad - cfg.rho_ineq * Jtv(J_h, psi)
            J_h_active = J_h * (psi > 0.0).unsqueeze(-1)
            H = H + cfg.rho_ineq * JtJ(J_h_active, J_h_active)
        if box is not None and box.n_box > 0:
            b0 = box.n_pre
            nxb, nub = box.nx_box, box.nu_box
            p_xlo = psi_full[:, b0 : b0 + nxb]
            p_xhi = psi_full[:, b0 + nxb : b0 + 2 * nxb]
            p_ulo = psi_full[:, b0 + 2 * nxb : b0 + 2 * nxb + nub]
            p_uhi = psi_full[:, b0 + 2 * nxb + nub : b0 + 2 * nxb + 2 * nub]
            # index adds on fresh tensors (grad and H were just allocated by
            # the sums above; nothing captured is written to)
            dg = torch.zeros_like(grad)
            dH = torch.zeros_like(grad)
            if nxb > 0:
                dg[:, :nxb] = -cfg.rho_ineq * (p_xlo - p_xhi)
                dH[:, :nxb] = cfg.rho_ineq * (
                    (p_xlo > 0.0).to(H.dtype) + (p_xhi > 0.0).to(H.dtype)
                )
            if nub > 0:
                dg[:, nx : nx + nub] = -cfg.rho_ineq * (p_ulo - p_uhi)
                dH[:, nx : nx + nub] = cfg.rho_ineq * (
                    (p_ulo > 0.0).to(H.dtype) + (p_uhi > 0.0).to(H.dtype)
                )
            grad = grad + dg
            H = H + torch.diag_embed(dH)
    nz = grad.shape[-1]
    return grad.reshape(lead + (nz,)), H.reshape(lead + (nz, nz))


def _final_derivatives(ocp: OCP, cfg: ALConfig, x, p_f, lam_f):
    """Gradient and GN Hessian of the AL final cost; x: (B, nx)."""
    B, nx = x.shape
    grad = x.new_zeros(B, nx)
    H = x.new_zeros(B, nx, nx)
    if ocp.n_feq > 0:
        gf = ocp.final_eq(x, p_f)
        Jg = vmap(jacfwd(ocp.final_eq))(x, p_f)
        Jt = Jg.transpose(-1, -2)
        grad = grad + (Jt @ (lam_f + cfg.rho_eq * gf).unsqueeze(-1)).squeeze(-1)
        H = H + cfg.rho_eq * Jt @ Jg
    return grad, H


# ---------------------------------------------------------------------------
# forward pass: nonlinear rollout with feedback, batched line search
# ---------------------------------------------------------------------------


def _rollout(ocp: OCP, X_ref, U_ref, K, kff, alpha, x0, p_stage):
    """Closed-loop rollout of every line-search candidate.

    X_ref (B, N+1, nx), U_ref (B, N, nu), K (B, N, nu, nx), kff (B, N, nu),
    alpha (n_a,), x0 (B, nx).  Returns X (n_a, B, N+1, nx), U (n_a, B, N, nu).
    """
    n_a = alpha.shape[0]
    a = alpha.view(n_a, 1, 1)
    x = x0.unsqueeze(0).expand(n_a, -1, -1)
    Xs, Us = [x], []
    for k in range(ocp.N):
        dx = x - X_ref[:, k]
        u = U_ref[:, k] + a * kff[:, k] + (K[:, k] @ dx.unsqueeze(-1)).squeeze(-1)
        if ocp.u_lb is not None:
            # input-bound clamping (box-DDP style forward pass)
            u = torch.minimum(torch.maximum(u, ocp.u_lb), ocp.u_ub)
        p_k = {name: v[:, k] for name, v in p_stage.items()}
        x = ocp.dynamics(x, u, p_k)
        Xs.append(x)
        Us.append(u)
    return torch.stack(Xs, dim=2), torch.stack(Us, dim=2)


def _merit_terms(ocp: OCP, cfg: ALConfig, X, U, p_stage, p_final, lam, mu,
                 lam_f, with_defect=True):
    """AL merit of (X, U) plus the reused terms: (total, (plain_cost, g, h,
    gf)).  X, U may carry extra leading (candidate) axes; the parameters and
    multipliers broadcast against them.

    with_defect adds the multiple-shooting defect penalty, so a stale
    (defect-carrying) reference trajectory cannot out-score consistent
    rollouts.  Rollout-generated trajectories satisfy x_{k+1} = f(x_k, u_k)
    by construction, so callers skip the term for them.
    """
    x = X[..., :-1, :]
    al, l, g, h = _al_stage_terms(ocp, cfg, x, U, p_stage, lam, mu)
    al_f, l_f, gf = _al_final_terms(ocp, cfg, X[..., -1, :], p_final, lam_f)
    total = al.sum(-1) + al_f
    if with_defect and cfg.defect_penalty > 0:
        f_next = ocp.dynamics(x, U, p_stage)
        total = total + cfg.defect_penalty * torch.abs(
            f_next - X[..., 1:, :]
        ).sum((-1, -2))
    return total, (l.sum(-1) + l_f, g, h, gf)


def _rollout_merit(ocp: OCP, cfg: ALConfig, X_ref, U_ref, K, kff, alpha, x0,
                   p_stage, p_final, lam, mu, lam_f):
    """Forward pass + AL merit for every line-search candidate."""
    X, U = _rollout(ocp, X_ref, U_ref, K, kff, alpha, x0, p_stage)
    merit, terms = _merit_terms(
        ocp, cfg, X, U, p_stage, p_final, lam, mu, lam_f, with_defect=False
    )
    return merit, X, U, terms


# ---------------------------------------------------------------------------
# main solve
# ---------------------------------------------------------------------------


def _select(best, accept, cand, keep):
    """Per instance: candidate ``best`` where accepted, else ``keep``.
    cand: (n_a, B, ...), keep: (B, ...), best/accept: (B,)."""
    if cand is None:
        return None
    tail = (1,) * (keep.ndim - 1)
    idx = best.view((1, -1) + tail).expand((1,) + tuple(keep.shape))
    chosen = torch.gather(cand, 0, idx).squeeze(0)
    return torch.where(accept.view((-1,) + tail), chosen, keep)


def solve(ocp: OCP, cfg: ALConfig, params, x0, state: SolverState,
          device="cuda", dtype=torch.float32, backward=None) -> Solution:
    """Run cfg.iterations AL-SQP iterations from the warm start ``state``,
    for a batch of instances.

    params: {"stage": dict of (B, N, ...) tensors, "final": dict of (B, ...)};
    x0: (B, nx); state: batch-first SolverState.  Every tensor must lie on
    ``device`` as ``dtype`` (the defaults are the card and float32).

    backward: the Riccati backward pass, the one ``cfg.backward`` names
    unless given; a caller passes ``riccati_backward_plain`` to compare
    against the kernel.
    """
    with span("al.solve", x0.device):
        check_on_device(x0, device, dtype, "x0")
        check_on_device(state.X, device, dtype, "state.X")
        if backward is None:
            if cfg.backward in ("scan", "pallas"):
                backward = riccati_backward
            elif cfg.backward == "pscan":
                backward = parallel_backward_pass
            else:
                raise ValueError("ALConfig.backward must be 'scan', 'pallas' or 'pscan'; "
                                 f"got {cfg.backward!r}")
        p_stage = params["stage"]
        p_final = params["final"]
        B = x0.shape[0]
        X, U, lam, mu, lam_f = state.X, state.U, state.lam, state.mu, state.lam_f

        if cfg.dual_reset_violation is not None and (ocp.n_eq > 0 or ocp.n_ineq > 0):
            # divergence watchdog (see ALConfig.dual_reset_violation)
            viol0 = x0.new_zeros(B)
            if ocp.n_eq > 0:
                g0 = ocp.eq(X[:, :-1], U, p_stage)
                viol0 = torch.maximum(viol0, torch.abs(g0).amax((-1, -2)))
            if ocp.n_ineq > 0:
                h0 = ocp.ineq(X[:, :-1], U, p_stage)
                viol0 = torch.maximum(viol0, torch.clamp(-h0, min=0.0).amax((-1, -2)))
            keep = (viol0 <= cfg.dual_reset_violation).to(X.dtype)
            lam = lam * keep.view(B, 1, 1)
            mu = mu * keep.view(B, 1, 1)
            lam_f = lam_f * keep.view(B, 1)

        alphas = torch.as_tensor(cfg.line_search_steps, dtype=X.dtype, device=X.device)
        K = cost = eq_viol = ineq_viol = defect = None

        for it in range(cfg.iterations):
            with span("al.linearize", x0.device):
                # pin the initial state
                X = torch.cat([x0.unsqueeze(1), X[:, 1:]], dim=1)
                x, u = X[:, :-1], U

                # linearize dynamics + defects
                if ocp.linear_dynamics:
                    # A, B are state-independent: linearize once at a reference
                    # point and hand the backward pass one stage-invariant pair
                    p00 = {name: v[0, 0] for name, v in p_stage.items()}
                    A = jacfwd(ocp.dynamics, argnums=0)(X[0, 0], U[0, 0], p00)
                    Bm = jacfwd(ocp.dynamics, argnums=1)(X[0, 0], U[0, 0], p00)
                else:
                    xf, uf, pf = _flatten_lead(2, x, u, p_stage)
                    A = vmap(jacfwd(ocp.dynamics, argnums=0))(xf, uf, pf)
                    Bm = vmap(jacfwd(ocp.dynamics, argnums=1))(xf, uf, pf)
                    A = A.reshape(B, ocp.N, ocp.nx, ocp.nx)
                    Bm = Bm.reshape(B, ocp.N, ocp.nx, ocp.nu)
                d = ocp.dynamics(x, u, p_stage) - X[:, 1:]

                # AL stage derivatives
                grads, hess = _stage_derivatives(ocp, cfg, x, u, p_stage, lam, mu)
                gf, Hf = _final_derivatives(ocp, cfg, X[:, -1], p_final, lam_f)

            with span("al.backward", x0.device):
                # Riccati backward pass: the CUDA kernel on the card, or the ladder
                # (a stage-invariant A, B pair is broadcast by either)
                K, kff = backward(
                    A.contiguous(), Bm.contiguous(), d.contiguous(), grads.contiguous(),
                    hess.contiguous(), gf.contiguous(), Hf.contiguous(), reg=cfg.reg,
                )

            with span("al.line_search", x0.device):
                # line search over fixed candidates
                merits, Xs, Us, terms_a = _rollout_merit(
                    ocp, cfg, X, U, K, kff, alphas, x0, p_stage, p_final, lam, mu, lam_f
                )
                merit0, terms0 = _merit_terms(
                    ocp, cfg, X, U, p_stage, p_final, lam, mu, lam_f
                )
                merits = torch.where(
                    torch.isnan(merits), torch.full_like(merits, float("inf")), merits
                )
                best = torch.argmin(merits, dim=0)  # (B,)
                accept = torch.gather(merits, 0, best.unsqueeze(0)).squeeze(0) < merit0

                X_new = _select(best, accept, Xs, X)
                U_new = _select(best, accept, Us, U)
                # Plain cost + constraint values at the accepted iterate, threaded
                # through the candidate select: the dual update and the diagnostics
                # below cost no further kinematic-chain sweep
                cost, g, h, gf_val = (
                    _select(best, accept, a, b) for a, b in zip(terms_a, terms0)
                )

            with span("al.update", x0.device):
                # dual (multiplier) update: makes warm-started 1-iteration MPC solves
                # track the constrained optimum.  Multipliers move only after an
                # accepted primal step: a rejected line search means the AL
                # subproblem was not (approximately) minimized, and integrating
                # rho*g against a stuck primal is pure windup.
                if cfg.update_multipliers:
                    plain = cfg.dual_update_every == 1 and cfg.dual_step == 1.0
                    if plain:
                        beta = 1.0
                    else:
                        do_update = ((it + 1) % cfg.dual_update_every) == 0
                        beta = cfg.dual_step if do_update else 0.0
                    beta = beta * accept.to(X.dtype)  # (B,)
                    if ocp.n_eq > 0:
                        lam = torch.clamp(
                            lam + beta.view(B, 1, 1) * cfg.rho_eq * g, -cfg.lam_max, cfg.lam_max
                        )
                    if ocp.n_ineq > 0:
                        mu_new = torch.clamp(
                            torch.clamp(mu - cfg.rho_ineq * h, min=0.0), 0.0, cfg.mu_max
                        )
                        if plain:
                            mu = torch.where(accept.view(B, 1, 1), mu_new, mu)
                        else:
                            mu = mu + beta.view(B, 1, 1) * (mu_new - mu)
                    if ocp.n_feq > 0:
                        lam_f = torch.clamp(
                            lam_f + beta.view(B, 1) * cfg.rho_eq * gf_val,
                            -cfg.lam_max, cfg.lam_max,
                        )

                # per-iteration diagnostics (the last iteration's are returned),
                # all assembled from the threaded candidate terms.  The defect is
                # exact: an accepted candidate came out of the rollout, so its defect
                # is a structural zero; a rejected step keeps (X, U) whose defect is d.
                eq_viol = torch.abs(g).amax((-1, -2)) if ocp.n_eq > 0 else x0.new_zeros(B)
                if ocp.n_feq > 0:
                    eq_viol = torch.maximum(eq_viol, torch.abs(gf_val).amax(-1))
                ineq_viol = (
                    torch.clamp(-h, min=0.0).amax((-1, -2)) if ocp.n_ineq > 0 else x0.new_zeros(B)
                )
                defect = torch.where(accept, torch.zeros_like(merit0), torch.abs(d).amax((-1, -2)))

                X, U = X_new, U_new

        new_state = SolverState(X=X, U=U, lam=lam, mu=mu, lam_f=lam_f)
        return Solution(
            state=new_state, K=K, cost=cost, eq_viol=eq_viol,
            ineq_viol=ineq_viol, defect=defect,
        )
