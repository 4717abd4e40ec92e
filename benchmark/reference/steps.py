"""The reference's units of work, with every line-search option kept.

``sqp_options`` is one AL-SQP iteration of ``solver/al.py`` ``solve`` (the
frozen copy beside this file), computed for every outcome the line search can
have: each candidate step accepted, or the step rejected.  A solver in float32
and one in float64 can take different outcomes where two merits lie within
rounding of each other; ``admissible`` marks those outcomes, so that a check
judges the program's outcome against the reference's best one and against
nothing else.

``loop_tick`` is one tick of the device loop (``runtime/device_loop.py``):
shift and heal the warm start, replan, apply the policy, step the plant.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.sim.simulation import SimState
from benchmark.reference.solver import al
from benchmark.reference.solver.ocp import SolverState
from benchmark.reference.solver.riccati import riccati_backward_plain

# Two line-search outcomes whose merits differ by less than this share of the
# merit are a tie: a float32 solver may take either.  A float32 merit of the
# problem's 20 stages carries relative rounding near 1e-6; the gains it is
# rolled out with differ from float64 ones by about 1e-5 of their size.
TIE_RTOL = 1e-4
# The merit of the incoming trajectory carries the defect penalty, which a
# trajectory stored in float32 does not zero: its every entry is rounded, and
# the program's float32 dynamics round a few times more.  So that merit may
# lie above the float32 solver's own by up to the penalty times this many
# float32 unit roundoffs of each state entry and of its dynamics.
DEFECT_ULPS = 4
F32_UNIT_ROUNDOFF = 2.0**-24


@dataclasses.dataclass
class Options:
    """Every outcome of one SQP iteration: option ``i < n_a`` is candidate
    step ``i`` accepted, option ``n_a`` the step rejected.  Leaves carry a
    leading option axis (n_a + 1, B, ...), except ``K`` (B, N, nu, nx), which
    no outcome changes."""

    K: torch.Tensor
    merit: torch.Tensor  # (n_o, B), NaN read as +inf
    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    lam_f: torch.Tensor
    cost: torch.Tensor  # (n_o, B)
    eq_viol: torch.Tensor  # (n_o, B)
    chosen: torch.Tensor  # (B,) the outcome the solver takes
    admissible: torch.Tensor  # (n_o, B) bool: within TIE_RTOL of the chosen merit

    def take(self, option):
        """The leaves of outcome ``option`` (B,) per instance, as a dict."""
        out = {}
        for f in ("X", "U", "lam", "mu", "lam_f", "cost", "eq_viol"):
            v = getattr(self, f)
            idx = option.view((1, -1) + (1,) * (v.ndim - 2)).expand((1,) + tuple(v.shape[1:]))
            out[f] = torch.gather(v, 0, idx).squeeze(0)
        out["K"] = self.K
        return out


def sqp_options(ocp, cfg, params, x0, state: SolverState) -> Options:
    """One iteration of ``al.solve`` (``cfg.iterations`` must be 1), with the
    multiplier watchdog, the dual update and the diagnostics worked out for
    every line-search outcome."""
    if cfg.iterations != 1:
        raise ValueError("sqp_options follows one SQP iteration")
    p_stage, p_final = params["stage"], params["final"]
    B = x0.shape[0]
    X, U, lam, mu, lam_f = state.X, state.U, state.lam, state.mu, state.lam_f
    if cfg.dual_reset_violation is not None and (ocp.n_eq > 0 or ocp.n_ineq > 0):
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
    X = torch.cat([x0.unsqueeze(1), X[:, 1:]], dim=1)
    x, u = X[:, :-1], U
    if ocp.linear_dynamics:
        p00 = {name: v[0, 0] for name, v in p_stage.items()}
        A = torch.func.jacfwd(ocp.dynamics, argnums=0)(X[0, 0], U[0, 0], p00)
        Bm = torch.func.jacfwd(ocp.dynamics, argnums=1)(X[0, 0], U[0, 0], p00)
    else:
        xf, uf, pf = al._flatten_lead(2, x, u, p_stage)
        A = torch.func.vmap(torch.func.jacfwd(ocp.dynamics, argnums=0))(xf, uf, pf)
        Bm = torch.func.vmap(torch.func.jacfwd(ocp.dynamics, argnums=1))(xf, uf, pf)
        A = A.reshape(B, ocp.N, ocp.nx, ocp.nx)
        Bm = Bm.reshape(B, ocp.N, ocp.nx, ocp.nu)
    d = ocp.dynamics(x, u, p_stage) - X[:, 1:]
    grads, hess = al._stage_derivatives(ocp, cfg, x, u, p_stage, lam, mu)
    gf, Hf = al._final_derivatives(ocp, cfg, X[:, -1], p_final, lam_f)
    K, kff = riccati_backward_plain(
        A.contiguous(), Bm.contiguous(), d.contiguous(), grads.contiguous(),
        hess.contiguous(), gf.contiguous(), Hf.contiguous(), reg=cfg.reg)

    merits, Xs, Us, terms_a = al._rollout_merit(
        ocp, cfg, X, U, K, kff, alphas, x0, p_stage, p_final, lam, mu, lam_f)
    merit0, terms0 = al._merit_terms(ocp, cfg, X, U, p_stage, p_final, lam, mu, lam_f)
    merits = torch.where(torch.isnan(merits), torch.full_like(merits, float("inf")), merits)
    n_a = alphas.shape[0]

    def stack(cand, keep):
        return None if cand is None else torch.cat([cand, keep.unsqueeze(0)], dim=0)

    all_merit = stack(merits, merit0)
    Xo, Uo = stack(Xs, X), stack(Us, U)
    cost, g, h, gfv = (stack(a, b) for a, b in zip(terms_a, terms0))
    accept = torch.arange(n_a + 1, device=X.device) < n_a  # (n_o,)

    lam_o = lam.expand((n_a + 1,) + tuple(lam.shape))
    mu_o = mu.expand((n_a + 1,) + tuple(mu.shape))
    lamf_o = lam_f.expand((n_a + 1,) + tuple(lam_f.shape))
    if cfg.update_multipliers:
        plain = cfg.dual_update_every == 1 and cfg.dual_step == 1.0
        if plain:
            beta = 1.0
        else:
            beta = cfg.dual_step if (1 % cfg.dual_update_every) == 0 else 0.0
        beta = beta * accept.to(X.dtype)  # (n_o,)
        if ocp.n_eq > 0:
            lam_o = torch.clamp(lam + beta.view(-1, 1, 1, 1) * cfg.rho_eq * g,
                                -cfg.lam_max, cfg.lam_max)
        if ocp.n_ineq > 0:
            mu_new = torch.clamp(torch.clamp(mu - cfg.rho_ineq * h, min=0.0), 0.0, cfg.mu_max)
            if plain:
                mu_o = torch.where(accept.view(-1, 1, 1, 1), mu_new, mu)
            else:
                mu_o = mu + beta.view(-1, 1, 1, 1) * (mu_new - mu)
        if ocp.n_feq > 0:
            lamf_o = torch.clamp(lam_f + beta.view(-1, 1, 1) * cfg.rho_eq * gfv,
                                 -cfg.lam_max, cfg.lam_max)

    n_o = n_a + 1
    eq_viol = torch.abs(g).amax((-1, -2)) if ocp.n_eq > 0 else x0.new_zeros(n_o, B)
    if ocp.n_feq > 0:
        eq_viol = torch.maximum(eq_viol, torch.abs(gfv).amax(-1))

    best = torch.argmin(merits, dim=0)
    best_merit = torch.gather(merits, 0, best.unsqueeze(0)).squeeze(0)
    took = best_merit < merit0
    chosen = torch.where(took, best, torch.full_like(best, n_a))
    m_star = torch.where(took, best_merit, merit0)
    tie = TIE_RTOL * torch.clamp(m_star.abs(), min=1.0)
    # the incoming trajectory's merit, less what float32 storage adds to it
    floor = cfg.defect_penalty * DEFECT_ULPS * F32_UNIT_ROUNDOFF * (
        X[:, 1:].abs() + ocp.dynamics(x, u, p_stage).abs()).sum((-1, -2))
    low = all_merit.clone()
    low[n_a] = merit0 - floor
    admissible = low <= m_star + tie
    admissible[chosen, torch.arange(B, device=X.device)] = True
    return Options(K=K, merit=all_merit, X=Xo, U=Uo, lam=lam_o.contiguous(),
                   mu=mu_o.contiguous(), lam_f=lamf_o.contiguous(), cost=cost,
                   eq_viol=eq_viol, chosen=chosen, admissible=admissible)


def solve_cold(ocp, cfg, params, x0, state, iterations):
    """``iterations`` SQP iterations of ``al.solve`` with the plain recursion."""
    cfg_n = dataclasses.replace(cfg, iterations=iterations)
    return al.solve(ocp, cfg_n, params, x0, state, device=x0.device, dtype=x0.dtype,
                    backward=riccati_backward_plain)


def loop_tick(problem, sim, cfg, ctrl_rate, use_feedback_policy, carry, params, pick):
    """One tick of the device loop from ``carry`` = dict(sim_t (B,), q, v,
    a_state, objects (an ObjectsState), solver (a SolverState)) under ``params`` (the
    stage parameters at ``t``, batch-first).  ``pick(options)`` returns the
    line-search outcome to continue with per instance.  Returns
    (options, option, dict of what the tick produced)."""
    dt_ctrl = 1.0 / ctrl_rate
    n_sub = max(1, int(round(dt_ctrl / sim.timestep)))
    nq = problem.dims.robot_q
    shift = float(round(dt_ctrl / problem.dt))
    x = torch.cat([carry["q"], carry["v"], carry["a_state"]], dim=-1)
    warm = problem.heal_warm_start(problem.shift_warm_start(carry["solver"], shift), x)
    opts = sqp_options(problem.ocp, cfg, params, x, warm)
    option = pick(opts)
    sol = opts.take(option)
    u = sol["U"][:, 0]
    if use_feedback_policy:
        u = u + (sol["K"][:, 0] @ (x - sol["X"][:, 0]).unsqueeze(-1)).squeeze(-1)
    j = u[:, :nq]
    v_cmd = carry["v"] + dt_ctrl * carry["a_state"] + 0.5 * dt_ctrl**2 * j
    a_next = carry["a_state"] + dt_ctrl * j
    state = SimState(t=carry["sim_t"], q=carry["q"], v=carry["v"], objects=carry["objects"])
    nxt = sim.step(state, v_cmd, n_steps=n_sub)
    _, r_ew = sim.robot.ee_pose(nxt.q)
    out = dict(sol, q=nxt.q, v=nxt.v, a_state=a_next, objects=nxt.objects, r_ew=r_ew)
    return opts, option, out
