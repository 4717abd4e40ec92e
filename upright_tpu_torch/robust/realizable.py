"""Density-realizable inertial-parameter sets (moment-relaxation verification).

Counterpart of ``upright_tpu/robust/realizable.py``.  The reference's
post-hoc verification maximizes each CWC-face violation h.Y.theta over
*density realizable* parameter sets: theta = [m, h = m c, vech(I)] must be the
moments of some nonnegative mass density on the object's bounding box.  The
set is encoded with the moment conditions

  * pseudo-inertia PSD:  J(theta) = [[S, h], [h', m]] >= 0 with
    S = 0.5 tr(I) I3 - I  (the second-moment matrix),
  * box support per axis and per axis pair (linear rows G theta <= g),
  * CoM box  m l_c <= h <= m u_c,  mass fixed at m0,

and each linear objective is maximized by a log-det barrier interior point:
damped Newton on f_t(y) = -t mu.y - logdet J(y) - sum log(slacks) over
y = theta[1:], with a geometric t ramp.  The reference differentiates f with
``jax.grad``/``jax.hessian`` and vmaps one solve per objective; here one
batched Newton method runs every objective (faces x states) at once, with
the same fixed counts (10 outer steps, 12 Newton steps, six backtracking
candidates), and f's gradient and Hessian in closed form (J is linear in y):

  d/dy_k  -logdet J = -tr(J^-1 E_k),
  d2/dy_k dy_l      =  tr(J^-1 E_k J^-1 E_l),
  -sum log s:  grad G_y^T (1/s),  Hessian G_y^T diag(1/s^2) G_y.

A point where J is not positive definite has a non-finite f (the reference's
Cholesky returns NaN there; ``cholesky_ex`` reports it), and the line search
rejects it.  Inertia about the EE origin; vech order (xx, xy, xz, yy, yz, zz)
as in ``verification.theta_from_body``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from upright_tpu_torch import resolve_device

# vech index pairs for the symmetric inertia matrix
_VECH = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
LINE_SEARCH = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


def _basis():
    """(10, 4, 4): J(theta) = sum_k theta_k E_k, theta = [m, h, vech(I)]."""
    E = np.zeros((10, 4, 4))
    E[0, 3, 3] = 1.0
    for i in range(3):
        E[1 + i, i, 3] = E[1 + i, 3, i] = 1.0
    for k, (a, b) in enumerate(_VECH):
        I = np.zeros((3, 3))
        I[a, b] = I[b, a] = 1.0
        E[4 + k, :3, :3] = 0.5 * np.trace(I) * np.eye(3) - I
    return E


def pseudo_inertia(theta):
    """J(theta) = [[0.5 tr(I) I3 - I, h], [h', m]] (..., 4, 4)."""
    theta = torch.as_tensor(theta)
    E = torch.as_tensor(_basis(), dtype=theta.dtype, device=theta.device)
    return torch.einsum("...k,kij->...ij", theta, E)


@dataclasses.dataclass(frozen=True)
class RealizableSet:
    """Mass densities supported on an axis-aligned box with CoM in a box.

    lower/upper: support box corners in the EE frame (about the EE origin);
    com_lower/com_upper: CoM bounds; mass: fixed total mass.
    """

    lower: np.ndarray
    upper: np.ndarray
    com_lower: np.ndarray
    com_upper: np.ndarray
    mass: float

    def linear_rows(self):
        """(G, g) with G theta <= g encoding all linear moment/CoM rows
        (the reference's rows, in its order)."""
        l, u = np.asarray(self.lower, float), np.asarray(self.upper, float)

        def S_row(i, j):
            """Coefficients of S_ij w.r.t. vech(I)."""
            c = np.zeros(6)
            for k, (a, b) in enumerate(_VECH):
                tr = 1.0 if a == b else 0.0
                c[k] += 0.5 * tr * (1.0 if i == j else 0.0)
                if (a, b) == (min(i, j), max(i, j)):
                    c[k] -= 1.0
            return c

        rows, rhs = [], []

        def add(coef_m, coef_h, coef_S, bound):
            rows.append(np.concatenate([[coef_m], coef_h, coef_S]))
            rhs.append(bound)

        # per axis: E[(x_i - l_i)(u_i - x_i)] >= 0
        for i in range(3):
            h_c = np.zeros(3)
            h_c[i] = -(l[i] + u[i])
            add(l[i] * u[i], h_c, S_row(i, i), 0.0)

        # axis pairs, the four lower/upper sign combinations
        for i in range(3):
            for j in range(i + 1, 3):
                for a_i, s_i in ((l[i], 1.0), (u[i], -1.0)):
                    for a_j, s_j in ((l[j], 1.0), (u[j], -1.0)):
                        s = s_i * s_j
                        h_c = np.zeros(3)
                        h_c[i] = s * a_j
                        h_c[j] = s * a_i
                        add(-s * a_i * a_j, h_c, [-s * c for c in S_row(i, j)], 0.0)

        # CoM box: m cl <= h <= m cu
        cl = np.asarray(self.com_lower, float)
        cu = np.asarray(self.com_upper, float)
        for i in range(3):
            h_c = np.zeros(3)
            h_c[i] = 1.0
            add(-cu[i], h_c, np.zeros(6), 0.0)
            h_c = np.zeros(3)
            h_c[i] = -1.0
            add(cl[i], h_c, np.zeros(6), 0.0)

        return np.asarray(rows), np.asarray(rhs)

    def feasible_start(self):
        """Strictly feasible theta: uniform density over a slightly shrunk
        support box, recentered on the CoM-box center."""
        l, u = np.asarray(self.lower, float), np.asarray(self.upper, float)
        c = 0.5 * (np.asarray(self.com_lower) + np.asarray(self.com_upper))
        half_s = 0.45 * 0.5 * (u - l)
        center = np.clip(c, l + half_s + 1e-9, u - half_s - 1e-9)
        m = self.mass
        S = m * (np.outer(center, center) + np.diag(half_s**2) / 3.0)
        I = np.trace(S) * np.eye(3) - S  # inertia about the origin
        vech = np.array([I[0, 0], I[0, 1], I[0, 2], I[1, 1], I[1, 2], I[2, 2]])
        return np.concatenate([[m], m * center, vech])


def _barrier_max(mu_y, G, g, y0, m0, t0=1.0, t_mult=8.0, outer=10, newton=12):
    """max mu_y . y  s.t.  G [m0; y] <= g,  J([m0; y]) >= 0, for a batch of
    objectives mu_y (n, 9), by a log-det barrier path from y0 (9,).
    Returns (values (n,), y (n, 9))."""
    E = torch.as_tensor(_basis(), dtype=mu_y.dtype, device=mu_y.device)
    J0, Ey = m0 * E[0], E[1:]  # J(y) = J0 + sum_k y_k Ey_k
    Gy = G[:, 1:]
    g_eff = g - G[:, 0] * m0
    alphas = torch.as_tensor(LINE_SEARCH, dtype=mu_y.dtype, device=mu_y.device)

    def phi(y):
        """Barrier of y (..., 9) and the Cholesky factor of J; non-finite
        where J is not positive definite or a slack is not positive."""
        J = J0 + torch.einsum("...k,kij->...ij", y, Ey)
        L, info = torch.linalg.cholesky_ex(J)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        logdet = torch.where(info == 0, logdet, torch.full_like(logdet, float("nan")))
        slack = g_eff - y @ Gy.T
        return -logdet - torch.log(slack).sum(-1), L, slack

    def f(y, t):
        return -t * (mu_y * y).sum(-1) + phi(y)[0]

    y = y0.expand_as(mu_y).clone()
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    t = t0
    for _ in range(outer):
        for _ in range(newton):
            f0, L, slack = phi(y)
            f0 = f0 - t * (mu_y * y).sum(-1)
            Jinv = torch.cholesky_inverse(L)
            M = torch.einsum("nij,kjl->nkil", Jinv, Ey)  # J^-1 E_k
            inv_s = 1.0 / slack
            grad = (-t * mu_y - torch.einsum("nkii->nk", M) + inv_s @ Gy)
            H = (torch.einsum("nkij,nlji->nkl", M, M)
                 + torch.einsum("nr,rk,rl->nkl", inv_s * inv_s, Gy, Gy))
            tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
            H = H + 1e-9 * tr[:, None, None] * eye
            dy = -torch.linalg.solve_ex(H, grad)[0]  # non-finite if singular, as jnp
            # the six candidates at once; the reference's scan keeps the
            # first strict improvement over the best so far, which is the
            # first minimum among the finite values
            cand = y + alphas[:, None, None] * dy
            f_all = torch.cat([f0[None], f(cand, t)], dim=0)
            f_all = torch.where(torch.isfinite(f_all), f_all, torch.full_like(f_all, float("inf")))
            best = torch.argmin(f_all, dim=0)
            y = torch.cat([y[None], cand])[best, torch.arange(y.shape[0], device=y.device)]
        t = t * t_mult
    return (mu_y * y).sum(-1), y


def realizable_max_linear(mus, rset: RealizableSet, device="cuda", dtype=torch.float64):
    """Exact-mass worst case max_{theta in rset} mu . theta for a batch of
    objectives ``mus`` (k, 10), one batched barrier solve on ``device``.
    Returns numpy (values (k,), thetas (k, 10))."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=dtype, device=dev)

    mus = t(np.atleast_2d(np.asarray(mus, dtype=float)))
    G, g = rset.linear_rows()
    y0 = t(rset.feasible_start()[1:])
    m0 = float(rset.mass)
    val_y, y = _barrier_max(mus[:, 1:], t(G), t(g), y0, m0)
    vals = mus[:, 0] * m0 + val_y
    thetas = torch.cat([torch.full_like(y[:, :1], m0), y], dim=-1)
    return vals.cpu().numpy(), thetas.cpu().numpy()


def verify_plan_realizable(face_form_A, Y_list, rset: RealizableSet, device="cuda",
                           dtype=torch.float64):
    """Worst-case face violation per planned state over the realizable set.

    face_form_A: (n_faces, 6) CWC face form; Y_list: (T, 6, 10) inertial
    regressors per state.  Returns (T,) max violations, the realizable-set
    counterpart of ``verification.verify_plan``.
    """
    Y = np.asarray(Y_list)
    A = np.asarray(face_form_A)
    M = np.einsum("fw,twp->tfp", A, Y)  # (T, n_faces, 10)
    T, F, P = M.shape
    vals, _ = realizable_max_linear(M.reshape(T * F, P), rset, device=device, dtype=dtype)
    return vals.reshape(T, F).max(axis=1)
