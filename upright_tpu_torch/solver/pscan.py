"""Parallel (log-depth) Riccati backward pass over the horizon.

Counterpart of ``upright_tpu/solver/pscan.py``.  The sequential Riccati
recursion is rewritten as an associative combination of conditional value
functions.  Element e = (A, b, C, J, eta) over a stage span [i, j) stands for

  V_{i,j}(x_i, x_j) = 1/2 (x_j - A x_i - b)^T C^{-1} (x_j - A x_i - b)
                      + 1/2 x_i^T J x_i - eta^T x_i  (+ const),

with C possibly singular (never inverted alone).  One stage of the
multiple-shooting subproblem, its input eliminated, gives

  A_e = A - B R^{-1} L,  b_e = d - B R^{-1} r,  C_e = B R^{-1} B^T,
  J_e = Q - L^T R^{-1} L,  eta_e = -(q - L^T R^{-1} r),

and the terminal element is (0, 0, 0, P_f, -p_f).  The suffix combination
over [k, N] yields the cost-to-go P_k = J_k, p_k = -eta_k, and the gains
come from the one-step minimization against V_{k+1}.

The reference evaluates the suffix scan with ``jax.lax.associative_scan``.
Here it is a ladder over the stage axis: at rung r every element k combines
with the element 2^r stages later (when there is one), so ceil(log2(N + 1))
rungs of one batched combination each reach the whole suffix.  The
combinations follow another tree than the reference's, so the two agree to
rounding, not bit for bit.  Plain torch, no kernel: every tensor keeps its
leading batch dimensions, and the inverses of the reference are batched
``torch.linalg.solve_ex`` calls.
"""

from __future__ import annotations

import torch


def _solve(A, B):
    """A^-1 B, batched.  ``solve_ex`` leaves a singular system non-finite, as
    the reference's solve does, and does not wait for the device to check."""
    return torch.linalg.solve_ex(A, B)[0]


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _combine(e_earlier, e_later):
    """Associative combination of conditional value functions: e_earlier
    spans [i, m), e_later spans [m, j); returns the element for [i, j).
    Vectors are columns (..., nx, 1); leading dimensions broadcast."""
    A1, b1, C1, J1, n1 = e_earlier
    A2, b2, C2, J2, n2 = e_later
    I = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device).expand_as(C1)
    # (I + C1 J2)^{-1} and (I + J2 C1)^{-1} by solves, as the reference
    M_inv = _solve(I + C1 @ J2, I)
    N_inv = _solve(I + J2 @ C1, I)
    A2M = A2 @ M_inv
    A1tN = A1.mT @ N_inv
    A = A2M @ A1
    b = A2M @ (b1 + C1 @ n2) + b2
    C = A2M @ C1 @ A2.mT + C2
    n = A1tN @ (n2 - J2 @ b1) + n1
    J = A1tN @ J2 @ A1 + J1
    return (A, b, C, J, n)


def _split_cost(grads, hess, nx, reg):
    """(lx, lu, Q, L, R + reg I) of the stage derivatives."""
    nu = grads.shape[-1] - nx
    eye_u = torch.eye(nu, dtype=hess.dtype, device=hess.device)
    return (grads[..., :nx], grads[..., nx:], hess[..., :nx, :nx], hess[..., nx:, :nx],
            hess[..., nx:, nx:] + reg * eye_u)


def _stage_elements(A, B, d, grads, hess, reg):
    """Elements of all stages at once, vectors as columns;
    A (..., N, nx, nx), B (..., N, nx, nu)."""
    nx = A.shape[-1]
    lx, lu, Q, L, R = _split_cost(grads, hess, nx, reg)
    Ri_L = _solve(R, L)  # R^{-1} L
    Ri_r = _solve(R, lu.unsqueeze(-1))  # R^{-1} r
    Ri_Bt = _solve(R, B.mT)  # R^{-1} B^T
    A_e = A - B @ Ri_L
    b_e = d.unsqueeze(-1) - B @ Ri_r
    C_e = B @ Ri_Bt
    J_e = Q - L.mT @ Ri_L
    n_e = -(lx.unsqueeze(-1) - L.mT @ Ri_r)
    return (A_e, b_e, C_e, J_e, n_e)


def _suffix_ladder(elems):
    """Reverse inclusive scan along the stage axis (-3): element k becomes
    the combination of elements k .. end, in ceil(log2(count)) rungs."""
    n = elems[0].shape[-3]
    out = list(elems)
    step = 1
    while step < n:
        combined = _combine([t[..., : n - step, :, :] for t in out],
                            [t[..., step:, :, :] for t in out])
        # the last `step` elements already reach the end
        out = [torch.cat([c, t[..., n - step :, :, :]], dim=-3) for c, t in zip(combined, out)]
        step *= 2
    return out


def parallel_backward_pass(A, B, d, grads, hess, gf, Hf, reg=1e-6):
    """Drop-in for the Riccati backward pass (``solver/riccati.py``
    ``riccati_backward``): returns (K (..., N, nu, nx), kff (..., N, nu)).

    A: (..., N, nx, nx), B: (..., N, nx, nu), d: (..., N, nx) defects,
    grads/hess: (..., N, nz[, nz]) AL derivatives, gf (..., nx) and
    Hf (..., nx, nx) terminal.  A stage-invariant pair (A (nx, nx),
    B (nx, nu)) is broadcast over the leading dimensions of d.
    """
    nx = d.shape[-1]
    nu = grads.shape[-1] - nx
    lead = d.shape[:-1]  # (..., N)
    A = A.expand(lead + (nx, nx))
    B = B.expand(lead + (nx, nu))
    elems = _stage_elements(A, B, d, grads, hess, reg)
    zero_m = torch.zeros_like(Hf).unsqueeze(-3)
    term = (zero_m, torch.zeros_like(gf)[..., None, :, None], zero_m, Hf.unsqueeze(-3),
            -gf[..., None, :, None])
    elems = [torch.cat([s, t.expand(s.shape[:-3] + t.shape[-3:])], dim=-3)
             for s, t in zip(elems, term)]
    _, _, _, J_all, n_all = _suffix_ladder(elems)
    P1 = J_all[..., 1:, :, :]  # cost-to-go Hessians of stages 1 .. N
    p1 = -n_all[..., 1:, :, 0]

    _, lu, _, L, R = _split_cost(grads, hess, nx, reg)
    Pd_p = p1 + _mv(P1, d)
    Qu = lu + _mv(B.mT, Pd_p)
    Quu = R + B.mT @ P1 @ B
    Qux = L + B.mT @ P1 @ A
    K = -_solve(Quu, Qux)
    kff = -_solve(Quu, Qu.unsqueeze(-1)).squeeze(-1)
    return K, kff
