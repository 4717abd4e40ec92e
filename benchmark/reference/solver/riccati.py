"""Batched Riccati backward pass: CUDA kernel, wrapper and plain version.

Replaces the TPU kernel ``upright_tpu/solver/pallas_riccati.py``
(``pallas_backward_pass``); the kernel source is ``csrc/riccati.cu`` and its
header note says what bounds it on the card.

``riccati_backward`` is what the solver calls.  For CUDA tensors it launches
the kernel or raises — there is no fallback on the card.  For CPU tensors,
and only then, it runs ``riccati_backward_plain``, the same recursion as a
Python loop over stages (any float dtype), which the CPU tests use and which
the kernel is held against on the card.

Two input forms:
  (a) per-stage dynamics  A (Bt, N, nx, nx), B (Bt, N, nx, nu);
  (b) stage-invariant     A (nx, nx),        B (nx, nu), one pair for the
      whole batch (linear dynamics).  The kernel takes it through zero
      strides; the broadcast is never materialised.

Two rules for the factorisation of Quu, switched at ``MAX_NU`` as in the
reference: up to 24 inputs the pivots are clamped, ``sqrt(max(s, 1e-12))``;
above, Quu gets a relative diagonal jitter and, per instance and stage, a
larger one where the first factorisation fails, and NaN where both do.

Two routes in the kernel, chosen by dtype and width alone (``INSTANCES``):
up to 16 inputs one elimination in registers (compile-time sizes for float32
calls at the widths of the shipped configurations, nx/nu = 27/13 and 18/10;
runtime-sized otherwise, float32 and float64); above 16 the wide route, which
factors Quu in panels of 16 columns and takes every shipped width in both
dtypes.  A shape whose block would need more than ``MAX_SMEM_BYTES`` of
shared memory raises (in float64 at nx 27: nu above 96).
"""

from __future__ import annotations

import torch


# Input-dimension cutoff of the clamped elementwise Cholesky.  Above it the
# reference (upright_tpu/solver/al.py, _backward_pass) factors with a relative
# diagonal jitter instead of a clamp, and falls back to a larger jitter where
# that fails; the kernel and the plain version switch at the same width.
MAX_NU = 24
PIVOT_EPS = 1e-12
JITTER = (1e-7, 1e-3)  # relative to max(trace(Quu) / nu, JITTER_FLOOR)
JITTER_FLOOR = 1e-9
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block can have on an H100

_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}

def _check_shapes(A, B, d, grads, hess, gf, Hf):
    """Validate shapes; returns (Bt, N, nx, nu, stage_invariant)."""
    if d.ndim != 3:
        raise ValueError(f"d must be (Bt, N, nx); got {tuple(d.shape)}")
    Bt, N, nx = d.shape
    nu = B.shape[-1]
    nz = nx + nu
    invariant = A.ndim == 2
    lead = () if invariant else (Bt, N)
    expect = {
        "A": (A, lead + (nx, nx)), "B": (B, lead + (nx, nu)),
        "grads": (grads, (Bt, N, nz)), "hess": (hess, (Bt, N, nz, nz)),
        "gf": (gf, (Bt, nx)), "Hf": (Hf, (Bt, nx, nx)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
    return Bt, N, nx, nu, invariant


def _chol_factor_clamped(M):
    """Lower Cholesky factor of (..., n, n) with pivots sqrt(max(s, eps)),
    column by column with elementwise tensor ops (the reference's unrolled
    factorisation, one column at a time)."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(n):
        s = M[..., j:, j] - (L[..., j:, :j] * L[..., j : j + 1, :j]).sum(-1)
        piv = torch.sqrt(torch.clamp(s[..., 0], min=PIVOT_EPS))
        L[..., j, j] = piv
        L[..., j + 1 :, j] = s[..., 1:] / piv.unsqueeze(-1)
    return L


def _chol_solve(L, R):
    """Solve (L L^T) X = R by forward and back substitution; R (..., n, m)."""
    n = L.shape[-1]
    Y = torch.zeros_like(R)
    for i in range(n):
        s = R[..., i, :] - (L[..., i, :i].unsqueeze(-1) * Y[..., :i, :]).sum(-2)
        Y[..., i, :] = s / L[..., i, i].unsqueeze(-1)
    X = torch.zeros_like(R)
    for i in reversed(range(n)):
        s = Y[..., i, :] - (L[..., i + 1 :, i].unsqueeze(-1) * X[..., i + 1 :, :]).sum(-2)
        X[..., i, :] = s / L[..., i, i].unsqueeze(-1)
    return X


def _solve_jittered(Quu, rhs):
    """-Quu^-1 rhs by the reference's route for wide input blocks: factor
    Quu + 1e-7 s I (s = max(trace(Quu) / nu, 1e-9), no pivot clamp); where
    that fails, per instance, factor Quu + 1e-3 s I instead; where both fail
    the solution is NaN, as the reference's NaN factor makes it."""
    nu = Quu.shape[-1]
    eye_u = torch.eye(nu, dtype=Quu.dtype, device=Quu.device)
    scale = torch.clamp(Quu.diagonal(dim1=-2, dim2=-1).sum(-1) / nu, min=JITTER_FLOOR)
    scale = scale[:, None, None]
    L, bad = torch.linalg.cholesky_ex(Quu + JITTER[0] * scale * eye_u)
    L_safe, bad_safe = torch.linalg.cholesky_ex(Quu + JITTER[1] * scale * eye_u)
    bad, bad_safe = (bad != 0)[:, None, None], (bad_safe != 0)[:, None, None]
    # a failed factor is unspecified below the failing pivot: never solve with it
    L = torch.where(bad, torch.where(bad_safe, eye_u, L_safe), L)
    sol = -torch.cholesky_solve(rhs, L)
    return torch.where(bad & bad_safe, torch.full_like(sol, float("nan")), sol)


def riccati_backward_plain(A, B, d, grads, hess, gf, Hf, reg=1e-6):
    """Plain PyTorch version of the kernel: multiple-shooting Riccati
    recursion with defects, batched over instances, a Python loop over
    stages.  Returns (K (Bt, N, nu, nx), kff (Bt, N, nu))."""
    Bt, N, nx, nu, invariant = _check_shapes(A, B, d, grads, hess, gf, Hf)
    Z = torch.cat([A, B], dim=-1)  # (Bt, N, nx, nz) or (nx, nz)
    eye_u = torch.eye(nu, dtype=d.dtype, device=d.device)

    P, p = Hf, gf
    Ks, kffs = [None] * N, [None] * N
    for k in reversed(range(N)):
        Z_k = Z if invariant else Z[:, k]
        Zt = Z_k.transpose(-1, -2)
        Pd_p = p + (P @ d[:, k].unsqueeze(-1)).squeeze(-1)
        Q = hess[:, k] + Zt @ (P @ Z_k)
        q = grads[:, k] + (Zt @ Pd_p.unsqueeze(-1)).squeeze(-1)
        Quu = Q[:, nx:, nx:] + reg * eye_u
        Qux = Q[:, nx:, :nx]
        rhs = torch.cat([Qux, q[:, nx:, None]], dim=-1)
        if nu <= MAX_NU:
            sol = -_chol_solve(_chol_factor_clamped(Quu), rhs)
        else:
            sol = _solve_jittered(Quu, rhs)
        K_k, kff_k = sol[..., :nx], sol[..., nx]
        P = Q[:, :nx, :nx] + Qux.transpose(-1, -2) @ K_k
        P = 0.5 * (P + P.transpose(-1, -2))
        p = q[:, :nx] + (Qux.transpose(-1, -2) @ kff_k.unsqueeze(-1)).squeeze(-1)
        Ks[k], kffs[k] = K_k, kff_k
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1)



def riccati_backward(A, B, d, grads, hess, gf, Hf, reg=1e-6):
    """The plain recursion on any device."""
    return riccati_backward_plain(A, B, d, grads, hess, gf, Hf, reg)
