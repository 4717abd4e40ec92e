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
"""

from __future__ import annotations

import ctypes

import torch

from upright_tpu_torch._build import load_library

# Input-dimension cutoff of the clamped elementwise Cholesky.  Above it the
# reference switches to a blocked factorisation with relative jitter and a
# NaN fallback (upright_tpu/solver/al.py); that route is not ported yet.
MAX_NU = 24
PIVOT_EPS = 1e-12

# Number of kernel launches made by `riccati_backward` (CUDA path only).
launch_count = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("riccati")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.riccati_backward_f32.argtypes = (
            [p] * 9 + [i, i, i, i] + [ll, ll, ll, ll] + [ctypes.c_float, p]
        )
        lib.riccati_backward_f32.restype = ctypes.c_int
        lib.riccati_backward_smem_bytes.argtypes = [i, i]
        lib.riccati_backward_smem_bytes.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check_shapes(A, B, d, grads, hess, gf, Hf):
    """Validate shapes; returns (Bt, N, nx, nu, stage_invariant)."""
    if d.ndim != 3:
        raise ValueError(f"d must be (Bt, N, nx); got {tuple(d.shape)}")
    Bt, N, nx = d.shape
    nu = B.shape[-1]
    nz = nx + nu
    if nu > MAX_NU:
        raise NotImplementedError(
            f"riccati_backward: nu = {nu} > {MAX_NU} needs the blocked "
            "factorisation with jitter and NaN fallback, which is not ported yet"
        )
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
        sol = -_chol_solve(_chol_factor_clamped(Quu), rhs)
        K_k, kff_k = sol[..., :nx], sol[..., nx]
        P = Q[:, :nx, :nx] + Qux.transpose(-1, -2) @ K_k
        P = 0.5 * (P + P.transpose(-1, -2))
        p = q[:, :nx] + (Qux.transpose(-1, -2) @ kff_k.unsqueeze(-1)).squeeze(-1)
        Ks[k], kffs[k] = K_k, kff_k
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1)


def _riccati_backward_cuda(A, B, d, grads, hess, gf, Hf, reg):
    global launch_count
    Bt, N, nx, nu, invariant = _check_shapes(A, B, d, grads, hess, gf, Hf)
    tensors = {"A": A, "B": B, "d": d, "grads": grads, "hess": hess, "gf": gf, "Hf": Hf}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != d.device:
            raise ValueError(f"{name} is on {t.device}; every input must be on {d.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the Riccati kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    if lib.riccati_backward_smem_bytes(nx, nu) > 232448:
        raise ValueError(f"nx = {nx}, nu = {nu} exceed one block's shared memory")

    K = torch.empty((Bt, N, nu, nx), dtype=torch.float32, device=d.device)
    kff = torch.empty((Bt, N, nu), dtype=torch.float32, device=d.device)
    if invariant:
        sA = sB = (0, 0)
    else:
        sA = (N * nx * nx, nx * nx)
        sB = (N * nx * nu, nx * nu)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.riccati_backward_f32(
            A.data_ptr(), B.data_ptr(), d.data_ptr(), grads.data_ptr(),
            hess.data_ptr(), gf.data_ptr(), Hf.data_ptr(), K.data_ptr(),
            kff.data_ptr(), Bt, N, nx, nu, sA[0], sA[1], sB[0], sB[1],
            float(reg), stream,
        )
    if err != 0:
        raise RuntimeError(f"riccati_backward_f32 launch failed with CUDA error {err}")
    launch_count += 1
    return K, kff


def riccati_backward(A, B, d, grads, hess, gf, Hf, reg=1e-6):
    """Batched Riccati backward pass.

    d: (Bt, N, nx), grads: (Bt, N, nz), hess: (Bt, N, nz, nz), gf: (Bt, nx),
    Hf: (Bt, nx, nx); A, B per stage (form a) or stage-invariant (form b).
    Returns (K (Bt, N, nu, nx), kff (Bt, N, nu)).

    CUDA tensors go to the kernel (float32, contiguous) or raise; CPU tensors
    run the plain version.
    """
    if d.is_cuda:
        return _riccati_backward_cuda(A, B, d, grads, hess, gf, Hf, reg)
    return riccati_backward_plain(A, B, d, grads, hess, gf, Hf, reg)
