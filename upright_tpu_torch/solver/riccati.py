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

import ctypes

import torch

from upright_tpu_torch._build import load_library

# Input-dimension cutoff of the clamped elementwise Cholesky.  Above it the
# reference (upright_tpu/solver/al.py, _backward_pass) factors with a relative
# diagonal jitter instead of a clamp, and falls back to a larger jitter where
# that fails; the kernel and the plain version switch at the same width.
MAX_NU = 24
PIVOT_EPS = 1e-12
JITTER = (1e-7, 1e-3)  # relative to max(trace(Quu) / nu, JITTER_FLOOR)
JITTER_FLOOR = 1e-9
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block can have on an H100

# The kernel's instantiations, in the order of csrc/riccati.cu's pick_instance:
# the register route (nu <= 16), then the wide route (nu > 16)
INSTANCES = ("float32 nx=27 nu=13", "float32 nx=18 nu=10",
             "float32 runtime-sized", "float64 runtime-sized",
             "float32 wide", "float64 wide")
_ELEM_BYTES = {torch.float32: 4, torch.float64: 8}

# Number of kernel launches made by `riccati_backward` (CUDA path only).
launch_count = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("riccati")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.riccati_backward.argtypes = (
            [p] * 9 + [i] * 5 + [ll] * 4 + [ctypes.c_double, i, p]
        )
        lib.riccati_backward.restype = ctypes.c_int
        lib.riccati_backward_smem_bytes.argtypes = [i, i, i, i]
        lib.riccati_backward_smem_bytes.restype = ctypes.c_longlong
        lib.riccati_backward_instance_attrs.argtypes = [i, ctypes.POINTER(i)]
        lib.riccati_backward_instance_attrs.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def instance_attrs():
    """Registers per thread, bytes of local memory per thread and bytes of
    static shared memory of each instantiation of the kernel, by name."""
    lib = _library()
    out = {}
    for which, name in enumerate(INSTANCES):
        buf = (ctypes.c_int * 3)()
        err = lib.riccati_backward_instance_attrs(which, buf)
        if err != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name} with CUDA error {err}")
        out[name] = {"registers": buf[0], "local_bytes": buf[1], "static_smem_bytes": buf[2]}
    return out


def smem_bytes(nx, nu, dtype=torch.float32, runtime_sized=False):
    """Bytes of dynamic shared memory one block of the kernel takes."""
    return _library().riccati_backward_smem_bytes(nx, nu, _ELEM_BYTES[dtype], int(runtime_sized))


def _riccati_backward_cuda(A, B, d, grads, hess, gf, Hf, reg, runtime_sized=False):
    """Launch the kernel.  ``runtime_sized`` keeps a float32 call off the
    instances compiled for the shipped widths: the card tests and the timing
    tools set it to hold the two against each other (they agree to float32
    rounding); the solver never does."""
    global launch_count
    Bt, N, nx, nu, invariant = _check_shapes(A, B, d, grads, hess, gf, Hf)
    if d.dtype not in _ELEM_BYTES:
        raise TypeError(f"d is {d.dtype}; the Riccati kernel takes float32 or float64")
    tensors = {"A": A, "B": B, "d": d, "grads": grads, "hess": hess, "gf": gf, "Hf": Hf}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != d.device:
            raise ValueError(f"{name} is on {t.device}; every input must be on {d.device}")
        if t.dtype != d.dtype:
            raise TypeError(f"{name} is {t.dtype} and d is {d.dtype}; the Riccati kernel "
                            "takes all its inputs in one dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    need = smem_bytes(nx, nu, d.dtype, runtime_sized)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"nx = {nx}, nu = {nu} in {d.dtype} need {need} bytes of shared "
                         f"memory; one block has {MAX_SMEM_BYTES}")

    K = torch.empty((Bt, N, nu, nx), dtype=d.dtype, device=d.device)
    kff = torch.empty((Bt, N, nu), dtype=d.dtype, device=d.device)
    if invariant:
        sA = sB = (0, 0)
    else:
        sA = (N * nx * nx, nx * nx)
        sB = (N * nx * nu, nx * nu)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.riccati_backward(
            A.data_ptr(), B.data_ptr(), d.data_ptr(), grads.data_ptr(),
            hess.data_ptr(), gf.data_ptr(), Hf.data_ptr(), K.data_ptr(),
            kff.data_ptr(), _ELEM_BYTES[d.dtype], Bt, N, nx, nu,
            sA[0], sA[1], sB[0], sB[1], float(reg), int(runtime_sized), stream,
        )
    if err != 0:
        raise RuntimeError(f"riccati_backward launch failed with CUDA error {err}")
    launch_count += 1
    return K, kff


def riccati_backward(A, B, d, grads, hess, gf, Hf, reg=1e-6):
    """Batched Riccati backward pass.

    d: (Bt, N, nx), grads: (Bt, N, nz), hess: (Bt, N, nz, nz), gf: (Bt, nx),
    Hf: (Bt, nx, nx); A, B per stage (form a) or stage-invariant (form b).
    Returns (K (Bt, N, nu, nx), kff (Bt, N, nu)).

    CUDA tensors go to the kernel (float32 or float64, all of one dtype,
    contiguous, any nu that fits a block's shared memory) or raise; CPU
    tensors run the plain version.
    """
    if d.is_cuda:
        return _riccati_backward_cuda(A, B, d, grads, hess, gf, Hf, reg)
    return riccati_backward_plain(A, B, d, grads, hess, gf, Hf, reg)
