"""The port's Riccati backward pass (plain version; the CUDA kernel runs only
on a card) against the JAX package's sequential backward and its Pallas
kernel in interpret mode.  Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upright_tpu.solver.al import ALConfig, _backward_pass
from upright_tpu.solver.ocp import OCP
from upright_tpu.solver.pallas_riccati import pallas_backward_pass
from upright_tpu_torch.solver.riccati import (
    riccati_backward,
    riccati_backward_plain,
)

REG = 1e-6


def random_batch(Bt, N, nx, nu, seed=0):
    """The conditioning of tests/test_pallas_riccati.py::random_batch."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((Bt, N, nx, nx)) * 0.2 + np.eye(nx)
    B = rng.standard_normal((Bt, N, nx, nu))
    d = rng.standard_normal((Bt, N, nx)) * 0.05
    grads = rng.standard_normal((Bt, N, nx + nu))
    M = rng.standard_normal((Bt, N, nx + nu, nx + nu))
    hess = 0.1 * np.einsum("bkij,bklj->bkil", M, M) + np.eye(nx + nu)
    gf = rng.standard_normal((Bt, nx))
    Mf = rng.standard_normal((Bt, nx, nx))
    Hf = 0.1 * np.einsum("bij,blj->bil", Mf, Mf) + np.eye(nx)
    return A, B, d, grads, hess, gf, Hf


def ab_batch(Bt, N=20, nx=27, nu=13, seed=0):
    """The conditioning of scripts/pallas_ab.py::make_inputs (float64)."""
    rng = np.random.default_rng(seed)
    nz = nx + nu
    A = rng.standard_normal((Bt, N, nx, nx)) * 0.1 + np.eye(nx)
    B = rng.standard_normal((Bt, N, nx, nu)) * 0.1
    d = rng.standard_normal((Bt, N, nx)) * 0.01
    g = rng.standard_normal((Bt, N, nz))
    Hh = rng.standard_normal((Bt, N, nz, nz)) * 0.1
    H = Hh @ np.swapaxes(Hh, -1, -2) + 3 * np.eye(nz)
    gf = rng.standard_normal((Bt, nx))
    Hf_ = rng.standard_normal((Bt, nx, nx)) * 0.1
    Hf = Hf_ @ np.swapaxes(Hf_, -1, -2) + np.eye(nx)
    return A, B, d, g, H, gf, Hf


def jax_sequential(arrays, N, nx, nu):
    cfg = ALConfig(reg=REG)
    ocp = OCP(N=N, nx=nx, nu=nu, n_eq=0, n_ineq=0, n_feq=0,
              dynamics=None, stage_cost=None, eq=None, ineq=None,
              final_cost=None, final_eq=None)
    Ks, ks = [], []
    for i in range(arrays[0].shape[0]):
        K_i, k_i = _backward_pass(ocp, cfg, *(jnp.asarray(a[i]) for a in arrays))
        Ks.append(np.asarray(K_i))
        ks.append(np.asarray(k_i))
    return np.stack(Ks), np.stack(ks)


def to_torch(arrays, dtype=torch.float64):
    return tuple(torch.as_tensor(a, dtype=dtype) for a in arrays)


@pytest.mark.parametrize(
    "maker,shape",
    [(random_batch, (8, 6, 5, 3)), (ab_batch, (4, 20, 27, 13))],
    ids=["random_batch-8x6x5x3", "pallas_ab-4x20x27x13"],
)
def test_plain_matches_jax_sequential_f64(maker, shape):
    """Same recursion, same clamped Cholesky, float64 on both sides: only the
    summation order inside the products differs, so rtol 1e-9."""
    Bt, N, nx, nu = shape
    arrays = maker(Bt, N, nx, nu)
    K_ref, k_ref = jax_sequential(arrays, N, nx, nu)
    K, kff = riccati_backward_plain(*to_torch(arrays), reg=REG)
    assert K.shape == (Bt, N, nu, nx) and kff.shape == (Bt, N, nu)
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(kff.numpy(), k_ref, rtol=1e-9, atol=1e-12)


def test_plain_matches_pallas_interpret_f32():
    """float32 against the Pallas kernel in interpret mode, block 4: the
    tolerance is that of tests/test_pallas_riccati.py (5e-3 absolute; the two
    float32 recursions round differently over 6 stages)."""
    Bt, N, nx, nu = 8, 6, 5, 3
    arrays = random_batch(Bt, N, nx, nu)
    K_p, k_p = pallas_backward_pass(
        *(jnp.asarray(a, dtype=jnp.float32) for a in arrays),
        reg=REG, block=4, interpret=True,
    )
    K, kff = riccati_backward(*to_torch(arrays, torch.float32), reg=REG)
    assert K.dtype == torch.float32
    np.testing.assert_allclose(K.numpy(), np.asarray(K_p), atol=5e-3, rtol=0)
    np.testing.assert_allclose(kff.numpy(), np.asarray(k_p), atol=5e-3, rtol=0)


def test_stage_invariant_form_equals_broadcast():
    """Form (b) (one unbatched (A, B) pair) equals form (a) with the
    broadcast materialised: the same float64 operations, so 1e-13."""
    Bt, N, nx, nu = 4, 7, 6, 4
    A, B, d, grads, hess, gf, Hf = random_batch(Bt, N, nx, nu, seed=3)
    A0, B0 = A[0, 0], B[0, 0]
    A_b = np.broadcast_to(A0, (Bt, N, nx, nx)).copy()
    B_b = np.broadcast_to(B0, (Bt, N, nx, nu)).copy()
    rest = to_torch((d, grads, hess, gf, Hf))
    K_a, k_a = riccati_backward_plain(*to_torch((A_b, B_b)), *rest, reg=REG)
    K_b, k_b = riccati_backward(*to_torch((A0, B0)), *rest, reg=REG)
    np.testing.assert_allclose(K_b.numpy(), K_a.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(k_b.numpy(), k_a.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("fn", [riccati_backward, riccati_backward_plain])
def test_wide_input_block_raises(fn):
    """nu > 24 is the blocked-factorisation route, which is not ported."""
    arrays = to_torch(random_batch(2, 3, 4, 25, seed=1))
    with pytest.raises(NotImplementedError, match="nu = 25"):
        fn(*arrays, reg=REG)


def test_wrapper_rejects_bad_shapes():
    A, B, d, grads, hess, gf, Hf = to_torch(random_batch(2, 3, 4, 2, seed=1))
    with pytest.raises(ValueError, match="hess"):
        riccati_backward(A, B, d, grads, hess[:, :, :-1], gf, Hf)
