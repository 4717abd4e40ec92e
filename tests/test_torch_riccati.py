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
from upright_tpu_torch.tools.stage_data import random_batch, stage_data

REG = 1e-6


def ab_batch(Bt, N=20, nx=27, nu=13, seed=0):
    """The conditioning of scripts/pallas_ab.py::make_inputs (float64)."""
    return stage_data(Bt, N, nx, nu, seed=seed)


def jax_sequential(arrays, N, nx, nu, reg=REG):
    cfg = ALConfig(reg=reg)
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


@pytest.mark.parametrize(
    "maker,shape",
    [
        (random_batch, (3, 4, 5, 24)),
        (random_batch, (3, 4, 5, 25)),
        (ab_batch, (2, 6, 27, 45)),
        (ab_batch, (2, 5, 9, 32)),
    ],
    ids=["random_batch-nu24", "random_batch-nu25", "pallas_ab-nu45", "pallas_ab-nu32"],
)
def test_plain_matches_jax_sequential_on_each_side_of_the_route_switch(maker, shape):
    """nu = 24 is the last width of the clamped factorisation, nu = 25 the
    first of the jittered one.  Above 24 both sides call LAPACK's Cholesky on
    the same jittered matrix in float64; only summation order differs, so
    rtol 1e-8."""
    Bt, N, nx, nu = shape
    arrays = maker(Bt, N, nx, nu, seed=nu)
    K_ref, k_ref = jax_sequential(arrays, N, nx, nu)
    K, kff = riccati_backward(*to_torch(arrays), reg=REG)
    assert np.isfinite(K_ref).all()
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(kff.numpy(), k_ref, rtol=1e-8, atol=1e-11)


def single_stage_batch(lasts, nx=4, nu=25, seed=5):
    """One stage, Hf = 0, luu = diag(1, ..., 1, last) per instance: Quu is luu
    exactly (reg = 0), so `last` alone decides which factorisation holds."""
    rng = np.random.default_rng(seed)
    Bt, nz = len(lasts), nx + nu
    A = rng.standard_normal((Bt, 1, nx, nx)) * 0.2 + np.eye(nx)
    B = rng.standard_normal((Bt, 1, nx, nu))
    d = rng.standard_normal((Bt, 1, nx)) * 0.05
    grads = rng.standard_normal((Bt, 1, nz))
    hess = np.zeros((Bt, 1, nz, nz))
    for b, last in enumerate(lasts):
        hess[b, 0, :nx, :nx] = 2 * np.eye(nx)
        hess[b, 0, nx:, nx:] = np.diag([1.0] * (nu - 1) + [last])
        lux = 0.1 * rng.standard_normal((nu, nx))
        hess[b, 0, nx:, :nx] = lux
        hess[b, 0, :nx, nx:] = lux.T
    gf = rng.standard_normal((Bt, nx))
    Hf = np.zeros((Bt, nx, nx))
    return A, B, d, grads, hess, gf, Hf


def test_jitter_fallback_is_taken_per_instance():
    """last = -1e-5 is below the first jitter (1e-7 of the mean diagonal) and
    above the second (1e-3): instances 1 and 3 take the second factorisation,
    the others the first, and all agree with the reference to 1e-8."""
    lasts = [1.0, -1e-5, 0.5, -1e-5]
    arrays = single_stage_batch(lasts)
    K_ref, k_ref = jax_sequential(arrays, 1, 4, 25, reg=0.0)
    K, kff = riccati_backward_plain(*to_torch(arrays), reg=0.0)
    assert np.isfinite(K_ref).all() and torch.isfinite(K).all()
    # the gain of the last input is lux / (last + jitter): huge only where the
    # second factorisation was taken
    big = K.abs().amax(dim=(1, 2, 3)) > 10.0
    assert big.tolist() == [False, True, False, True]
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(kff.numpy(), k_ref, rtol=1e-8, atol=1e-11)


def test_both_factorisations_failing_gives_nan_where_the_reference_has_nan():
    """last = -1 defeats both jitters: that instance is NaN on both sides, in
    the same entries, and its neighbours are untouched."""
    lasts = [1.0, -1.0, -1e-5]
    arrays = single_stage_batch(lasts, seed=6)
    K_ref, k_ref = jax_sequential(arrays, 1, 4, 25, reg=0.0)
    K, kff = riccati_backward_plain(*to_torch(arrays), reg=0.0)
    assert np.isnan(K_ref[1]).all() and np.isnan(k_ref[1]).all()
    np.testing.assert_array_equal(np.isnan(K.numpy()), np.isnan(K_ref))
    np.testing.assert_array_equal(np.isnan(kff.numpy()), np.isnan(k_ref))
    np.testing.assert_allclose(K.numpy()[[0, 2]], K_ref[[0, 2]], rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(kff.numpy()[[0, 2]], k_ref[[0, 2]], rtol=1e-8, atol=1e-11)


def test_nan_spreads_to_earlier_stages_only():
    """A stage where both factorisations fail poisons P, so every earlier
    stage of that instance is NaN and every later one is not, as in the
    reference's scan."""
    Bt, N, nx, nu = 2, 3, 4, 25
    arrays = list(random_batch(Bt, N, nx, nu, seed=9))
    bad = single_stage_batch([-1.0], nx=nx, nu=nu, seed=8)
    arrays[1][1, 1] = 0.0  # B = 0 at stage 1 of instance 1: Quu = luu there
    arrays[4][1, 1] = bad[4][0, 0]
    K_ref, _ = jax_sequential(arrays, N, nx, nu, reg=0.0)
    K, _ = riccati_backward_plain(*to_torch(arrays), reg=0.0)
    nan = torch.isnan(K).all(dim=-1).all(dim=-1)
    assert nan.tolist() == [[False, False, False], [True, True, False]]
    np.testing.assert_array_equal(np.isnan(K.numpy()), np.isnan(K_ref))
    np.testing.assert_allclose(K.numpy()[0], K_ref[0], rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(K.numpy()[1, 2], K_ref[1, 2], rtol=1e-8, atol=1e-11)


def test_wrapper_rejects_bad_shapes():
    A, B, d, grads, hess, gf, Hf = to_torch(random_batch(2, 3, 4, 2, seed=1))
    with pytest.raises(ValueError, match="hess"):
        riccati_backward(A, B, d, grads, hess[:, :, :-1], gf, Hf)
