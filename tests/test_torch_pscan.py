"""The port's log-depth backward pass (``upright_tpu_torch/solver/pscan.py``)
and ``ALConfig.backward``, against the JAX package, in float64 on the CPU.

- ``parallel_backward_pass`` against the JAX ``parallel_backward_pass`` (1e-8:
  both evaluate the same combination, the port's ladder in another tree
  than ``jax.lax.associative_scan``) and against the sequential recursions,
  the JAX package's ``_backward_pass`` and the port's
  ``riccati_backward_plain``, at the limits of tests/test_pscan.py (1e-7;
  1e-6 at N = 200), at that file's three sizes and at the main path's
  27/13;
- ``ALConfig(backward=...)``: the cases of
  tests/test_backward_options.py::test_backend_matches_scan on the same
  linear-quadratic problem, at that test's limits against "scan", and the
  port's solve against the JAX package's to 1e-8;
- ``plan_robust(use_parallel_scan=True)`` equal to the sequential plan at
  N = 40, as ::test_plan_robust_parallel_scan_real (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upright_tpu.solver import al as jal
from upright_tpu.solver.ocp import OCP as JOCP
from upright_tpu.solver.ocp import zeros_warm_start as jzeros
from upright_tpu.solver.pscan import parallel_backward_pass as jpscan
from upright_tpu_torch.solver import al as tal
from upright_tpu_torch.solver.ocp import OCP as TOCP
from upright_tpu_torch.solver.ocp import zeros_warm_start as tzeros
from upright_tpu_torch.solver.pscan import parallel_backward_pass
from upright_tpu_torch.solver.riccati import riccati_backward_plain

CPU64 = dict(device="cpu", dtype=torch.float64)
REG = 1e-8


def random_lqr(N, nx, nu, seed=0):
    """tests/test_pscan.py's random_lqr, as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, nx, nx)) * 0.3 + np.eye(nx)
    B = rng.standard_normal((N, nx, nu))
    d = rng.standard_normal((N, nx)) * 0.1
    grads = rng.standard_normal((N, nx + nu))
    hs = []
    for _ in range(N):
        M = rng.standard_normal((nx + nu, nx + nu))
        hs.append(M @ M.T * 0.1 + np.eye(nx + nu))
    hess = np.stack(hs)
    gf = rng.standard_normal(nx)
    Mf = rng.standard_normal((nx, nx))
    Hf = Mf @ Mf.T * 0.1 + np.eye(nx)
    return A, B, d, grads, hess, gf, Hf


def jax_sequential(N, nx, nu, data):
    cfg = jal.ALConfig(reg=REG)
    ocp = JOCP(N=N, nx=nx, nu=nu, n_eq=0, n_ineq=0, n_feq=0, dynamics=None,
               stage_cost=None, eq=None, ineq=None, final_cost=None, final_eq=None)
    return jal._backward_pass(ocp, cfg, *(jnp.asarray(a) for a in data))


@pytest.mark.parametrize("N,nx,nu,seed,atol", [
    (24, 6, 3, 0, 1e-7), (200, 4, 2, 1, 1e-6), (12, 4, 2, 2, 1e-7), (20, 27, 13, 3, 1e-7),
])
def test_parallel_matches_reference_and_sequential(N, nx, nu, seed, atol):
    data = random_lqr(N, nx, nu, seed)
    K, kff = parallel_backward_pass(*(torch.as_tensor(a) for a in data), reg=REG)
    K_j, kff_j = jpscan(*(jnp.asarray(a) for a in data), reg=REG)
    np.testing.assert_allclose(K.numpy(), K_j, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(kff.numpy(), kff_j, rtol=1e-8, atol=1e-8)
    K_s, kff_s = jax_sequential(N, nx, nu, data)
    np.testing.assert_allclose(K.numpy(), K_s, rtol=0, atol=atol)
    np.testing.assert_allclose(kff.numpy(), kff_s, rtol=0, atol=atol)
    K_p, kff_p = riccati_backward_plain(*(torch.as_tensor(a)[None] for a in data), reg=REG)
    np.testing.assert_allclose(K.numpy(), K_p[0].numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(kff.numpy(), kff_p[0].numpy(), rtol=0, atol=atol)


def test_leading_dimensions_and_stage_invariant_form():
    """Every tensor keeps its leading batch dimensions: a (2, 3) batch
    equals its six instances one by one, and a stage-invariant (A, B) pair
    (the solver's linear-dynamics form) equals its per-stage broadcast."""
    N, nx, nu = 12, 4, 2
    sets = [[random_lqr(N, nx, nu, seed=10 * i + j) for j in range(3)] for i in range(2)]
    data = [np.array([[sets[i][j][k] for j in range(3)] for i in range(2)]) for k in range(7)]
    K, kff = parallel_backward_pass(*(torch.as_tensor(a) for a in data), reg=REG)
    assert K.shape == (2, 3, N, nu, nx) and kff.shape == (2, 3, N, nu)
    for i in range(2):
        for j in range(3):
            K1, kff1 = parallel_backward_pass(*(torch.as_tensor(a[i, j]) for a in data), reg=REG)
            np.testing.assert_allclose(K[i, j].numpy(), K1.numpy(), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(kff[i, j].numpy(), kff1.numpy(), rtol=1e-12, atol=1e-12)
    A, B, d, grads, hess, gf, Hf = (torch.as_tensor(a[0]) for a in data)
    Ks, kffs = parallel_backward_pass(A[0, 0], B[0, 0], d, grads, hess, gf, Hf, reg=REG)
    Kb, kffb = parallel_backward_pass(A[0, 0].expand_as(A).clone(), B[0, 0].expand_as(B).clone(),
                                      d, grads, hess, gf, Hf, reg=REG)
    np.testing.assert_allclose(Ks.numpy(), Kb.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(kffs.numpy(), kffb.numpy(), rtol=1e-12, atol=1e-12)


# -- ALConfig.backward -----------------------------------------------------------


def lq_problem(N=20, nx=4, nu=2, seed=0):
    """tests/test_backward_options.py's make_problem in both packages.  The
    port's OCP has no terminal cost, so the terminal term is final-equality
    rows x = 0 on both sides (with rho_eq 10 its penalty is the original's
    5 x'x until the first dual update)."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    B = 0.1 * rng.standard_normal((nx, nu))
    W = np.diag(np.concatenate([np.ones(nx), 0.1 * np.ones(nu)]))
    x0 = rng.standard_normal(nx)

    Aj, Bj, Wj = jnp.asarray(A), jnp.asarray(B), jnp.asarray(W)
    jocp = JOCP(
        N=N, nx=nx, nu=nu, n_eq=0, n_ineq=0, n_feq=nx,
        dynamics=lambda x, u, p: Aj @ x + Bj @ u,
        stage_cost=lambda x, u, p: 0.5 * jnp.concatenate([x, u]) @ Wj @ jnp.concatenate([x, u]),
        eq=lambda x, u, p: jnp.zeros((0,)), ineq=lambda x, u, p: jnp.zeros((0,)),
        final_cost=lambda x, p: 0.0 * (x @ x), final_eq=lambda x, p: x,
    )
    At, Bt, Wt = (torch.as_tensor(a) for a in (A, B, W))

    def zeros_rows(x, u, p):
        return x.new_zeros(x.shape[:-1] + (0,))

    tocp = TOCP(
        N=N, nx=nx, nu=nu, n_eq=0, n_ineq=0, n_feq=nx,
        dynamics=lambda x, u, p: x @ At.T + u @ Bt.T,
        stage_cost=lambda x, u, p: 0.5 * ((torch.cat([x, u], -1) @ Wt) * torch.cat([x, u], -1)).sum(-1),
        eq=zeros_rows, ineq=zeros_rows, final_eq=lambda x, p: x,
        # the cost as Gauss-Newton residuals r = (x, u) with weight W
        stage_residuals=lambda x, u, p: (torch.cat([x, u], -1), Wt),
        stage_quad=lambda x, u, p: x.new_zeros(x.shape[:-1]),
        stage_quad_derivs=lambda x, u, p: (x.new_zeros(x.shape[:-1] + (nx + nu,)),
                                           torch.zeros((nx + nu, nx + nu), dtype=x.dtype)),
        device=torch.device("cpu"), dtype=torch.float64,
    )
    jparams = {"stage": {"t": jnp.zeros(N)}, "final": {"t": jnp.zeros(())}}
    tparams = {"stage": {"t": torch.zeros(1, N, dtype=torch.float64)},
               "final": {"t": torch.zeros(1, dtype=torch.float64)}}
    return jocp, tocp, jparams, tparams, x0


def tsolve(tocp, cfg, tparams, x0):
    x = torch.as_tensor(x0)[None]
    return tal.solve(tocp, cfg, tparams, x, tzeros(tocp, x, **CPU64), **CPU64)


@pytest.mark.parametrize("backend", ["pscan", "pallas"])
def test_backend_matches_scan(backend):
    jocp, tocp, jparams, tparams, x0 = lq_problem()
    base = tal.ALConfig(iterations=3, backward="scan")
    sol_scan = tsolve(tocp, base, tparams, x0)
    sol_alt = tsolve(tocp, dataclasses.replace(base, backward=backend), tparams, x0)
    np.testing.assert_allclose(sol_alt.state.X, sol_scan.state.X, atol=1e-6)
    np.testing.assert_allclose(sol_alt.state.U, sol_scan.state.U, atol=1e-6)
    np.testing.assert_allclose(sol_alt.K, sol_scan.K, atol=1e-5)
    # and the port's solve against the JAX package's, same backend
    jcfg = jal.ALConfig(iterations=3, backward=backend, pallas_interpret=backend == "pallas")
    x = jnp.asarray(x0)
    jsol = jax.jit(lambda p, x_, s: jal.solve(jocp, jcfg, p, x_, s))(jparams, x, jzeros(jocp, x))
    if backend == "pallas":
        # the Pallas kernel forms its products in float32 (see
        # tests/test_torch_solve.py PALLAS_TOL): the JAX test's own limits
        tol = [dict(atol=1e-6), dict(atol=1e-6), dict(atol=1e-5)]
    else:
        tol = [dict(rtol=1e-8, atol=1e-8)] * 3
    np.testing.assert_allclose(sol_alt.state.X[0].numpy(), jsol.state.X, **tol[0])
    np.testing.assert_allclose(sol_alt.state.U[0].numpy(), jsol.state.U, **tol[1])
    np.testing.assert_allclose(sol_alt.K[0].numpy(), jsol.K, **tol[2])


def test_unknown_backward_is_refused():
    _, tocp, _, tparams, x0 = lq_problem(N=3)
    with pytest.raises(ValueError, match="pscan"):
        tsolve(tocp, tal.ALConfig(backward="assoc"), tparams, x0)


def test_plan_robust_parallel_scan_real(monkeypatch):
    """plan_robust(use_parallel_scan=True) must actually change the backward
    pass and produce the same long-horizon plan."""
    import upright_tpu_torch.config as tcfg
    from upright_tpu_torch.robust.planning import plan_robust

    config = tcfg.load_config(tcfg.resolve_package_path(
        {"package": "configs", "path": "demos/ur10_demo.yaml"}))
    calls = []
    for name in ("riccati_backward", "parallel_backward_pass"):
        real = getattr(tal, name)
        monkeypatch.setattr(tal, name, lambda *a, _f=real, _n=name, **kw: calls.append(_n)
                            or _f(*a, **kw))
    _, _, plan_seq = plan_robust(config, duration=4.0, iterations=10, **CPU64)
    assert calls == ["riccati_backward"] * 10
    _, _, plan_par = plan_robust(config, duration=4.0, iterations=10, use_parallel_scan=True,
                                 **CPU64)
    assert calls[10:] == ["parallel_backward_pass"] * 10
    assert plan_par.X.shape[0] == 41  # N = 40 long horizon
    np.testing.assert_allclose(plan_par.X, plan_seq.X, atol=1e-5)
    np.testing.assert_allclose(plan_par.U, plan_seq.U, atol=1e-5)
