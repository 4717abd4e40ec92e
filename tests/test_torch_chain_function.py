"""The rules of ``kinematics/chain.py``'s ``_Sweep``, the Function that
carries kernel K2 under ``torch.func``, on the CPU.

A chain whose ``kernel`` is ``PlainSweep`` takes the Function's route with K2's
interface in plain PyTorch (its Jacobian one ``torch.func.jvp`` per
direction), as the card takes it with the kernel.  So the Function's ``jvp``
(the solver's wide and blocked jacfwd), its ``backward`` (jacrev) and its
``vmap`` rule (the solver's vmap over points, jacfwd's over basis tangents)
are held here against today's plain chain: the stage and final derivatives
of thing_demo and full_bottle_point1 (the configurations of the benchmark's
two cells), each problem built once, float64, to 1e-10 of the largest entry.
And a second derivative through the Function raises.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import upright_tpu_torch.config as cfg
from upright_tpu_torch.kinematics.chain import PlainSweep
from upright_tpu_torch.ocp.problem import build_problem
from upright_tpu_torch.parallel.batch import broadcast_params
from upright_tpu_torch.solver import al

CONFIGS = {"thing_demo": "demos/thing_demo.yaml",
           "full_bottle_point1": "ral23/static_obstacles/full_bottle_point1.yaml"}
N = 2
B = 3
TOL = 1e-10

_cache = {}


def problem(name):
    if name not in _cache:
        conf = cfg.load_config(cfg.resolve_package_path({"package": "configs",
                                                         "path": CONFIGS[name]}))
        _cache[name] = build_problem(conf, N=N, device="cpu", dtype=torch.float64)
    return _cache[name]


def point(prob, seed=0):
    o = prob.ocp
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    x = t(prob.x0.numpy() + 0.05 * rng.standard_normal((B, N + 1, o.nx)))
    u = t(0.1 * rng.standard_normal((B, N, o.nu)))
    lam = t(rng.standard_normal((B, N, o.n_eq)))
    mu = t(np.abs(rng.standard_normal((B, N, o.n_ineq))))
    lam_f = t(rng.standard_normal((B, o.n_feq)))
    return x, u, lam, mu, lam_f


def through_the_function(prob, fn):
    """``fn()`` on the plain route and on the Function's route."""
    chain = prob.robot.chain
    plain = fn()
    chain.kernel = PlainSweep
    try:
        return plain, fn()
    finally:
        chain.kernel = None


def assert_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        assert float((g - w).abs().max()) <= TOL * max(1.0, float(w.abs().max()))


def modes(prob):
    nq, n_obs = prob.dims.robot_q, prob.dims.num_obstacles
    blocks = (nq,) * 3 + ((9 * n_obs,) if n_obs else ())
    return {"wide": dict(x_jac_blocks=None, jac_mode="fwd"),
            "blocked": dict(x_jac_blocks=blocks, jac_mode="fwd"),
            "rev": dict(x_jac_blocks=None, jac_mode="rev")}


@pytest.mark.parametrize("mode", ["wide", "blocked", "rev"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_derivatives_equal_the_plain_chains(name, mode):
    prob = problem(name)
    ocp = dataclasses.replace(prob.ocp, **modes(prob)[mode])
    x, u, lam, mu, _ = point(prob)
    p = broadcast_params(prob.stage_params(0.0), B)["stage"]
    plain, fn = through_the_function(
        prob, lambda: al._stage_derivatives(ocp, al.ALConfig(), x[:, :-1], u, p, lam, mu))
    assert_close(fn, plain)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_final_derivatives_equal_the_plain_chains(name):
    prob = problem(name)
    x, _, _, _, lam_f = point(prob, seed=1)
    p_f = broadcast_params(prob.stage_params(0.0), B)["final"]
    plain, fn = through_the_function(
        prob, lambda: al._final_derivatives(prob.ocp, al.ALConfig(), x[:, -1], p_f, lam_f))
    assert_close(fn, plain)


def test_a_second_derivative_raises():
    prob = problem("thing_demo")
    chain = prob.robot.chain
    x = point(prob)[0][0, 0, : 3 * chain.nq]
    nq = chain.nq

    def ee_p(x_):
        return chain.ee_motion(x_[:nq], x_[nq:2 * nq], x_[2 * nq:]).p

    chain.kernel = PlainSweep
    try:
        assert jacfwd(ee_p)(x).shape == (3, 3 * nq)  # once is fine
        for second in (jacfwd(jacfwd(ee_p)), jacrev(jacrev(ee_p)), jacfwd(jacrev(ee_p))):
            with pytest.raises(RuntimeError, match="first derivatives only"):
                second(x)
    finally:
        chain.kernel = None
