"""The solver's stage linearization in its three Jacobian modes (one wide
jacfwd, one jacfwd per block of x-columns, one jacrev) against the JAX
package's ``_stage_derivatives`` in float64 on the CPU, on the four cases of
tests/test_stage_derivatives.py; and float32 solves in each mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver import al as jal
from upright_tpu_torch.convert import params_from_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.parallel.batch import batch_warm_starts, broadcast_params
from upright_tpu_torch.solver import al as tal
from upright_tpu_torch.solver.riccati import riccati_backward_plain

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
LS = (1.0, 0.5)
STATE_FIELDS = ("X", "U", "lam", "mu", "lam_f")


def load(path, frictional=False):
    spec = {"package": "configs", "path": path}
    jconf = jcfg.load_config(jcfg.resolve_package_path(spec))
    tconf = tcfg.load_config(tcfg.resolve_package_path(spec))
    if frictional:
        for c in (jconf, tconf):
            c["controller"]["balancing"]["frictionless"] = False
    return jbuild(jconf, N=N), tbuild(tconf, N=N, **CPU64)


# the four cases of tests/test_stage_derivatives.py, and a problem without
# objects or equality rows (alignment cone, collision rows)
DERIV_CASES = {
    "ur10": ("demos/ur10_demo.yaml", False),
    "thing": ("demos/thing_demo.yaml", False),
    "thing_obstacles": ("demos/thing_obstacle_demo.yaml", False),
    "frictional": ("demos/thing_demo.yaml", True),
    "aligned": ("ral23/static_obstacles/aligned_bottle_point1.yaml", False),
}
MODES = {
    "wide": dict(x_jac_blocks=None, jac_mode="fwd"),
    "blocked": {},  # the CPU default: x_jac_blocks = (nq, nq, nq[, 9 n_obs])
    "rev": dict(x_jac_blocks=None, jac_mode="rev"),
}

_cache = {}


def problems(key, path, frictional=False):
    if key not in _cache:
        _cache[key] = load(path, frictional)
    return _cache[key]


DERIV_CFG = dict(rho_eq=10.0, rho_ineq=10.0)


def reference_derivatives(case):
    """(point, JAX gradient, JAX Hessian) of one case, at the point
    tests/test_stage_derivatives.py takes (stage 3, x0 + 0.05 noise)."""
    key = ("derivatives", case)
    if key not in _cache:
        jp, tp = problems(case, *DERIV_CASES[case])
        o = tp.ocp
        rng = np.random.default_rng(0)
        x = np.asarray(jp.x0) + 0.05 * rng.standard_normal(o.nx)
        u = 0.1 * rng.standard_normal(o.nu)
        lam = rng.standard_normal(o.n_eq)
        mu = np.abs(rng.standard_normal(o.n_ineq))
        jp3 = jax.tree.map(lambda v: v[3], jp.stage_params(0.0)["stage"])
        g_ref, H_ref = jal._stage_derivatives(
            jp.ocp, jal.ALConfig(**DERIV_CFG), jnp.asarray(x), jnp.asarray(u), jp3,
            jnp.asarray(lam), jnp.asarray(mu))
        _cache[key] = ((x, u, lam, mu), np.asarray(g_ref), np.asarray(H_ref))
    return _cache[key]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(DERIV_CASES))
def test_stage_derivatives_match_reference(case, mode):
    """One stage's AL gradient and GN Hessian, the port in each Jacobian
    mode against the JAX package's ``_stage_derivatives`` (its CPU default,
    the column blocks): 1e-9."""
    jp, tp = problems(case, *DERIV_CASES[case])
    o = dataclasses.replace(tp.ocp, **MODES[mode])
    if mode == "blocked":
        assert o.x_jac_blocks is not None and o.x_jac_blocks == jp.ocp.x_jac_blocks
    (x, u, lam, mu), g_ref, H_ref = reference_derivatives(case)
    cfg_kw = DERIV_CFG
    jparams = jp.stage_params(0.0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), batch=1, **CPU64)
    tp3 = {k: v[:, 3] for k, v in tparams["stage"].items()}
    g, H = tal._stage_derivatives(
        o, tal.ALConfig(**cfg_kw), torch.as_tensor(x)[None], torch.as_tensor(u)[None], tp3,
        torch.as_tensor(lam)[None], torch.as_tensor(mu)[None])
    np.testing.assert_allclose(g[0].numpy(), g_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(H[0].numpy(), H_ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode", list(MODES))
def test_float32_solve_stays_float32(mode):
    """The card runs float32: on a problem with an obstacle in x, collision
    and projectile rows, every Jacobian mode keeps every tensor of a float32
    solve float32 (a Python number meeting a 0-dim tensor under jacfwd
    would promote the tangents), and tracks the float64 solve."""
    spec = {"package": "configs", "path": "demos/thing_projectile_demo.yaml"}
    conf = tcfg.load_config(tcfg.resolve_package_path(spec))
    conf["controller"]["waypoints"][0]["projectile_flag"] = 1.0  # projectile rows live
    results = {}
    for dtype in (torch.float32, torch.float64):
        tp = tbuild(conf, N=N, device="cpu", dtype=dtype)
        ocp = dataclasses.replace(tp.ocp, **MODES[mode])
        x0 = tp.x0.expand(2, -1).clone()
        x0[1, :9] += 0.01
        seen = {}

        def spy(*args, **kw):
            seen["dtypes"] = {a.dtype for a in args}
            return riccati_backward_plain(*args, **kw)

        sol = tal.solve(ocp, tal.ALConfig(iterations=1, line_search_steps=LS),
                        broadcast_params(tp.stage_params(0.0), 2), x0,
                        batch_warm_starts(ocp, x0, device="cpu", dtype=dtype),
                        device="cpu", dtype=dtype, backward=spy)
        assert seen["dtypes"] == {dtype}
        for f in STATE_FIELDS:
            assert getattr(sol.state, f).dtype == dtype, f
        results[dtype] = sol
    s32, s64 = results[torch.float32], results[torch.float64]
    np.testing.assert_allclose(s32.state.X.numpy(), s64.state.X.numpy(), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(s32.defect.numpy() == 0, s64.defect.numpy() == 0)
