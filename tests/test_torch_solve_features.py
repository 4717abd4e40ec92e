"""Whole solves on the problems beyond the two demos (frictional cones,
collision rows, a wide input block of nu = 33) against the JAX package's
vmapped solve in float64 on the CPU, where the port's Riccati wrapper runs
its plain version.  Tolerance as in tests/test_torch_solve.py: 1e-8,
identical accept/reject.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver import al as jal
from upright_tpu.solver.ocp import zeros_warm_start as jzeros
from upright_tpu_torch.convert import params_from_numpy, solver_state_from_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.parallel.batch import batch_solve_fn
from upright_tpu_torch.solver import al as tal

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TOL = dict(rtol=1e-8, atol=1e-8)
LS = (1.0, 0.5)
STATE_FIELDS = ("X", "U", "lam", "mu", "lam_f")


def load(path):
    spec = {"package": "configs", "path": path}
    jconf = jcfg.load_config(jcfg.resolve_package_path(spec))
    tconf = tcfg.load_config(tcfg.resolve_package_path(spec))
    return jbuild(jconf, N=N), tbuild(tconf, N=N, **CPU64)


_cache = {}


def problems(name, path):
    if name not in _cache:
        _cache[name] = load(path)
    return _cache[name]


LS_FULL = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003, 0.001)
SOLVE_CASES = {
    # name: (config, batch, warm re-solves, line-search steps).  From the
    # cold start of full_bottle_point1 neither of the steps 1 and 0.5 is
    # accepted, so it takes the controller's full ladder
    "full_bottle_point1": ("ral23/static_obstacles/full_bottle_point1.yaml", 2, 2, LS_FULL),
    "ur10_friction_demo": ("demos/ur10_friction_demo.yaml", 2, 2, LS),
    # nu = 33: the plain version of the jittered route (c)
    "full_dice_point1": ("ral23/freespace/full_dice_point1.yaml", 1, 0, LS),
}


@pytest.mark.parametrize("name", list(SOLVE_CASES))
def test_solve_matches_reference(name):
    """A cold iteration and chained warm re-solves, batched on the port and
    vmapped on the JAX side, from the same perturbed x0: X, U, K, the
    multipliers and the diagnostics to 1e-8, identical accept/reject."""
    path, batch, resolves, steps = SOLVE_CASES[name]
    jp, tp = problems(name, path)
    rng = np.random.default_rng(0)
    x0 = np.asarray(jp.x0)[None, :] + 0.01 * rng.standard_normal((batch, jp.ocp.nx))
    jparams = jp.stage_params(0.0)
    jparams_b = jax.tree.map(lambda v: jnp.broadcast_to(v, (batch,) + jnp.shape(v)), jparams)
    jstate = jax.vmap(lambda x: jzeros(jp.ocp, x))(jnp.asarray(x0))
    jcfg_ = jal.ALConfig(iterations=1, rho_eq=10.0, rho_ineq=10.0, line_search_steps=steps)
    jsolve = jax.jit(jax.vmap(lambda p, x, s: jal.solve(jp.ocp, jcfg_, p, x, s)))
    tcfg_ = tal.ALConfig(iterations=1, rho_eq=10.0, rho_ineq=10.0, line_search_steps=steps)
    tsolve = batch_solve_fn(tp.ocp, tcfg_, **CPU64)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), batch=batch, **CPU64)
    tstate = solver_state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}, **CPU64)
    tx0 = torch.as_tensor(x0)
    accepted = []
    for i in range(1 + resolves):
        jsol = jsolve(jparams_b, jnp.asarray(x0), jstate)
        tsol = tsolve(tparams, tx0, tstate)
        for f in STATE_FIELDS:
            np.testing.assert_allclose(getattr(tsol.state, f).numpy(),
                                       np.asarray(getattr(jsol.state, f)),
                                       err_msg=f"{name} solve {i} {f}", **TOL)
        for f in ("K", "cost", "eq_viol", "ineq_viol", "defect"):
            np.testing.assert_allclose(getattr(tsol, f).numpy(), np.asarray(getattr(jsol, f)),
                                       err_msg=f"{name} solve {i} {f}", **TOL)
        np.testing.assert_array_equal(tsol.defect.numpy() == 0.0,
                                      np.asarray(jsol.defect) == 0.0,
                                      err_msg=f"{name} solve {i} accept/reject")
        accepted.append(np.asarray(jsol.defect) == 0.0)
        jstate, tstate = jsol.state, tsol.state
    assert np.stack(accepted).any(), "no step was ever accepted: the comparison would be vacuous"
    assert torch.isfinite(tsol.K).all()
