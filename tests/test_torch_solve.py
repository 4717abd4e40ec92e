"""The ported main path as a whole: the port's batch-first AL-SQP solve against the JAX
package's vmapped solve, from the same numpy-made state, in float64 on the
CPU (where the port's Riccati wrapper runs its plain version).

Tolerance 1e-8: both sides run the same algorithm in float64; the orders of
summation differ (batched products, column-wise Cholesky), and the Riccati
recursion and the chained re-solves amplify the 1e-16 differences.  The
accept/reject decisions of the line search must agree exactly.
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
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu.solver.ocp import zeros_warm_start as jzeros
from upright_tpu_torch.convert import (
    params_from_numpy,
    solver_state_from_numpy,
    solver_state_to_numpy,
)
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.parallel.batch import (
    batch_solve_fn,
    batch_warm_starts,
    broadcast_params,
)
from upright_tpu_torch.solver import al as tal
from upright_tpu_torch.solver.riccati import riccati_backward_plain

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TOL = dict(rtol=1e-8, atol=1e-8)
LS = (1.0, 0.5)
STATE_FIELDS = ("X", "U", "lam", "mu", "lam_f")

_cache = {}


def problems(name):
    if name not in _cache:
        path = {"package": "configs", "path": f"demos/{name}.yaml"}
        jp = jbuild(jcfg.load_config(jcfg.resolve_package_path(path)), N=N)
        tp = tbuild(tcfg.load_config(tcfg.resolve_package_path(path)), N=N, **CPU64)
        _cache[name] = (jp, tp)
    return _cache[name]


def perturbed_x0(jp, batch, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(jp.x0)[None, :] + 0.01 * rng.standard_normal((batch, jp.ocp.nx))


def jax_batch_solver(jp, **cfg_kw):
    cfg = jal.ALConfig(rho_eq=10.0, rho_ineq=10.0, line_search_steps=LS, **cfg_kw)
    return jax.jit(jax.vmap(lambda p, x, s: jal.solve(jp.ocp, cfg, p, x, s)))


def np_state(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in STATE_FIELDS}


def assert_solution_equal(tsol, jsol, label="", tol=TOL):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(tsol.state, f).numpy(), getattr(jsol.state, f),
            err_msg=f"{label} {f}", **tol)
    for f in ("K", "cost", "eq_viol", "ineq_viol", "defect"):
        np.testing.assert_allclose(
            getattr(tsol, f).numpy(), getattr(jsol, f), err_msg=f"{label} {f}", **tol)
    # defect is a structural zero exactly when the step was accepted
    np.testing.assert_array_equal(
        tsol.defect.numpy() == 0.0, np.asarray(jsol.defect) == 0.0,
        err_msg=f"{label} accept/reject")


def run_both(name, batch, resolves, tol=TOL, **cfg_kw):
    """Cold solve then ``resolves`` chained warm re-solves on both sides,
    comparing after every solve.  Returns the last pair of solutions."""
    jp, tp = problems(name)
    x0 = perturbed_x0(jp, batch)
    jparams = jp.stage_params(0.0)
    jparams_b = jax.tree.map(
        lambda v: jnp.broadcast_to(v, (batch,) + jnp.shape(v)), jparams)
    jstate = jax.vmap(lambda x: jzeros(jp.ocp, x))(jnp.asarray(x0))
    jsolve = jax_batch_solver(jp, **cfg_kw)

    tcfg_kw = {k: v for k, v in cfg_kw.items()
               if k not in ("backward", "pallas_interpret", "pallas_block")}
    cfg = tal.ALConfig(rho_eq=10.0, rho_ineq=10.0, line_search_steps=LS, **tcfg_kw)
    tsolve = batch_solve_fn(tp.ocp, cfg, **CPU64)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), batch=batch, **CPU64)
    tstate = solver_state_from_numpy(np_state(jstate), **CPU64)
    tx0 = torch.as_tensor(x0)

    accepted = []
    for i in range(1 + resolves):
        jsol = jsolve(jparams_b, jnp.asarray(x0), jstate)
        tsol = tsolve(tparams, tx0, tstate)
        assert_solution_equal(tsol, jsol, label=f"{name} solve {i}", tol=tol)
        accepted.append(np.asarray(jsol.defect) == 0.0)
        jstate, tstate = jsol.state, tsol.state
    return tsol, jsol, np.stack(accepted)


# The Pallas kernel forms its products with preferred_element_type=float32
# whatever the input type, so the JAX package's own pallas route departs from
# its scan route at float32 level (tests/test_backward_options.py holds the two
# to 1e-6 on X, U and 1e-5 on K).  The port is held to the pallas route at
# PALLAS_TOL; the accept/reject decisions must still agree exactly.
PALLAS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "backward_kw,tol",
    [(dict(backward="scan"), TOL),
     (dict(backward="pallas", pallas_interpret=True), PALLAS_TOL)],
    ids=["jax-scan", "jax-pallas-interpret"],
)
def test_ur10_solve_matches_jax(backward_kw, tol):
    tsol, _, accepted = run_both(
        "ur10_demo", batch=3, resolves=3, tol=tol, iterations=1, **backward_kw)
    assert accepted.any(), "no step was ever accepted: the comparison would be vacuous"
    assert torch.isfinite(tsol.K).all()


def test_thing_solve_matches_jax():
    tsol, _, accepted = run_both("thing_demo", batch=2, resolves=0, iterations=1)
    assert accepted.all()
    assert tsol.K.shape == (2, N, 13, 27)


def test_dual_safeguards_match_jax():
    """Two iterations per solve with the damped, every-other-iteration dual
    update and the divergence watchdog (which fires on the warm re-solve:
    eq_viol stays above the 0.1 threshold on this short horizon)."""
    run_both("ur10_demo", batch=2, resolves=1, iterations=2, dual_update_every=2,
             dual_step=0.5, dual_reset_violation=0.1)


def test_stage_derivatives_match_jax():
    """Gradient and GN Hessian of the AL stage cost at one stage: one jacfwd
    through the chain plus J^T J products, 1e-9."""
    jp, tp = problems("ur10_demo")
    o = tp.ocp
    rng = np.random.default_rng(5)
    x = np.asarray(jp.x0) + 0.2 * rng.standard_normal(o.nx)
    x[12:] = 9.9 + 0.2 * rng.uniform(size=6)  # some state-limit rows active
    u = rng.standard_normal(o.nu)
    u[6:] = -0.1  # force lower bounds active
    lam = rng.standard_normal(o.n_eq)
    mu = rng.uniform(size=o.n_ineq)
    jparams = jp.stage_params(0.0)
    jp0 = jax.tree.map(lambda v: v[0], jparams["stage"])
    cfg_kw = dict(rho_eq=10.0, rho_ineq=7.0)
    g_ref, H_ref = jal._stage_derivatives(
        jp.ocp, jal.ALConfig(**cfg_kw), jnp.asarray(x), jnp.asarray(u), jp0,
        jnp.asarray(lam), jnp.asarray(mu))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), batch=1, **CPU64)
    tp0 = {k: v[:, 0] for k, v in tparams["stage"].items()}
    g, H = tal._stage_derivatives(
        o, tal.ALConfig(**cfg_kw), torch.as_tensor(x)[None], torch.as_tensor(u)[None],
        tp0, torch.as_tensor(lam)[None], torch.as_tensor(mu)[None])
    assert g.shape == (1, o.nx + o.nu) and H.shape == (1, o.nx + o.nu, o.nx + o.nu)
    np.testing.assert_allclose(g[0].numpy(), g_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(H[0].numpy(), H_ref, rtol=1e-9, atol=1e-9)


def test_replan_step_matches_jax():
    """shift -> heal -> solve -> u = U[0] + K[0](x - X[0]), from a warm state
    both sides share, with a fractional shift and a drifted observation."""
    jp, tp = problems("ur10_demo")
    tsol, jsol, _ = run_both("ur10_demo", batch=1, resolves=0, iterations=1)
    rng = np.random.default_rng(6)
    x_obs = np.asarray(jsol.state.X[0, 0]) + 1e-3 * rng.standard_normal(jp.ocp.nx)
    shift = 0.35
    jparams = jp.stage_params(0.0)
    jcfg_ = jal.ALConfig(iterations=1, line_search_steps=LS)

    def jreplan(p, x, st):
        warm = jp.heal_warm_start(jp.shift_warm_start(st, shift), x)
        s = jal.solve(jp.ocp, jcfg_, p, x, warm)
        return s, s.state.U[0] + s.K[0] @ (x - s.state.X[0])

    js0 = JState(**{f: jnp.asarray(np.asarray(getattr(jsol.state, f))[0]) for f in STATE_FIELDS})
    js, ju = jax.jit(jreplan)(jparams, jnp.asarray(x_obs), js0)

    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), batch=1, **CPU64)
    tx = torch.as_tensor(x_obs)[None]
    warm = tp.heal_warm_start(tp.shift_warm_start(tsol.state, shift), tx)
    ts = tal.solve(tp.ocp, tal.ALConfig(iterations=1, line_search_steps=LS),
                   tparams, tx, warm, **CPU64)
    tu = ts.state.U[:, 0] + (ts.K[:, 0] @ (tx - ts.state.X[:, 0]).unsqueeze(-1)).squeeze(-1)
    np.testing.assert_allclose(tu[0].numpy(), ju, **TOL)
    np.testing.assert_allclose(ts.state.X[0].numpy(), js.state.X, **TOL)
    np.testing.assert_allclose(ts.state.lam[0].numpy(), js.state.lam, **TOL)


def port_solve(tp, x0, backward=None, iterations=2):
    cfg = tal.ALConfig(iterations=iterations, line_search_steps=LS)
    B = x0.shape[0]
    params = broadcast_params(tp.stage_params(0.0), B)
    state = batch_warm_starts(tp.ocp, x0, **CPU64)
    return tal.solve(tp.ocp, cfg, params, torch.as_tensor(x0), state,
                     backward=backward, **CPU64)


def test_batched_equals_per_instance():
    """Instances do not see each other: a batch of 3 equals three B = 1
    solves (identical operations per instance up to the batched products'
    summation order: 1e-12)."""
    jp, tp = problems("ur10_demo")
    x0 = perturbed_x0(jp, 3, seed=7)
    full = port_solve(tp, x0)
    for b in range(3):
        one = port_solve(tp, x0[b : b + 1])
        for f in STATE_FIELDS:
            np.testing.assert_allclose(
                getattr(one.state, f)[0].numpy(), getattr(full.state, f)[b].numpy(),
                rtol=1e-12, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(one.K[0].numpy(), full.K[b].numpy(), rtol=1e-12, atol=1e-12)


def test_per_stage_dynamics_path_equals_stage_invariant():
    """With sqp.linear_dynamics off the solver linearizes every stage and
    feeds the backward pass form (a); the dynamics are exactly linear, so the
    result equals the stage-invariant form (b)."""
    jp, tp = problems("ur10_demo")
    path = {"package": "configs", "path": "demos/ur10_demo.yaml"}
    conf = tcfg.load_config(tcfg.resolve_package_path(path))
    conf["controller"]["sqp"]["linear_dynamics"] = False
    tp_a = tbuild(conf, N=N, **CPU64)
    assert tp.ocp.linear_dynamics and not tp_a.ocp.linear_dynamics
    x0 = perturbed_x0(jp, 2, seed=8)
    seen = []

    def spy(A, B, *rest, **kw):
        seen.append(A.ndim)
        return riccati_backward_plain(A, B, *rest, **kw)

    sol_b = port_solve(tp, x0, backward=spy, iterations=1)
    sol_a = port_solve(tp_a, x0, backward=spy, iterations=1)
    assert seen == [2, 4]
    np.testing.assert_allclose(sol_a.state.X.numpy(), sol_b.state.X.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sol_a.K.numpy(), sol_b.K.numpy(), rtol=1e-12, atol=1e-12)


def test_state_roundtrip_through_convert():
    jp, tp = problems("ur10_demo")
    state = batch_warm_starts(tp.ocp, perturbed_x0(jp, 2), **CPU64)
    back = solver_state_from_numpy(solver_state_to_numpy(state), **CPU64)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f))


def test_float32_solve_stays_float32_and_tracks_float64():
    """The card runs float32.  Every tensor of a float32 solve stays float32
    (a Python number combined with a 0-dim tensor under jacfwd would promote
    the Jacobians), and the result tracks the float64 solve at float32
    level: 2e-3 on trajectories that are O(1)."""
    jp, tp = problems("thing_demo")
    path = {"package": "configs", "path": "demos/thing_demo.yaml"}
    conf = tcfg.load_config(tcfg.resolve_package_path(path))
    tp32 = tbuild(conf, N=N, device="cpu", dtype=torch.float32)
    x0 = perturbed_x0(jp, 2, seed=9)
    sol64 = port_solve(tp, x0, iterations=1)
    cfg = tal.ALConfig(iterations=1, line_search_steps=LS)
    x32 = torch.as_tensor(x0, dtype=torch.float32)
    seen = {}

    def spy(*args, **kw):
        seen["dtypes"] = {a.dtype for a in args}
        return riccati_backward_plain(*args, **kw)

    sol32 = tal.solve(
        tp32.ocp, cfg, broadcast_params(tp32.stage_params(0.0), 2), x32,
        batch_warm_starts(tp32.ocp, x32, device="cpu", dtype=torch.float32),
        device="cpu", dtype=torch.float32, backward=spy)
    assert seen["dtypes"] == {torch.float32}
    for f in STATE_FIELDS:
        assert getattr(sol32.state, f).dtype == torch.float32, f
    assert sol32.K.dtype == torch.float32 and sol32.cost.dtype == torch.float32
    np.testing.assert_allclose(sol32.state.X.numpy(), sol64.state.X.numpy(), atol=2e-3, rtol=0)
    np.testing.assert_allclose(sol32.state.U.numpy(), sol64.state.U.numpy(), atol=2e-2, rtol=0)
    np.testing.assert_array_equal(sol32.defect.numpy() == 0, sol64.defect.numpy() == 0)
