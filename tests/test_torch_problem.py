"""The port's problem assembly against the JAX package, field by field, for
the two demo problems (float64 on the CPU, numpy-seeded inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.ocp.reference import TargetTrajectory as JTarget
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu_torch.convert import params_from_numpy, solver_state_from_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild
from upright_tpu_torch.ocp.reference import TargetTrajectory as TTarget

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
DIMS = {  # nx, nu, n_eq, n_ineq, n_feq
    "ur10_demo": (18, 10, 6, 56, 15),
    "thing_demo": (27, 13, 6, 80, 21),
}


def demo_path(mod, name):
    return mod.resolve_package_path({"package": "configs", "path": f"demos/{name}.yaml"})


_cache = {}


def problems(name):
    if name not in _cache:
        jconf = jcfg.load_config(demo_path(jcfg, name))
        tconf = tcfg.load_config(demo_path(tcfg, name))
        _cache[name] = (jconf, tconf, jbuild(jconf, N=N), tbuild(tconf, N=N, **CPU64))
    return _cache[name]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list(DIMS))
def test_config_and_static_data_equal(name):
    jconf, tconf, jp, tp = problems(name)
    assert tconf == jconf
    assert tcfg.PACKAGE_PATHS["configs"] == jcfg.PACKAGE_PATHS["configs"]

    o = tp.ocp
    assert (o.nx, o.nu, o.n_eq, o.n_ineq, o.n_feq) == DIMS[name]
    jo = jp.ocp
    assert (jo.nx, jo.nu, jo.n_eq, jo.n_ineq, jo.n_feq) == DIMS[name]
    assert o.N == jo.N == N and o.linear_dynamics == jo.linear_dynamics
    assert tp.ineq_groups == jp.ineq_groups
    assert (o.ineq_box.n_pre, o.ineq_box.nx_box, o.ineq_box.nu_box) == (
        jo.ineq_box.n_pre, jo.ineq_box.nx_box, jo.ineq_box.nu_box)
    assert tp.dt == jp.dt and tp.heal_jump_threshold == jp.heal_jump_threshold

    # host-side numpy on both sides, assembled in float64: 1e-12
    tol = dict(rtol=1e-12, atol=1e-12)
    for f in ("params", "mu", "normal", "span", "r1", "r2", "S1", "S2"):
        np.testing.assert_allclose(
            getattr(tp.balance_model, f).numpy(), np.asarray(getattr(jp.balance_model, f)),
            err_msg=f, **tol)
    np.testing.assert_allclose(tp.force_scale, jp.force_scale, **tol)
    np.testing.assert_allclose(o.u_lb.numpy(), np.asarray(jo.u_lb), **tol)
    np.testing.assert_allclose(o.u_ub.numpy(), np.asarray(jo.u_ub), **tol)
    np.testing.assert_allclose(tp.x0.numpy(), np.asarray(jp.x0), **tol)
    np.testing.assert_allclose(tp.gravity.numpy(), np.asarray(jp.gravity), **tol)
    np.testing.assert_allclose(tp.target.times.numpy(), np.asarray(jp.target.times), **tol)
    np.testing.assert_allclose(tp.target.poses.numpy(), np.asarray(jp.target.poses), **tol)

    jparams, tparams = np_tree(jp.stage_params(0.3)), tp.stage_params(0.3)
    for part in ("stage", "final"):
        assert set(tparams[part]) == set(jparams[part])
        for k, v in jparams[part].items():
            assert tuple(tparams[part][k].shape) == v.shape, (part, k)
            np.testing.assert_allclose(tparams[part][k].numpy(), v, **tol)


@pytest.mark.parametrize("name", list(DIMS))
def test_stage_functions_equal(name):
    """Each stage function at random (x, u): a kinematic sweep and a handful
    of products in float64 on both sides, so 1e-10."""
    _, _, jp, tp = problems(name)
    jo, o = jp.ocp, tp.ocp
    rng = np.random.default_rng(0)
    M = 6
    x = np.asarray(jp.x0)[None] + 0.3 * rng.standard_normal((M, o.nx))
    u = rng.standard_normal((M, o.nu))
    jparams = jp.stage_params(0.0)
    jp0 = jax.tree.map(lambda v: v[0], jparams["stage"])
    tparams = params_from_numpy(np_tree(jparams), batch=M, **CPU64)
    tp0 = {k: v[:, 0] for k, v in tparams["stage"].items()}
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)
    tol = dict(rtol=1e-10, atol=1e-10)

    def jv(fn):
        return jax.vmap(lambda a, b: fn(a, b, jp0))(jx, ju)

    np.testing.assert_allclose(o.dynamics(tx, tu, tp0).numpy(), jv(jo.dynamics), **tol)
    np.testing.assert_allclose(o.eq(tx, tu, tp0).numpy(), jv(jo.eq), **tol)
    np.testing.assert_allclose(o.ineq(tx, tu, tp0).numpy(), jv(jo.ineq), **tol)
    assert o.ineq_smooth(tx, tu, tp0).shape == jv(jo.ineq_smooth).shape == (M, 0)
    np.testing.assert_allclose(o.stage_cost(tx, tu, tp0).numpy(), jv(jo.stage_cost), **tol)
    np.testing.assert_allclose(o.stage_quad(tx, tu, tp0).numpy(), jv(jo.stage_quad), **tol)
    r, W = o.stage_residuals(tx, tu, tp0)
    r_ref, W_ref = jv(jo.stage_residuals)
    np.testing.assert_allclose(r.numpy(), r_ref, **tol)
    np.testing.assert_allclose(W.numpy(), W_ref[0], **tol)
    g, H = o.stage_quad_derivs(tx, tu, tp0)
    g_ref, H_ref = jv(jo.stage_quad_derivs)
    np.testing.assert_allclose(g.numpy(), g_ref, **tol)
    np.testing.assert_allclose(H.numpy(), H_ref[0], **tol)
    feq_ref = jax.vmap(lambda a: jo.final_eq(a, jparams["final"]))(jx)
    np.testing.assert_allclose(o.final_eq(tx, tparams["final"]).numpy(), feq_ref, **tol)


def random_state(rng, o, B):
    return dict(
        X=rng.standard_normal((B, o.N + 1, o.nx)), U=rng.standard_normal((B, o.N, o.nu)),
        lam=rng.standard_normal((B, o.N, o.n_eq)), mu=rng.uniform(size=(B, o.N, o.n_ineq)),
        lam_f=rng.standard_normal((B, o.n_feq)),
    )


@pytest.mark.parametrize("shift", [0.0, 0.4, 1.0, 2.7, 9.0])
def test_shift_warm_start_equal(shift):
    """Gather + linear interpolation of the same rows: 1e-13."""
    _, _, jp, tp = problems("ur10_demo")
    arrays = random_state(np.random.default_rng(1), tp.ocp, 3)
    out = tp.shift_warm_start(solver_state_from_numpy(arrays, **CPU64), shift)
    for b in range(3):
        ref = jp.shift_warm_start(
            JState(**{k: jnp.asarray(v[b]) for k, v in arrays.items()}), shift)
        for f in ("X", "U", "lam", "mu", "lam_f"):
            np.testing.assert_allclose(
                getattr(out, f)[b].numpy(), getattr(ref, f), rtol=1e-13, atol=1e-13, err_msg=f)


def test_heal_warm_start_both_sides_of_threshold():
    """Instance 0 jumps in position by less than the threshold (plan kept),
    instance 1 by more (re-rolled), instance 2 only in velocity (kept)."""
    _, _, jp, tp = problems("ur10_demo")
    o = tp.ocp
    rng = np.random.default_rng(2)
    arrays = random_state(rng, o, 3)
    arrays["U"] *= 0.1
    x0 = arrays["X"][:, 0].copy()
    dq = rng.standard_normal(6)
    dq /= np.linalg.norm(dq)
    x0[0, :6] += 0.19 * dq
    x0[1, :6] += 0.21 * dq
    x0[2, 6:12] += 5.0
    out = tp.heal_warm_start(solver_state_from_numpy(arrays, **CPU64), torch.as_tensor(x0))
    kept = []
    for b in range(3):
        ref = jp.heal_warm_start(
            JState(**{k: jnp.asarray(v[b]) for k, v in arrays.items()}), jnp.asarray(x0[b]))
        np.testing.assert_allclose(out.X[b].numpy(), ref.X, rtol=1e-12, atol=1e-12)
        kept.append(bool(np.array_equal(out.X[b].numpy(), arrays["X"][b])))
    assert kept == [True, False, True]


def test_multi_waypoint_interpolation_equal():
    """The port writes the segment search as a comparison sum; hold it against
    the reference's searchsorted, before, inside, at and after the knots."""
    rng = np.random.default_rng(4)
    times = np.array([0.0, 1.0, 1.0, 2.5])
    poses = rng.standard_normal((4, 8))
    poses[:, 7] = [0.0, 1.0, 1.0, 0.0]
    jt = JTarget(times=jnp.asarray(times), poses=jnp.asarray(poses))
    tt = TTarget(times=torch.as_tensor(times), poses=torch.as_tensor(poses))
    ts = np.array([-0.5, 0.0, 0.3, 1.0, 1.7, 2.5, 4.0])
    r, q, s = tt.interpolate(torch.as_tensor(ts))
    r_ref, q_ref, s_ref = jax.vmap(jt.interpolate)(jnp.asarray(ts))
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=0)
    # differentiable and vmappable, as the solver needs it
    J = torch.func.vmap(torch.func.jacfwd(lambda t: tt.interpolate(t)[0]))(torch.as_tensor(ts))
    assert torch.isfinite(J).all()


@pytest.mark.parametrize(
    "name,key",
    [("thing_obstacle_demo", "obstacles"), ("ur10_friction_demo", "frictionless")],
)
def test_unported_feature_raises(name, key):
    conf = tcfg.load_config(demo_path(tcfg, name))
    with pytest.raises(NotImplementedError, match=key):
        tbuild(conf, N=N, **CPU64)
