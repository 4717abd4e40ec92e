"""core/math, core/rigid_body and core/balance of the port against the JAX
package, pointwise in float64 on numpy-seeded inputs.  Both sides do the same
few float64 operations per output, so the tolerance is 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upright_tpu.core import balance as jbal
from upright_tpu.core import math as jmath
from upright_tpu.core import rigid_body as jrb
from upright_tpu_torch.core import balance as tbal
from upright_tpu_torch.core import math as tmath
from upright_tpu_torch.core import rigid_body as trb

TOL = dict(rtol=1e-12, atol=1e-12)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def random_rotation(rng):
    q = rng.standard_normal(4)
    return np.asarray(jmath.quat_to_rot(jnp.asarray(q)))


def rotation_near_branch(branch, rng):
    """A rotation for which rot_to_quat's largest pivot is ``branch``
    (0: w, 1: x, 2: y, 3: z)."""
    q = 0.15 * rng.standard_normal(4)
    q[[3, 0, 1, 2][branch]] = 1.0
    return np.asarray(jmath.quat_to_rot(jnp.asarray(q)))


def test_vector_ops_match():
    rng = np.random.default_rng(0)
    v, w, a = rng.standard_normal((3, 5, 3))
    C = np.stack([random_rotation(rng) for _ in range(5)])
    np.testing.assert_allclose(
        tmath.skew3(t64(v)).numpy(), jax.vmap(jmath.skew3)(jnp.asarray(v)), **TOL)
    np.testing.assert_allclose(
        tmath.dC_dtt(t64(C), t64(w), t64(a)).numpy(),
        jax.vmap(jmath.dC_dtt)(jnp.asarray(C), jnp.asarray(w), jnp.asarray(a)), **TOL)
    n = rng.standard_normal((5, 3))
    n[0] = [1.0, 0.01, 0.0]  # the |n_x| >= 0.9 branch
    np.testing.assert_allclose(
        tmath.plane_span(t64(n)).numpy(), jax.vmap(jmath.plane_span)(jnp.asarray(n)), **TOL)


def test_quaternion_ops_match():
    rng = np.random.default_rng(1)
    q0, q1 = rng.standard_normal((2, 6, 4))
    jq0, jq1 = jnp.asarray(q0), jnp.asarray(q1)
    np.testing.assert_allclose(
        tmath.quat_to_rot(t64(q0)).numpy(), jax.vmap(jmath.quat_to_rot)(jq0), **TOL)
    np.testing.assert_allclose(
        tmath.quat_multiply(t64(q0), t64(q1)).numpy(),
        jax.vmap(jmath.quat_multiply)(jq0, jq1), **TOL)
    np.testing.assert_allclose(
        tmath.orientation_error(t64(q0), t64(q1)).numpy(),
        jax.vmap(jmath.orientation_error)(jq0, jq1), **TOL)
    alpha = rng.uniform(size=6)
    q1[0] = q0[0]  # the tiny-angle (lerp) branch
    q1[1] = -q0[1] + 1e-3  # the long-way-around branch
    np.testing.assert_allclose(
        tmath.quat_slerp(t64(q0), t64(q1), t64(alpha)).numpy(),
        jax.vmap(jmath.quat_slerp)(jq0, jnp.asarray(q1), jnp.asarray(alpha)), **TOL)


@pytest.mark.parametrize("branch", [0, 1, 2, 3])
def test_rot_to_quat_matches_on_every_branch(branch):
    rng = np.random.default_rng(10 + branch)
    C = np.stack([rotation_near_branch(branch, rng) for _ in range(4)])
    d = np.einsum("bii->bi", C)
    pivots = np.stack([1 + d.sum(1), 1 + d[:, 0] - d[:, 1] - d[:, 2],
                       1 - d[:, 0] + d[:, 1] - d[:, 2], 1 - d[:, 0] - d[:, 1] + d[:, 2]], 1)
    assert (pivots.argmax(1) == branch).all()
    ref = jax.vmap(jmath.rot_to_quat)(jnp.asarray(C))
    np.testing.assert_allclose(tmath.rot_to_quat(t64(C)).numpy(), ref, **TOL)
    # and its Jacobian, through torch.func as the solver takes it
    J = torch.func.vmap(torch.func.jacfwd(tmath.rot_to_quat))(t64(C))
    J_ref = jax.vmap(jax.jacfwd(jmath.rot_to_quat))(jnp.asarray(C))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=1e-10, atol=1e-10)


def test_rigid_body_roundtrip_matches():
    rng = np.random.default_rng(2)
    mass = rng.uniform(0.1, 2.0, size=3)
    com = rng.standard_normal((3, 3))
    M = rng.standard_normal((3, 3, 3))
    inertia = M @ np.swapaxes(M, -1, -2)
    p = trb.body_to_params(t64(mass), t64(com), t64(inertia))
    p_ref = jax.vmap(jrb.body_to_params)(jnp.asarray(mass), jnp.asarray(com), jnp.asarray(inertia))
    np.testing.assert_allclose(p.numpy(), p_ref, **TOL)
    m2, c2, I2 = trb.params_to_body(p)
    np.testing.assert_allclose(m2.numpy(), mass, **TOL)
    np.testing.assert_allclose(c2.numpy(), com, **TOL)
    np.testing.assert_allclose(I2.numpy(), inertia, **TOL)


def random_model(rng, n_obj=2, n_c=5):
    mass = rng.uniform(0.1, 2.0, size=n_obj)
    com = 0.1 * rng.standard_normal((n_obj, 3))
    M = rng.standard_normal((n_obj, 3, 3))
    inertia = 0.01 * M @ np.swapaxes(M, -1, -2)
    params = np.asarray(jax.vmap(jrb.body_to_params)(
        jnp.asarray(mass), jnp.asarray(com), jnp.asarray(inertia)))
    normal = rng.standard_normal((n_c, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    span = np.asarray(jax.vmap(jmath.plane_span)(jnp.asarray(normal)))
    arrays = dict(
        params=params, mu=rng.uniform(0.1, 1.0, n_c), normal=normal, span=span,
        r1=0.1 * rng.standard_normal((n_c, 3)), r2=0.1 * rng.standard_normal((n_c, 3)),
        S1=(rng.uniform(size=(n_obj, n_c)) > 0.5).astype(float),
        S2=(rng.uniform(size=(n_obj, n_c)) > 0.7).astype(float),
    )
    jm = jbal.BalanceModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    from upright_tpu_torch.convert import balance_model_from_numpy
    tm = balance_model_from_numpy(arrays, device="cpu", dtype=torch.float64)
    return jm, tm


def test_balance_constraints_match():
    rng = np.random.default_rng(3)
    jm, tm = random_model(rng)
    n_c = 5
    forces = rng.standard_normal((4, n_c, 3))
    scal = rng.standard_normal((4, n_c))
    ee = dict(
        C_we=np.stack([random_rotation(rng) for _ in range(4)]),
        r_ew_w=rng.standard_normal((4, 3)), v_ew_w=rng.standard_normal((4, 3)),
        w_ew_w=rng.standard_normal((4, 3)), a_ew_w=rng.standard_normal((4, 3)),
        alpha_ew_w=rng.standard_normal((4, 3)),
    )
    g = np.array([0.0, 0.0, -9.81])
    jf = jnp.asarray(forces)

    np.testing.assert_allclose(
        tbal.expand_frictionless_forces(tm, t64(scal)).numpy(),
        jax.vmap(lambda s: jbal.expand_frictionless_forces(jm, s))(jnp.asarray(scal)), **TOL)
    np.testing.assert_allclose(
        tbal.contact_force_constraints_linearized(tm, t64(forces)).numpy(),
        jax.vmap(lambda f: jbal.contact_force_constraints_linearized(jm, f))(jf), **TOL)
    F, M = tbal.compute_object_wrenches(tm, t64(forces))
    F_ref, M_ref = jax.vmap(lambda f: jbal.compute_object_wrenches(jm, f))(jf)
    np.testing.assert_allclose(F.numpy(), F_ref, **TOL)
    np.testing.assert_allclose(M.numpy(), M_ref, **TOL)

    j_ee = jbal.EEState(**{k: jnp.asarray(v) for k, v in ee.items()})
    t_ee = tbal.EEState(**{k: t64(v) for k, v in ee.items()})
    for normalize in (True, False):
        ref = jax.vmap(
            lambda f, e: jbal.object_dynamics_constraints(jm, f, e, jnp.asarray(g), normalize)
        )(jf, j_ee)
        out = tbal.object_dynamics_constraints(tm, t64(forces), t_ee, t64(g), normalize)
        assert out.shape == (4, 12)
        # residuals are divided by masses down to 0.1: 1e-11 absolute
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-11)
