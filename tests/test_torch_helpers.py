"""The port's last public helpers against the JAX package, float64 on the CPU:

- ``contact_force_constraints_exact``: the exact-cone rows of
  ``tests/test_balance.py::test_friction_cone_values``, and a batch of random
  forces on a parsed arrangement against the JAX function under ``jax.vmap``;
- ``BalanceModel.with_params``: ``test_vmap_over_scenarios`` built through it
  (scaled masses, residuals zero), and random per-scenario parameters with
  two batch axes, parameters and Newton-Euler residuals against the JAX
  model's;
- ``KinematicChain.frame_motion`` for every joint frame of the Thing and UR10
  chains, batched and unbatched (a frame before the first actuated joint
  too);
- ``EEState.zero`` and ``ocp.problem.CollisionSphere``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.core import balance as jbal
from upright_tpu.kinematics.robot import build_robot_model as jbuild
from upright_tpu.ocp import problem as jproblem
from upright_tpu_torch.config.arrangement import parse_control_objects as tparse
from upright_tpu_torch.core import balance as tbal
from upright_tpu_torch.kinematics.robot import build_robot_model as tbuild
from upright_tpu_torch.ocp import problem as tproblem

TOL = dict(rtol=1e-12, atol=1e-12)
GRAVITY = np.array([0.0, 0.0, -9.81])
EE_FIELDS = ("C_we", "r_ew_w", "v_ew_w", "w_ew_w", "a_ew_w", "alpha_ew_w")
MOTION_FIELDS = ("R", "p", "v", "w", "a", "al")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def arrangement_conf(arrangement):
    path = jcfg.resolve_package_path({"package": "configs", "path": "arrangements.yaml"})
    conf = jcfg.load_config(path)
    conf["balancing"] = {"arrangement": arrangement, "frictionless": False}
    return conf


def models(arrangement):
    conf = arrangement_conf(arrangement)
    jm = jcfg.parse_control_objects(conf)[0]
    tm = tparse(conf, device="cpu", dtype=torch.float64)[0]
    return jm, tm


def test_exact_cone_values():
    """``test_friction_cone_values``' hand-built contact through both."""
    arrays = dict(
        params=np.ones((1, 10)), mu=np.array([0.5]), normal=np.array([[0.0, 0.0, 1.0]]),
        span=np.array([[[1.0, 0, 0], [0, 1.0, 0]]]), r1=np.zeros((1, 3)), r2=np.zeros((1, 3)),
        S1=np.zeros((1, 1)), S2=np.ones((1, 1)),
    )
    jm = jbal.BalanceModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = tbal.BalanceModel(**{k: t64(v) for k, v in arrays.items()})
    f = np.array([[0.3, -0.1, 2.0]])
    out = tbal.contact_force_constraints_exact(tm, t64(f))
    assert out.shape == (tbal.NUM_FRICTION_CONSTRAINTS_PER_CONTACT,)
    np.testing.assert_allclose(out.numpy(), [2.0, 0.5**2 * 4 - (0.3**2 + 0.01)], **TOL)
    np.testing.assert_allclose(
        out.numpy(), jbal.contact_force_constraints_exact(jm, jnp.asarray(f)), **TOL)


def test_exact_cone_matches_batched():
    """Forces with two batch axes on blue_cups (frictional contacts, rows
    interleaved per contact) against the JAX function under ``jax.vmap``."""
    jm, tm = models("blue_cups")
    n_c = tm.num_contacts
    rng = np.random.default_rng(4)
    forces = rng.standard_normal((2, 3, n_c, 3))
    out = tbal.contact_force_constraints_exact(tm, t64(forces))
    ref = jax.jit(jax.vmap(lambda f: jbal.contact_force_constraints_exact(jm, f)))(
        jnp.asarray(forces.reshape(6, n_c, 3))).reshape(2, 3, -1)
    assert out.shape == ref.shape == (2, 3, 2 * n_c)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_with_params_scenarios_balance():
    """``test_vmap_over_scenarios`` through ``with_params``: scaled masses on
    pink_bottle hold the equilibrium in every scenario, as in the JAX model."""
    conf = arrangement_conf("pink_bottle")
    conf["balancing"]["frictionless"] = True
    jm = jcfg.parse_control_objects(conf)[0]
    tm = tparse(conf, device="cpu", dtype=torch.float64)[0]
    base = np.asarray(jm.params)[0]
    scales = np.array([0.5, 1.0, 2.0])
    masses = (base[0] * scales)[:, None]  # (3, 1)
    coms = np.broadcast_to(base[1:4] / base[0], (3, 1, 3)).copy()
    inertias = np.stack([jbal.params_to_body(jnp.asarray(base) * s)[2] for s in scales])[:, None]
    scen = tm.with_params(t64(masses), t64(coms), t64(inertias))
    assert scen.params.shape == (3, 1, 10) and scen.mu is tm.mu
    jparams = jax.vmap(lambda m, c, i: jm.with_params(m, c, i).params)(
        jnp.asarray(masses), jnp.asarray(coms), jnp.asarray(inertias))
    np.testing.assert_allclose(scen.params.numpy(), jparams, **TOL)

    nc = tm.num_contacts
    forces = tbal.expand_frictionless_forces(
        scen, (scen.params[..., 0, 0:1] * 9.81 / nc).expand(3, nc))
    res = tbal.object_dynamics_constraints(scen, forces, tbal.EEState.zero(), t64(GRAVITY))
    assert res.shape == (3, 6)
    np.testing.assert_allclose(res.numpy(), 0.0, atol=1e-10)


def test_with_params_matches_batched():
    """Random scenarios with two batch axes on box_arch (3 objects): the
    parameters and the Newton-Euler residuals equal the JAX model's."""
    jm, tm = models("box_arch")
    n_obj, n_c = tm.num_objects, tm.num_contacts
    rng = np.random.default_rng(5)
    masses = rng.uniform(0.1, 2.0, (2, 4, n_obj))
    coms = 0.05 * rng.standard_normal((2, 4, n_obj, 3))
    M = rng.standard_normal((2, 4, n_obj, 3, 3))
    inertias = 0.01 * M @ np.swapaxes(M, -1, -2)
    scen = tm.with_params(t64(masses), t64(coms), t64(inertias))
    assert scen.params.shape == (2, 4, n_obj, 10)

    forces = rng.standard_normal((2, 4, n_c, 3))
    ee = {k: rng.standard_normal((2, 4, 3)) for k in EE_FIELDS[1:]}
    ee["C_we"] = np.broadcast_to(np.eye(3), (2, 4, 3, 3)).copy()

    def jax_one(m, c, i, f, e):
        jscen = jm.with_params(m, c, i)
        return jscen.params, jbal.object_dynamics_constraints(jscen, f, e, jnp.asarray(GRAVITY))

    # one vmap over the 8 scenarios laid flat
    flat = lambda x: jnp.asarray(x.reshape((8,) + x.shape[2:]))  # noqa: E731
    jee = jbal.EEState(**{k: flat(v) for k, v in ee.items()})
    jparams, jres = (r.reshape((2, 4) + r.shape[1:]) for r in jax.jit(jax.vmap(jax_one))(
        flat(masses), flat(coms), flat(inertias), flat(forces), jee))
    np.testing.assert_allclose(scen.params.numpy(), jparams, **TOL)
    res = tbal.object_dynamics_constraints(
        scen, t64(forces), tbal.EEState(**{k: t64(v) for k, v in ee.items()}), t64(GRAVITY))
    # residuals are divided by masses down to 0.1, as in test_torch_core
    np.testing.assert_allclose(res.numpy(), jres, rtol=1e-12, atol=1e-11)


def test_ee_state_zero_matches():
    jz = jbal.EEState.zero()
    tz = tbal.EEState.zero()
    for field in EE_FIELDS:
        got = getattr(tz, field)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jz, field)))
    assert tbal.EEState.zero(dtype=torch.float32).a_ew_w.dtype == torch.float32


def robot_conf(name):
    path = jcfg.resolve_package_path({"package": "configs", "path": f"robots/{name}.yaml"})
    return jcfg.load_config(path)["controller"]["robot"]


def motion_fields(f):
    """A JAX ``FrameMotion`` as a tuple, which ``jax.vmap`` can return."""
    return tuple(getattr(f, field) for field in MOTION_FIELDS)


@pytest.mark.parametrize("name", ["thing", "ur10"])
def test_frame_motion_matches(name):
    """Every joint frame, at random (q, v, a) batched (5, 2) and unbatched,
    and with v and a left out, against the JAX chain.  The JAX frames come
    from one compiled, vmapped pass of its chain, each the frame that its
    ``frame_motion`` returns (checked on the first frame): a call per frame
    would take seconds."""
    conf = robot_conf(name)
    jchain, tchain = jbuild(conf).chain, tbuild(conf).chain
    nq = jbuild(conf).nq
    rng = np.random.default_rng(6)
    q, v, a = (rng.standard_normal((5, 2, nq)) for _ in range(3))
    jq, jv, ja = (jnp.asarray(x) for x in (q, v, a))
    assert tchain.joint_names == jchain.joint_names
    frames = tchain.joint_names
    every_frame = jax.jit(jax.vmap(jax.vmap(lambda q_, v_, a_: [
        motion_fields(f) for f in jchain._propagate(q_, v_, a_)])))
    refs = every_frame(jq, jv, ja)
    refs_rest = every_frame(jq, jnp.zeros_like(jq), jnp.zeros_like(jq))
    first = jax.jit(lambda *x: motion_fields(jchain.frame_motion(frames[0], *x)))(
        jq[1, 0], jv[1, 0], ja[1, 0])
    for got, want in zip(first, refs[0]):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want)[1, 0], **TOL)
    assert len(refs) == len(frames)
    for frame, ref, ref_rest in zip(frames, refs, refs_rest):
        out = tchain.frame_motion(frame, t64(q), t64(v), t64(a))
        one = tchain.frame_motion(frame, t64(q[1, 0]), t64(v[1, 0]), t64(a[1, 0]))
        rest = tchain.frame_motion(frame, t64(q[1, 0]))
        for field, want, want_rest in zip(MOTION_FIELDS, ref, ref_rest):
            got, want = getattr(out, field), np.asarray(want)
            assert got.shape == want.shape, (frame, field)
            np.testing.assert_allclose(got.numpy(), want, err_msg=f"{frame} {field}", **TOL)
            np.testing.assert_allclose(getattr(one, field).numpy(), want[1, 0],
                                       err_msg=f"{frame} {field}", **TOL)
            np.testing.assert_allclose(getattr(rest, field).numpy(), np.asarray(want_rest)[1, 0],
                                       err_msg=f"{frame} {field}", **TOL)
    with pytest.raises(ValueError):
        tchain.frame_motion("no_such_frame", t64(q))


def test_collision_sphere_fields():
    fields = [(f.name, f.type) for f in dataclasses.fields(tproblem.CollisionSphere)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(jproblem.CollisionSphere)]
    sphere = tproblem.CollisionSphere(link="ur10_arm_wrist_3_joint",
                                      offset=np.array([0.0, 0.0, 0.1]), radius=0.15)
    assert sphere.link == "ur10_arm_wrist_3_joint" and sphere.radius == 0.15
    np.testing.assert_array_equal(sphere.offset, [0.0, 0.0, 0.1])
