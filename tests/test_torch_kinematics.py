"""The port's kinematic chain against the JAX package: EE pose, velocity and
acceleration for the Thing (9 DOF, planar base) and the fixed-base UR10 at
random (q, v, a), float64.  Both sweeps do the same operations joint by
joint, so the tolerance is 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.kinematics.robot import build_robot_model as jbuild
from upright_tpu_torch.kinematics.robot import build_robot_model as tbuild

TOL = dict(rtol=1e-12, atol=1e-12)


def robot_conf(name):
    path = jcfg.resolve_package_path({"package": "configs", "path": f"robots/{name}.yaml"})
    return jcfg.load_config(path)["controller"]["robot"]


@pytest.mark.parametrize("name,nq", [("thing", 9), ("ur10", 6)])
def test_ee_state_matches(name, nq):
    conf = robot_conf(name)
    jr, tr = jbuild(conf), tbuild(conf)
    assert tr.nq == jr.nq == nq and tr.joint_names == jr.joint_names
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 3 * nq))
    ref = jax.vmap(jr.ee_state)(jnp.asarray(x))
    out = tr.ee_state(torch.as_tensor(x))
    for field in ("C_we", "r_ew_w", "v_ew_w", "w_ew_w", "a_ew_w", "alpha_ew_w"):
        got = getattr(out, field)
        assert got.shape == getattr(ref, field).shape
        np.testing.assert_allclose(got.numpy(), getattr(ref, field), err_msg=field, **TOL)
    # extra leading axes (batch, stage) give the same numbers
    out2 = tr.ee_state(torch.as_tensor(x).reshape(7, 1, 3 * nq).expand(7, 2, 3 * nq))
    np.testing.assert_allclose(out2.a_ew_w[:, 1].numpy(), ref.a_ew_w, **TOL)


@pytest.mark.parametrize("name", ["thing", "ur10"])
def test_link_positions_and_jacobian_match(name):
    conf = robot_conf(name)
    jr, tr = jbuild(conf), tbuild(conf)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, jr.nq))
    np.testing.assert_allclose(
        tr.link_positions(torch.as_tensor(q)).numpy(),
        jax.vmap(jr.link_positions)(jnp.asarray(q)), **TOL)
    R, p = tr.ee_pose(torch.as_tensor(q))
    R_ref, p_ref = jax.vmap(jr.ee_pose)(jnp.asarray(q))
    np.testing.assert_allclose(R.numpy(), R_ref, **TOL)
    np.testing.assert_allclose(p.numpy(), p_ref, **TOL)
    # the position Jacobian through torch.func, as the solver takes it
    J = torch.func.vmap(torch.func.jacfwd(lambda q_: tr.ee_pose(q_)[1]))(torch.as_tensor(q))
    J_ref = jax.vmap(jax.jacfwd(lambda q_: jr.ee_pose(q_)[1]))(jnp.asarray(q))
    np.testing.assert_allclose(J.numpy(), J_ref, rtol=1e-11, atol=1e-11)


def test_locked_joints_match():
    conf = dict(robot_conf("thing"))
    conf["locked_joints"] = {"ur10_arm_elbow_joint": "0.5pi", "y_to_x_joint": 0.3}
    jr, tr = jbuild(conf), tbuild(conf)
    assert tr.nq == jr.nq == 7
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 21))
    ref = jax.vmap(jr.ee_state)(jnp.asarray(x))
    out = tr.ee_state(torch.as_tensor(x))
    np.testing.assert_allclose(out.r_ew_w.numpy(), ref.r_ew_w, **TOL)
    np.testing.assert_allclose(out.alpha_ew_w.numpy(), ref.alpha_ew_w, **TOL)
