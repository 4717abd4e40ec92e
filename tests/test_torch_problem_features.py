"""The port's ``build_problem`` against the JAX package's on every feature
beyond the two demo problems: frictional cones, static and dynamic obstacles
(collision rows, obstacle states in x), the projectile path and plane rows,
the three inertial-alignment modes, the EE box and the rolling rows of a
nonholonomic base.  Float64 on the CPU, N = 5, inputs from numpy seeds.

The shipped configs are taken as they are; the features no shipped config
switches on are switched on by editing a loaded config, as the JAX package's
own tests do (tests/test_ral23_configs.py, tests/test_obstacles.py,
tests/test_closed_loop.py).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.ocp.problem import build_problem as jbuild
from upright_tpu.solver.ocp import SolverState as JState
from upright_tpu_torch.convert import params_from_numpy, solver_state_from_numpy
from upright_tpu_torch.ocp.problem import build_problem as tbuild

CPU64 = dict(device="cpu", dtype=torch.float64)
N = 5
TOL = dict(rtol=1e-10, atol=1e-10)


def _set(conf, keys, value):
    d = conf["controller"]
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


# (config path, edits (controller key path, value)); the edited cases follow
# the JAX package's own tests
CASES = {
    "full_bottle_point1": ("ral23/static_obstacles/full_bottle_point1.yaml", ()),
    "ur10_friction_demo": ("demos/ur10_friction_demo.yaml", ()),
    "thing_obstacle_demo": ("demos/thing_obstacle_demo.yaml", ()),
    "thing_restaurant_demo": ("demos/thing_restaurant_demo.yaml", ()),
    "thing_projectile_demo": ("demos/thing_projectile_demo.yaml", ()),
    "sudden_t1.0": ("ral23/sudden_obstacle/sudden_t1.0.yaml", ()),
    "aligned_bottle_point1": ("ral23/static_obstacles/aligned_bottle_point1.yaml", ()),
    "upward_dice_point1": ("ral23/freespace/upward_dice_point1.yaml", ()),
    "angular_acceleration": ("ral23/freespace/aligned_dice_point1.yaml", (
        (("inertial_alignment", "use_angular_acceleration"), True),
        (("inertial_alignment", "com"), [0.0, 0.0, 0.1]),
    )),
    "alignment_cost": ("demos/ur10_demo.yaml", (
        (("inertial_alignment", "cost_enabled"), True),
        (("inertial_alignment", "cost_weight"), 100.0),
    )),
    "ee_box": ("demos/ur10_demo.yaml", (
        (("end_effector_box_constraint", "enabled"), True),
    )),
    "projectile_plane": ("demos/thing_projectile_demo.yaml", (
        (("projectile_plane_constraint",),
         {"enabled": True, "distance": 0.3, "normal": [0.0, 1.0, 0.0]}),
    )),
    "nonholonomic": ("demos/thing_demo.yaml", (
        (("robot", "base_type"), "nonholonomic"),
    )),
}

_cache = {}


def problems(name):
    if name not in _cache:
        path, edits = CASES[name]
        spec = {"package": "configs", "path": path}
        jconf = jcfg.load_config(jcfg.resolve_package_path(spec))
        tconf = tcfg.load_config(tcfg.resolve_package_path(spec))
        for keys, value in edits:
            _set(jconf, keys, copy.deepcopy(value))
            _set(tconf, keys, copy.deepcopy(value))
        _cache[name] = (jconf, tconf, jbuild(jconf, N=N), tbuild(tconf, N=N, **CPU64))
    return _cache[name]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", list(CASES))
def test_build_matches_reference(name):
    """Dims, named inequality groups, box split, Jacobian blocks, force
    scaling, bounds, x0 and the stage parameters: host-side numpy on both
    sides, 1e-12."""
    jconf, tconf, jp, tp = problems(name)
    assert tconf == jconf
    o, jo = tp.ocp, jp.ocp
    assert (o.N, o.nx, o.nu, o.n_eq, o.n_ineq, o.n_feq) == (
        jo.N, jo.nx, jo.nu, jo.n_eq, jo.n_ineq, jo.n_feq)
    assert dataclasses.asdict(tp.dims) == dataclasses.asdict(jp.dims)
    assert tp.ineq_groups == jp.ineq_groups
    assert sum(n for _, n in tp.ineq_groups) == o.n_ineq
    assert (o.ineq_box.n_pre, o.ineq_box.nx_box, o.ineq_box.nu_box) == (
        jo.ineq_box.n_pre, jo.ineq_box.nx_box, jo.ineq_box.nu_box)
    # the CPU resolves "auto" to the column blocks, as the reference does
    assert o.x_jac_blocks == jo.x_jac_blocks and o.jac_mode == jo.jac_mode
    assert o.linear_dynamics == jo.linear_dynamics
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tp.force_scale, jp.force_scale, **tol)
    for f in ("u_lb", "u_ub"):
        np.testing.assert_allclose(getattr(o, f).numpy(), np.asarray(getattr(jo, f)),
                                   err_msg=f, **tol)
    np.testing.assert_allclose(tp.x0.numpy(), np.asarray(jp.x0), **tol)
    np.testing.assert_allclose(tp.target.poses.numpy(), np.asarray(jp.target.poses), **tol)
    jparams, tparams = np_tree(jp.stage_params(0.3)), tp.stage_params(0.3)
    for part in ("stage", "final"):
        for k, v in jparams[part].items():
            np.testing.assert_allclose(tparams[part][k].numpy(), v, err_msg=k, **tol)


def _stage_point(jp, o, seed):
    rng = np.random.default_rng(seed)
    M = 4
    x = np.asarray(jp.x0)[None] + 0.3 * rng.standard_normal((M, o.nx))
    u = rng.standard_normal((M, o.nu))
    return x, u


# the target's projectile flag gates the projectile rows: the cases that
# have them are also taken with the flag switched on
FLAG_ON = ("thing_projectile_demo", "projectile_plane")


@pytest.mark.parametrize(
    "name,flag",
    [(n, 0.0) for n in CASES] + [(n, 1.0) for n in FLAG_ON],
    ids=[*CASES, *(f"{n}-target_flag_on" for n in FLAG_ON)],
)
def test_stage_functions_match_reference(name, flag):
    """Every stage function at seeded (x, u) and stage 2 of a solve at t =
    0.3, with the target's projectile flag as configured (and switched on
    for FLAG_ON): a kinematic sweep and a handful of products on both sides
    in float64, 1e-10."""
    _, _, jp, tp = problems(name)
    jo, o = jp.ocp, tp.ocp
    x, u = _stage_point(jp, o, seed=sum(map(ord, name)))
    target = jp.target
    if flag:
        target = target.replace(poses=target.poses.at[:, 7].set(flag))
    jparams = jp.stage_params(0.3, target)
    jp2 = jax.tree.map(lambda v: v[2], jparams["stage"])
    tparams = params_from_numpy(np_tree(jparams), batch=x.shape[0], **CPU64)
    tp2 = {k: v[:, 2] for k, v in tparams["stage"].items()}
    jx, ju, tx, tu = jnp.asarray(x), jnp.asarray(u), torch.as_tensor(x), torch.as_tensor(u)

    def jv(fn):
        return np.asarray(jax.vmap(lambda a, b: fn(a, b, jp2))(jx, ju))

    for f in ("dynamics", "eq", "ineq", "ineq_smooth", "stage_cost", "stage_quad"):
        out = getattr(o, f)(tx, tu, tp2).numpy()
        ref = jv(getattr(jo, f))
        assert out.shape == ref.shape, f
        np.testing.assert_allclose(out, ref, err_msg=f, **TOL)
    r, W = o.stage_residuals(tx, tu, tp2)
    r_ref, W_ref = jax.vmap(lambda a, b: jo.stage_residuals(a, b, jp2))(jx, ju)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), **TOL)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref[0]), **TOL)
    g, H = o.stage_quad_derivs(tx, tu, tp2)
    g_ref, H_ref = jax.vmap(lambda a, b: jo.stage_quad_derivs(a, b, jp2))(jx, ju)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), **TOL)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref[0]), **TOL)
    feq_ref = jax.vmap(lambda a: jo.final_eq(a, jparams["final"]))(jx)
    np.testing.assert_allclose(o.final_eq(tx, tparams["final"]).numpy(), np.asarray(feq_ref),
                               **TOL)
    # every named group is a block of ineq at one (x, u, t)
    cons = tp.evaluate_constraints(x[0], u[0], 0.3 + 2 * tp.dt, tp.target)
    cons_ref = jp.evaluate_constraints(x[0], u[0], 0.3 + 2 * jp.dt, jp.target)
    for group, _n in tp.ineq_groups:
        np.testing.assert_allclose(cons[group].numpy(), np.asarray(cons_ref[group]),
                                   err_msg=group, **TOL)


def test_collision_constraint_rows():
    """4 robot spheres x 9 static obstacles = 36 collision rows, all positive
    at the home configuration (tests/test_obstacles.py on the port)."""
    _, tconf, _, tp = problems("thing_obstacle_demo")
    p0 = {k: v[0] for k, v in tp.stage_params(0.0)["stage"].items()}
    h = tp.ocp.ineq(tp.x0, torch.zeros(tp.ocp.nu, dtype=torch.float64), p0)
    conf = copy.deepcopy(tconf)
    conf["controller"]["obstacles"] = {"enabled": False}
    tp_free = tbuild(conf, N=N, **CPU64)
    h_free = tp_free.ocp.ineq(tp_free.x0, torch.zeros(tp_free.ocp.nu, dtype=torch.float64), p0)
    assert h.shape[0] - h_free.shape[0] == 36
    assert (h[-36:] > 0).all()


def test_collision_rows_sign():
    """Moving the base into an obstacle pillar makes rows negative."""
    _, _, _, tp = problems("thing_obstacle_demo")
    p0 = {k: v[0] for k, v in tp.stage_params(0.0)["stage"].items()}
    x_bad = tp.x0.clone()
    x_bad[0], x_bad[1] = 1.5, 1.0  # base at pillar 2
    h = tp.ocp.ineq(x_bad, torch.zeros(tp.ocp.nu, dtype=torch.float64), p0)
    assert (h[-36:] < 0).any()


def test_dynamic_obstacle_in_state():
    """A dynamic obstacle extends x by 9 states from its first mode and
    falls ballistically through dynamics."""
    _, _, _, tp = problems("thing_projectile_demo")
    assert tp.ocp.nx == 27 + 9 and tp.dims.num_obstacles == 1
    np.testing.assert_allclose(tp.x0[27:30].numpy(), [0, -10, 0])
    p0 = {k: v[0] for k, v in tp.stage_params(0.0)["stage"].items()}
    x1 = tp.ocp.dynamics(tp.x0, torch.zeros(tp.ocp.nu, dtype=torch.float64), p0)
    assert np.isclose(float(x1[29]), -0.5 * 9.81 * tp.dt**2)


def test_alignment_modes_behave_as_the_reference():
    """The fixed-vector ("upward") rows do not move under acceleration and
    read (1, alpha, ...) for a level tray at rest; the acceleration-mode rows
    move; use_angular_acceleration adds a CoM term only under angular
    acceleration (tests/test_ral23_configs.py on the port)."""
    _, _, _, up = problems("upward_dice_point1")
    _, _, _, ang = problems("angular_acceleration")
    conf = tcfg.load_config(tcfg.resolve_package_path(
        {"package": "configs", "path": "ral23/freespace/aligned_dice_point1.yaml"}))
    plain = tbuild(conf, N=N, **CPU64)
    x = up.x0.numpy()
    u = np.zeros(up.ocp.nu)
    nq = up.dims.robot_q

    def rows(prob, x_):
        return prob.evaluate_constraints(x_, u)["alignment_constraints"].numpy()

    r0 = rows(up, x)
    assert abs(r0[0] - 1.0) < 1e-6 and np.allclose(r0[1:], 0.2, atol=1e-6)
    xa = x.copy()
    xa[2 * nq :] = 2.0
    assert np.allclose(rows(up, xa), r0, atol=1e-9)
    assert np.max(np.abs(rows(plain, xa) - rows(plain, x))) > 1e-3
    xa[2 * nq :] = 1.0
    assert np.allclose(rows(ang, x), rows(plain, x), atol=1e-9)
    assert np.max(np.abs(rows(ang, xa) - rows(plain, xa))) > 1e-4


def test_projectile_plane_row_by_hand():
    """The plane row is s * (n.(r_ew - r_obs) - w), and the s flag gates it
    exactly (tests/test_obstacles.py on the port)."""
    _, _, _, tp = problems("projectile_plane")
    assert ("projectile_plane", 1) in tp.ineq_groups
    x = tp.x0
    u = torch.zeros(tp.ocp.nu, dtype=torch.float64)
    r_ee = tp.robot.ee_state(x[: tp.dims.robot_x]).r_ew_w
    d = float((r_ee - x[27:30])[1]) - 0.3
    for s in (float(tp.target.poses[0, 7]), 1.0):
        poses = tp.target.poses.clone()
        poses[:, 7] = s
        target = dataclasses.replace(tp.target, poses=poses)
        p0 = {k: v[0] for k, v in tp.stage_params(0.0, target)["stage"].items()}
        assert np.isclose(float(tp.ocp.ineq(x, u, p0)[-1]), s * d, atol=1e-12)


def test_heal_warm_start_repropagates_obstacle_tails():
    """Obstacle tails are re-rolled from the measured obstacle state on
    every heal, whichever side of the jump threshold the robot is on."""
    _, _, jp, tp = problems("sudden_t1.0")
    o = tp.ocp
    rng = np.random.default_rng(3)
    B = 2
    arrays = dict(
        X=rng.standard_normal((B, o.N + 1, o.nx)), U=0.1 * rng.standard_normal((B, o.N, o.nu)),
        lam=rng.standard_normal((B, o.N, o.n_eq)), mu=rng.uniform(size=(B, o.N, o.n_ineq)),
        lam_f=rng.standard_normal((B, o.n_feq)),
    )
    x0 = arrays["X"][:, 0].copy()
    x0[0, 27:] += 0.5  # the obstacle moved; the robot did not
    x0[1, :9] += 0.3 / 3.0  # and a robot jump above the threshold
    out = tp.heal_warm_start(solver_state_from_numpy(arrays, **CPU64), torch.as_tensor(x0))
    for b in range(B):
        ref = jp.heal_warm_start(
            JState(**{k: jnp.asarray(v[b]) for k, v in arrays.items()}), jnp.asarray(x0[b]))
        np.testing.assert_allclose(out.X[b].numpy(), np.asarray(ref.X), rtol=1e-12, atol=1e-12)
    # instance 0 kept its robot plan and re-rolled the obstacle tail
    np.testing.assert_array_equal(out.X[0, :, :27].numpy(), arrays["X"][0, :, :27])
    assert not np.allclose(out.X[0, :, 27:].numpy(), arrays["X"][0, :, 27:])


def test_jac_col_blocks_resolution():
    """"auto" takes the column blocks on the CPU and one wide jacfwd on the
    card; a bool in the config overrides; anything else raises."""
    from upright_tpu_torch.ocp.problem import _use_jac_col_blocks

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert _use_jac_col_blocks({}, cpu) and not _use_jac_col_blocks({}, cuda)
    assert _use_jac_col_blocks({"jac_col_blocks": True}, cuda)
    assert not _use_jac_col_blocks({"jac_col_blocks": False}, cpu)
    with pytest.raises(ValueError, match="jac_col_blocks"):
        _use_jac_col_blocks({"jac_col_blocks": "sometimes"}, cpu)
    _, tconf, _, _ = problems("sudden_t1.0")
    conf = copy.deepcopy(tconf)
    conf["controller"]["sqp"]["jac_mode"] = "rev"
    conf["controller"]["sqp"]["jac_col_blocks"] = False
    o = tbuild(conf, N=N, **CPU64).ocp
    assert o.jac_mode == "rev" and o.x_jac_blocks is None
    conf["controller"]["sqp"]["jac_mode"] = "sideways"
    with pytest.raises(ValueError, match="jac_mode"):
        tbuild(conf, N=N, **CPU64)
