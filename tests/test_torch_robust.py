"""The port's robust layer (``upright_tpu_torch/robust``: modelling,
verification, scenarios, synthesis, realizable) against the JAX package's,
in float64 on the CPU, on the same numpy inputs.

The cases are those of tests/test_robust.py, tests/test_synthesis.py and
tests/test_realizable.py, each run on the port with its original checks and
limits, and each port function held to its JAX counterpart on the same
inputs: host-side numpy results to 1e-12 (the same arithmetic; the
regressor takes its rotation derivative from each package's own core.math),
face forms equal up to row order, the realizable barrier (batched Newton
with closed-form derivatives against the reference's vmapped jax.hessian)
to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
import upright_tpu_torch.config as tcfg
from upright_tpu.robust import modelling as jrm
from upright_tpu.robust import realizable as jreal
from upright_tpu.robust import scenarios as jscen
from upright_tpu.robust import synthesis as jsyn
from upright_tpu.robust import verification as jrv
from upright_tpu_torch.robust import modelling as rm
from upright_tpu_torch.robust import realizable as treal
from upright_tpu_torch.robust import synthesis as tsyn
from upright_tpu_torch.robust import verification as rv
from upright_tpu_torch.robust.scenarios import (
    box_vertices,
    com_vertex_params,
    sample_inertial_params,
    stack_vertex_scenarios_in_model,
)

CPU64 = dict(device="cpu", dtype=torch.float64)
HOST = dict(rtol=1e-12, atol=1e-12)
BARRIER = dict(rtol=1e-8, atol=1e-8)


def load_contacts(arrangement="pink_bottle"):
    """(port parse, JAX parse) of an arrangement, each (model, names,
    objects, contacts)."""
    out = []
    for cfg, kw in ((tcfg, CPU64), (jcfg, {})):
        path = cfg.resolve_package_path({"package": "configs", "path": "arrangements.yaml"})
        conf = cfg.load_config(path)
        conf["balancing"] = {"arrangement": arrangement, "frictionless": False}
        out.append(cfg.parse_control_objects(conf, **kw))
    return out


def face_form(mod, parsed):
    _model, names, _objects, contacts = parsed
    rcps = [mod.RobustContactPoint(c) for c in contacts]
    return mod.compute_cwc_face_form(mod.compute_object_name_index(names), rcps)


def assert_same_rows(A, B, tol=1e-9):
    """Face forms are equal up to row order (qhull's facet order)."""
    assert A.shape == B.shape
    for a in A:
        assert np.abs(B - a).max(axis=1).min() < tol, a


def oracle_face_form(S):
    """x in cone(S) iff z >= 0 with S z = x exists (an LP, qhull-free)."""
    from scipy.optimize import linprog

    def in_cone(x):
        k = S.shape[1]
        res = linprog(np.zeros(k), A_eq=S, b_eq=x, bounds=[(0, None)] * k, method="highs")
        return res.success

    return in_cone


# -- tests/test_robust.py --------------------------------------------------------


def test_cone_span_to_face_form_3d():
    mu = 0.5
    S = np.array([[mu, 0, 1.0], [-mu, 0, 1.0], [0, mu, 1.0], [0, -mu, 1.0]]).T
    A = rm.cone_span_to_face_form(S)
    assert A.shape[1] == 3
    assert_same_rows(A, jrm.cone_span_to_face_form(S))
    in_cone = oracle_face_form(S)
    rng = np.random.default_rng(0)
    for _ in range(40):
        x = rng.standard_normal(3)
        lp = in_cone(x)
        ff = bool((A @ x <= 1e-9).all())
        assert lp == ff, f"disagreement at {x}: lp={lp} ff={ff}"


def test_cwc_face_form_static_equilibrium():
    tparsed, jparsed = load_contacts()
    A = face_form(rm, tparsed)
    assert A.shape[1] == 6
    assert_same_rows(A, face_form(jrm, jparsed))
    obj = tparsed[2]["bottle"]
    m, c = obj.mass, np.asarray(obj.com)
    g = np.array([0, 0, -9.81])
    w_gi = np.concatenate([m * -g, np.cross(c, m * -g)])
    assert (A @ w_gi <= 1e-8).all(), "resting wrench should be supportable"
    w_bad = np.concatenate([[50.0 * m, 0, m * 9.81], np.cross(c, [50.0 * m, 0, m * 9.81])])
    assert (A @ w_bad > 1e-8).any(), "slipping wrench should violate the CWC"


def test_uncertain_object_wrench():
    kw = dict(mass=2.0, com=[0.1, 0, 0.05], inertia=np.diag([0.1, 0.1, 0.05]))
    obj, jobj = rm.UncertainObject(**kw), jrm.UncertainObject(**kw)
    V = np.array([0.1, -0.2, 0.3, 0.05, 0.02, -0.1])
    A6 = np.array([1.0, 2, 3, 0.1, 0.2, 0.3])
    w = obj.wrench(A6, V)
    assert w.shape == (6,)
    np.testing.assert_allclose(w, jobj.wrench(A6, V), **HOST)
    g = np.array([0, 0, -9.81])
    w_static = obj.wrench(np.concatenate([-g, np.zeros(3)]), np.zeros(6))
    assert np.allclose(w_static[:3], 2.0 * -g)
    assert np.allclose(w_static[3:], np.cross(2.0 * np.asarray([0.1, 0, 0.05]), -g))


def test_regressor_matches_direct_wrench():
    """Y theta equals the directly computed gravito-inertial wrench, and the
    port's Y equals the JAX package's."""
    from upright_tpu_torch.core.math import dC_dtt, quat_to_rot

    rng = np.random.default_rng(1)
    q = rng.standard_normal(4)
    C_we = quat_to_rot(torch.as_tensor(q / np.linalg.norm(q))).numpy()
    w_w, al_w, a_w = rng.standard_normal(3), rng.standard_normal(3), rng.standard_normal(3)
    g = np.array([0, 0, -9.81])
    mass, com = 1.5, np.array([0.02, -0.01, 0.12])
    I_com = np.diag([0.02, 0.02, 0.01])
    theta = rv.theta_from_body(mass, com, I_com)
    np.testing.assert_allclose(theta, jrv.theta_from_body(mass, com, I_com), **HOST)

    Y = rv.inertial_regressor(C_we, w_w, al_w, a_w, g)
    np.testing.assert_allclose(Y, jrv.inertial_regressor(C_we, w_w, al_w, a_w, g), **HOST)
    w_pred = Y @ theta

    C_ew = C_we.T
    ddC = dC_dtt(*(torch.as_tensor(a) for a in (C_we, w_w, al_w))).numpy()
    b = C_ew @ (a_w - g)
    F = mass * b + C_ew @ ddC @ (mass * com)
    Sc = rm.skew3(com)
    I_o = I_com - mass * Sc @ Sc
    w_e = C_ew @ w_w
    al_e = C_ew @ al_w
    tau = I_o @ al_e + np.cross(w_e, I_o @ w_e) + np.cross(mass * com, b)
    assert np.allclose(w_pred, np.concatenate([F, tau]), atol=1e-10)


def test_parameter_set_max_linear():
    c = np.arange(10.0)
    mu, mu2 = np.ones(10), -np.ones(10)
    sets = [
        dict(center=c, box_half=0.5 * np.ones(10)),
        dict(center=c, ellipsoid=0.1 * np.eye(10)),
        dict(center=c, vertices=np.stack([c - 1, c + 2])),
    ]
    for kw in sets:
        for m in (mu, mu2):
            assert rv.ParameterSet(**kw).max_linear(m) == pytest.approx(
                jrv.ParameterSet(**kw).max_linear(m), rel=1e-12, abs=1e-12)
    box = rv.ParameterSet(**sets[0])
    assert np.isclose(box.max_linear(mu), c.sum() + 5.0)
    assert np.isclose(box.max_linear(mu2), -c.sum() + 5.0)
    assert np.isclose(rv.ParameterSet(**sets[1]).max_linear(mu), c.sum() + 0.1 * np.sqrt(10))
    assert np.isclose(rv.ParameterSet(**sets[2]).max_linear(mu), (c + 2).sum())


def test_verification_static_plan():
    """A resting trajectory is robustly feasible for small CoM boxes but not
    for huge ones (CoM beyond the support area)."""
    tparsed, jparsed = load_contacts()
    A, A_j = face_form(rm, tparsed), face_form(jrm, jparsed)
    obj = tparsed[2]["bottle"]
    g = np.array([0, 0, -9.81])
    states = [(np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3))] * 3
    out = {}
    for name, box in (("small", [0.005, 0.005, 0.01]), ("big", [0.2, 0.2, 0.01])):
        pset = rv.ParameterSet.from_com_box(obj.mass, obj.com, obj.inertia, box)
        jpset = jrv.ParameterSet.from_com_box(obj.mass, obj.com, obj.inertia, box)
        np.testing.assert_allclose(pset.vertices, jpset.vertices, **HOST)
        out[name] = rv.verify_plan(A, states, g, pset)
        np.testing.assert_allclose(out[name], jrv.verify_plan(A_j, states, g, jpset), **HOST)
    assert (out["small"] <= 1e-6).all()
    assert (out["big"] > 1e-6).all()


def test_scenario_generation():
    tparsed, jparsed = load_contacts()
    model, jmodel = tparsed[0], jparsed[0]
    base = model.params.numpy()
    ext = [[0.01, 0.01, 0.02]]
    scen = com_vertex_params(base, ext)
    assert scen.shape == (8, 1, 10)
    np.testing.assert_allclose(scen, np.asarray(jscen.com_vertex_params(base, ext)), **HOST)
    np.testing.assert_allclose(box_vertices([1, 2, 3], [0.5, 0, 0]),
                               jscen.box_vertices([1, 2, 3], [0.5, 0, 0]))
    assert np.allclose(scen[:, 0, 0], base[0, 0])
    coms = scen[:, 0, 1:4] / base[0, 0]
    com0 = base[0, 1:4] / base[0, 0]
    assert np.allclose(np.sort(np.unique(np.round(coms[:, 0] - com0[0], 6))), [-0.01, 0.01])

    kw = dict(com_half_extents=ext, mass_range=(0.8, 1.2), inertia_scale_range=(0.5, 2.0))
    samples = sample_inertial_params(base, np.random.default_rng(0), 100, **kw)
    np.testing.assert_allclose(
        samples, np.asarray(jscen.sample_inertial_params(base, np.random.default_rng(0), 100, **kw)),
        **HOST)
    assert samples.shape == (100, 1, 10)
    masses = samples[:, 0, 0]
    assert masses.min() >= 0.8 * base[0, 0] - 1e-9
    assert masses.max() <= 1.2 * base[0, 0] + 1e-9

    stacked = stack_vertex_scenarios_in_model(model, ext)
    jstacked = jscen.stack_vertex_scenarios_in_model(jmodel, ext)
    for f in ("params", "mu", "normal", "span", "r1", "r2", "S1", "S2"):
        got = getattr(stacked, f)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jstacked, f)), err_msg=f,
                                   **HOST)
    assert stacked.params.shape == (8, 10)
    nc = model.num_contacts
    assert stacked.S1.shape == (8, 8 * nc)
    assert stacked.num_contacts == 8 * nc
    S1 = stacked.S1.numpy()
    for i in range(8):
        assert np.allclose(S1[i, i * nc : (i + 1) * nc], model.S1.numpy()[0])
        assert S1[i].sum() == model.S1.numpy()[0].sum()


def test_count_failures():
    disp = np.array([[0.1, 0.2], [0.6, 0.1], [0.0, 0.0], [np.inf, 0.0]])
    assert rv.count_failures(disp) == jrv.count_failures(disp) == 2
    assert rv.count_failures(disp[:3]) == 1


def test_robust_solve_fn_is_one_batched_solve():
    """Four sampled parameter sets solved as one batch of four, against the
    JAX package's vmapped scenario solve (1e-8, as tests/test_torch_solve.py)."""
    import jax

    from upright_tpu.ocp.problem import build_problem as jbuild
    from upright_tpu.robust.scenarios import robust_solve_fn as jrobust
    from upright_tpu.solver import al as jal
    from upright_tpu.solver.ocp import zeros_warm_start as jzeros
    from upright_tpu_torch.convert import params_from_numpy
    from upright_tpu_torch.ocp.problem import build_problem as tbuild
    from upright_tpu_torch.robust.scenarios import robust_solve_fn
    from upright_tpu_torch.solver import al as tal
    from upright_tpu_torch.solver.ocp import zeros_warm_start as tzeros

    path = {"package": "configs", "path": "demos/ur10_demo.yaml"}
    jp = jbuild(jcfg.load_config(jcfg.resolve_package_path(path)), N=4)
    tp = tbuild(tcfg.load_config(tcfg.resolve_package_path(path)), N=4, **CPU64)
    base = np.asarray(jp.balance_model.params)
    scen = sample_inertial_params(base, np.random.default_rng(3), 4, com_half_extents=[[0.01] * 3],
                                  mass_range=(0.9, 1.1))
    x0 = np.asarray(jp.x0)
    cfg = dict(iterations=2, line_search_steps=(1.0, 0.5))
    jstates = jax.vmap(lambda _: jzeros(jp.ocp, jnp.asarray(x0)))(jnp.arange(4))
    jsol = jrobust(jp.ocp, jal.ALConfig(**cfg))(jp.stage_params(0.0), jnp.asarray(scen),
                                                 jnp.asarray(x0), jstates)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jp.stage_params(0.0)), **CPU64)
    tstates = tzeros(tp.ocp, torch.tensor(x0).expand(4, -1), **CPU64)
    tsol = robust_solve_fn(tp.ocp, tal.ALConfig(**cfg), **CPU64)(tparams, scen, x0, tstates)
    for f in ("X", "U", "lam", "mu", "lam_f"):
        np.testing.assert_allclose(getattr(tsol.state, f).numpy(),
                                   np.asarray(getattr(jsol.state, f)), err_msg=f,
                                   rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tsol.eq_viol.numpy(), jsol.eq_viol, rtol=1e-8, atol=1e-8)


# -- tests/test_synthesis.py -----------------------------------------------------


def test_com_offset_grid_is_15():
    grid = tsyn.com_offset_grid([0.01, 0.02, 0.03])
    assert len(grid) == 15  # center + 6 faces + 8 vertices
    assert np.allclose(grid[0], 0)
    np.testing.assert_array_equal(np.asarray(grid), np.asarray(jsyn.com_offset_grid([0.01, 0.02, 0.03])))


def test_worst_case_inertia_realizable():
    h = np.array([0.03, 0.03, 0.1])
    for com in tsyn.com_offset_grid(0.5 * h):
        I_diag = tsyn.max_min_eig_inertia(h, com, mass=0.5)
        np.testing.assert_allclose(I_diag, jsyn.max_min_eig_inertia(h, com, mass=0.5), **HOST)
        assert I_diag.shape == (3,)
        assert (I_diag >= -1e-12).all()
        V = tsyn.box_vertices(h)
        r2 = (V**2).sum(axis=1).max()
        assert I_diag.max() <= 0.5 * 2 * r2 + 1e-9


def test_worst_case_beats_uniform():
    from upright_tpu_torch.core.math import cuboid_inertia_matrix

    h = np.array([0.03, 0.03, 0.1])
    I_worst = tsyn.max_min_eig_inertia(h, np.zeros(3), mass=0.5)
    I_uniform = np.diag(cuboid_inertia_matrix(0.5, 2 * h))
    assert (I_worst > I_uniform).all()


def test_parse_robust_bounds():
    path = tcfg.resolve_package_path({"package": "configs", "path": "demos/robust_demo.yaml"})
    config = tcfg.load_config(path)
    half = tsyn.parse_robust_bounds(config["controller"])
    assert half is not None and len(half) == 1
    np.testing.assert_allclose(half[0], [0.02, 0.02, 0.07])
    half_approx = tsyn.parse_robust_bounds(config["controller"], approx=True)
    np.testing.assert_allclose(half_approx[0], [0.015, 0.015, 0.05])
    jconfig = jcfg.load_config(path)
    for approx in (False, True):
        np.testing.assert_array_equal(
            tsyn.parse_robust_bounds(config["controller"], approx=approx),
            jsyn.parse_robust_bounds(jconfig["controller"], approx=approx))


@pytest.mark.slow
def test_ral25_protocol_slice():
    """One waypoint x 15 CoM x 1 scale through the port's protocol pipeline."""
    from upright_tpu_torch.robust.planning import ral25_protocol

    path = tcfg.resolve_package_path({"package": "configs", "path": "demos/robust_demo.yaml"})
    config = tcfg.load_config(path)
    out = ral25_protocol(config, waypoints=[np.array([-0.25, 0.4, 0.2])],
                         inertia_scales=(1.0,), iterations=20, **CPU64)
    assert out["runs"] == 15
    assert out["failures"] == 0


# -- tests/test_realizable.py ----------------------------------------------------

MASS = 0.8
BOX_L = np.array([-0.04, -0.04, 0.0])
BOX_U = np.array([0.04, 0.04, 0.12])
COM_C = np.array([0.0, 0.0, 0.05])
RSET = dict(lower=BOX_L, upper=BOX_U, com_lower=COM_C - 1e-3, com_upper=COM_C + 1e-3, mass=MASS)


def realizable_both(mus):
    """The port's barrier and the JAX package's on the same objectives; the
    two agree to 1e-8.  Returns the port's (values, thetas)."""
    vals, thetas = treal.realizable_max_linear(mus, treal.RealizableSet(**RSET), device="cpu")
    jvals, jthetas = jreal.realizable_max_linear(mus, jreal.RealizableSet(**RSET))
    np.testing.assert_allclose(vals, jvals, **BARRIER)
    np.testing.assert_allclose(thetas, jthetas, **BARRIER)
    return vals, thetas


def test_realizable_rows_and_start_match():
    G, g = treal.RealizableSet(**RSET).linear_rows()
    jG, jg = jreal.RealizableSet(**RSET).linear_rows()
    np.testing.assert_array_equal(G, jG)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(treal.RealizableSet(**RSET).feasible_start(),
                                  jreal.RealizableSet(**RSET).feasible_start())
    theta = np.random.default_rng(0).standard_normal((5, 10))
    np.testing.assert_allclose(
        treal.pseudo_inertia(torch.as_tensor(theta)).numpy(),
        np.stack([np.asarray(jreal.pseudo_inertia(jnp.asarray(t))) for t in theta]), **HOST)


def test_mass_objective_exact():
    mu = np.zeros(10)
    mu[0] = 1.0
    vals, _ = realizable_both(mu[None])
    assert vals[0] == pytest.approx(MASS, rel=1e-6)


def test_com_objective_hits_com_box():
    mu = np.zeros(10)
    mu[3] = 1.0
    vals, _ = realizable_both(mu[None])
    assert vals[0] == pytest.approx(MASS * (COM_C[2] + 1e-3), rel=5e-3)


def test_second_moment_two_point_density():
    mu = np.zeros(10)
    mu[4 + 0] = 0.5
    mu[4 + 3] = 0.5
    mu[4 + 5] = -0.5
    vals, thetas = realizable_both(mu[None])
    l, u, cz = BOX_L[2], BOX_U[2], COM_C[2]
    exact = (l + u) * MASS * cz - l * u * MASS
    assert vals[0] == pytest.approx(exact, rel=2e-2)
    J = treal.pseudo_inertia(torch.as_tensor(thetas[0])).numpy()
    assert np.linalg.eigvalsh(J).min() > -1e-5


def test_monte_carlo_densities_are_inside():
    """Random point-mass densities on the box with the right CoM never beat
    the barrier max (containment), and the best comes close (tightness)."""
    rng = np.random.default_rng(42)
    mus = rng.standard_normal((4, 10))
    mus[:, 0] = 0.0
    vals, _ = realizable_both(mus)

    best = np.full(len(mus), -np.inf)
    for _ in range(3000):
        k = rng.integers(2, 6)
        pts = rng.uniform(BOX_L, BOX_U, size=(k, 3))
        w = rng.dirichlet(np.ones(k)) * MASS
        com = (w[:, None] * pts).sum(axis=0) / MASS
        if np.any(np.abs(com - COM_C) > 1e-3):
            pts_s = pts + (COM_C - com)
            if np.any(pts_s < BOX_L) or np.any(pts_s > BOX_U):
                continue
            pts = pts_s
        S = (w[:, None, None] * pts[:, :, None] * pts[:, None, :]).sum(axis=0)
        I = np.trace(S) * np.eye(3) - S
        h = (w[:, None] * pts).sum(axis=0)
        theta = np.concatenate([[MASS], h, [I[0, 0], I[0, 1], I[0, 2], I[1, 1], I[1, 2], I[2, 2]]])
        best = np.maximum(best, mus @ theta)

    assert np.all(best <= vals + 5e-3 * np.abs(vals) + 1e-4), (best, vals)
    assert np.all(best >= vals - 0.35 * np.abs(vals) - 0.01), (best, vals)
