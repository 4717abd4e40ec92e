"""The port's plant (``upright_tpu_torch/sim``) against the JAX package's.

Both packages build the same contact specs from a config and, from the same
state, step to the same state.  The port's plant runs its contact substeps
through ``sim/contact.py`` ``advance_objects``, which on CPU tensors is the
plain PyTorch version of the CUDA kernel P1.  All in float64 (jax x64, see
conftest.py): both sides differ in summation order only (the port sums
contact forces per object with index adds, solves the 3 x 3 inertia system
with torch.linalg.solve), so r, q, v, w and the stiction anchors agree to
1e-10 absolute over 3 outer steps (120 substeps) and the contact and latch
flags are identical.  States are made with numpy from seeds and carried
across with ``upright_tpu_torch.convert``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upright_tpu.config as jcfg
from upright_tpu.sim.simulation import ObjectsState as JObjectsState
from upright_tpu.sim.simulation import SimState as JSimState
from upright_tpu.sim.simulation import UprightSimulation as JSim
from upright_tpu_torch.convert import (
    plant_params_from_numpy,
    plant_params_to_numpy,
    sim_state_from_numpy,
    sim_state_to_numpy,
)
from upright_tpu_torch.kinematics.chain import FrameMotion
from upright_tpu_torch.sim.simulation import UprightSimulation

CPU64 = dict(device="cpu", dtype=torch.float64)
TOL = 1e-10
N_STEPS = 3


def sim_config(demo, arrangement=None, friction_model=None, command_frame=None):
    conf = jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": f"demos/{demo}.yaml"})
    )
    sc = dict(conf["simulation"])
    if arrangement is not None:
        sc["arrangement"] = arrangement
    if friction_model is not None:
        sc["friction_model"] = friction_model
    if command_frame is not None:
        # a yawed base, so that the body -> world mapping is not the identity
        home = list(jcfg.parse_array(sc["robot"]["home"]))
        home[2] = 0.7
        sc["robot"] = dict(sc["robot"], command_frame=command_frame, home=home)
    return sc


def to_jax(arrays):
    o = arrays["objects"]

    def tup(x):
        return None if x is None else tuple(jnp.asarray(a) for a in x)

    objects = JObjectsState(
        r=jnp.asarray(o["r"]), q=jnp.asarray(o["q"]), v=jnp.asarray(o["v"]),
        w=jnp.asarray(o["w"]), anchors=tup(o["anchors"]), anchor_valid=tup(o["anchor_valid"]),
        diverged=None if o["diverged"] is None else jnp.asarray(o["diverged"]),
    )
    return JSimState(t=jnp.asarray(arrays["t"]), q=jnp.asarray(arrays["q"]),
                     v=jnp.asarray(arrays["v"]), objects=objects)


def from_jax(state):
    o = state.objects

    def tup(x):
        return None if x is None else tuple(np.asarray(a) for a in x)

    return {"t": np.asarray(state.t), "q": np.asarray(state.q), "v": np.asarray(state.v),
            "objects": {"r": np.asarray(o.r), "q": np.asarray(o.q), "v": np.asarray(o.v),
                        "w": np.asarray(o.w), "anchors": tup(o.anchors),
                        "anchor_valid": tup(o.anchor_valid),
                        "diverged": None if o.diverged is None else np.asarray(o.diverged)}}


def assert_states_match(port, ref, tol=TOL):
    """port, ref: numpy dicts of sim_state_to_numpy's form."""
    for f in ("q", "v"):
        np.testing.assert_allclose(port[f], ref[f], rtol=0, atol=tol, err_msg=f)
    po, ro = port["objects"], ref["objects"]
    for f in ("r", "q", "v", "w"):
        np.testing.assert_allclose(po[f], ro[f], rtol=0, atol=tol, err_msg=f)
    assert (po["diverged"] is None) == (ro["diverged"] is None)
    if ro["diverged"] is not None:
        np.testing.assert_array_equal(po["diverged"], ro["diverged"])
    assert (po["anchors"] is None) == (ro["anchors"] is None)
    if ro["anchors"] is not None:
        for a, b, va, vb in zip(po["anchors"], ro["anchors"], po["anchor_valid"],
                                ro["anchor_valid"]):
            np.testing.assert_array_equal(va, vb, err_msg="anchor_valid")
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg="anchors")


def moving_state(sim, seed, batch=1, params=None):
    """The nominal state settled for 8 ms on a tray that starts to move under
    a small command (so the support vertices are in contact, clear of the
    contact threshold, and the objects move with the tray), then the objects
    nudged: (state, the next command)."""
    rng = np.random.default_rng(seed)
    n, nq = sim.n_obj, sim.robot.nq

    def noise(scale, *shape):
        return torch.as_tensor(scale * rng.standard_normal((batch,) + shape))

    cmd = noise(0.02, nq)
    s = sim.step(sim.initial_state(batch), cmd, n_steps=8, params=params)
    o = s.objects
    s = s.replace(objects=o.replace(v=o.v + noise(1e-3, n, 3), w=o.w + noise(1e-2, n, 3)))
    return s, cmd + noise(0.01, nq)


CASES = {
    "thing_stiction": ("thing_demo", None, "stiction", None),
    "thing_regularized": ("thing_demo", None, "regularized", None),
    "thing_body_frame": ("thing_demo", None, "stiction", "body"),
    "ur10_stiction": ("ur10_demo", None, "stiction", None),
    "box_arch_stiction": ("ur10_demo", "box_arch", "stiction", None),
    "box_arch_regularized": ("ur10_demo", "box_arch", "regularized", None),
    # seven cups on 112 contact slots: the plant kernel's block-wide route
    "blue_cups_stiction": ("ur10_demo", "blue_cups", "stiction", None),
    # two stacked dice, 77 substeps an outer step
    "foam_die2_stiction": ("ur10_demo", "foam_die2", "stiction", None),
}


@pytest.fixture(scope="module")
def sims():
    """(JAX plant, port plant) per case, built once: the JAX plant compiles
    its step once per instance."""
    cache = {}

    def get(case):
        if case not in cache:
            sc = sim_config(*CASES[case])
            cache[case] = (JSim(sc), UprightSimulation(sc, **CPU64))
        return cache[case]

    return get


@pytest.mark.parametrize(
    "demo,arrangement",
    [("thing_demo", None), ("ur10_demo", None), ("ur10_demo", "box_arch"),
     ("ur10_demo", "simulation_box_with_fixture"), ("ur10_demo", "blue_cups"),
     ("ur10_demo", "foam_die2")],
)
def test_specs_and_substeps_match(demo, arrangement):
    sc = sim_config(demo, arrangement)
    js, ts = JSim(sc), UprightSimulation(sc, **CPU64)
    assert ts.object_substeps == js.object_substeps
    assert ts.n_obj == js.n_obj and ts.n_obj >= 1
    for a, b in zip(ts.specs, js.specs):
        assert a.name == b.name and a.fixture == b.fixture
        for f in ("mass", "mu"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("inertia_local", "vertices_local", "com_world_ee", "q_init"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert len(a.surfaces) == len(b.surfaces)
        for sa, sb in zip(a.surfaces, b.surfaces):
            assert sa.parent == sb.parent and sa.max_depth == sb.max_depth
            for f in ("point", "normal", "half_extents", "tangents"):
                np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f), err_msg=f)
    # the slot tables hold every (object, surface, vertex) once
    assert ts.tables.n_slots == sum(len(sp.surfaces) * len(sp.vertices_local) for sp in ts.specs)
    np.testing.assert_array_equal(
        plant_params_to_numpy(ts.default_params())["inertia"],
        np.asarray(js.default_params()["inertia"]),
    )


@pytest.mark.parametrize("case", ["thing_stiction", "box_arch_regularized"])
def test_initial_state_matches(sims, case):
    js, ts = sims(case)
    port = sim_state_to_numpy(ts.initial_state(), ts)
    assert_states_match(port, from_jax(js.initial_state()), tol=1e-12)
    np.testing.assert_allclose(ts.object_displacements(ts.initial_state())[0],
                               js.object_displacements(js.initial_state()), atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference(sims, case):
    """3 outer steps (3 x object_substeps contact substeps) from a moving,
    in-contact state, per-instance parameters off their defaults."""
    js, ts = sims(case)
    rng = np.random.default_rng(7)
    params = plant_params_to_numpy(ts.default_params())
    params["mass"] = params["mass"] * rng.uniform(0.9, 1.1, ts.n_obj)
    params["mu"] = params["mu"] * rng.uniform(0.9, 1.1, ts.n_obj)
    # horizontal CoM shifts: the support vertices stay on their surfaces
    params["com_offset"] = rng.uniform(-2e-3, 2e-3, (ts.n_obj, 3)) * np.array([1.0, 1.0, 0.0])
    state, cmd = moving_state(ts, seed=1,
                              params=plant_params_from_numpy(params, **CPU64))

    arrays = sim_state_to_numpy(state, ts)
    ref = js.step(to_jax(arrays), cmd[0].numpy(), n_steps=N_STEPS,
                  params={k: jnp.asarray(v) for k, v in params.items()})
    back = sim_state_from_numpy(arrays, ts, **CPU64)
    out = ts.step(back, cmd, n_steps=N_STEPS, params=plant_params_from_numpy(params, **CPU64))
    assert_states_match(sim_state_to_numpy(out, ts), from_jax(ref))
    # the objects moved and, under stiction, some anchors stayed in contact
    moved = np.abs(out.objects.r.numpy() - state.objects.r.numpy()).max()
    assert moved > 1e-6
    if out.objects.anchors is not None:
        assert bool(out.objects.anchor_valid.any())


def test_divergence_latch_reads_inf(sims):
    """A non-finite velocity freezes the object at its last finite pose and
    latches ``diverged``; the displacement then reads inf, as in the JAX
    package."""
    js, ts = sims("thing_stiction")
    state, cmd = moving_state(ts, seed=11)
    state = state.replace(objects=state.objects.replace(
        v=torch.full_like(state.objects.v, float("nan"))))
    arrays = sim_state_to_numpy(state, ts)
    ref = js.step(to_jax(arrays), cmd[0].numpy(), n_steps=N_STEPS)
    out = ts.step(state, cmd, n_steps=N_STEPS)
    assert bool(out.objects.diverged.all()) and bool(np.asarray(ref.objects.diverged).all())
    assert np.isfinite(out.objects.r.numpy()).all()
    assert np.isinf(ts.object_displacements(out)).all()
    assert np.isinf(js.object_displacements(ref)).all()
    np.testing.assert_allclose(out.objects.r[0].numpy(), np.asarray(ref.objects.r), atol=TOL)


def test_batch_equals_single_runs():
    """B instances with their own state, command and parameters step as B
    single runs do (1e-12: the same float64 operations, batched)."""
    ts = UprightSimulation(sim_config("ur10_demo", "box_arch", "stiction"), **CPU64)
    B = 3
    state, cmd = moving_state(ts, seed=3, batch=B)
    params = ts.default_params(B)
    params["mu"] = params["mu"] * torch.linspace(0.8, 1.2, B)[:, None]
    out = ts.step(state, cmd, n_steps=2, params=params)
    for b in range(B):
        sl = slice(b, b + 1)
        single = state.replace(
            t=state.t[sl], q=state.q[sl], v=state.v[sl],
            objects=state.objects.replace(**{
                f: getattr(state.objects, f)[sl]
                for f in ("r", "q", "v", "w", "anchors", "anchor_valid", "diverged")}),
        )
        one = ts.step(single, cmd[sl], n_steps=2,
                      params={k: v[sl] for k, v in params.items()})
        assert_states_match(sim_state_to_numpy(one, ts), sim_state_to_numpy(out, ts, index=b),
                            tol=1e-12)


# -- closed-form physics through the prescribed-frame hook --------------------
# (tests/test_plant_physics.py's Coulomb slide threshold, at 0.1 s)

MU = 0.4


def physics_sim():
    ur10 = jcfg.load_config(
        jcfg.resolve_package_path({"package": "configs", "path": "robots/ur10.yaml"}))
    sc = {
        "timestep": 1e-3, "gravity": [0, 0, -9.81], "arrangement": "phys",
        "objects": {
            "ee": {"shape": "cuboid", "side_lengths": [0.285, 0.285, 0.02],
                   "position": [0, 0, -0.01]},
            "block": {"shape": "cuboid", "mass": 0.2, "com_offset": [0, 0, 0],
                      "side_lengths": [0.06, 0.06, 0.06]},
        },
        "arrangements": {"phys": {
            "objects": [{"name": "b", "type": "block", "parent": "ee"}],
            "contacts": [{"first": "ee", "second": "b", "mu": MU}],
        }},
        "robot": ur10["simulation"]["robot"],
    }
    return UprightSimulation(sc, **CPU64)


def rot_x(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def test_coulomb_threshold_through_the_prescribed_frame():
    """Instance 0: surface tilted to tan(theta) = 0.5 mu, the block holds.
    Instance 1: tan(theta) = 2 mu, it slides downhill at g (sin - mu cos)
    (within 35%, the reference test's bound).  The tray frame is prescribed
    per instance through the overridable ``_parent_motion``."""
    sim = physics_sim()
    thetas = [np.arctan(0.5 * MU), np.arctan(2.0 * MU)]
    Rs = torch.as_tensor(np.stack([rot_x(th) for th in thetas]))

    def prescribed(self, t, q, v):
        lead = t.shape
        z = torch.zeros(lead + (3,), dtype=t.dtype)
        return FrameMotion(R=Rs[:, None].expand(lead + (3, 3)), p=z, v=z, w=z, a=z, al=z)

    sim._parent_motion = types.MethodType(prescribed, sim)
    s0 = sim.initial_state(2)
    com = torch.as_tensor(sim.specs[0].com_world_ee)
    s0 = s0.replace(objects=s0.objects.replace(
        r=(Rs @ com)[:, None], q=torch.as_tensor(
            np.stack([[np.sin(th / 2), 0, 0, np.cos(th / 2)] for th in thetas]))[:, None]))
    T = 0.1
    s1 = sim.step(s0, torch.zeros(sim.robot.nq), n_steps=int(round(T / sim.timestep)))
    d = (s1.objects.r - s0.objects.r)[:, 0].numpy()
    normals = Rs.numpy()[:, :, 2]
    d_t = d - (d * normals).sum(-1, keepdims=True) * normals
    assert np.linalg.norm(d_t[0]) < 2e-3, d_t[0]
    th = thetas[1]
    d_expect = 0.5 * 9.81 * (np.sin(th) - MU * np.cos(th)) * T * T
    disp = np.linalg.norm(d_t[1])
    assert abs(disp - d_expect) < 0.35 * d_expect, (disp, d_expect)
    g = np.array([0.0, 0, -9.81])
    g_t = g - (g @ normals[1]) * normals[1]
    assert d_t[1] @ (g_t / np.linalg.norm(g_t)) > 0.9 * disp
