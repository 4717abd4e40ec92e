"""The CUDA kernels on the card (Riccati K1, plant P1, the chain's K2), at the
edges of what they take.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests and the
port do not need.)

``chip_smoke.py`` holds the kernel against its plain version at the
main-path shapes; these cover the rest: the narrowest input block, the
widths on each side of the switch to the wide route (nu = 16, 17) and of the
jitter (24, 25), a full warp of inputs (32), 45, the stage data the solver
hands the kernel at every ral23 width (float64 too, 27/57, 27/93 and 18/90
included), a shape past the wide route's shared memory, the three Jacobian
modes of the stage derivatives, a single stage
and a long horizon, odd widths (rows that cannot be copied 16 bytes at a
time), a shape whose shared memory exceeds the 48 KB static limit (the opt-in
attribute path), both input forms, the instances compiled for the shipped
widths against the runtime-sized one, float64, and what the wrapper refuses.
K2 is held against the plain sweep in both modes and dtypes, at one point and
at the solve cell's points, through the solver's three Jacobian modes, and
counted: one Jacobian launch per jacfwd sweep.
"""

import pytest
import torch

from upright_tpu_torch.sim import contact
from upright_tpu_torch.solver import riccati
from upright_tpu_torch.tools.plant_data import (
    F32_TOL,
    float32_witness,
    max_errors,
    objects_to,
    plant_for,
    tick_inputs,
)
from upright_tpu_torch.tools.stage_data import solver_stage_data, stage_data

pytestmark = pytest.mark.gpu

REG = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape",
    [
        (3, 1, 4, 2),  # a single stage
        (5, 7, 6, 1),  # one input
        (3, 6, 12, 16),  # the widest register elimination of the runtime-sized instance
        (3, 6, 12, 17),  # the narrowest of the wide route
        (2, 3, 70, 16),  # more column groups than warps: two passes of the register elimination
        (4, 9, 10, 24),  # the widest input block of the clamped route
        (4, 9, 10, 25),  # the narrowest of the jittered route
        (3, 6, 12, 32),  # a full warp of input columns
        (3, 8, 27, 45),  # the frictional three-object width
        (3, 5, 7, 4),  # odd nx and nz: element-sized copies only
        (2, 5, 60, 20),  # 92 KB of shared memory: above the static limit
        (300, 20, 27, 13),  # more blocks than SMs, main-path widths
        (5, 20, 18, 10),  # the arm-only widths
        (2, 200, 27, 13),  # a long horizon
    ],
    ids=lambda s: "x".join(map(str, s)),
)
@pytest.mark.parametrize("invariant", [False, True], ids=["form_a", "form_b"])
def test_kernel_matches_plain_float64(card, shape, invariant):
    """float32 kernel against the float64 plain version: K and kff are O(1)
    on this conditioning, 1e-4 absolute (see chip_smoke.py)."""
    arrays = stage_data(*shape, seed=sum(shape), invariant=invariant)
    f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays)
    before = riccati.launch_count
    K, kff = riccati.riccati_backward(*f32, reg=REG)
    torch.cuda.synchronize()
    assert riccati.launch_count == before + 1
    K_ref, kff_ref = riccati.riccati_backward_plain(*(t.double() for t in f32), reg=REG)
    assert K.shape == K_ref.shape and K.dtype == torch.float32
    assert float((K.double() - K_ref).abs().max()) < 1e-4
    assert float((kff.double() - kff_ref).abs().max()) < 1e-4


@pytest.mark.parametrize(
    "shape",
    [(3, 1, 4, 2), (3, 6, 12, 16), (3, 6, 12, 17), (4, 9, 10, 24), (4, 9, 10, 25),
     (3, 8, 27, 45), (3, 5, 7, 4), (16, 20, 27, 13), (2, 200, 27, 13),
     (3, 6, 27, 93), (2, 5, 27, 96)],  # the wide route's widest shipped and widest float64 width
    ids=lambda s: "x".join(map(str, s)),
)
@pytest.mark.parametrize("invariant", [False, True], ids=["form_a", "form_b"])
def test_float64_kernel_matches_plain_to_rounding(card, shape, invariant):
    """Both sides float64: they differ in summation order only, so 1e-10 of
    the largest entry, tight enough to catch an indexing fault at a tile edge
    that a float32 comparison would let through."""
    arrays = stage_data(*shape, seed=sum(shape), invariant=invariant)
    f64 = tuple(torch.as_tensor(a, dtype=torch.float64, device=card) for a in arrays)
    K, kff = riccati.riccati_backward(*f64, reg=REG)
    torch.cuda.synchronize()
    K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=REG)
    assert K.dtype == torch.float64
    scale = max(1.0, float(K_ref.abs().max()))
    assert float((K - K_ref).abs().max()) < 1e-10 * scale
    assert float((kff - kff_ref).abs().max()) < 1e-10 * scale


@pytest.mark.parametrize("shape", [(64, 20, 27, 13), (64, 20, 18, 10)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("invariant", [False, True], ids=["form_a", "form_b"])
def test_specialised_instance_matches_runtime_sized(card, shape, invariant):
    """The instances compiled for the shipped widths and the runtime-sized one
    compute the same recursion and differ at most in float32 rounding (the
    compiler may order the products' sums differently): 2e-5 of the largest
    entry, against 3e-6 between either and float64 on an H100."""
    arrays = stage_data(*shape, seed=sum(shape), invariant=invariant)
    f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays)
    K_s, kff_s = riccati.riccati_backward(*f32, reg=REG)
    K_r, kff_r = riccati._riccati_backward_cuda(*f32, REG, runtime_sized=True)
    torch.cuda.synchronize()
    scale = max(1.0, float(K_r.abs().max()))
    assert float((K_s - K_r).abs().max()) < 2e-5 * scale
    assert float((kff_s - kff_r).abs().max()) < 2e-5 * scale


def test_kernel_runs_on_the_current_stream(card):
    """Launched on a side stream, the kernel is ordered after the work that
    made its inputs on that stream and before the work that reads K."""
    arrays = stage_data(8, 20, 27, 13, seed=1, invariant=True)
    f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays)
    K_ref, _ = riccati.riccati_backward(*f32, reg=REG)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scaled = tuple(t * 1.0 for t in f32)  # inputs produced on the side stream
        K, _ = riccati.riccati_backward(*scaled, reg=REG)
        total = K.sum()
    side.synchronize()
    assert torch.equal(K, K_ref)
    assert torch.isfinite(total)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    arrays = stage_data(2, 3, 4, 2, seed=2)
    f32 = [torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays]
    before = riccati.launch_count
    with pytest.raises(TypeError, match="one dtype"):  # mixed dtypes
        bad = list(f32)
        bad[4] = f32[4].double()
        riccati.riccati_backward(*bad, reg=REG)
    with pytest.raises(TypeError, match="float32 or float64"):
        riccati.riccati_backward(*(t.bfloat16() for t in f32), reg=REG)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(f32)
        bad[4] = f32[4].transpose(-1, -2)
        riccati.riccati_backward(*bad, reg=REG)
    with pytest.raises(ValueError, match="is on cpu"):
        bad = list(f32)
        bad[0] = f32[0].cpu()
        riccati.riccati_backward(*bad, reg=REG)
    with pytest.raises(ValueError, match="shared memory"):
        huge = stage_data(1, 1, 100, 60, seed=3)
        riccati.riccati_backward(
            *(torch.as_tensor(a, dtype=torch.float32, device=card) for a in huge), reg=REG)
    assert riccati.launch_count == before  # nothing was launched


# -- K1 on the solver's own stage data ----------------------------------------------

# (config, batch): the widths the solver hands K1 on this slice's problems
SOLVER_WIDTHS = {
    "27x21": ("ral23/static_obstacles/full_bottle_point1.yaml", 16),
    "18x18": ("demos/ur10_friction_demo.yaml", 16),
    "36x13": ("ral23/sudden_obstacle/sudden_t1.0.yaml", 16),
    "27x33": ("ral23/freespace/full_dice_point1.yaml", 8),
    "27x93": ("ral23/static_obstacles/full_cups_point2.yaml", 4),
    # the other widths of the ral23 configs
    "27x17": ("ral23/static_obstacles/robust_dice_point1.yaml", 8),
    "27x25": ("ral23/static_obstacles/robust_arch_point1.yaml", 8),
    "27x37": ("ral23/static_obstacles/robust_cups_point1.yaml", 8),
    "18x22": ("ral23/static_obstacles/robust_arch_arm_only.yaml", 8),
    "18x34": ("ral23/static_obstacles/robust_cups_arm_only.yaml", 8),
    "18x54": ("ral23/static_obstacles/full_arch_arm_only.yaml", 8),
    "27x57": ("ral23/freespace/full_arch_point1.yaml", 4),
    "18x90": ("ral23/static_obstacles/full_cups_arm_only.yaml", 4),
}


@pytest.fixture(scope="module")
def solver_data():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    cache = {}

    def get(width):
        if width not in cache:
            path, batch = SOLVER_WIDTHS[width]
            cache[width] = solver_stage_data(path, batch)
        return cache[width]

    return get


@pytest.mark.parametrize("width", list(SOLVER_WIDTHS))
def test_kernel_matches_plain_on_solver_stage_data(solver_data, width):
    """The stage data of the second iteration of a cold solve on the card:
    the float32 kernel within 1e-3 of the largest entry of the float64 plain
    version (on this data the plain version in float32 is itself 1.2e-4 off
    at 27/21, see chip_smoke.py phase 11), and the float64 kernel within 1e-10
    of it."""
    data = solver_data(width)
    nx, nu = data[2].shape[-1], data[1].shape[-1]
    assert f"{nx}x{nu}" == width
    f64 = tuple(t.double() for t in data)
    K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=REG)
    scale = max(1.0, float(K_ref.abs().max()))
    K, kff = riccati.riccati_backward(*data, reg=REG)
    torch.cuda.synchronize()
    assert float((K.double() - K_ref).abs().max()) < 1e-3 * scale
    assert float((kff.double() - kff_ref).abs().max()) < 1e-3 * scale
    K64, kff64 = riccati.riccati_backward(*f64, reg=REG)
    torch.cuda.synchronize()
    assert float((K64 - K_ref).abs().max()) < 1e-10 * scale
    assert float((kff64 - kff_ref).abs().max()) < 1e-10 * scale


@pytest.mark.parametrize("width", ["27x57", "27x93", "18x90"])
def test_float64_runs_at_every_shipped_width(solver_data, width):
    """The three widest shipped widths, whose float64 blocks take the most
    shared memory: each fits under MAX_SMEM_BYTES and launches, within 1e-10
    of the largest entry of the float64 plain version."""
    data = solver_data(width)
    nx, nu = data[2].shape[-1], data[1].shape[-1]
    assert riccati.smem_bytes(nx, nu, torch.float64, True) <= riccati.MAX_SMEM_BYTES
    f64 = tuple(t.double() for t in data)
    before = riccati.launch_count
    K, kff = riccati.riccati_backward(*f64, reg=REG)
    torch.cuda.synchronize()
    assert riccati.launch_count == before + 1
    K_ref, kff_ref = riccati.riccati_backward_plain(*f64, reg=REG)
    scale = max(1.0, float(K_ref.abs().max()))
    assert float((K - K_ref).abs().max()) < 1e-10 * scale
    assert float((kff - kff_ref).abs().max()) < 1e-10 * scale


def test_shape_past_the_wide_route_raises(card):
    """nx 27, nu 97 in float64 needs more shared memory a block than the card
    has (nu 96 is the widest that fits): ValueError naming the limit, and
    nothing launched; float32 fits."""
    assert riccati.smem_bytes(27, 96, torch.float64, True) <= riccati.MAX_SMEM_BYTES
    assert riccati.smem_bytes(27, 97, torch.float32, True) <= riccati.MAX_SMEM_BYTES
    assert riccati.smem_bytes(27, 97, torch.float64, True) > riccati.MAX_SMEM_BYTES
    arrays = stage_data(1, 2, 27, 97, seed=5, invariant=True)
    before = riccati.launch_count
    with pytest.raises(ValueError, match=f"one block has {riccati.MAX_SMEM_BYTES}"):
        riccati.riccati_backward(
            *(torch.as_tensor(a, dtype=torch.float64, device=card) for a in arrays), reg=REG)
    assert riccati.launch_count == before


@pytest.mark.parametrize("config", ["demos/thing_demo.yaml",
                                    "ral23/static_obstacles/full_bottle_point1.yaml",
                                    "ral23/sudden_obstacle/sudden_t1.0.yaml"])
def test_jacobian_modes_agree_on_the_card(card, config):
    """The stage derivatives in the three Jacobian modes (one wide jacfwd,
    one per block of x-columns, one jacrev) at batch 8 in float32: the same
    to float32 rounding, 1e-4 of the largest entry."""
    import dataclasses

    import numpy as np

    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import broadcast_params
    from upright_tpu_torch.solver import al

    prob = build_problem(cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": config})))
    o = prob.ocp
    rng = np.random.default_rng(0)
    B = 8

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=card)

    x = t(prob.x0.cpu().numpy() + 0.05 * rng.standard_normal((B, o.N, o.nx)))
    u = t(0.1 * rng.standard_normal((B, o.N, o.nu)))
    lam = t(rng.standard_normal((B, o.N, o.n_eq)))
    mu = t(np.abs(rng.standard_normal((B, o.N, o.n_ineq))))
    p = broadcast_params(prob.stage_params(0.0), B)["stage"]
    nq = prob.dims.robot_q
    blocks = (nq,) * 3 + ((9 * prob.dims.num_obstacles,) if prob.dims.num_obstacles else ())
    out = {}
    for mode, kw in (("wide", dict(x_jac_blocks=None, jac_mode="fwd")),
                     ("blocked", dict(x_jac_blocks=blocks, jac_mode="fwd")),
                     ("rev", dict(x_jac_blocks=None, jac_mode="rev"))):
        ocp = dataclasses.replace(o, **kw)
        out[mode] = al._stage_derivatives(ocp, al.ALConfig(), x, u, p, lam, mu)
    g_ref, H_ref = out["wide"]
    assert g_ref.dtype == torch.float32 and bool(torch.isfinite(H_ref).all())
    for mode in ("blocked", "rev"):
        g, H = out[mode]
        assert g.dtype == H.dtype == torch.float32
        assert float((g - g_ref).abs().max()) <= 1e-4 * max(1.0, float(g_ref.abs().max()))
        assert float((H - H_ref).abs().max()) <= 1e-4 * max(1.0, float(H_ref.abs().max()))


# -- the plant's contact kernel P1 ----------------------------------------------


def plant_case(card, demo, arrangement, friction, batch, dtype, diverge=()):
    """One tick's inputs made on the CPU in float64, on the card as dtype,
    and the plain version's float64 result on the card."""
    sim = plant_for(demo, arrangement, friction)
    frames, objects, params = tick_inputs(sim, batch, seed=batch, diverge=diverge)
    tables = sim.tables.to(device=card)
    f64 = (frames.to(card), objects_to(objects, card, torch.float64),
           {k: v.to(card) for k, v in params.items()})
    ref = contact.advance_objects_plain(tables, sim.contact, *f64)
    inputs = (frames.to(card, dtype), objects_to(objects, card, dtype),
              {k: v.to(card, dtype) for k, v in params.items()})
    return sim, tables.to(dtype=dtype), inputs, ref


@pytest.mark.parametrize(
    "demo,arrangement,friction,batch,diverge",
    [
        ("thing_demo", None, "stiction", 1, ()),
        ("thing_demo", None, "stiction", 64, ()),
        ("thing_demo", None, "regularized", 8, ()),
        ("ur10_demo", "box_arch", "stiction", 8, ()),
        ("ur10_demo", "blue_cups", "stiction", 2, ()),  # 7 objects, 112 slots: four warps
        ("ur10_demo", "blue_cups", "regularized", 2, ()),
        ("ur10_demo", "simulation_box_with_fixture", "stiction", 4, ()),  # pieces cut at warps
        ("ur10_demo", "foam_die2", "stiction", 4, ()),  # stacked dice, 77 substeps a step
        ("thing_demo", None, "stiction", 4, (0, 2)),
    ],
    ids=["thing_b1", "thing_b64", "regularized", "stacked", "cups", "cups_regularized",
         "fixture", "dice", "latch"],
)
def test_plant_kernel_float64_matches_plain(card, demo, arrangement, friction, batch, diverge):
    """float64 kernel against the float64 plain version over one tick: 1e-10
    absolute, identical contact and latch flags (see chip_smoke.py)."""
    sim, tables, inputs, ref = plant_case(card, demo, arrangement, friction, batch,
                                          torch.float64, diverge)
    before = contact.launch_count
    out = contact.advance_objects(tables, sim.contact, *inputs)
    torch.cuda.synchronize()
    assert contact.launch_count == before + 1
    err, same = max_errors(out, ref)
    assert same and max(err.values()) < 1e-10, err


def check_float32_against_witness(card, demo, arrangement, batch):
    sim, tables, inputs, ref = plant_case(card, demo, arrangement, "stiction", batch,
                                          torch.float32)
    out = contact.advance_objects(tables, sim.contact, *inputs)
    witness, control = float32_witness(tables, sim.contact, *inputs)
    torch.cuda.synchronize()
    assert out.r.dtype == torch.float32
    err, _same = max_errors(out, witness)
    err_ctl, _ = max_errors(control, witness)
    err_ref, err_wit = max_errors(out, ref)[0], max_errors(witness, ref)[0]
    for field, tol in F32_TOL.items():
        assert err[field] <= tol, (field, err)
        assert err_ref[field] <= err_wit[field] + tol, (field, err_ref, err_wit)
    assert all(err_ctl[k] > tol for k, tol in F32_TOL.items()), err_ctl


def test_plant_kernel_float32_tracks_float64(card):
    """float32 kernel within chip_smoke.py's float32 limits
    (tools/plant_data.py F32_TOL) of the witness, the plain version in
    float32 on the same inputs, which the control exceeds in every field; so it
    is as far from the float64 result as float32 rounding puts the witness."""
    check_float32_against_witness(card, "thing_demo", None, 64)


def test_plant_kernel_float32_blue_cups(card):
    """The same on seven cups, whose stiff contacts amplify rounding most: a
    kernel compiled with fused multiply-adds reads w 1.2e-3 against the
    witness here (PERF.md), over its limit of 1e-3."""
    check_float32_against_witness(card, "ur10_demo", "blue_cups", 2)


def test_plant_kernel_float32_dice(card):
    """The two stacked dice (77 substeps a step) at the batch of a ral23 dice
    group amplify float32 rounding past F32_TOL: on an H100 the kernel and
    the witness are both 0.29 rad/s in w from float64 and 7.5e-3 from each
    other (chip_smoke.py phase 7).  The float32 kernel is held nearer the
    witness than the control in every field, and the control over every
    float32 limit."""
    sim, tables, inputs, _ref = plant_case(card, "ur10_demo", "foam_die2", "stiction", 3,
                                           torch.float32)
    out = contact.advance_objects(tables, sim.contact, *inputs)
    witness, control = float32_witness(tables, sim.contact, *inputs)
    torch.cuda.synchronize()
    err, same = max_errors(out, witness)
    err_ctl, _ = max_errors(control, witness)
    assert same and all(err[k] < err_ctl[k] for k in err), (err, err_ctl)
    assert all(err_ctl[k] > tol for k, tol in F32_TOL.items()), err_ctl


def test_plant_wrapper_refuses_what_the_kernel_does_not_take(card):
    sim, tables, (frames, objects, params), _ref = plant_case(
        card, "thing_demo", None, "stiction", 2, torch.float32)
    before = contact.launch_count
    with pytest.raises(TypeError, match="one dtype"):
        contact.advance_objects(tables, sim.contact, frames, objects.replace(r=objects.r.double()),
                                params)
    with pytest.raises(TypeError, match="float32 or float64"):
        contact.advance_objects(tables, sim.contact, frames.bfloat16(), objects, params)
    with pytest.raises(ValueError, match="is on cpu"):
        contact.advance_objects(tables, sim.contact, frames, objects.replace(q=objects.q.cpu()),
                                params)
    many = plant_for("ur10_demo", "blue_cups").tables
    big = many.__class__(n_obj=many.n_obj, s_max=many.s_max, k_max=many.k_max,
                         slot_int=many.slot_int.repeat(3, 1), slot_geom=many.slot_geom.repeat(3, 1),
                         obj_int=many.obj_int, obj_data=many.obj_data)
    with pytest.raises(ValueError, match="at most 256"):
        contact.advance_objects(big.to(device=card, dtype=torch.float32), sim.contact, frames,
                                objects, params)
    assert contact.launch_count == before  # nothing was launched


# -- the kinematic chain's kernel K2 ---------------------------------------------

CHAIN_CONFIGS = ("demos/thing_demo.yaml", "ral23/static_obstacles/full_bottle_point1.yaml")


def chain_of(path):
    """(chain, the frames the config's collision spheres hang on or a spread)."""
    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.kinematics.robot import build_robot_model

    ctrl = cfg.load_config(cfg.resolve_package_path({"package": "configs", "path": path}))[
        "controller"]
    chain = build_robot_model(ctrl["robot"]).chain
    spheres = ctrl.get("obstacles", {}).get("collision_spheres", [])
    frames = tuple(dict.fromkeys(chain.joint_names.index(s["link"]) for s in spheres))
    return chain, frames or (0, len(chain.joints) // 2, len(chain.joints) - 1)


@pytest.mark.parametrize("points", [1, 16384 * 20])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("path", CHAIN_CONFIGS)
def test_k2_matches_the_plain_chain(card, path, dtype, tol, points):
    """Both modes against the plain sweep in the same dtype, on the card: the
    EE's motion along (q, v, a), the collision frames' poses along q, at one
    point and at the solve cell's points (B 16,384 x N 20); of the largest
    entry."""
    from upright_tpu_torch.kinematics import chain as ch

    chain, frames = chain_of(path)
    nq, last = chain.nq, len(chain.joints) - 1
    gen = torch.Generator(device=card)
    gen.manual_seed(points)
    x = torch.randn(points, 3 * nq, generator=gen, device=card, dtype=dtype)
    q, v, a = x[:, :nq], x[:, nq:2 * nq], x[:, 2 * nq:]
    for req, (vv, aa), n_dir in ((ch.SweepRequest(chain, (last,), last), (v, a), 3 * nq),
                                 (ch.SweepRequest(chain, frames), (None, None), nq)):
        before = dict(ch.launch_count)
        got = (ch.K2.value(req, q, vv, aa), ch.K2.jacobian(req, q, vv, aa, n_dir))
        assert ch.launch_count == {"value": before["value"] + 1,
                                   "jacobian": before["jacobian"] + 1}
        want = (ch.PlainSweep.value(req, q, vv, aa), ch.PlainSweep.jacobian(req, q, vv, aa, n_dir))
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == dtype
            assert float((g - w).abs().max()) <= tol * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("path", CHAIN_CONFIGS)
def test_k2_stage_derivatives_match_the_plain_sweep(card, path):
    """The stage derivatives in the three Jacobian modes through K2 against
    the same through the plain sweep, float64 at batch 8: 1e-10 of the
    largest entry."""
    import dataclasses

    import numpy as np

    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.kinematics.chain import PlainSweep
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import broadcast_params
    from upright_tpu_torch.solver import al

    prob = build_problem(cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": path})), dtype=torch.float64)
    o = prob.ocp
    rng = np.random.default_rng(1)
    B = 8

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=card)

    x = t(prob.x0.cpu().numpy() + 0.05 * rng.standard_normal((B, o.N, o.nx)))
    u = t(0.1 * rng.standard_normal((B, o.N, o.nu)))
    lam = t(rng.standard_normal((B, o.N, o.n_eq)))
    mu = t(np.abs(rng.standard_normal((B, o.N, o.n_ineq))))
    p = broadcast_params(prob.stage_params(0.0), B)["stage"]
    nq = prob.dims.robot_q
    blocks = (nq,) * 3 + ((9 * prob.dims.num_obstacles,) if prob.dims.num_obstacles else ())
    for kw in (dict(x_jac_blocks=None, jac_mode="fwd"), dict(x_jac_blocks=blocks, jac_mode="fwd"),
               dict(x_jac_blocks=None, jac_mode="rev")):
        ocp = dataclasses.replace(o, **kw)
        got = al._stage_derivatives(ocp, al.ALConfig(), x, u, p, lam, mu)
        prob.robot.chain.kernel = PlainSweep
        try:
            want = al._stage_derivatives(ocp, al.ALConfig(), x, u, p, lam, mu)
        finally:
            prob.robot.chain.kernel = None
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-10 * max(1.0, float(w.abs().max()))


def test_one_k2_jacobian_launch_per_jacfwd_sweep(card):
    """A vmap(jacfwd(...)) of one sweep launches K2 once in each mode; the
    solver's wide linearization sweeps twice (residuals and equality rows)."""
    import numpy as np
    from torch.func import jacfwd, vmap

    import upright_tpu_torch.config as cfg
    from upright_tpu_torch.kinematics import chain as ch
    from upright_tpu_torch.ocp.problem import build_problem
    from upright_tpu_torch.parallel.batch import broadcast_params
    from upright_tpu_torch.solver import al

    chain, _ = chain_of(CHAIN_CONFIGS[0])
    nq = chain.nq
    x = torch.randn(64, 3 * nq, device=card)

    def ee_p(x_):
        return chain.ee_motion(x_[:nq], x_[nq:2 * nq], x_[2 * nq:]).p

    before = dict(ch.launch_count)
    vmap(jacfwd(ee_p))(x)
    assert ch.launch_count == {"value": before["value"] + 1, "jacobian": before["jacobian"] + 1}

    prob = build_problem(cfg.load_config(cfg.resolve_package_path(
        {"package": "configs", "path": CHAIN_CONFIGS[0]})))
    o = prob.ocp
    B = 4
    rng = np.random.default_rng(2)
    xs = torch.as_tensor(prob.x0.cpu().numpy() + 0.05 * rng.standard_normal((B, o.N, o.nx)),
                         dtype=torch.float32, device=card)
    us = torch.zeros((B, o.N, o.nu), device=card)
    lam = torch.zeros((B, o.N, o.n_eq), device=card)
    mu = torch.zeros((B, o.N, o.n_ineq), device=card)
    p = broadcast_params(prob.stage_params(0.0), B)["stage"]
    before = dict(ch.launch_count)
    al._stage_derivatives(o, al.ALConfig(), xs, us, p, lam, mu)
    assert ch.launch_count["jacobian"] - before["jacobian"] == 2


def test_k2_refuses_what_it_does_not_take(card):
    from upright_tpu_torch.kinematics import chain as ch

    chain, _ = chain_of(CHAIN_CONFIGS[0])
    req = ch.SweepRequest(chain, (len(chain.joints) - 1,))
    q = torch.zeros(4, chain.nq, device=card)
    before = dict(ch.launch_count)
    with pytest.raises(TypeError, match="float32 or float64"):
        ch.K2.value(req, q.half(), None, None)
    with pytest.raises(TypeError, match="q is"):
        ch.K2.value(req, q, q.double(), None)
    with pytest.raises(ValueError, match="coordinates"):
        ch.K2.value(req, q[:, :3], None, None)
    assert ch.launch_count == before
