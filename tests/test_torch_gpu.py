"""The CUDA kernels on the card (Riccati K1, plant P1), at the edges of what
they take.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests and the
port do not need.)

``chip_smoke.py`` holds the kernel against its plain version at the
main-path shapes; these cover the rest: the narrowest input block and the
widths on each side of the route switch (nu = 24, 25, 32, 45), a single stage
and a long horizon, odd widths (rows that cannot be copied 16 bytes at a
time), a shape whose shared memory exceeds the 48 KB static limit (the opt-in
attribute path), both input forms, the instances compiled for the shipped
widths against the runtime-sized one, float64, and what the wrapper refuses.
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
from upright_tpu_torch.tools.stage_data import stage_data

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
        (3, 6, 12, 17),  # the narrowest elimination in shared memory
        (2, 3, 70, 16),  # more column groups than warps: two passes of the register elimination
        (4, 9, 10, 24),  # the widest input block of the clamped route
        (4, 9, 10, 25),  # the narrowest of the jittered route
        (3, 6, 12, 32),  # a full warp of input columns
        (3, 8, 27, 45),  # the frictional three-object width
        (3, 5, 7, 4),  # odd nx and nz: element-sized copies only
        (2, 5, 60, 20),  # 143 KB of shared memory: above the static limit
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
     (3, 8, 27, 45), (3, 5, 7, 4), (16, 20, 27, 13), (2, 200, 27, 13)],
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
