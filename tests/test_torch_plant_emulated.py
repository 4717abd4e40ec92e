"""The device code of the plant's CUDA kernel P1, run on the CPU against the
kernel's plain version.

Between them the cases take both routes of the kernel (one warp for at most
32 slots; block-wide for blue_cups and the fixture box) with both friction
models.  The kernel itself runs only on a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Here ``upright_tpu_torch/tools/emulate_plant.py``
compiles the device code of ``csrc/plant.cu`` with the host's C++ compiler,
one pthread per CUDA thread, and runs it in float64 on one control tick (10
outer steps of 40 or more contact substeps) from a moving, in-contact start
(``tools/plant_data.py``, numpy seeds).  Both sides are float64 and differ in
summation order, in the 3 x 3 solve (Cramer's rule against LU) and in fused
multiply-adds only, so every field agrees to 1e-10 absolute and the contact
and latch flags are identical.  Shared memory starts as NaN patterns, so a
read before a write shows.
"""

import shutil

import numpy as np
import pytest
import torch

from upright_tpu_torch.sim.contact import advance_objects_plain
from upright_tpu_torch.tools import emulate_plant
from upright_tpu_torch.tools.plant_data import (
    F32_TOL,
    float32_witness,
    max_errors,
    plant_for,
    tick_inputs,
)

TOL = 1e-10


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation harness")
    return emulate_plant.build(tmp_path_factory.mktemp("plant_emulation"))


@pytest.mark.parametrize(
    "demo,arrangement,friction,batch,diverge",
    [
        ("thing_demo", None, "stiction", 2, ()),  # the main path's tick
        ("thing_demo", None, "regularized", 2, ()),
        ("ur10_demo", "box_arch", "stiction", 2, ()),  # stacked: reactions, two surfaces
        ("ur10_demo", "box_arch", "regularized", 1, ()),
        # fixture faces: 84 slots, three warps (the block-wide route), pieces
        # cut at the warps' edges
        ("ur10_demo", "simulation_box_with_fixture", "stiction", 1, ()),
        ("thing_demo", None, "stiction", 3, (1,)),  # instance 1 trips the divergence latch
        # 7 objects on 112 slots: four warps, the block-wide route
        ("ur10_demo", "blue_cups", "stiction", 1, ()),
        ("ur10_demo", "blue_cups", "regularized", 1, ()),
        # stacked dice: a reaction on one warp, 77 substeps an outer step (more
        # frames than lanes)
        ("ur10_demo", "foam_die2", "stiction", 2, ()),
    ],
    ids=["thing", "thing_regularized", "stacked", "stacked_regularized", "fixture", "latch",
         "cups", "cups_regularized", "dice"],
)
def test_emulated_kernel_matches_plain(harness, demo, arrangement, friction, batch, diverge):
    sim = plant_for(demo, arrangement, friction)
    frames, objects, params = tick_inputs(sim, batch, seed=batch, diverge=diverge)
    ref = advance_objects_plain(sim.tables, sim.contact, frames, objects, params)
    out = emulate_plant.run(harness, sim.tables, sim.contact, frames, objects, params)
    err, same = max_errors(out, ref)
    assert same, "contact or latch flags differ"
    assert max(err.values()) <= TOL, err
    # the tick did something: the objects moved, and stayed on the tray
    assert float((ref.r - objects.r).abs().max()) > 1e-5
    if ref.anchor_valid is not None:
        assert bool(ref.anchor_valid.any())
    latched = ref.diverged.any(-1).numpy()
    np.testing.assert_array_equal(np.flatnonzero(latched), list(diverge))
    # the non-finite substep is held at the last finite pose, and the latch stays
    assert torch.isfinite(out.r).all() and torch.isfinite(out.v).all()


def test_emulated_float32_kernel_tracks_float64(harness):
    """The float32 instance on the main path's tick: within chip_smoke.py's
    float32 limits (tools/plant_data.py F32_TOL) of the witness, the plain
    version in float32 on the same inputs, which the control exceeds in
    every field; so it is as far from the float64 result as float32 rounding puts
    the witness."""
    sim = plant_for("thing_demo")
    frames, objects, params = tick_inputs(sim, 2, seed=5)
    ref = advance_objects_plain(sim.tables, sim.contact, frames, objects, params)
    witness, control = float32_witness(sim.tables, sim.contact, frames, objects, params)
    out = emulate_plant.run(harness, sim.tables, sim.contact, frames, objects, params,
                            precision="f")
    err, _same = max_errors(out, witness)
    err_ctl, _ = max_errors(control, witness)
    err_ref, err_wit = max_errors(out, ref)[0], max_errors(witness, ref)[0]
    for field, tol in F32_TOL.items():
        assert err[field] <= tol, (field, err)
        assert err_ref[field] <= err_wit[field] + tol, (field, err_ref, err_wit)
    assert all(err_ctl[k] > tol for k, tol in F32_TOL.items()), err_ctl
