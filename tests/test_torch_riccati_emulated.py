"""The device code of the Riccati CUDA kernel, run on the CPU against the JAX
package's sequential backward pass and against the port's plain version.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).  Here ``upright_tpu_torch/tools/emulate_riccati.py``
compiles the device code of ``csrc/riccati.cu`` with the host's C++ compiler,
one pthread per CUDA thread, and each instantiation is run in float64: all
sides float64 and differing in summation order only, so 1e-8 against
``upright_tpu.solver.al._backward_pass`` (the tolerance the plain version is
held to in ``test_torch_riccati.py``) and 1e-10 of the largest entry against
the plain version.  The specialised instances, float32 on the card, run in
float64 here as well, which holds their indexing to the same tolerances.
Against the reference every case runs twice: with each asynchronous copy
landing when it is started, and when its thread waits for it.  Above nu 16
the runtime-sized instances take the wide route (panels of 16 columns), as
the launcher picks it, up to the widest shipped widths 27/57, 27/93 and
18/90.  Shared memory
starts as NaN patterns, so padding that leaks into a result shows.  Inputs
are made with numpy from a seed.
"""

import shutil

import numpy as np
import pytest
import torch
from test_torch_riccati import jax_sequential

from upright_tpu_torch.solver.riccati import riccati_backward_plain
from upright_tpu_torch.tools import emulate_riccati
from upright_tpu_torch.tools.stage_data import fallback_batch, stage_data

REG = 1e-6


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation harness")
    return emulate_riccati.build(tmp_path_factory.mktemp("riccati_emulation"))


def plain(arrays, reg):
    K, kff = riccati_backward_plain(*(torch.as_tensor(a, dtype=torch.float64) for a in arrays),
                                    reg=reg)
    return K.numpy(), kff.numpy()


@pytest.mark.parametrize(
    "instance,shape,invariant,rtol",
    [
        # the runtime-sized instance, float64
        ("d0", (2, 3, 5, 3), False, 1e-10),
        ("d0", (2, 3, 27, 13), True, 1e-10),
        ("d0", (2, 1, 7, 2), False, 1e-10),  # one stage, odd widths: element-sized copies
        ("d0", (1, 2, 40, 5), True, 1e-10),  # more than a warp of columns in [K | kff]
        ("d0", (1, 2, 9, 16), False, 1e-10),  # the widest register elimination
        ("d0", (1, 2, 9, 17), True, 1e-10),  # the narrowest of the wide route: one partial panel, clamped
        ("d0", (1, 2, 30, 24), False, 1e-10),  # the widest clamped
        ("f0", (1, 1, 70, 16), True, 1e-5),  # more column groups than warps: two passes
        ("d0", (1, 2, 7, 25), False, 1e-10),  # the first width of the jitter route
        ("d0", (1, 2, 27, 45), True, 1e-10),
        # the wide route at the widest shipped widths, and at the edges of its
        # panels of 16 columns
        ("d0", (1, 2, 27, 57), False, 1e-10),
        ("d0", (1, 2, 27, 93), True, 1e-10),
        ("d0", (1, 2, 18, 90), False, 1e-10),
        ("d0", (1, 2, 6, 32), False, 1e-10),  # two whole panels
        ("d0", (1, 2, 6, 33), True, 1e-10),  # and one column more
        ("f0", (1, 2, 27, 57), False, 1e-5),
        # the instances with compile-time sizes, run in float64 for the indexing
        ("d2713", (2, 3, 27, 13), False, 1e-10),
        ("d2713", (2, 3, 27, 13), True, 1e-10),
        ("d1810", (2, 3, 18, 10), False, 1e-10),
        ("d1810", (2, 3, 18, 10), True, 1e-10),
        # float32 as on the card: rounding of a 3-stage float32 recursion
        ("f2713", (2, 3, 27, 13), True, 1e-5),
        ("f0", (2, 3, 27, 13), True, 1e-5),
    ],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_emulated_kernel_matches_plain(harness, instance, shape, invariant, rtol):
    arrays = stage_data(*shape, seed=sum(shape), invariant=invariant)
    K, kff = emulate_riccati.run(harness, instance, arrays, REG)
    K_ref, kff_ref = plain(arrays, REG)
    scale = max(1.0, np.abs(K_ref).max())
    assert np.isfinite(K).all() and np.isfinite(kff).all()
    assert np.abs(K - K_ref).max() <= rtol * scale
    assert np.abs(kff - kff_ref).max() <= rtol * scale


@pytest.mark.parametrize("late_copies", [False, True], ids=["copies_land_early", "copies_land_late"])
@pytest.mark.parametrize(
    "instance,shape",
    [
        ("d2713", (2, 4, 27, 13)),  # the main path's widths, compile-time sizes
        ("d0", (2, 4, 27, 13)),  # the same on the runtime-sized instance
        ("d1810", (2, 4, 18, 10)),  # the arm-only widths
        ("d0", (2, 3, 9, 17)),  # the narrowest of the wide route: one partial panel, clamped
        ("d0", (2, 3, 7, 25)),  # the first width of the jitter route
        ("d0", (2, 3, 27, 45)),  # the frictional three-object width
        ("d0", (1, 2, 27, 57)),  # freespace full_arch
        ("d0", (1, 2, 27, 93)),  # static_obstacles full_cups
        ("d0", (1, 2, 18, 90)),  # full_cups_arm_only
    ],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_emulated_kernel_matches_jax_sequential(harness, instance, shape, late_copies):
    """Per-stage dynamics (the reference's form), float64 on both sides."""
    Bt, N, nx, nu = shape
    arrays = stage_data(Bt, N, nx, nu, seed=nu)
    K, kff = emulate_riccati.run(harness, instance, arrays, REG, late_copies=late_copies)
    K_ref, k_ref = jax_sequential(arrays, N, nx, nu)
    assert np.isfinite(K_ref).all()
    np.testing.assert_allclose(K, K_ref, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(kff, k_ref, rtol=1e-8, atol=1e-11)


def check_fallback(harness, arrays, late_copies):
    """Stage 1 of instances 1 and 3 fails the first factorisation and passes
    the second (luu ends in -1e-5, B = 0 there), instance 4 fails both (-1):
    NaN in exactly the entries where the reference and the plain version have
    it, the rest equal to the reference to 1e-8 and to the plain version to
    1e-10 of the largest entry."""
    Bt, N, nx = arrays[2].shape
    nu = arrays[1].shape[-1]
    K, kff = emulate_riccati.run(harness, "d0", arrays, 0.0, late_copies=late_copies)
    K_jax, k_jax = jax_sequential(arrays, N, nx, nu, reg=0.0)
    K_ref, kff_ref = plain(arrays, 0.0)
    # instance 4 is NaN from stage 1 back; instances 1 and 3 take the second
    # factorisation at stage 1, whose huge gains make P indefinite, so both
    # factorisations fail at stage 0; the rest is finite
    nan_stages = np.isnan(K_ref).all(axis=(2, 3))
    expect = np.zeros((Bt, N), dtype=bool)
    expect[1, 0] = expect[3, 0] = expect[4, 0] = expect[4, 1] = True
    np.testing.assert_array_equal(nan_stages, expect)
    assert np.abs(K_ref[[1, 3], 1]).max() > 10.0  # the second factorisation's gains
    for ref in (K_jax, K_ref):
        np.testing.assert_array_equal(np.isnan(K), np.isnan(ref))
    for ref in (k_jax, kff_ref):
        np.testing.assert_array_equal(np.isnan(kff), np.isnan(ref))
    ok = ~np.isnan(K_ref)
    np.testing.assert_allclose(K[ok], K_jax[ok], rtol=1e-8, atol=1e-11)
    assert np.abs(K - K_ref)[ok].max() <= 1e-10 * np.abs(K_ref[ok]).max()


@pytest.mark.parametrize("late_copies", [False, True], ids=["copies_land_early", "copies_land_late"])
def test_emulated_kernel_takes_the_jitter_fallback_like_the_reference(harness, late_copies):
    """The fallback batch at nu 26: two panels of the wide route."""
    check_fallback(harness, fallback_batch(), late_copies)


@pytest.mark.parametrize("late_copies", [False, True], ids=["copies_land_early", "copies_land_late"])
def test_emulated_wide_kernel_takes_the_jitter_fallback_like_the_reference(harness, late_copies):
    """The same at nu 70, five panels: the failing pivot sits in the last one,
    and the second attempt starts from a Quu recomputed after the first had
    factored four panels over it."""
    check_fallback(harness, fallback_batch(nu=70), late_copies)
