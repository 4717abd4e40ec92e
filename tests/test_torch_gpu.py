"""The Riccati CUDA kernel on the card, at the edges of what it takes.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them with

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which these tests and the
port do not need.)

``chip_smoke.py`` holds the kernel against its plain version at the
main-path shapes; these cover the runtime-sized parts: the widest and the
narrowest input block, a single stage, a shape whose shared memory exceeds
the 48 KB static limit (the opt-in attribute path), both input forms, and
what the wrapper refuses.
"""

import numpy as np
import pytest
import torch

from upright_tpu_torch.solver import riccati

pytestmark = pytest.mark.gpu

REG = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def make_inputs(Bt, N, nx, nu, seed, invariant=False):
    rng = np.random.default_rng(seed)
    nz = nx + nu
    lead = () if invariant else (Bt, N)
    A = rng.standard_normal(lead + (nx, nx)) * 0.1 + np.eye(nx)
    B = rng.standard_normal(lead + (nx, nu)) * 0.1
    d = rng.standard_normal((Bt, N, nx)) * 0.01
    g = rng.standard_normal((Bt, N, nz))
    Hh = rng.standard_normal((Bt, N, nz, nz)) * 0.1
    H = Hh @ np.swapaxes(Hh, -1, -2) + 3 * np.eye(nz)
    gf = rng.standard_normal((Bt, nx))
    Hf_ = rng.standard_normal((Bt, nx, nx)) * 0.1
    Hf = Hf_ @ np.swapaxes(Hf_, -1, -2) + np.eye(nx)
    return A, B, d, g, H, gf, Hf


@pytest.mark.parametrize(
    "shape",
    [
        (3, 1, 4, 2),  # a single stage
        (5, 7, 6, 1),  # one input
        (4, 9, 10, 24),  # the widest input block the kernel takes
        (2, 5, 60, 20),  # 84 KB of shared memory: above the static limit
        (300, 20, 27, 13),  # more blocks than SMs, main-path widths
    ],
    ids=lambda s: "x".join(map(str, s)),
)
@pytest.mark.parametrize("invariant", [False, True], ids=["form_a", "form_b"])
def test_kernel_matches_plain_float64(card, shape, invariant):
    """float32 kernel against the float64 plain version: K and kff are O(1)
    on this conditioning, 1e-4 absolute (see chip_smoke.py)."""
    arrays = make_inputs(*shape, seed=sum(shape), invariant=invariant)
    f32 = tuple(torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays)
    before = riccati.launch_count
    K, kff = riccati.riccati_backward(*f32, reg=REG)
    torch.cuda.synchronize()
    assert riccati.launch_count == before + 1
    K_ref, kff_ref = riccati.riccati_backward_plain(*(t.double() for t in f32), reg=REG)
    assert K.shape == K_ref.shape and K.dtype == torch.float32
    assert float((K.double() - K_ref).abs().max()) < 1e-4
    assert float((kff.double() - kff_ref).abs().max()) < 1e-4


def test_kernel_runs_on_the_current_stream(card):
    """Launched on a side stream, the kernel is ordered after the work that
    made its inputs on that stream and before the work that reads K."""
    arrays = make_inputs(8, 20, 27, 13, seed=1, invariant=True)
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
    arrays = make_inputs(2, 3, 4, 2, seed=2)
    f32 = [torch.as_tensor(a, dtype=torch.float32, device=card) for a in arrays]
    before = riccati.launch_count
    with pytest.raises(TypeError, match="float32"):
        riccati.riccati_backward(*(t.double() for t in f32), reg=REG)
    with pytest.raises(ValueError, match="contiguous"):
        bad = list(f32)
        bad[4] = f32[4].transpose(-1, -2)
        riccati.riccati_backward(*bad, reg=REG)
    with pytest.raises(ValueError, match="is on cpu"):
        bad = list(f32)
        bad[0] = f32[0].cpu()
        riccati.riccati_backward(*bad, reg=REG)
    with pytest.raises(NotImplementedError, match="nu = 25"):
        wide = make_inputs(2, 3, 4, 25, seed=3)
        riccati.riccati_backward(
            *(torch.as_tensor(a, dtype=torch.float32, device=card) for a in wide), reg=REG)
    assert riccati.launch_count == before  # nothing was launched
