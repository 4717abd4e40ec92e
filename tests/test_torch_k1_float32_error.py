"""K1's float32 error over the ral25 robust plan's 100 stages (ROADMAP K1-e)
beside the JAX package's own float32 backward passes on the same data.

The stage data (1x100x27x41) is the copy committed beside
``upright_tpu_torch/tools/k1_float32_error.py``, made on a CPU in float32 by
``tools/stage_data.py`` ``ral25_stage_data`` (5 SQP iterations of the plan;
20 and 60 give the same data: its line search stalls), so that this test and
the card read the same bits.  In float32, against the float64 plain version,
as a fraction of the largest entry of K: the JAX package's Pallas kernel
(``pallas_backward_pass``, interpret mode, about 45 s) and its scan
(``solver/al.py`` ``_backward_pass``), the port's plain version and pscan, and
the emulated K1.  The JAX scan, the port's plain version and the emulated K1
sit within 2x of the JAX Pallas kernel.  K1 itself runs only on a card:
``chip_smoke.py`` phase 16 holds it within 2x of the JAX kernel's reading
here (``K1E_JAX_PALLAS`` there); its reading on the card is printed beside
(``K1_CARD``, PERF.md) and is not asserted.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from upright_tpu.solver import al as jal
from upright_tpu.solver.pallas_riccati import pallas_backward_pass
from upright_tpu_torch.tools import k1_float32_error as k1e

# K1 in float32 on this data on an NVIDIA H100 80GB HBM3 at 700 W (the tool's
# reading, PERF.md §6), printed for comparison
K1_CARD = 3.767655717758091e-05
FACTOR = 2.0


@pytest.mark.slow
def test_k1_float32_error_within_2x_of_the_jax_kernel():
    arrays = k1e.load_or_make()
    port, (K_ref, kff_ref) = k1e.readings(arrays)
    A, B = arrays[0], arrays[1]
    assert A.shape == (27, 27) and B.shape == (27, 41) and arrays[2].shape == (1, 100, 27)
    j = [jnp.asarray(a) for a in arrays]
    assert all(a.dtype == jnp.float32 for a in j)
    Bt, N = arrays[2].shape[:2]
    per_stage = [jnp.broadcast_to(j[0], (Bt, N, 27, 27)), jnp.broadcast_to(j[1], (Bt, N, 27, 41))]
    K, kff = pallas_backward_pass(*per_stage, *j[2:], reg=k1e.REG, interpret=True)
    jax_pallas = k1e.relative_error(K, kff, K_ref, kff_ref)
    ocp = SimpleNamespace(nx=27, nu=41)
    cfg = SimpleNamespace(reg=k1e.REG, scan_unroll=1)
    K, kff = jax.jit(jax.vmap(
        lambda *a: jal._backward_pass(ocp, cfg, *a), in_axes=(None, None, 0, 0, 0, 0, 0)))(*j)
    jax_scan = k1e.relative_error(K, kff, K_ref, kff_ref)
    print(f"float32 error of the largest entry ({port['abs_K_max']:.4g}): JAX Pallas kernel "
          f"{jax_pallas!r}, JAX scan {jax_scan:.3e}, port plain {port['plain_cpu']:.3e}, "
          f"pscan {port['pscan_cpu']:.3e}, emulated K1 {port.get('k1_emulated')}; "
          f"K1 on the card (recorded, not asserted) {K1_CARD} = "
          f"{K1_CARD / jax_pallas:.2f}x the JAX kernel's")
    for name, e in (("JAX scan", jax_scan), ("port plain", port["plain_cpu"]),
                    ("emulated K1", port.get("k1_emulated", 0.0))):
        assert np.isfinite(e) and e <= FACTOR * jax_pallas, (name, e, jax_pallas)
