#!/usr/bin/env python3
"""K1's float32 error on the ral25 robust plan's stage data, beside the other
float32 versions of the same recursion on the same data.

    python3 upright_tpu_torch/tools/k1_float32_error.py [--data FILE.npz]

The stage data (1x100x27x41, ``tools/stage_data.py`` ``ral25_stage_data``,
float32) is read from ``--data``, by default the copy committed beside this
file (``data/ral25_stage_float32.npz``), so that every machine reads the same
bits; where the file does not exist it is made on the CPU and written there
(about 30 s).  Each version runs in float32 and is held against the float64
plain version on the CPU, as a fraction of the largest entry of K (the
reading of ``chip_smoke.py`` phase 16):

- the plain version (``solver/riccati.py``) on the CPU, and on the card;
- the log-depth backward pass (``solver/pscan.py``) on the CPU, and on the
  card;
- the emulated K1 (``tools/emulate_riccati.py``, the float32 instance
  ``f0``), where ``g++`` exists;
- K1 itself, on the card.

To read a variant of K1 (other build flags, another square root), copy the
package into a git-ignored directory, edit the copy and run the copy's own
file: it imports the package beside it.  The JAX package's Pallas kernel and
scan on the same data are read by ``tests/test_torch_k1_float32_error.py``
(slow), which also calls ``readings`` here.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from upright_tpu_torch.solver import riccati  # noqa: E402
from upright_tpu_torch.solver.pscan import parallel_backward_pass  # noqa: E402
from upright_tpu_torch.tools import emulate_riccati  # noqa: E402
from upright_tpu_torch.tools.stage_data import ral25_stage_data  # noqa: E402

REG = 1e-6
DATA = Path(__file__).resolve().with_name("data") / "ral25_stage_float32.npz"


def load_or_make(path=DATA):
    """The float32 stage data as numpy arrays (A, B, d, grads, hess, gf, Hf):
    read from ``path`` if it exists, else made on the CPU and saved there."""
    path = Path(path)
    if path.exists():
        with np.load(path) as f:
            return [f[f"arr_{i}"] for i in range(7)]
    arrays = [t.numpy() for t in ral25_stage_data()]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, *arrays)
    return arrays


def reference(arrays):
    """The float64 plain version on the CPU on ``arrays``: (K, kff), numpy."""
    return tuple(t.numpy() for t in riccati.riccati_backward_plain(
        *(torch.as_tensor(a, dtype=torch.float64) for a in arrays), reg=REG))


def relative_error(K, kff, K_ref, kff_ref):
    """max |K - K_ref|, |kff - kff_ref| over the largest entry of K_ref (at
    least 1), as ``chip_smoke.py`` phase 16 reads it."""
    K, kff = np.asarray(K, dtype=np.float64), np.asarray(kff, dtype=np.float64)
    scale = max(1.0, float(np.abs(K_ref).max()))
    return max(float(np.abs(K - K_ref).max()), float(np.abs(kff - kff_ref).max())) / scale


def readings(arrays):
    """Float32 errors of the port's versions on ``arrays`` (float32 numpy):
    a dict of name -> error, and the float64 reference (K, kff)."""
    f32 = [torch.as_tensor(a) for a in arrays]
    K_ref, kff_ref = reference(arrays)

    def err(out):
        return relative_error(out[0].cpu(), out[1].cpu(), K_ref, kff_ref)

    out = {"abs_K_max": float(np.abs(K_ref).max()),
           "plain_cpu": err(riccati.riccati_backward_plain(*f32, reg=REG)),
           "pscan_cpu": err(parallel_backward_pass(*f32, reg=REG))}
    if shutil.which("g++"):
        with tempfile.TemporaryDirectory() as work:
            binary = emulate_riccati.build(work)
            out["k1_emulated"] = relative_error(
                *emulate_riccati.run(binary, "f0", [a.astype(np.float64) for a in arrays],
                                     reg=REG), K_ref, kff_ref)
    if torch.cuda.is_available():
        card = [t.cuda() for t in f32]
        out["k1_card"] = err(riccati.riccati_backward(*card, reg=REG))
        out["plain_card"] = err(riccati.riccati_backward_plain(*card, reg=REG))
        out["pscan_card"] = err(parallel_backward_pass(*card, reg=REG))
    return out, (K_ref, kff_ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=str(DATA),
                    help="npz of the stage data, read (or made and written when absent)")
    args = ap.parse_args(argv)
    arrays = load_or_make(args.data)
    out, _ = readings(arrays)
    out.update(data=args.data, shapes=[list(a.shape) for a in arrays], torch=torch.__version__)
    if torch.cuda.is_available():
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
