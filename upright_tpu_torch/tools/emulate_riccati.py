"""Run the Riccati CUDA kernel's device code on the CPU, for its logic.

``csrc/riccati.cu`` is plain C++ apart from ``threadIdx``, ``__syncthreads``,
``__syncwarp``, ``__shfl_sync``, ``rsqrtf``, the two ``cp_async`` helpers and
the L2 prefetch (a no-op here).  The headers in ``tools/emulate/`` define
those for a host compiler (one pthread per CUDA thread, a pthread barrier per
block and per warp), and ``harness.cpp`` runs one instantiation of the kernel
block by block on arrays read from files (``f0``/``d0``: the register route
up to nu 16, the wide route above, as the launcher picks).  So
the indexing, the barriers' placement and the arithmetic of every
instantiation can be held against the reference and the plain version in
float64 without a card; the specialised instances, float32 on the card, can
here be run in float64 too.  An asynchronous copy lands either when it is
started or, with ``late_copies``, when its thread waits for it: the two ends
of what the card may do.  What it cannot show: that ``nvcc`` accepts the
source, races between real warps inside that span, and any time.

    binary = build(workdir)                       # needs g++
    K, kff = run(binary, "d0", arrays, reg=1e-6)  # arrays: numpy, float64
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np

_TOOLS = Path(__file__).resolve().parent
_KERNEL = _TOOLS.parent / "csrc" / "riccati.cu"
INSTANCES = ("f0", "d0", "f2713", "d2713", "f1810", "d1810")


def build(workdir, compiler="g++"):
    """Compile the harness around the device code of csrc/riccati.cu (the
    source defines its host side away under RICCATI_DEVICE_CODE_ONLY) into
    ``workdir``; returns the binary's path."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for f in [*(_TOOLS / "emulate").iterdir(), _KERNEL]:
        shutil.copy(f, workdir / f.name)
    binary = workdir / "harness"
    cmd = [compiler, "-std=c++17", "-O1", "-Wno-unknown-pragmas", f"-I{workdir}",
           "-o", str(binary), str(workdir / "harness.cpp"), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on the emulation harness:\n{proc.stderr}")
    return binary


def run(binary, instance, arrays, reg, late_copies=False, timeout=600):
    """Run ``instance`` on (A, B, d, grads, hess, gf, Hf); A and B are 2-D for
    stage-invariant dynamics.  Returns (K, kff) as float64 numpy arrays."""
    A, B, d = arrays[0], arrays[1], arrays[2]
    Bt, N, nx = d.shape
    nu = B.shape[-1]
    data = Path(binary).parent / f"data_{instance}"
    data.mkdir(exist_ok=True)
    for name, a in zip(("A", "B", "d", "g", "H", "gf", "Hf"), arrays):
        np.ascontiguousarray(a, dtype=np.float64).tofile(data / name)
    cmd = [str(binary), str(data), instance, str(Bt), str(N), str(nx), str(nu),
           str(int(A.ndim == 2)), repr(float(reg)), str(int(late_copies))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"emulated kernel {instance} exited {proc.returncode}: {proc.stderr}")
    K = np.fromfile(data / "K_out").reshape(Bt, N, nu, nx)
    kff = np.fromfile(data / "kff_out").reshape(Bt, N, nu)
    return K, kff
