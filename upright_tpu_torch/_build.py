"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>.so`` (``build/`` is git-ignored), then
loaded with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  The library is rebuilt when the source is newer than it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS = {}


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
            "kernels of upright_tpu_torch cannot be built on this machine."
        )
    return nvcc


def build_command(name, extra_flags=()):
    """The nvcc command line that builds ``csrc/<name>.cu``."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    return [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(out), str(src)], src, out


def load_library(name, extra_flags=(), verbose=False):
    """Compile (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    if name in _LIBS:
        return _LIBS[name]
    cmd, src, out = build_command(name, extra_flags)
    if not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd[cmd.index(str(out))] = str(tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
