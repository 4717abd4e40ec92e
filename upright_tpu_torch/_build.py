"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>.so`` (``build/`` is git-ignored), then
loaded with ``ctypes``.  No PyTorch headers are involved, so a build takes
seconds.  A library is rebuilt when its own source, or a header that source
includes (``SOURCES``), is newer than it; ``build`` starts one ``nvcc`` per
stale library, all at once.
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

# Each library: its source, then the headers under csrc/ that it includes.
SOURCES = {
    "riccati": ("riccati.cu", "async_copy.cuh"),
    "plant": ("plant.cu",),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# Flags of one library.  The plant kernel rounds every product and sum on its
# own, as its plain version does: a stiff contact amplifies the difference a
# fused multiply-add makes until float32 leaves the limits it is held to
# (tools/plant_data.py F32_TOL; PERF.md).
LIBRARY_FLAGS = {"plant": ("-fmad=false",)}

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


def library_path(name):
    return BUILD_DIR / f"lib{name}.so"


def is_stale(name):
    """True when lib<name>.so is missing or older than its source or headers."""
    out = library_path(name)
    newest = max((CSRC_DIR / f).stat().st_mtime for f in SOURCES[name])
    return not out.exists() or out.stat().st_mtime < newest


def build(names, extra_flags=(), verbose=False):
    """Compile the stale libraries among ``names``: one ``nvcc`` each, all
    started together, each written to a temporary file and moved into place
    when it succeeds (a concurrent build never loads a partial file)."""
    running = {}
    for name in names:
        if not is_stale(name):
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, *LIBRARY_FLAGS.get(name, ()), *extra_flags,
               "-o", str(tmp), str(CSRC_DIR / SOURCES[name][0])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True), tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        stdout, stderr = proc.communicate()
        if verbose:
            print(f"[nvcc {SOURCES[name][0]}]\n{stdout}{stderr}", flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name][0]} (exit {proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name, extra_flags=(), verbose=False):
    """Compile (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    if name in _LIBS:
        return _LIBS[name]
    build([name], extra_flags, verbose)
    lib = ctypes.CDLL(str(library_path(name)))
    _LIBS[name] = lib
    return lib
