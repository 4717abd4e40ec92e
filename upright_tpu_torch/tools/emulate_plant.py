"""Run the plant CUDA kernel's device code on the CPU, for its logic.

``csrc/plant.cu`` is plain C++ apart from ``threadIdx``, ``blockIdx`` and
``__syncthreads``.  The stand-in headers in ``tools/emulate/`` define those
for a host compiler (one pthread per CUDA thread, a pthread barrier per
block), and ``plant_harness.cpp`` runs either instantiation of the kernel
block by block on arrays read from files, so its indexing, the placement of
its barriers and its arithmetic can be held against the plain version
(``sim/contact.py`` ``advance_objects_plain``) without a card.  Shared memory
starts as NaN patterns, so a read before a write shows.  What it cannot show:
that ``nvcc`` accepts the source, races between real warps, and any time.

    binary = build(workdir)                                       # needs g++
    objects = run(binary, tables, consts, frames, objects, params)  # CPU tensors
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from upright_tpu_torch.sim.contact import plant_params_for_batch

_TOOLS = Path(__file__).resolve().parent
_KERNEL = _TOOLS.parent / "csrc" / "plant.cu"


def build(workdir, compiler="g++"):
    """Compile the harness around the device code of csrc/plant.cu (the
    source defines its host side away under PLANT_DEVICE_CODE_ONLY) into
    ``workdir``; returns the binary's path."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for f in [*(_TOOLS / "emulate").iterdir(), _KERNEL]:
        shutil.copy(f, workdir / f.name)
    binary = workdir / "plant_harness"
    cmd = [compiler, "-std=c++17", "-O1", "-Wno-unknown-pragmas", f"-I{workdir}",
           "-o", str(binary), str(workdir / "plant_harness.cpp"), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on the emulation harness:\n{proc.stderr}")
    return binary


def run(binary, tables, consts, frames, objects, params, precision="d", timeout=600):
    """Run the kernel on CPU tensors (the arguments of ``advance_objects``)
    and return the new ``ObjectsState`` as float64 CPU tensors.  ``precision``
    is "d" (float64) or "f" (float32)."""
    B, n_steps, _ = frames.shape
    data = Path(binary).parent / f"data_{precision}"
    data.mkdir(exist_ok=True)
    prm = plant_params_for_batch(params, B)
    has_div = objects.diverged is not None
    meta = [B, n_steps, consts.n_sub, tables.n_obj, tables.n_slots, tables.s_max,
            tables.k_max, int(consts.stiction), int(has_div)]
    vals = [*consts.gravity, consts.k_contact, consts.c_contact, consts.v_slip,
            consts.max_contact_force, consts.divergence_freeze, consts.dt_obj]
    (data / "meta").write_text(" ".join(map(str, meta)) + "\n" + " ".join(map(repr, vals)) + "\n")

    def put(name, t, dtype=np.float64):
        np.ascontiguousarray(t.detach().cpu().numpy(), dtype=dtype).tofile(data / name)

    for name, t in (("frames", frames), ("slot_geom", tables.slot_geom),
                    ("obj_data", tables.obj_data), ("r", objects.r), ("q", objects.q),
                    ("v", objects.v), ("w", objects.w), *prm.items()):
        put(name, t)
    put("slot_int", tables.slot_int, np.int32)
    put("obj_int", tables.obj_int, np.int32)
    if consts.stiction:
        put("anchors", objects.anchors)
        put("anchor_valid", objects.anchor_valid, np.uint8)
    if has_div:
        put("diverged", objects.diverged, np.uint8)
    proc = subprocess.run([str(binary), str(data), precision], capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"emulated plant kernel exited {proc.returncode}: {proc.stderr}")

    def get(name, shape, dtype=np.float64):
        return torch.as_tensor(np.fromfile(data / name, dtype=dtype).reshape(shape))

    n = tables.n_obj
    out = dict(r=get("r_out", (B, n, 3)), q=get("q_out", (B, n, 4)),
               v=get("v_out", (B, n, 3)), w=get("w_out", (B, n, 3)))
    if consts.stiction:
        shape = (B, n, tables.s_max, tables.k_max)
        out["anchors"] = get("anchors_out", shape + (2,))
        out["anchor_valid"] = get("anchor_valid_out", shape, np.uint8).bool()
    if has_div:
        out["diverged"] = get("diverged_out", (B, n), np.uint8).bool()
    return objects.replace(**out)
