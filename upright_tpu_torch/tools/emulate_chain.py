"""Run kernel K2's device code (``csrc/chain.cu``) on the CPU, for its logic.

K2 is plain C++ apart from ``threadIdx``, ``blockIdx`` and the qualifiers,
which the stand-in header in ``tools/emulate/`` defines for a host compiler;
it needs no barrier, so ``chain_harness.cpp`` plays every CUDA thread in turn
on one host thread, on arrays read from files, one launch after another.
``Emulated`` puts the harness behind K2's interface (``kinematics/chain.py``
``PlainSweep``), with the launch arguments that the CUDA path builds
(``SweepRequest.launch_args``), so a chain whose ``kernel`` is an
``Emulated`` runs its sweeps through the device code: its indexing, its
output slots and its arithmetic can be held against the plain sweep and
``torch.func`` in float64 without a card.  What it cannot show: that ``nvcc``
accepts the source, and any time.

    binary = build(workdir)                      # needs g++
    chain.kernel = Emulated(binary)              # float64 ("d") or float32 ("f")
    out = chain.kernel.run(lambda: f(chain))     # every sweep of f in one harness run
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from upright_tpu_torch.kinematics import chain as chain_mod

_TOOLS = Path(__file__).resolve().parent
_KERNEL = _TOOLS.parent / "csrc" / "chain.cu"


def build(workdir, compiler="g++"):
    """Compile the harness around the device code of csrc/chain.cu (the
    source defines its host side away under CHAIN_DEVICE_CODE_ONLY) into
    ``workdir``; returns the binary's path."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for f in [*(_TOOLS / "emulate").iterdir(), _KERNEL]:
        shutil.copy(f, workdir / f.name)
    binary = workdir / "chain_harness"
    cmd = [compiler, "-std=c++17", "-O1", "-Wno-unknown-pragmas", f"-I{workdir}",
           "-o", str(binary), str(workdir / "chain_harness.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on the emulation harness:\n{proc.stderr}")
    return binary


def _same(a, b):
    return (a is None and b is None) or (
        a is not None and b is not None and a.shape == b.shape and bool((a == b).all()))


class Emulated:
    """K2's two modes through the harness: the sweep interface of
    ``chain.PlainSweep`` on CPU tensors, results in the inputs' dtype.

    ``run(fn)`` calls ``fn()`` twice.  The first call records each sweep and
    answers it with zeros; the recorded sweeps then run in one harness
    process; the second call gets the device code's answers in the recorded
    order, and its result is returned.  So ``fn`` must make the same sweeps on
    the same inputs both times, as a function whose sweep inputs do not
    depend on earlier sweeps' outputs does; a sweep that differs raises."""

    def __init__(self, binary, precision="d", timeout=600):
        self.binary, self.precision, self.timeout = Path(binary), precision, timeout
        self._recorded = None  # sweeps of run()'s first call
        self._answers = None  # the harness's answers, for its second call

    def run(self, fn):
        self._recorded, self._answers = [], None
        try:
            fn()
            self._answers = self._launch(self._recorded)
            result = fn()
            if self._answers:
                raise RuntimeError(f"{len(self._answers)} recorded sweeps were not replayed")
            return result
        finally:
            self._recorded = self._answers = None

    def _sweep(self, req, q, v, a, n_dir):
        inputs = tuple(None if t is None else t.detach().clone() for t in (q, v, a))
        if self._answers is not None:
            if not self._answers:
                raise RuntimeError("a sweep more than run()'s first call made")
            (req0, inputs0, n_dir0), out = self._answers.pop(0)
            if req0 is not req or n_dir0 != n_dir or not all(map(_same, inputs0, inputs)):
                raise RuntimeError("a sweep other than the one run()'s first call made")
            return out.to(q.dtype)
        if self._recorded is None:
            raise RuntimeError("the emulated K2 sweeps only inside Emulated.run")
        self._recorded.append((req, inputs, n_dir))
        return torch.zeros((max(n_dir, 1),) + q.shape[:1] + (req.n_out,), dtype=q.dtype)

    def _launch(self, sweeps):
        """One harness run over ``sweeps`` [(req, (q, v, a), n_dir)]: their
        outputs, (max(n_dir, 1), P, n_out) each, beside them."""
        dirs = []
        for n, (req, (q, v, a), n_dir) in enumerate(sweeps):
            args = chain_mod._SweepArgs.from_buffer_copy(req.launch_args)
            P, nq = q.shape
            data = self.binary.parent / f"data_{self.precision}" / str(n)
            data.mkdir(parents=True, exist_ok=True)
            meta = [P, nq, args.n_joints, args.n_out, args.motion, args.motion_offset, n_dir,
                    int(v is not None), int(a is not None), int(n_dir > 0)]
            kinds = list(args.kind)[: args.n_joints]
            slots = list(args.slot)[: args.n_joints]
            (data / "meta").write_text("\n".join(" ".join(map(str, line))
                                                 for line in (meta, kinds, slots)) + "\n")
            consts = req.chain._k2_constants("cpu", torch.float64)[: args.n_joints]
            for name, t in (("consts", consts), ("q", q), ("v", v), ("a", a)):
                if t is not None:
                    np.ascontiguousarray(t.cpu().numpy(), dtype=np.float64).tofile(data / name)
            dirs.append(data)
        cmd = [str(self.binary), self.precision, *map(str, dirs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=self.timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"emulated K2 exited {proc.returncode}: {proc.stderr}")
        return [((req, inputs, n_dir), torch.as_tensor(np.fromfile(data / "out").reshape(
                    max(n_dir, 1), inputs[0].shape[0], req.n_out)))
                for (req, inputs, n_dir), data in zip(sweeps, dirs)]

    def value(self, req, q, v, a):
        return self._sweep(req, q, v, a, 0)[0]

    def jacobian(self, req, q, v, a, n_dir):
        return self._sweep(req, q, v, a, n_dir).permute(1, 2, 0)
