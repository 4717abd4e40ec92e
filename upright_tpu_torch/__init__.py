"""upright_tpu_torch: the PyTorch/CUDA port of ``upright_tpu``.

A balance-aware model-predictive-control engine for the waiter's problem
(a mobile manipulator carrying objects on a tray), written in PyTorch for an
NVIDIA Hopper card.  The JAX package ``upright_tpu`` is the reference; this
package imports ``torch`` and never ``jax``, ``flax`` or ``upright_tpu``.
Sub-packages and functions keep the reference's names so a reader finds the
counterpart:

  config/      YAML config + arrangement parser   (host, numpy)
  core/        balance physics + geometry
  kinematics/  differentiable robot chain
  ocp/         optimal-control problem assembly
  solver/      batch-first AL-SQP + the Riccati backward kernel (csrc/)
  parallel/    batched solving
  convert.py   numpy arrays -> the port's dataclasses

Every problem-building function and entry point takes an explicit ``device``
and ``dtype`` and defaults to ``device="cuda"``, ``dtype=torch.float32``: the
port runs on the card unless the caller asks for the CPU, and raises when no
card is there.

Precision: float32 products stay full float32 on the card.  The Riccati
recursion and the constraint Jacobians feeding it are precision-critical:
the reference needed a matmul-precision floor for exactly this recursion
(``upright_tpu/solver/al.py`` pins around the backward pass,
``upright_tpu/ocp/problem.py`` precision_floor), because reduced-precision
products make weakly-conditioned ``Quu`` blocks produce steps the line search
rejects forever.  TF32 (about three decimal digits) is the same hazard on
Hopper, so it is switched off here once, for the whole package, and the port
carries no ``precision_floor`` machinery.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device="cuda"):
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device is only returned when a card is present: the port never
    carries on quietly on the CPU.  Ask for ``device="cpu"`` explicitly (as
    the CPU parity tests do) to run there.
    """
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "upright_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU."
        )
    return dev


def check_on_device(tensor, device, dtype, name):
    """Raise unless ``tensor`` lies on ``device`` with ``dtype``."""
    dev = resolve_device(device)
    if tensor.device.type != dev.type or tensor.dtype != dtype:
        raise ValueError(
            f"{name} is on {tensor.device} as {tensor.dtype}; this entry point"
            f" was asked for device={dev}, dtype={dtype}."
        )
