"""Device helpers of the reference (the port's ``resolve_device`` and
``check_on_device``, without the card requirement)."""

import torch


def resolve_device(device="cuda"):
    return torch.device(device)


def check_on_device(tensor, device, dtype, name):
    """Raise unless ``tensor`` lies on ``device`` with ``dtype``."""
    dev = torch.device(device)
    if tensor.device.type != dev.type or tensor.dtype != dtype:
        raise ValueError(f"{name} is on {tensor.device} as {tensor.dtype}; the reference "
                         f"was asked for device={dev}, dtype={dtype}.")
