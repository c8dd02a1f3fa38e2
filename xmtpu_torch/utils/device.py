"""Where the port's entry points run: on ``cuda`` unless the caller
names a device, never on the CPU by default."""

from __future__ import annotations

import torch

from xmtpu_torch.utils.errors import DeviceError


def resolve_device(device) -> torch.device:
    """``device`` as given, else ``cuda``; without a CUDA device and
    without ``device`` raise :class:`DeviceError`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device: the port's entry points run on cuda unless a "
            "device is given; pass device=\"cpu\" to run the kernels' plain "
            "torch twins on the CPU")
    return torch.device("cuda")
