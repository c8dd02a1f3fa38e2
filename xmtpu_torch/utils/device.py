"""Where the port's entry points run: on ``cuda`` unless the caller
names a device, never on the CPU by default."""

from __future__ import annotations

import numpy as np
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


def to_device(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, or an array: copied first if read-only, as
    decoders hand them out) as a tensor on :func:`resolve_device`'s
    device. The transfer blocks, so the caller may reuse a host buffer
    once it returns; on the CPU the tensor shares the array's memory."""
    dev = resolve_device(device)
    if torch.is_tensor(x):
        return x.to(dev)
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dev)
