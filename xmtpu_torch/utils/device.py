"""Where the port's entry points run: on ``cuda`` unless the caller
names a device, never on the CPU by default; and the one rule for
``interpret=`` (:func:`check_interpret`)."""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.utils.errors import ConfigError, DeviceError


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


def check_interpret(interpret, *devices) -> None:
    """``interpret=True`` (the JAX package's Pallas interpret mode, and
    ``backend="pallas_interpret"`` of the chains, sessions and pools)
    means the kernels' plain torch twins, which run on the CPU only:
    raise :class:`ConfigError` when any of ``devices`` is another device
    or None (the default, ``cuda``). Callers check before they build or
    upload anything. None and False let each device decide: the kernels
    on ``cuda``, their twins on the CPU."""
    if not interpret:
        return
    bad = sorted({"the default (cuda)" if d is None else str(d)
                  for d in devices
                  if d is None or torch.device(d).type != "cpu"})
    if bad:
        raise ConfigError("interpret=True (backend='pallas_interpret') runs "
                          "the kernels' plain twins, on the CPU only; got "
                          + ", ".join(bad))


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
