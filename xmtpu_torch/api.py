"""Public API (counterpart of ``xmtpu.api``): :func:`effects`, the
EQ -> reverb -> limiter chain of BASELINE config 3.

Accepts int16 or float32 PCM shaped ``(n,)``, ``(n, channels)`` or a
batched ``(B, n, channels)`` stack, as a numpy array or a tensor, and
returns the same format. The device layout is time-last, as the JAX
package's: ``(channels, n)`` or ``(B, channels, n)``.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.ops import convert as _convert


def _to_f32_device(pcm, device) -> tuple[torch.Tensor, bool, bool]:
    """-> (contiguous float32 time-last tensor on ``device``, was_int16,
    was_1d)."""
    arr = pcm if torch.is_tensor(pcm) else torch.from_numpy(np.asarray(pcm))
    arr = arr.to(device)
    was_1d = arr.dim() == 1
    if was_1d:
        arr = arr[:, None]
    if arr.dim() == 2:
        arr = arr.T  # -> (channels, n), time-last for device ops
    elif arr.dim() == 3:  # batched clips (B, n, ch) -> (B, ch, n)
        arr = arr.transpose(-1, -2)
    else:
        raise ValueError(
            f"PCM must be (n,), (n, channels) or (B, n, channels), "
            f"got {tuple(arr.shape)}")
    if arr.dtype == torch.int16:
        return _convert.pcm16_to_f32(arr).contiguous(), True, was_1d
    return arr.to(torch.float32).contiguous(), False, was_1d


def _from_f32_device(y: torch.Tensor, was_int16: bool, was_1d: bool,
                     to_host: bool = True):
    """Back to the caller's format and time-first layout: a numpy array
    (``to_host``) or a contiguous tensor on the device."""
    out = _convert.f32_to_pcm16(y) if was_int16 else y
    out = out.transpose(-1, -2)  # back to (..., n, channels)
    if was_1d:
        out = out[..., 0]
    out = out.contiguous()
    return out.cpu().numpy() if to_host else out


def effects(pcm, sample_rate: int, chain, **kw):
    """Effect chain (config 3): the chain runs on the port's kernels, on
    ``cuda`` unless ``device=`` names another device (``device="cpu"``
    runs the kernels' plain twins). Other keywords: ``block_size``
    (fixed blocks with carried state), ``backend`` (the default engine
    of effects that name none), ``device_out`` (return the tensor on the
    device instead of a numpy array). See
    :func:`xmtpu_torch.graph.fx.apply_chain`."""
    from xmtpu_torch.graph import fx

    return fx.apply_chain(pcm, sample_rate, chain, **kw)
