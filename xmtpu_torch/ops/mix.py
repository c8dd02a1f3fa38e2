"""Mixing primitives of the flagship chain: the fade ramp and dB gain
(counterpart of ``xmtpu.ops.mix``; bit-exact with it).

Pinned ramp semantics:

* fade-in over ``F`` samples: sample ``i`` gets ``min(1, (i+1)/F)``;
* fade-out over ``F`` samples of a track of length ``N``: sample ``i``
  gets ``min(1, (N-i)/F)``;
* both ramps multiply (a short track may be inside both windows).
"""

from __future__ import annotations

import numpy as np
import torch


def fade_ramp(n: int, fade_in: int, fade_out: int, length: int,
              offset: int = 0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Gain ramp for samples [offset, offset+n) of a length-``length``
    track. Index math runs in float64 (a float32 index is exact only
    below 2^24 samples), then the gain casts to ``dtype``."""
    i = torch.arange(offset, offset + n, dtype=torch.float64, device=device)
    g = torch.ones(n, dtype=torch.float64, device=device)
    if fade_in > 0:
        g = g * torch.clamp((i + 1.0) / float(fade_in), max=1.0)
    if fade_out > 0:
        g = g * torch.clamp((float(length) - i) / float(fade_out), 0.0, 1.0)
    return g.to(dtype)


def apply_gain_fade(x: torch.Tensor, gain: float, fade_in: int,
                    fade_out: int, offset: int = 0,
                    length: int | None = None) -> torch.Tensor:
    """``x * (ramp * gain)`` over the last axis, the ramp of
    :func:`fade_ramp` in x's dtype and the gain rounded to it first."""
    n = x.shape[-1]
    if length is None:
        length = offset + n
    ramp = fade_ramp(n, fade_in, fade_out, length, offset, x.dtype,
                     device=x.device)
    return x * (ramp * torch.tensor(gain, dtype=x.dtype).item())


def db_to_amp(db: float) -> float:
    return float(10.0 ** (db / 20.0))


def fade_ramp_np(n, fade_in, fade_out, length, offset=0):
    """Float64 numpy oracle for :func:`fade_ramp`."""
    i = np.arange(offset, offset + n, dtype=np.float64)
    g = np.ones(n)
    if fade_in > 0:
        g *= np.minimum((i + 1.0) / fade_in, 1.0)
    if fade_out > 0:
        g *= np.clip((length - i) / fade_out, 0.0, 1.0)
    return g
