"""Sample-format conversion: int16 <-> float32 (counterpart of
``xmtpu.ops.convert``; bit-exact with it).

The pinned rule:

* int16 -> float32:  ``f = i / 32768.0`` (INT16_MIN -> -1.0 exactly)
* float32 -> int16:  ``i = clip(round_half_away(f * 32768.0), -32768,
  32767)``, the C idiom ``(short)(x + (x >= 0 ? 0.5f : -0.5f))``.

A torch version (device) and a numpy version (host oracle) are given.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.utils.profiling import stage

PCM16_SCALE = 32768.0
INT16_MIN = -32768
INT16_MAX = 32767


def pcm16_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1.0, 1.0)."""
    return x.to(torch.float32) * (1.0 / PCM16_SCALE)


def f32_to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int16 PCM: scale, round half away from zero, clip."""
    with stage("to_pcm16"):
        scaled = x.to(torch.float32) * PCM16_SCALE
        rounded = torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)
        return torch.clamp(rounded, INT16_MIN, INT16_MAX).to(torch.int16)


def pcm16_to_f32_np(x: np.ndarray) -> np.ndarray:
    """Numpy oracle for :func:`pcm16_to_f32`."""
    return (x.astype(np.float32) / np.float32(PCM16_SCALE)).astype(np.float32)


def f32_to_pcm16_np(x: np.ndarray) -> np.ndarray:
    """Numpy oracle for :func:`f32_to_pcm16`."""
    scaled = x.astype(np.float32) * np.float32(PCM16_SCALE)
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + np.float32(0.5))
    return np.clip(rounded, INT16_MIN, INT16_MAX).astype(np.int16)
