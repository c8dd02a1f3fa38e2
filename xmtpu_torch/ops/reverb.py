"""FIR reverb (counterpart of ``xmtpu.ops.reverb``).

Reverb is FIR convolution with an impulse response. The IR synthesis,
the tail trim and the float64 oracle are host numpy, bit-exact with the
JAX package. :func:`reverb` is the device op, the JAX ``reverb`` on its
Pallas backend: the wet/dry mix ``dry*x + wet*conv(x, ir)``, or a pure
convolution (``dry=0``, the folded EQ+reverb IR) of the input scaled
per row (``pre_row``) and per sample (``pre_col``), with an optional
gain (``prescale``). The convolution runs on the fftconv kernel
(``xmtpu_torch.kernels.fftconv``).
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels.fftconv import fir_convolve


def trim_ir_tail(h: np.ndarray, rel: float = 1e-6) -> np.ndarray:
    """Drop the numerically dead tail of a host-side impulse response:
    keep taps through the last index whose remaining l1 mass exceeds
    ``rel`` x the total l1 mass (~-120 dB of residual energy)."""
    h = np.asarray(h)
    tail = np.cumsum(np.abs(h[::-1]))[::-1]
    if tail.size == 0 or tail[0] <= 0:
        return h
    over = np.nonzero(tail > rel * tail[0])[0]
    return h[: (int(over[-1]) + 1 if over.size else 1)]


def synthetic_ir(
    seconds: float, sr: int, rt60: float | None = None, seed: int = 7
) -> np.ndarray:
    """Exp-decaying white-noise IR, unit direct path, -60 dB at rt60,
    unit energy."""
    n = max(1, int(round(seconds * sr)))
    rt60 = rt60 if rt60 is not None else seconds
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    env = 10.0 ** (-3.0 * t / max(rt60, 1e-6))  # -60 dB at rt60
    ir = rng.standard_normal(n) * env
    ir[0] = 1.0
    ir /= np.sqrt(np.sum(ir**2))
    return ir.astype(np.float64)


def reverb_np(x, ir, wet=0.3, dry=0.7):
    """Float64 oracle: ``dry*x + wet*conv(x, ir)[:n]``."""
    from scipy import signal as _sig

    x = np.asarray(x, np.float64)
    ir = np.asarray(ir, np.float64)
    w = _sig.fftconvolve(x, np.broadcast_to(ir, x.shape[:-1] + ir.shape), axes=-1)
    return dry * x + wet * w[..., : x.shape[-1]]


def reverb(x: torch.Tensor, ir, wet: float = 0.3, dry: float = 0.7,
           prescale=None, pre_row=None, pre_col=None) -> torch.Tensor:
    """Same-length causal reverb of ``x`` (..., n) float32:
    ``prescale * (dry * x + wet * conv(pre_row[..., None] * pre_col * x,
    ir))``, in the JAX package's operation order.

    ``ir`` is a host array or a 1-D tensor. ``pre_row`` is batch-shaped,
    ``pre_col`` is (n,); either may be None (1). They scale only the
    convolution's input; ``prescale`` (broadcastable) scales both
    terms. ``dry=0`` emits no dry term."""
    n = x.shape[-1]
    batch = x.shape[:-1]
    R = int(np.prod(batch)) if batch else 1
    dev = x.device
    f32 = torch.float32
    h = torch.as_tensor(ir, dtype=f32, device=dev).contiguous()
    pr = (torch.ones(R, dtype=f32, device=dev) if pre_row is None
          else torch.as_tensor(pre_row, dtype=f32, device=dev).reshape(R))
    pc = (torch.ones(n, dtype=f32, device=dev) if pre_col is None
          else torch.as_tensor(pre_col, dtype=f32, device=dev).reshape(n))
    w = fir_convolve(x.reshape(R, n).to(f32).contiguous(), h,
                     pr.contiguous(), pc.contiguous()).reshape(*batch, n)
    s = (None if prescale is None
         else torch.as_tensor(prescale, dtype=f32, device=dev))
    if dry == 0.0:
        if s is not None:
            return (s * wet) * w
        return wet * w if wet != 1.0 else w
    if s is not None:
        return (s * dry) * x + (s * wet) * w
    return dry * x + wet * w
