"""FIR reverb (counterpart of ``xmtpu.ops.reverb``).

Reverb is FIR convolution with an impulse response. The IR synthesis,
the tail trim and the float64 oracle are host numpy, bit-exact with the
JAX package. :func:`reverb` is the device op, the JAX ``reverb`` on each
of its backends: the wet/dry mix ``dry*x + wet*conv(x, ir)``, or a pure
convolution (``dry=0``, the folded EQ+reverb IR), with an optional gain
(``prescale``). Its backends:

* ``"pallas"`` (the port's default): the fftconv kernel
  (``xmtpu_torch.kernels.fftconv``), which also scales the input per row
  (``pre_row``) and per sample (``pre_col``) as it loads;
* ``"xla"``: ``torch.fft`` (:func:`fir_convolve_full`, or overlap-save
  blocks with ``block``: :func:`fir_convolve_os`), in float32, or float64
  for float64 input; the scan engine's reverb;
* ``"mxu"``: overlap-save whose DFTs are matmuls
  (``ops.fftmm.fir_convolve_os_mxu``), at ``precision=`` (FP32 by
  default).

The JAX package's engine knobs, each refused on the other backends as
the JAX ``reverb`` refuses it: ``precision`` (``"mxu"`` only), ``gp``
and ``interpret`` (``"pallas"`` only), ``trim=False`` (``"pallas"``
with ``dry=0``: the kernel's hop-padded output, samples past n the
convolution tail). :func:`fftconv_gp` is the JAX block -> gp table.

:func:`reverb_block` carries the output tail across blocks (the scan
engine's streaming form).
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels.fftconv import fir_convolve
from xmtpu_torch.kernels.fftconv import fftconv_gp  # noqa: F401
from xmtpu_torch.utils.device import check_interpret
from xmtpu_torch.utils.errors import ConfigError


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


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def fir_convolve_full(x: torch.Tensor, ir) -> torch.Tensor:
    """Full linear convolution of the last axis of ``x`` (..., n) with a
    1-D IR (m,) by one ``torch.fft`` transform pair -> (..., n + m - 1)
    in x's dtype; computed in float32, or float64 for float64 input."""
    dt = _work_dtype(x)
    h = torch.as_tensor(ir, device=x.device).to(dt)
    n, m = x.shape[-1], h.shape[-1]
    nfft = _next_pow2(n + m - 1)
    X = torch.fft.rfft(x.to(dt), n=nfft, dim=-1)
    H = torch.fft.rfft(h, n=nfft, dim=-1)
    y = torch.fft.irfft(X * H, n=nfft, dim=-1)[..., : n + m - 1]
    return y.to(x.dtype)


def fir_convolve_os(x: torch.Tensor, ir, block: int = 65536) -> torch.Tensor:
    """Same-length causal convolution by overlap-save ``torch.fft``
    blocks of ``block`` points (one batched transform over all blocks);
    the full transform when ``block <= 2*(m-1)`` or ``n <= block``."""
    dt = _work_dtype(x)
    h = torch.as_tensor(ir, device=x.device).to(dt)
    n, m = x.shape[-1], h.shape[-1]
    if block <= 2 * (m - 1) or n <= block:
        return fir_convolve_full(x, h)[..., :n]
    hop = block - (m - 1)  # useful samples per block
    nblk = -(-n // hop)
    batch = x.shape[:-1]
    # block b covers output [b*hop, b*hop + hop) from input [b*hop - (m-1),
    # b*hop + hop): left-pad by m-1, frame by hop
    xp = torch.nn.functional.pad(x.to(dt), (m - 1, nblk * hop - n))
    frames = xp.unfold(-1, block, hop)  # (..., nblk, block)
    H = torch.fft.rfft(h, n=block, dim=-1)
    Y = torch.fft.irfft(torch.fft.rfft(frames, dim=-1) * H, n=block, dim=-1)
    y = Y[..., m - 1:].reshape(*batch, nblk * hop)[..., :n]
    return y.to(x.dtype)


REVERB_BACKENDS = ("pallas", "xla", "mxu")


def reverb(x: torch.Tensor, ir, wet: float = 0.3, dry: float = 0.7,
           prescale=None, pre_row=None, pre_col=None, block: int | None = None,
           backend: str = "pallas", interpret: bool | None = None,
           precision=None, gp: int | None = None,
           trim: bool = True) -> torch.Tensor:
    """Same-length causal reverb of ``x`` (..., n):
    ``prescale * (dry * x + wet * conv(pre_row[..., None] * pre_col * x,
    ir))``, in the JAX package's operation order.

    ``ir`` is a host array or a 1-D tensor. ``backend`` (module
    docstring): ``"pallas"`` (the port's default, float32) runs the
    fftconv kernel, whose frame size is its own (a given ``block`` is
    checked as the JAX kernel checks it, and changes what it computes
    only with ``trim=False``, where it sets the JAX hop geometry of the
    padded length, 65536 by default); ``"xla"`` the
    ``torch.fft`` forms (one transform, or overlap-save blocks of
    ``block`` points); ``"mxu"`` the matmul DFTs (``block`` or 16384
    points) at ``precision`` (``ops.precision``; None = FP32).
    ``pre_row`` is batch-shaped, ``pre_col`` is (n,); either may be None
    (1); they scale only the convolution's input and need ``"pallas"``,
    as in the JAX package. ``prescale`` (broadcastable) scales both
    terms. ``dry=0`` emits no dry term. ``gp``: the JAX kernel's row
    pairs a grid step, checked and capped as there and not a parameter
    of the card's launch (``kernels.fftconv``). ``trim=False`` (with
    ``"pallas"`` and ``dry=0``) returns (..., nblk*hop), the convolution
    tail past n. ``interpret=True`` (the JAX package's Pallas interpret
    mode) means the kernel's plain twin: it needs ``"pallas"`` and ``x``
    on the CPU, else :class:`ConfigError`; None and False let x's device
    decide."""
    if backend not in REVERB_BACKENDS:
        raise ValueError(f"unknown reverb backend {backend!r}; accepted: "
                         + ", ".join(REVERB_BACKENDS))
    if not trim and (backend != "pallas" or dry != 0.0):
        raise ValueError("trim=False requires backend='pallas', dry=0")
    if backend != "pallas" and (gp is not None or interpret):
        raise ConfigError(f"gp/interpret apply to backend='pallas' only, "
                          f"got backend={backend!r}")
    if precision is not None and backend != "mxu":
        raise ValueError(f"precision applies to backend='mxu' only, got "
                         f"backend={backend!r}")
    check_interpret(interpret, x.device)
    n = x.shape[-1]
    dev = x.device
    if backend == "pallas":
        batch = x.shape[:-1]
        R = int(np.prod(batch)) if batch else 1
        f32 = torch.float32
        h = torch.as_tensor(ir, dtype=f32, device=dev).contiguous()
        pr = (torch.ones(R, dtype=f32, device=dev) if pre_row is None
              else torch.as_tensor(pre_row, dtype=f32, device=dev).reshape(R))
        pc = (torch.ones(n, dtype=f32, device=dev) if pre_col is None
              else torch.as_tensor(pre_col, dtype=f32, device=dev).reshape(n))
        w = fir_convolve(x.reshape(R, n).to(f32).contiguous(), h,
                         pr.contiguous(), pc.contiguous(), trim=trim,
                         block=block, gp=gp)
        w = w.reshape(*batch, w.shape[-1])
    elif pre_row is not None or pre_col is not None:
        raise ValueError("pre_row/pre_col require backend='pallas'")
    elif backend == "mxu":
        from xmtpu_torch.ops.fftmm import fir_convolve_os_mxu

        w = fir_convolve_os_mxu(x, ir, block or 16384, precision=precision)
    elif block is not None:
        w = fir_convolve_os(x, ir, block)
    else:
        w = fir_convolve_full(x, ir)[..., :n]
    s = (None if prescale is None
         else torch.as_tensor(prescale, dtype=w.dtype, device=dev))
    if dry == 0.0:
        if s is not None:
            return (s * wet) * w
        return wet * w if wet != 1.0 else w
    if s is not None:
        return (s * dry) * x + (s * wet) * w
    return dry * x + wet * w


def reverb_block(x: torch.Tensor, ir, tail: torch.Tensor, wet: float = 0.3,
                 dry: float = 0.7):
    """One block of streaming reverb with a carried output tail
    (overlap-add): ``x`` (..., n), ``tail`` (..., m-1) -> (y, new_tail),
    y the same-length wet/dry output. Blockwise equals :func:`reverb`
    in exact arithmetic."""
    n = x.shape[-1]
    full = fir_convolve_full(x, ir)  # (..., n + m - 1)
    acc = full + torch.nn.functional.pad(tail.to(full.dtype), (0, n))
    y = dry * x + wet * acc[..., :n]
    return y, acc[..., n:]


def reverb_tail_init(batch_shape, ir_len: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The zero output tail of :func:`reverb_block`."""
    return torch.zeros(tuple(batch_shape) + (ir_len - 1,), dtype=dtype,
                       device=device)
