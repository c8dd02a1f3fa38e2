"""ITU-R BS.1770-4 loudness (LUFS) measurement and normalization
(counterpart of ``xmtpu.ops.loudness``).

Algorithm (BS.1770-4):

1. K-weighting pre-filter: a +4 dB high shelf then a high-pass, two
   cascaded biquads (:func:`k_weighting_sos`, host float64, bit-exact
   with the JAX package's; re-designed from the analog prototype at
   rates other than 48 kHz).
2. Mean square over 400 ms blocks, 75% overlap (100 ms hop); block
   loudness ``l_j = -0.691 + 10 log10(sum_ch z_j,ch)`` (channel weights
   1 for mono and stereo).
3. Absolute gate at -70 LUFS, then a relative gate 10 LU below the
   power mean of the surviving blocks; integrated loudness = the power
   mean of the doubly gated blocks. Silence returns -inf.

The K-weighting runs on ``kernels.iir.sosfilt``, as the JAX package's
on its IIR kernel: the kernel on ``cuda`` (time-segmented by the card's
rule), its plain twin on the CPU. The block powers come from one float64
cumulative sum and a strided gather, the gates are masked reductions,
and the result stays a tensor on the device: nothing is read back.
:func:`measure_lufs_np` is the float64 scipy oracle.

Profiler ranges (``utils.profiling.stage``): ``lufs`` around all of
:func:`lufs_normalize`; ``lufs_kweight`` around the K-weighting and
``lufs_gate`` around the squares, the cumulative sum, the gather, the
gates and the gain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels.iir import sosfilt
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.utils.device import to_device
from xmtpu_torch.utils.profiling import stage

ABS_GATE_LUFS = -70.0
REL_GATE_LU = -10.0
BLOCK_S = 0.400
HOP_S = 0.100


def k_weighting_sos(sr: int) -> np.ndarray:
    """K-weighting cascade as a (2, 6) sos array at sample rate ``sr``:
    stage 1 (shelf) and stage 2 (high-pass) from the BS.1770 analog
    prototype (De Man parameterization); at 48 kHz the standard's
    coefficient table."""
    # stage 1: high shelf f0=1681.97 Hz, G=+3.9998 dB, Q=0.7072
    f0, g_db, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = math.tan(math.pi * f0 / sr)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_sh = [
        (vh + vb * k / q + k * k) / a0,
        2.0 * (k * k - vh) / a0,
        (vh - vb * k / q + k * k) / a0,
    ]
    a_sh = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]

    # stage 2: high pass f0=38.135 Hz, Q=0.5003
    f0, q = 38.13547087613982, 0.5003270373253953
    k = math.tan(math.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    b_hp = [1.0, -2.0, 1.0]  # the standard's table keeps these unscaled
    a_hp = [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0]

    return np.array([b_sh + a_sh, b_hp + a_hp], np.float64)


def _block_geometry(n: int, sr: int):
    block = int(round(BLOCK_S * sr))
    hop = int(round(HOP_S * sr))
    if n < block:  # short-signal fallback: one block of everything
        return n, max(n, 1), 1
    return block, hop, (n - block) // hop + 1


def measure_lufs(x, sr: int, device=None) -> torch.Tensor:
    """Integrated loudness (LUFS) of ``x`` shaped (n,) or (ch, n), int16
    (the pinned PCM conversion) or float, as a 0-d float64 tensor on the
    device; -inf where no block passes the absolute gate. Runs on
    ``cuda`` unless ``device`` names another device."""
    x = to_device(x, device)
    if x.dtype == torch.int16:
        # the pinned PCM scaling, as every public op (a bare cast reads
        # ~90.3 dB too loud)
        x = _convert.pcm16_to_f32(x)
    if x.dim() == 1:
        x = x[None]
    n = x.shape[-1]
    with stage("lufs_kweight"):
        xw = sosfilt(k_weighting_sos(sr),
                     x.to(torch.float32).contiguous())[0]
    with stage("lufs_gate"):
        block, hop, nblk = _block_geometry(n, sr)
        cs = torch.cat([
            x.new_zeros(x.shape[:-1] + (1,), dtype=torch.float64),
            torch.cumsum(torch.square(xw.to(torch.float64)), dim=-1)], dim=-1)
        starts = torch.arange(nblk, device=x.device) * hop
        z = (cs[..., starts + block] - cs[..., starts]) / block  # (ch, nblk)
        power = torch.sum(z, dim=0)  # channel weights G=1 (mono/stereo)
        l_blk = -0.691 + 10.0 * torch.log10(torch.clamp_min(power, 1e-30))

        abs_mask = l_blk > ABS_GATE_LUFS
        n_abs = torch.clamp_min(torch.sum(abs_mask), 1)
        p_abs = torch.sum(torch.where(abs_mask, power, 0.0)) / n_abs
        rel_thresh = (-0.691
                      + 10.0 * torch.log10(torch.clamp_min(p_abs, 1e-30))
                      + REL_GATE_LU)
        mask = abs_mask & (l_blk > rel_thresh)
        n_g = torch.clamp_min(torch.sum(mask), 1)
        p_g = torch.sum(torch.where(mask, power, 0.0)) / n_g
        lufs = -0.691 + 10.0 * torch.log10(torch.clamp_min(p_g, 1e-30))
        return torch.where(torch.any(abs_mask), lufs, -math.inf)


def lufs_normalize(x, sr: int, target_lufs: float = -23.0, device=None):
    """Scale ``x`` so its integrated loudness hits ``target_lufs``.
    Returns (scaled, linear gain), tensors on the device; silence passes
    through (gain 1). The gain stays float32 (cast to the input dtype, a
    gain of 0.03 would truncate to int16 zero); int16 input gives the
    pinned-converted int16 back. Runs on ``cuda`` unless ``device``
    names another device."""
    with stage("lufs"):
        x = to_device(x, device)
        was_i16 = x.dtype == torch.int16
        xf = _convert.pcm16_to_f32(x) if was_i16 else x
        lufs = measure_lufs(xf, sr, device=x.device)
        with stage("lufs_gate"):
            gain = torch.where(torch.isfinite(lufs),
                               torch.pow(10.0, (target_lufs - lufs) / 20.0),
                               1.0).to(torch.float32)
        y = xf * gain
        if was_i16:
            y = _convert.f32_to_pcm16(y)
        return y, gain


# ---------------------------------------------------------------------------
# float64 scipy oracle
# ---------------------------------------------------------------------------


def measure_lufs_np(x, sr: int) -> float:
    from scipy import signal as sps

    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    n = x.shape[-1]
    xw = sps.sosfilt(k_weighting_sos(sr), x, axis=-1)
    block, hop, nblk = _block_geometry(n, sr)
    power = np.array([
        np.sum(np.mean(xw[:, j * hop: j * hop + block] ** 2, axis=-1))
        for j in range(nblk)
    ])
    l_blk = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))
    abs_mask = l_blk > ABS_GATE_LUFS
    if not np.any(abs_mask):
        return float("-inf")
    p_abs = np.mean(power[abs_mask])
    rel = -0.691 + 10.0 * np.log10(p_abs) + REL_GATE_LU
    mask = abs_mask & (l_blk > rel)
    if not np.any(mask):
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(np.mean(power[mask])))
