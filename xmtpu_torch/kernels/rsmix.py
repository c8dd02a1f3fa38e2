"""Fused int16 voice + BGM resample, fade and gain mix (counterpart of
``xmtpu.kernels.rsmix.resample_mix_pallas``): the flagship chain's
front in one pass over the two int16 tracks,

    out = ramp * (resample(v) + bgm_gain * resample(b))

in int16 scale, with ``ramp`` the fade ramp computed in float32 from the
absolute output index as the JAX kernel computes it. Each track runs
the direct banded FIR of ``kernels.resample`` (the hand-written kernel
``csrc/rsmix.cu`` over ``csrc/polyphase.cuh``) on CUDA; on a CPU tensor
:func:`resample_mix` runs :func:`resample_mix_plain`, the same function
through the frame-aligned banded matmuls (``ops.resample.apply_aligned``)
on the unscaled tables.

:func:`resample_mix_supported` and :func:`_pick_F` give the JAX
package's answers bit for bit: the gate decides which front the step
runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels import resample as _kres
from xmtpu_torch.kernels._seg import on_device
from xmtpu_torch.ops import resample as _rs
from xmtpu_torch.utils.errors import ConfigError

# Launches of the CUDA kernel in this process; callers may reset it.
launches = 0


def _pick_F(nc: int) -> int:
    """Frames per grid step of the JAX kernel: the largest divisor of nc
    that is a multiple of 8 and <= 256, else nc itself when nc <= 1024
    (single-block rows), else 0. The kernel here tiles by its own rule;
    this decides support exactly as the JAX package does."""
    best = 0
    for f in range(8, min(nc, 256) + 1, 8):
        if nc % f == 0:
            best = f
    if best == 0 and nc <= 1024:
        best = nc
    return best


def resample_mix_supported(n: int, B: int, sr_in: int, sr_out: int,
                           taps_per_phase: int = 24) -> bool:
    """True if the fused front runs for (B, n) clips at this rate pair:
    a frame-aligned length (n % M == 0, n >= 2M), at most 2^24 output
    samples (the in-kernel fade index is float32), a band no wider than
    2M and a frame count the JAX kernel tiles."""
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    if L == M or n % M or n < 2 * M:
        return False
    if (n // M) * L > 1 << 24:
        return False
    plan = _rs.make_plan(L, M, taps_per_phase, 9.0)
    return plan.width <= 2 * M and _pick_F(n // M) > 0


def fade_ramp_f32(out_n: int, fade: int, device=None) -> torch.Tensor:
    """The JAX kernel's in-kernel ramp: float32 index math,
    ``min((i+1)/fade, 1) * clip((out_n - i)/fade, 0, 1)``; ones for
    fade 0. Exact index only below 2^24 (the support gate)."""
    i = torch.arange(out_n, dtype=torch.float32, device=device)
    if fade <= 0:
        return torch.ones_like(i)
    f = float(fade)
    return (torch.clamp_max((i + 1.0) / f, 1.0)
            * torch.clamp((float(out_n) - i) / f, 0.0, 1.0))


def _aligned(plan, device) -> dict:
    t = _rs.aligned_tables(plan)
    key = ("rsmix_aligned", plan.L, plan.M, plan.taps.tobytes())
    h = on_device(key, device, lambda: dict(zip(
        ("H1", "H0", "H2"), (a.astype(np.float32) for a in (t.H1, t.H0,
                                                             t.H2)))))
    return dict(h, lo=t.lo, hi=t.hi, r0=t.r0, r2=t.r2)


def resample_mix_plain(voice_i16: torch.Tensor, bgm_i16: torch.Tensor,
                       plan: _rs.ResamplePlan, bgm_gain: float,
                       fade: int) -> torch.Tensor:
    """Plain twin: ``ramp * (apply_aligned(v) + g * apply_aligned(b))``
    on the unscaled aligned tables, float32 (B, nc*L)."""
    B, n = voice_i16.shape
    M = plan.M
    t = _aligned(plan, voice_i16.device)

    def rs(a):
        a3 = a.to(torch.float32).reshape(B, n // M, M)
        return _rs.apply_aligned(a3, t["H1"], t["H0"], t["H2"], t["lo"],
                                 t["hi"], t["r0"], t["r2"]).reshape(B, -1)

    out = rs(voice_i16)
    ramp = fade_ramp_f32(out.shape[-1], fade, device=out.device)
    return ramp * (out + float(np.float32(bgm_gain)) * rs(bgm_i16))


def _check(voice_i16, bgm_i16) -> None:
    for name, t in (("voice", voice_i16), ("bgm", bgm_i16)):
        if (not torch.is_tensor(t) or t.dtype != torch.int16 or t.dim() != 2
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 2-D int16 tensor")
    if voice_i16.shape != bgm_i16.shape or voice_i16.device != bgm_i16.device:
        raise ValueError(f"voice {tuple(voice_i16.shape)} and bgm "
                         f"{tuple(bgm_i16.shape)} differ in shape or device")


def resample_mix(voice_i16: torch.Tensor, bgm_i16: torch.Tensor,
                 sr_in: int, sr_out: int, bgm_gain: float = 0.4,
                 fade: int = 0, taps_per_phase: int = 24,
                 beta: float = 9.0) -> torch.Tensor:
    """Fused resample + fade + gain mix of two (B, n) int16 tracks ->
    (B, n*L/M) float32 in int16 scale. Raises :class:`ConfigError` where
    :func:`resample_mix_supported` is False. The kernel on CUDA, the
    twin on the CPU."""
    global launches
    _check(voice_i16, bgm_i16)
    B, n = voice_i16.shape
    if not resample_mix_supported(n, B, sr_in, sr_out,
                                  taps_per_phase=taps_per_phase):
        raise ConfigError(
            f"resample_mix does not support n={n}, B={B}, {sr_in}->"
            f"{sr_out} Hz (gate with resample_mix_supported)")
    g = math.gcd(int(sr_in), int(sr_out))
    plan = _rs.make_plan(sr_out // g, sr_in // g, taps_per_phase, beta)
    dev = voice_i16.device
    if dev.type == "cpu":
        return resample_mix_plain(voice_i16, bgm_i16, plan, bgm_gain, fade)
    if dev.type != "cuda":
        raise ValueError(f"no rsmix kernel for device {dev}")
    out_len = (n // plan.M) * plan.L
    tabs = _kres.device_tables(plan, dev)
    geo = _kres.poly_geometry(plan, n // plan.M, tracks=2)
    voice_i16, bgm_i16 = _kres.aligned16(voice_i16), _kres.aligned16(bgm_i16)
    y = torch.empty((B, out_len), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        blocks = _kres.persistent_blocks("xm_rsmix_blocks_per_sm", geo, B,
                                         dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.xm_rsmix_i16(
            voice_i16.data_ptr(), bgm_i16.data_ptr(), tabs["hsel"].data_ptr(),
            tabs["soff"].data_ptr(), y.data_ptr(), B, n, out_len, plan.L,
            plan.M, plan.K2, geo.G, geo.frames // 32, geo.pitch,
            geo.tile_pitch, geo.pair_skew, blocks, float(bgm_gain),
            int(fade), stream)
    _build.check(rc, "rsmix")
    launches += 1
    return y
