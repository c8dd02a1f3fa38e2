"""Batched offline flagship chain on one GPU (counterpart of
``xmtpu.batch``).

A [B, n] batch of int16 voice and BGM clips runs the whole decode-side
chain as one module call:

    frame + convert + mix (int16 -> f32)  ->  banded polyphase resample
    (two FP32 matmuls)  ->  fade ramp + per-clip peak normalize gain  ->
    EQ + reverb as ONE convolution (the EQ impulse response folds into
    the reverb IR on the host)  ->  fused soft-knee limiter  ->  int16

Two hand-written CUDA kernels carry it: the fftconv kernel, which also
applies the normalize gain (per row) and the fade ramp (per sample) as
the input loads, and the envelope kernel, which applies the limiter's
curve and clamp in the same pass as its recurrences. Everything else is
plain torch.

``make_flagship_step`` ports the JAX package's default branch (mixfirst
front, LTI fold, fused limiter); other options raise
:class:`NotPortedError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from xmtpu_torch.kernels.envelope import curve_of, limiter
from xmtpu_torch.ops import biquad as _biquad
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.ops import limiter as _limiter
from xmtpu_torch.ops import mix as _mix
from xmtpu_torch.ops import resample as _resample
from xmtpu_torch.ops import reverb as _reverb
from xmtpu_torch.utils.errors import NotPortedError
from xmtpu_torch.utils.profiling import stage

DEFAULT_BANDS = (
    {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
    {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
    {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
    {"freq_hz": 4000.0, "gain_db": -2.0, "q": 1.1},
    {"freq_hz": 7000.0, "gain_db": 3.0, "q": 0.8},
)

# limiter detector time constants of the chain
LIM_RELEASE_MS = 100.0
LIM_ATTACK_MS = 1.0


def _combined_ir(sos, ir, wet: float, dry: float):
    """Host combined impulse response of EQ -> reverb:
    ``dry*h_eq + wet*(h_eq (*) ir)`` with ``h_eq`` truncated at a
    -120 dB l1 tail, re-trimmed, float32. None if the cascade's
    response does not truncate."""
    h_eq = _biquad.sos_impulse_np(sos)
    if h_eq is None:
        return None
    c = wet * np.convolve(h_eq, np.asarray(ir, np.float64))
    c[: len(h_eq)] += dry * h_eq
    return _reverb.trim_ir_tail(c).astype(np.float32)


def flagship_oracle_np(voice_i16, bgm_i16, sr_in: int = 44100,
                       sr_bus: int = 16000, bands=DEFAULT_BANDS,
                       ir_seconds: float = 0.25, wet: float = 0.25,
                       dry: float = 0.75, bgm_gain: float = 0.4,
                       fade_ms: float = 250.0,
                       threshold_db: float = -3.0) -> np.ndarray:
    """Float64 host oracle of the full chain (numpy/scipy composition
    of the per-op oracles; exact EQ IIR, no fold). Its loops are O(n)
    per clip in Python: pass one clip, not a batch."""
    v = np.asarray(voice_i16)
    b = np.asarray(bgm_i16)
    x = (v.astype(np.float64) + bgm_gain * b.astype(np.float64)) / 32768.0
    m = _resample.resample_oracle_np(x, sr_in, sr_bus)
    nb = m.shape[-1]
    fade = int(round(fade_ms * sr_bus / 1000.0))
    out = m * _mix.fade_ramp_np(nb, fade, fade, nb)
    peak = np.max(np.abs(out), axis=-1, keepdims=True)
    scale = np.where(peak > 0, _mix.db_to_amp(-1.0) / np.maximum(peak, 1e-30),
                     1.0)
    out = out * scale
    sos = _biquad.eq_sos(list(bands), sr_bus)
    out, _ = _biquad.sosfilt_np(sos, out)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype(np.float64)
    out = _reverb.reverb_np(out, ir, wet=wet, dry=dry)
    y, _ = _limiter.limiter_np(out[..., None, :], sr_bus,
                               threshold_db=threshold_db,
                               release_ms=LIM_RELEASE_MS,
                               attack_ms=LIM_ATTACK_MS)
    return _convert.f32_to_pcm16_np(y[..., 0, :].astype(np.float32))


def flagship_tables(sr_in: int = 44100, sr_bus: int = 16000,
                    bands=DEFAULT_BANDS, ir_seconds: float = 0.25,
                    wet: float = 0.25, dry: float = 0.75,
                    bgm_gain: float = 0.4, fade_ms: float = 250.0,
                    threshold_db: float = -3.0) -> dict:
    """Every host table the step needs (the chain has no learned
    weights): EQ ``sos``, combined EQ+reverb ``ir`` (float32), the
    aligned resample tables ``H1``/``H0``/``H2`` with ``lo``/``hi``/
    ``r0``/``r2``, the limiter coefficients ``k_rel``/``c_att``, the
    ``curve`` (threshold, knee, ceiling, slope, makeup), the ``fade``
    length and the rates and mix gain."""
    _resample.check_rates(sr_in, sr_bus)
    sos = _biquad.eq_sos(list(bands), sr_bus)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype(np.float32)
    ir_comb = _combined_ir(sos, ir, wet, dry)
    if ir_comb is None:
        raise NotPortedError(
            "the EQ impulse response does not truncate, so the EQ cannot "
            "fold into the reverb; the unfolded chain needs the eq_env "
            "kernel (ROADMAP.md Queue 2, K6)")
    g = math.gcd(sr_in, sr_bus)
    t = _resample.aligned_tables(
        _resample.make_plan(sr_bus // g, sr_in // g, 24, 9.0))
    return {
        "sos": sos, "ir": ir_comb,
        "H1": t.H1, "H0": t.H0, "H2": t.H2,
        "lo": t.lo, "hi": t.hi, "r0": t.r0, "r2": t.r2,
        "k_rel": _limiter._release_coeff(LIM_RELEASE_MS, sr_bus),
        "c_att": _limiter._attack_coeff(LIM_ATTACK_MS, sr_bus),
        "curve": np.array(curve_of(threshold_db), np.float64),
        "fade": int(round(fade_ms * sr_bus / 1000.0)),
        "sr_in": sr_in, "sr_bus": sr_bus, "bgm_gain": bgm_gain,
    }


class FlagshipStep(nn.Module):
    """The flagship chain: forward(voice_i16 (B, n), bgm_i16 (B, n)) ->
    int16 (B, ceil(n*L/M)). Host tables are buffers on ``device``."""

    def __init__(self, tables: dict, device=None, auto_fused: bool = False):
        super().__init__()
        dev = torch.device(device) if device is not None else None
        f32 = torch.float32
        self.register_buffer("ir", torch.as_tensor(
            np.asarray(tables["ir"]), dtype=f32, device=dev).contiguous())
        # the resample tables carry pcm16_to_f32's 1/32768 (see front)
        for name in ("H1", "H0", "H2"):
            h = np.asarray(tables[name], np.float64) / _convert.PCM16_SCALE
            self.register_buffer(name, torch.as_tensor(
                h, dtype=f32, device=dev).contiguous())
        self.register_buffer("sos", torch.as_tensor(
            np.asarray(tables["sos"], np.float64), device=dev))
        self.lo, self.hi = int(tables["lo"]), int(tables["hi"])
        self.r0, self.r2 = int(tables["r0"]), int(tables["r2"])
        self.k_rel = float(tables["k_rel"])
        self.c_att = float(tables["c_att"])
        self.curve = tuple(float(v) for v in tables["curve"])
        self.fade = int(tables["fade"])
        self.sr_in, self.sr_bus = int(tables["sr_in"]), int(tables["sr_bus"])
        self.bgm_gain = float(tables["bgm_gain"])
        self.register_buffer("gain", torch.tensor(self.bgm_gain, dtype=f32,
                                                  device=dev))
        g = math.gcd(self.sr_in, self.sr_bus)
        self.M = self.sr_in // g
        # fused=None in make_flagship_step: the JAX package's auto rule
        # takes the unfused chain below 128 rows, which is not ported
        self.auto_fused = auto_fused

    @classmethod
    def from_tables(cls, tables: dict, device=None) -> "FlagshipStep":
        """Step from host tables built elsewhere (keys as
        :func:`flagship_tables` returns them)."""
        return cls(tables, device=device)

    @torch.no_grad()
    def front(self, voice_i16: torch.Tensor, bgm_i16: torch.Tensor):
        """Mix, resample and normalize stages -> (m (B, nb) bus signal,
        scale (B,) normalize gain, ramp (nb,) fade): the inputs of the
        fftconv kernel, which applies scale and ramp as it loads m."""
        B, n_in = voice_i16.shape
        if bgm_i16.shape != voice_i16.shape:
            raise ValueError(f"voice {tuple(voice_i16.shape)} and bgm "
                             f"{tuple(bgm_i16.shape)} differ")
        if self.auto_fused and B < 128:
            raise NotPortedError(
                f"fused=None picks the unfused chain for {B} < 128 rows, "
                "which needs the IIR kernel (ROADMAP.md Queue 2, K5); "
                "pass fused=True to run the fused chain")
        if not _resample.aligned_supported(n_in, self.sr_in, self.sr_bus):
            raise NotPortedError(
                f"clip length {n_in} is not a multiple of {self.M} input "
                "samples; only the aligned resample front is ported "
                "(ROADMAP.md Queue 1 item 7, ragged batches)")
        with stage("mixfirst"):
            # frame the int16 inputs first, then mix at integer scale,
            # v + g*b in float32, and let the resample tables (scaled by
            # 1/32768 in __init__) apply pcm16_to_f32's scale. Scaling by
            # a power of two commutes with every float32 rounding, so this
            # is bit for bit the JAX package's pcm16_to_f32(v3) + g *
            # pcm16_to_f32(b3) through the unscaled tables, in two
            # elementwise passes instead of six. Mixing before the rate
            # conversion is exact: the resampler is LTI and both tracks
            # share the fade window.
            M = self.M
            v3 = voice_i16.reshape(B, n_in // M, M)
            b3 = bgm_i16.reshape(B, n_in // M, M)
            m3 = (b3 * self.gain).add_(v3)  # int16 * f32 0-dim -> f32
            m = _resample.apply_aligned(
                m3, self.H1, self.H0, self.H2, self.lo, self.hi,
                self.r0, self.r2).reshape(B, -1)
            nb = m.shape[-1]
            ramp = _mix.fade_ramp(nb, self.fade, self.fade, nb,
                                  device=m.device)
        with stage("normalize"):
            # per-clip peak of the faded signal
            peak = torch.amax(m.abs() * ramp, dim=-1)
            scale = torch.where(
                peak > 0, _mix.db_to_amp(-1.0) / torch.clamp_min(peak, 1e-30),
                1.0)
        return m, scale, ramp

    @torch.no_grad()
    def forward(self, voice_i16: torch.Tensor,
                bgm_i16: torch.Tensor) -> torch.Tensor:
        m, scale, ramp = self.front(voice_i16, bgm_i16)
        with stage("eq+reverb"):
            out = _reverb.reverb(m, self.ir, wet=1.0, dry=0.0,
                                 pre_row=scale, pre_col=ramp)
        with stage("limiter"):
            out, _ = limiter(out, self.k_rel, self.c_att, self.curve)
        return _convert.f32_to_pcm16(out)


def make_flagship_step(
    sr_in: int = 44100,
    sr_bus: int = 16000,
    bands=DEFAULT_BANDS,
    ir_seconds: float = 0.25,
    wet: float = 0.25,
    dry: float = 0.75,
    bgm_gain: float = 0.4,
    fade_ms: float = 250.0,
    threshold_db: float = -3.0,
    iir_backend: str = "pallas",
    resample_backend: str = "mixfirst",
    fused: bool | None = None,
    lti_fold: bool = True,
    envelope_block: int | None = None,
    limiter_fuse: bool = True,
    device=None,
) -> FlagshipStep:
    """Build the flagship step on ``device`` with the port's own host
    tables. The arguments mirror ``xmtpu.batch.make_flagship_step``;
    ``iir_backend="pallas"`` names the JAX package's kernel branch,
    whose kernels this port replaces. ``fused=None`` is the JAX
    package's auto rule, which picks the fused branch only for >= 128
    rows; the port has only that branch, so pass ``fused=True`` for
    smaller batches. ``envelope_block``: the kernel steps per sample,
    which is ``envelope_block=1``; None is accepted as the default."""
    refuse = {
        "iir_backend": (iir_backend != "pallas",
                        "the scan backend needs the float64 twins "
                        "(ROADMAP.md Queue 1 item 5)"),
        "resample_backend": (resample_backend != "mixfirst",
                             "resample_backend values other than "
                             "'mixfirst' need their own kernels (ROADMAP.md "
                             "Queue 2, K7 'pallas' and K8 'rsmix')"),
        "fused": (fused is False,
                  "the unfused chain needs the IIR kernel (ROADMAP.md "
                  "Queue 2, K5)"),
        "lti_fold": (not lti_fold,
                     "the unfolded chain needs the eq_env kernel "
                     "(ROADMAP.md Queue 2, K6)"),
        "limiter_fuse": (not limiter_fuse,
                         "the unfused limiter needs the envelope-only "
                         "kernel (ROADMAP.md Queue 2, K3)"),
        "envelope_block": (envelope_block not in (None, 1),
                           "block lookahead is not ported; the envelope "
                           "kernel steps per sample (ROADMAP.md Queue 2, "
                           "K2 follow-up)"),
    }
    for name, (bad, why) in refuse.items():
        if bad:
            raise NotPortedError(f"{name}: {why}")
    return FlagshipStep(
        flagship_tables(sr_in, sr_bus, bands, ir_seconds, wet, dry,
                        bgm_gain, fade_ms, threshold_db), device=device,
        auto_fused=fused is None)
