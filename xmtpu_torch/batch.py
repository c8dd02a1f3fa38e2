"""Batched offline flagship chain on one GPU (counterpart of
``xmtpu.batch``).

A [B, n] batch of int16 voice and BGM clips runs the whole decode-side
chain as one module call. The front is shared:

    frame + convert + mix (int16 -> f32)  ->  banded polyphase resample
    (two FP32 matmuls)  ->  fade ramp + per-clip peak normalize gain

and then one of the JAX package's two branches, picked as it picks
them (``fused=None``: fused from 128 rows up):

- fused: EQ + reverb as ONE convolution (the EQ impulse response folds
  into the reverb IR on the host) on the fftconv kernel, which also
  applies the normalize gain (per row) and the fade ramp (per sample)
  as the input loads, then the fused limiter kernel (envelope, curve
  and clamp in one pass);
- unfused (small batches): the EQ as an IIR cascade on the biquad
  kernel, time-segmented; the reverb with its wet/dry mix on the
  fftconv kernel; the limiter's envelope on the envelope kernel,
  time-segmented, and its curve in torch.

Everything else is plain torch. ``make_flagship_step`` refuses the
options whose paths are not ported with :class:`NotPortedError` naming
the ROADMAP item that ports them. The step builds on ``cuda`` unless
``device=`` names another device; ``device="cpu"`` runs the kernels'
plain twins.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from xmtpu_torch.kernels.envelope import curve_of, limiter
from xmtpu_torch.kernels.iir import sosfilt
from xmtpu_torch.ops import biquad as _biquad
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.ops import limiter as _limiter
from xmtpu_torch.ops import mix as _mix
from xmtpu_torch.ops import resample as _resample
from xmtpu_torch.ops import reverb as _reverb
from xmtpu_torch.utils.errors import DeviceError, NotPortedError
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
    weights): EQ ``sos``, combined EQ+reverb ``ir`` (float32) for the
    fused branch, the raw reverb IR ``reverb_ir`` (float32) and its
    ``wet``/``dry`` gains for the unfused one, the aligned resample
    tables ``H1``/``H0``/``H2`` with ``lo``/``hi``/``r0``/``r2``, the
    limiter coefficients ``k_rel``/``c_att``, the ``curve`` (threshold,
    knee, ceiling, slope, makeup), the ``fade`` length and the rates and
    mix gain."""
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
        "sos": sos, "ir": ir_comb, "reverb_ir": ir, "wet": wet, "dry": dry,
        "H1": t.H1, "H0": t.H0, "H2": t.H2,
        "lo": t.lo, "hi": t.hi, "r0": t.r0, "r2": t.r2,
        "k_rel": _limiter._release_coeff(LIM_RELEASE_MS, sr_bus),
        "c_att": _limiter._attack_coeff(LIM_ATTACK_MS, sr_bus),
        "curve": np.array(curve_of(threshold_db), np.float64),
        "fade": int(round(fade_ms * sr_bus / 1000.0)),
        "sr_in": sr_in, "sr_bus": sr_bus, "bgm_gain": bgm_gain,
    }


_UNFOLDED = ("lti_fold=False on the fused branch needs the eq_env kernel "
             "(ROADMAP.md Queue 2, K6); the unfused branch (fused=False, "
             "or fewer than 128 rows) does not fold and runs")


def _resolve_device(device) -> torch.device:
    """``device`` as given, else ``cuda``; never the CPU unless asked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device: the step builds on cuda unless a device is "
            "given; pass device=\"cpu\" to run the kernels' plain torch "
            "twins on the CPU")
    return torch.device("cuda")


class FlagshipStep(nn.Module):
    """The flagship chain: forward(voice_i16 (B, n), bgm_i16 (B, n)) ->
    int16 (B, ceil(n*L/M)). Host tables are buffers on ``device``
    (None = ``cuda``; without a CUDA device that raises
    :class:`DeviceError`). ``fused``: True = the fused branch, False =
    the unfused one, None = the JAX package's rule (fused from 128 rows
    up). ``limiter_fuse=False`` runs the fused branch's limiter as the
    envelope kernel plus the torch curve. ``lti_fold=False`` only
    changes the fused branch, which it refuses (:class:`NotPortedError`,
    at build for ``fused=True``, at the call for ``fused=None`` from 128
    rows up); the unfused branch runs as with the fold."""

    def __init__(self, tables: dict, device=None, fused: bool | None = None,
                 limiter_fuse: bool = True, lti_fold: bool = True):
        super().__init__()
        if fused and not lti_fold:
            raise NotPortedError(_UNFOLDED)
        dev = _resolve_device(device)
        f32 = torch.float32
        for name in ("ir", "reverb_ir"):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(tables[name]), dtype=f32, device=dev).contiguous())
        # the resample tables carry pcm16_to_f32's 1/32768 (see front)
        for name in ("H1", "H0", "H2"):
            h = np.asarray(tables[name], np.float64) / _convert.PCM16_SCALE
            self.register_buffer(name, torch.as_tensor(
                h, dtype=f32, device=dev).contiguous())
        # host copy: the IIR's segment corrections are built from it
        self.sos = np.asarray(tables["sos"], np.float64)
        self.lo, self.hi = int(tables["lo"]), int(tables["hi"])
        self.r0, self.r2 = int(tables["r0"]), int(tables["r2"])
        self.k_rel = float(tables["k_rel"])
        self.c_att = float(tables["c_att"])
        # the unfused limiter, like the JAX step's, reads the threshold
        # and keeps the op's default knee, ceiling, ratio and makeup
        self.curve = tuple(float(v) for v in tables["curve"])
        self.wet, self.dry = float(tables["wet"]), float(tables["dry"])
        self.fade = int(tables["fade"])
        self.sr_in, self.sr_bus = int(tables["sr_in"]), int(tables["sr_bus"])
        self.bgm_gain = float(tables["bgm_gain"])
        self.register_buffer("gain", torch.tensor(self.bgm_gain, dtype=f32,
                                                  device=dev))
        g = math.gcd(self.sr_in, self.sr_bus)
        self.M = self.sr_in // g
        self.fused = fused
        self.limiter_fuse = limiter_fuse
        self.lti_fold = lti_fold

    @classmethod
    def from_tables(cls, tables: dict, device=None, fused: bool | None = None,
                    limiter_fuse: bool = True,
                    lti_fold: bool = True) -> "FlagshipStep":
        """Step from host tables built elsewhere (keys as
        :func:`flagship_tables` returns them)."""
        return cls(tables, device=device, fused=fused,
                   limiter_fuse=limiter_fuse, lti_fold=lti_fold)

    @torch.no_grad()
    def front(self, voice_i16: torch.Tensor, bgm_i16: torch.Tensor):
        """Mix, resample and normalize stages -> (m (B, nb) bus signal,
        scale (B,) normalize gain, ramp (nb,) fade). The fused branch's
        fftconv kernel applies scale and ramp as it loads m."""
        B, n_in = voice_i16.shape
        if bgm_i16.shape != voice_i16.shape:
            raise ValueError(f"voice {tuple(voice_i16.shape)} and bgm "
                             f"{tuple(bgm_i16.shape)} differ")
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
        fused = (self.fused if self.fused is not None
                 else voice_i16.shape[0] >= 128)
        if fused and not self.lti_fold:
            raise NotPortedError(_UNFOLDED)
        m, scale, ramp = self.front(voice_i16, bgm_i16)
        if not fused:
            return self._unfused(m, scale, ramp)
        with stage("eq+reverb"):
            out = _reverb.reverb(m, self.ir, wet=1.0, dry=0.0,
                                 pre_row=scale, pre_col=ramp)
        with stage("limiter"):
            if self.limiter_fuse:
                out, _ = limiter(out, self.k_rel, self.c_att, self.curve)
            else:
                out = self._limiter(out)
        return _convert.f32_to_pcm16(out)

    def _limiter(self, out: torch.Tensor) -> torch.Tensor:
        """The unfused limiter: the envelope kernel, then the curve in
        torch (the JAX ``ops.limiter.limiter`` on its Pallas backend)."""
        y, _ = _limiter.limiter(
            out[:, None, :], self.sr_bus, threshold_db=self.curve[0],
            release_ms=LIM_RELEASE_MS, attack_ms=LIM_ATTACK_MS)
        return y[:, 0, :]

    def _unfused(self, m, scale, ramp) -> torch.Tensor:
        """The small-batch branch in the JAX step's operation order: EQ
        on the faded, normalized signal, reverb with its wet/dry mix,
        limiter, int16."""
        out = m * ramp
        with stage("eq"):
            out, _ = sosfilt(self.sos, out * scale[:, None])
        with stage("reverb"):
            out = _reverb.reverb(out, self.reverb_ir, wet=self.wet,
                                 dry=self.dry)
        with stage("limiter"):
            out = self._limiter(out)
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
    """Build the flagship step on ``device`` (None = ``cuda``;
    ``device="cpu"`` runs the kernels' plain twins) with the port's own
    host tables. The arguments mirror ``xmtpu.batch.make_flagship_step``;
    ``iir_backend="pallas"`` names the JAX package's kernel branch,
    whose kernels this port replaces. ``fused=None`` is the JAX
    package's auto rule: the fused branch from 128 rows up, the unfused
    one below. ``lti_fold=False`` is refused where the fused branch
    runs (see :class:`FlagshipStep`). ``envelope_block``: the kernels
    step per sample, which is ``envelope_block=1``; None is accepted as
    the default."""
    refuse = {
        "iir_backend": (iir_backend != "pallas",
                        "the scan backend needs the float64 twins "
                        "(ROADMAP.md Queue 1 item 5)"),
        "resample_backend": (resample_backend != "mixfirst",
                             "resample_backend values other than "
                             "'mixfirst' need their own kernels (ROADMAP.md "
                             "Queue 2, K7 'pallas' and K8 'rsmix')"),
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
        fused=fused, limiter_fuse=limiter_fuse, lti_fold=lti_fold)
