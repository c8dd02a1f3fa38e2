"""Batched offline flagship chain on one GPU (counterpart of
``xmtpu.batch``).

A [B, n] batch of int16 voice and BGM clips runs the whole decode-side
chain as one module call. The front is picked by ``resample_backend``,
as the JAX step picks it:

- ``"mixfirst"`` (default): mix the int16 tracks at the input rate, then
  the banded polyphase resample (FP32 matmuls); the fade ramp is
  deferred to the next stage;
- ``"mixfirst_pad"``: the same, with the framed operand's minor
  dimension zero-padded to a multiple of 128 (441 -> 512) and zero rows
  in the filter, the JAX package's lane-padding front; the same FP32
  matmuls, so it may differ from ``"mixfirst"`` only by the matmul's
  rounding at another depth;
- ``"pallas"``: convert both tracks, resample them as 2B rows on the
  resample kernel, then fade and gain each and sum;
- ``"rsmix"``: the fused int16 resample + fade + mix kernel, or the
  two-track front where that kernel's gate (``resample_mix_supported``)
  refuses the length;

then the per-clip peak-normalize gain and one of the JAX package's
branches (``fused=None``: fused from 128 rows up):

- fused, folded: EQ + reverb as ONE convolution (the EQ impulse
  response folds into the reverb IR on the host) on the fftconv kernel,
  which applies the normalize gain (per row) and a deferred fade ramp
  (per sample) as the input loads, then the fused limiter kernel;
- fused, unfolded (``lti_fold=False``, or an EQ whose impulse response
  does not truncate): the reverb with its wet/dry mix on the fftconv
  kernel, then the EQ cascade and the limiter's envelope in one pass on
  the eq_env kernel, and the limiter's curve in torch;
- unfused (small batches): the EQ on the biquad kernel, time-segmented;
  the reverb on the fftconv kernel; the limiter's envelope on the
  envelope kernel, time-segmented, and its curve in torch. With
  ``iir_backend="scan"`` (the JAX package's float64 twin) the EQ runs as
  float64 associative scans (``ops.biquad.sosfilt_scan``) and the
  limiter as float64 scans (``limiter(backend="scan")``); the reverb
  stays on the fftconv kernel, nothing folds, and the auto rule never
  takes the fused branch.

:func:`make_batch_step` is the ragged-length step (``lengths`` per
clip; masked fades, peak and output). :func:`flagship_step_sharded` runs
the flagship step over the ``dp`` axis of a
:class:`~xmtpu_torch.parallel.Mesh` (:func:`shard_over_batch` makes one),
the branch decided from the global batch. Everything outside the kernels is
plain torch. Both steps build on ``cuda`` unless ``device=`` names another
device; ``device="cpu"`` runs the kernels' plain twins.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from xmtpu_torch.kernels.envelope import curve_of, envelope, limiter
from xmtpu_torch.kernels.eq_env import eq_env
from xmtpu_torch.kernels.iir import sosfilt
from xmtpu_torch.kernels.resample import resample as resample_kernel
from xmtpu_torch.kernels.rsmix import resample_mix, resample_mix_supported
from xmtpu_torch.ops import biquad as _biquad
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.ops import limiter as _limiter
from xmtpu_torch.ops import mix as _mix
from xmtpu_torch.ops import resample as _resample
from xmtpu_torch.ops import reverb as _reverb
from xmtpu_torch.utils.device import check_interpret, resolve_device
from xmtpu_torch.utils.errors import ConfigError
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

RESAMPLE_BACKENDS = ("mixfirst", "pallas", "rsmix", "mixfirst_pad")
MIXFIRST = ("mixfirst", "mixfirst_pad")
LANE_PAD = 128  # mixfirst_pad's multiple for the framed operand's width
IIR_BACKENDS = ("pallas", "scan")


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
    """Every host table the steps need (the chain has no learned
    weights): EQ ``sos``, combined EQ+reverb ``ir`` (float32, None when
    the EQ's impulse response does not truncate: the steps then run the
    unfolded chain) for the folded branch, the raw reverb IR
    ``reverb_ir`` (float32) and its ``wet``/``dry`` gains, the aligned
    resample tables ``H1``/``H0``/``H2`` with ``lo``/``hi``/``r0``/
    ``r2``, the limiter coefficients ``k_rel``/``c_att``, the ``curve``
    (threshold, knee, ceiling, slope, makeup), the ``fade`` length and
    the rates and mix gain."""
    _resample.check_rates(sr_in, sr_bus)
    sos = _biquad.eq_sos(list(bands), sr_bus)
    ir = _reverb.synthetic_ir(ir_seconds, sr_bus).astype(np.float32)
    g = math.gcd(sr_in, sr_bus)
    t = _resample.aligned_tables(
        _resample.make_plan(sr_bus // g, sr_in // g, 24, 9.0))
    return {
        "sos": sos, "ir": _combined_ir(sos, ir, wet, dry), "reverb_ir": ir,
        "wet": wet, "dry": dry,
        "H1": t.H1, "H0": t.H0, "H2": t.H2,
        "lo": t.lo, "hi": t.hi, "r0": t.r0, "r2": t.r2,
        "k_rel": _limiter._release_coeff(LIM_RELEASE_MS, sr_bus),
        "c_att": _limiter._attack_coeff(LIM_ATTACK_MS, sr_bus),
        "curve": np.array(curve_of(threshold_db), np.float64),
        "fade": int(round(fade_ms * sr_bus / 1000.0)),
        "sr_in": sr_in, "sr_bus": sr_bus, "bgm_gain": bgm_gain,
    }


def _check_resample_backend(name: str) -> None:
    if name not in RESAMPLE_BACKENDS:
        raise ConfigError(f"unknown resample_backend {name!r}; accepted: "
                          + ", ".join(map(repr, RESAMPLE_BACKENDS)))


class _Chain(nn.Module):
    """Host tables on ``device`` and the chain's stages after the front,
    shared by :class:`FlagshipStep` and :class:`BatchStep`."""

    def __init__(self, tables: dict, device=None, lti_fold: bool = True,
                 iir_backend: str = "pallas"):
        super().__init__()
        dev = resolve_device(device)
        f32 = torch.float32
        for name in ("ir", "reverb_ir"):
            h = tables[name]
            self.register_buffer(name, None if h is None else torch.as_tensor(
                np.asarray(h), dtype=f32, device=dev).contiguous())
        # host copy: the IIR's segment corrections are built from it
        self.sos = np.asarray(tables["sos"], np.float64)
        self.k_rel = float(tables["k_rel"])
        self.c_att = float(tables["c_att"])
        # the unfused limiter and the curve after eq_env, like the JAX
        # step's, read the threshold and keep the op's default knee,
        # ceiling, ratio and makeup
        self.curve = tuple(float(v) for v in tables["curve"])
        self.wet, self.dry = float(tables["wet"]), float(tables["dry"])
        self.fade = int(tables["fade"])
        self.sr_in, self.sr_bus = int(tables["sr_in"]), int(tables["sr_bus"])
        self.bgm_gain = float(tables["bgm_gain"])
        g = math.gcd(self.sr_in, self.sr_bus)
        self.L, self.M = self.sr_bus // g, self.sr_in // g
        self.lti_fold = lti_fold
        self.iir_backend = iir_backend
        # the EQ folds into the reverb IR unless asked not to, unless its
        # impulse response does not truncate, or on the scan engine
        self.fold = (lti_fold and self.ir is not None
                     and iir_backend == "pallas")

    def _limiter(self, out: torch.Tensor) -> torch.Tensor:
        """The unfused limiter: the envelope kernel, then the curve in
        torch (the JAX ``ops.limiter.limiter`` on its Pallas backend), or
        on the scan engine the float64 scans."""
        y, _ = _limiter.limiter(
            out[:, None, :], self.sr_bus, threshold_db=self.curve[0],
            release_ms=LIM_RELEASE_MS, attack_ms=LIM_ATTACK_MS,
            backend=self.iir_backend)
        return y[:, 0, :]

    def _unfolded(self, out: torch.Tensor, scale: torch.Tensor):
        """Fused branch without the fold, in the JAX step's order: the
        reverb first (LTI, so it commutes with the EQ) with the normalize
        gain in its wet/dry epilogue, then EQ + envelope on the eq_env
        kernel, the curve in torch. ``scale``: (B, 1)."""
        with stage("reverb"):
            out = _reverb.reverb(out, self.reverb_ir, wet=self.wet,
                                 dry=self.dry, prescale=scale)
        with stage("eq+limiter"):
            y, e2, _, _ = eq_env(self.sos, out, self.k_rel, self.c_att)
            return _limiter.apply_gain_curve(y[:, None, :], e2,
                                             self.curve[0])[:, 0, :]

    def _unfused(self, out: torch.Tensor, scale: torch.Tensor):
        """The small-batch branch in the JAX step's operation order: EQ
        on the normalized signal, reverb with its wet/dry mix, limiter.
        ``scale``: (B, 1)."""
        with stage("eq"):
            if self.iir_backend == "scan":
                out, _ = _biquad.sosfilt_scan(self.sos, out * scale)
            else:
                out, _ = sosfilt(self.sos, out * scale)
        with stage("reverb"):
            out = _reverb.reverb(out, self.reverb_ir, wet=self.wet,
                                 dry=self.dry)
        with stage("limiter"):
            return self._limiter(out)


class FlagshipStep(_Chain):
    """The flagship chain: forward(voice_i16 (B, n), bgm_i16 (B, n)) ->
    int16 (B, ceil(n*L/M)). Host tables are buffers on ``device``
    (None = ``cuda``; without a CUDA device that raises
    :class:`DeviceError`). ``fused``: True = the fused branch, False =
    the unfused one, None = the JAX package's rule (fused from 128 rows
    up, with ``iir_backend="pallas"``). ``limiter_fuse=False`` runs the
    folded branch's limiter as the envelope kernel plus the torch curve.
    ``lti_fold=False`` (or tables whose ``ir`` is None, or
    ``iir_backend="scan"``) runs the fused branch unfolded, on the eq_env
    kernel; the unfused branch does not fold either way.
    ``iir_backend``: ``"pallas"`` (the kernels) or ``"scan"`` (the
    unfused branch's EQ and limiter as float64 scans; module
    docstring).
    ``resample_backend``: the front (module docstring); anything but
    ``"mixfirst"``, ``"pallas"``, ``"rsmix"`` and ``"mixfirst_pad"``
    raises :class:`ConfigError`."""

    def __init__(self, tables: dict, device=None, fused: bool | None = None,
                 limiter_fuse: bool = True, lti_fold: bool = True,
                 resample_backend: str = "mixfirst",
                 iir_backend: str = "pallas"):
        _check_resample_backend(resample_backend)
        _check_iir_backend(iir_backend)
        super().__init__(tables, device=device, lti_fold=lti_fold,
                         iir_backend=iir_backend)
        dev = self.reverb_ir.device
        f32 = torch.float32
        # the resample tables carry pcm16_to_f32's 1/32768 (see front)
        for name in ("H1", "H0", "H2"):
            h = np.asarray(tables[name], np.float64) / _convert.PCM16_SCALE
            self.register_buffer(name, torch.as_tensor(
                h, dtype=f32, device=dev).contiguous())
        self.lo, self.hi = int(tables["lo"]), int(tables["hi"])
        self.r0, self.r2 = int(tables["r0"]), int(tables["r2"])
        self.register_buffer("gain", torch.tensor(self.bgm_gain, dtype=f32,
                                                  device=dev))
        self.fused = fused
        self.limiter_fuse = limiter_fuse
        self.resample_backend = resample_backend

    @classmethod
    def from_tables(cls, tables: dict, device=None, fused: bool | None = None,
                    limiter_fuse: bool = True, lti_fold: bool = True,
                    resample_backend: str = "mixfirst",
                    iir_backend: str = "pallas") -> "FlagshipStep":
        """Step from host tables built elsewhere (keys as
        :func:`flagship_tables` returns them)."""
        return cls(tables, device=device, fused=fused,
                   limiter_fuse=limiter_fuse, lti_fold=lti_fold,
                   resample_backend=resample_backend, iir_backend=iir_backend)

    def _mixfirst(self, voice_i16, bgm_i16) -> torch.Tensor:
        B, n_in = voice_i16.shape
        M = self.M
        if not _resample.aligned_supported(n_in, self.sr_in, self.sr_bus):
            # any length: mix in float32, the general banded resample
            g = float(np.float32(self.bgm_gain))
            m = (_convert.pcm16_to_f32(voice_i16)
                 + g * _convert.pcm16_to_f32(bgm_i16))
            return _resample.polyphase_resample(m, self.sr_in, self.sr_bus)
        # frame the int16 inputs first, then mix at integer scale, v + g*b
        # in float32, and let the resample tables (scaled by 1/32768 in
        # __init__) apply pcm16_to_f32's scale. Scaling by a power of two
        # commutes with every float32 rounding, so this is bit for bit
        # the JAX package's pcm16_to_f32(v3) + g * pcm16_to_f32(b3)
        # through the unscaled tables, in two elementwise passes instead
        # of six. Mixing before the rate conversion is exact: the
        # resampler is LTI and both tracks share the fade window.
        v3 = voice_i16.reshape(B, n_in // M, M)
        b3 = bgm_i16.reshape(B, n_in // M, M)
        m3 = (b3 * self.gain).add_(v3)  # int16 * f32 0-dim -> f32
        if self.resample_backend == "mixfirst_pad":
            # lanes M..Mp are zero, and apply_aligned gives H1 zero rows
            # there: they never reach the output
            Mp = -(-M // LANE_PAD) * LANE_PAD
            m3 = torch.nn.functional.pad(m3, (0, Mp - M))
        return _resample.apply_aligned(
            m3, self.H1, self.H0, self.H2, self.lo, self.hi,
            self.r0, self.r2).reshape(B, -1)

    def _two_track(self, voice_i16, bgm_i16) -> torch.Tensor:
        """Both tracks resampled as 2B rows on the resample kernel (for
        "pallas", and for the "rsmix" fallback, where the JAX step takes
        XLA's banded matmul), then faded, gained and summed."""
        B = voice_i16.shape[0]
        with stage("resample"):
            vb = _convert.pcm16_to_f32(torch.cat([voice_i16, bgm_i16], 0))
            vb = resample_kernel(vb, self.sr_in, self.sr_bus)
        with stage("mix"):
            nb = vb.shape[-1]
            return (_mix.apply_gain_fade(vb[:B], 1.0, self.fade, self.fade,
                                         length=nb)
                    + _mix.apply_gain_fade(vb[B:], self.bgm_gain, self.fade,
                                           self.fade, length=nb))

    @torch.no_grad()
    def front(self, voice_i16: torch.Tensor, bgm_i16: torch.Tensor):
        """Mix, resample and normalize stages -> (m (B, nb) bus signal,
        scale (B,) normalize gain, ramp (nb,) fade or None). The mixfirst
        front defers the fade ramp, which the next stage applies (the
        folded branch's fftconv kernel as it loads m); the other fronts
        apply it themselves and return None."""
        B, n_in = voice_i16.shape
        if bgm_i16.shape != voice_i16.shape:
            raise ValueError(f"voice {tuple(voice_i16.shape)} and bgm "
                             f"{tuple(bgm_i16.shape)} differ")
        ramp = None
        if self.resample_backend == "rsmix" and resample_mix_supported(
                n_in, B, self.sr_in, self.sr_bus):
            with stage("rsmix"):
                m = resample_mix(voice_i16.contiguous(), bgm_i16.contiguous(),
                                 self.sr_in, self.sr_bus, self.bgm_gain,
                                 self.fade) * float(np.float32(1.0 / 32768.0))
        elif self.resample_backend in MIXFIRST:
            with stage("mixfirst"):
                m = self._mixfirst(voice_i16, bgm_i16)
                nb = m.shape[-1]
                ramp = _mix.fade_ramp(nb, self.fade, self.fade, nb,
                                      device=m.device)
        else:
            m = self._two_track(voice_i16, bgm_i16)
        with stage("normalize"):
            # per-clip peak of the faded signal
            det = m.abs() if ramp is None else m.abs() * ramp
            peak = torch.amax(det, dim=-1)
            scale = torch.where(
                peak > 0, _mix.db_to_amp(-1.0) / torch.clamp_min(peak, 1e-30),
                1.0)
        return m, scale, ramp

    @torch.no_grad()
    def forward(self, voice_i16: torch.Tensor,
                bgm_i16: torch.Tensor) -> torch.Tensor:
        with stage("step"):
            return self._forward(voice_i16, bgm_i16)

    def _forward(self, voice_i16, bgm_i16):
        fused = (self.fused if self.fused is not None
                 else self.iir_backend == "pallas"
                 and voice_i16.shape[0] >= 128)
        m, scale, ramp = self.front(voice_i16, bgm_i16)
        if not (fused and self.fold):
            out = m if ramp is None else m * ramp
            if fused:
                return _convert.f32_to_pcm16(
                    self._unfolded(out, scale[:, None]))
            return _convert.f32_to_pcm16(self._unfused(out, scale[:, None]))
        with stage("eq+reverb"):
            out = _reverb.reverb(m, self.ir, wet=1.0, dry=0.0,
                                 pre_row=scale, pre_col=ramp)
        with stage("limiter"):
            if self.limiter_fuse:
                out, _ = limiter(out, self.k_rel, self.c_att, self.curve)
            else:
                out = self._limiter(out)
        return _convert.f32_to_pcm16(out)


def _check_iir_backend(name: str) -> None:
    if name not in IIR_BACKENDS:
        # the JAX step runs any other string as the scan backend
        raise ConfigError(f"unknown iir_backend {name!r}; accepted: "
                          + ", ".join(map(repr, IIR_BACKENDS)))


def check_options(iir_backend: str = "pallas",
                  resample_backend: str = "mixfirst",
                  envelope_block: int | None = None) -> None:
    """Raise for the flagship step's option values that do not run:
    :class:`ConfigError` for an unknown ``iir_backend`` or
    ``resample_backend`` or an ``envelope_block`` that is not a power of
    two (the limiter's own validation)."""
    _check_iir_backend(iir_backend)
    _limiter.check_envelope_block(envelope_block)
    _check_resample_backend(resample_backend)


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
    interpret: bool | None = None,
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
    whose kernels this port replaces; ``"scan"`` its float64 twin. ``fused=None`` is the JAX
    package's auto rule: the fused branch from 128 rows up, the unfused
    one below. ``envelope_block``: None or a power of two, as in
    ``ops.limiter.limiter``; the kernels step per sample, the same
    function in exact arithmetic as any block lookahead. See
    :class:`FlagshipStep` for ``resample_backend``, ``lti_fold`` and
    ``iir_backend``. ``interpret``: the JAX package's Pallas interpret
    mode; True means the kernels' plain twins, which run on the CPU only
    (:class:`ConfigError` on any other device, the default included,
    before anything is built); None and False let the device decide."""
    check_interpret(interpret, device)
    check_options(iir_backend, resample_backend, envelope_block)
    return FlagshipStep(
        flagship_tables(sr_in, sr_bus, bands, ir_seconds, wet, dry,
                        bgm_gain, fade_ms, threshold_db), device=device,
        fused=fused, limiter_fuse=limiter_fuse, lti_fold=lti_fold,
        resample_backend=resample_backend, iir_backend=iir_backend)


class BatchStep(_Chain):
    """Masked flagship step for ragged clip batches (counterpart of the
    step ``xmtpu.batch.make_batch_step`` returns): forward(voice_i16 (B,
    n_pad), bgm_i16 (B, n_pad), lengths (B,)) -> int16 (B,
    ceil(n_pad*L/M)). Clips are zero-padded to a common n_pad;
    ``lengths`` holds each clip's true sample count, so the fades, the
    peak and the output mask ignore the pad, and every output sample at
    or past ``ceil(length*L/M)`` is 0. The front mixes in float32 and
    resamples on ``polyphase_resample`` at any length; the branches are
    :class:`FlagshipStep`'s (fused from 128 rows up when ``fused`` is
    None), the folded one with the envelope kernel and the torch curve."""

    def __init__(self, tables: dict, device=None, fused: bool | None = None,
                 lti_fold: bool = True):
        super().__init__(tables, device=device, lti_fold=lti_fold)
        self.fused = fused

    @torch.no_grad()
    def forward(self, voice_i16: torch.Tensor, bgm_i16: torch.Tensor,
                lengths) -> torch.Tensor:
        with stage("step"):
            return self._forward(voice_i16, bgm_i16, lengths)

    def _forward(self, voice_i16, bgm_i16, lengths):
        if bgm_i16.shape != voice_i16.shape:
            raise ValueError(f"voice {tuple(voice_i16.shape)} and bgm "
                             f"{tuple(bgm_i16.shape)} differ")
        dev = voice_i16.device
        with stage("mixfirst"):
            g = float(np.float32(self.bgm_gain))
            v = (_convert.pcm16_to_f32(voice_i16)
                 + g * _convert.pcm16_to_f32(bgm_i16))
            v = _resample.polyphase_resample(v, self.sr_in, self.sr_bus)
        n = v.shape[-1]
        with stage("mask+normalize"):
            # per-clip output lengths at the bus rate, ceil(len * L / M),
            # in int64 (int32 len * L wraps for clips of ~304 s and up);
            # float64 indices (float32 is exact only below 2^24)
            lens = torch.as_tensor(lengths, device=dev).to(torch.int64)
            out_len = -torch.div(-lens * self.L, self.M,
                                 rounding_mode="floor")
            i = torch.arange(n, dtype=torch.float64, device=dev)[None, :]
            lenf = out_len.to(torch.float64)[:, None]
            mask = i < lenf
            fade = float(self.fade)
            if fade > 0:
                ramp = (torch.clamp_max((i + 1.0) / fade, 1.0) * torch.clamp(
                    (lenf - i) / fade, 0.0, 1.0)).to(torch.float32)
            else:  # no 0/0 NaN, which would poison the peak
                ramp = 1.0
            out = v * ramp * mask
            peak = torch.amax(out.abs(), dim=-1, keepdim=True)  # pad is 0
            scale = torch.where(
                peak > 0, _mix.db_to_amp(-1.0) / torch.clamp_min(peak, 1e-30),
                1.0)
        fused = self.fused if self.fused is not None else out.shape[0] >= 128
        if not fused:
            out = self._unfused(out, scale)
        elif not self.fold:
            out = self._unfolded(out, scale)
        else:
            with stage("eq+reverb"):
                out = _reverb.reverb(out, self.ir, wet=1.0, dry=0.0,
                                     prescale=scale)
            with stage("limiter"):
                e2, _ = envelope(out.abs(), self.k_rel, self.c_att)
                out = _limiter.apply_gain_curve(
                    out[:, None, :], e2, self.curve[0])[:, 0, :]
        return _convert.f32_to_pcm16(out * mask)


def make_batch_step(
    sr_in: int = 44100,
    sr_bus: int = 16000,
    bands=DEFAULT_BANDS,
    ir_seconds: float = 0.25,
    wet: float = 0.25,
    dry: float = 0.75,
    bgm_gain: float = 0.4,
    fade_ms: float = 250.0,
    threshold_db: float = -3.0,
    interpret: bool | None = None,
    fused: bool | None = None,
    lti_fold: bool = True,
    device=None,
) -> BatchStep:
    """Build the ragged-length step on ``device`` (None = ``cuda``;
    ``device="cpu"`` runs the kernels' plain twins). The arguments
    mirror ``xmtpu.batch.make_batch_step``; ``interpret`` as in
    :func:`make_flagship_step`."""
    check_interpret(interpret, device)
    return BatchStep(
        flagship_tables(sr_in, sr_bus, bands, ir_seconds, wet, dry,
                        bgm_gain, fade_ms, threshold_db), device=device,
        fused=fused, lti_fold=lti_fold)


def shard_over_batch(n_devices: int | None = None, device=None):
    """1-D data-parallel mesh over clips (counterpart of
    ``xmtpu.batch.shard_over_batch``) -> ``(mesh, ("dp", None))``, the
    mesh and the spec that splits a (B, n) batch over it
    (``mesh.split(x, spec)``). ``device=None``: the first ``n_devices``
    cards (all of them when None); fewer cards than asked, or none,
    raise :class:`DeviceError`. ``device="cpu"`` (or one card): that
    many virtual shards on it (one when ``n_devices`` is None)."""
    from xmtpu_torch.parallel.mesh import Mesh
    from xmtpu_torch.utils.errors import DeviceError

    if device is not None:
        return Mesh([device] * (n_devices or 1), ("dp",)), ("dp", None)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if not 1 <= n <= have:
        raise DeviceError(
            f"a data-parallel mesh of {n_devices or 'every'} card(s) needs "
            f"as many CUDA devices; this host has {have}. device=\"cpu\" "
            "(or \"cuda:0\") gives virtual shards")
    return Mesh([f"cuda:{i}" for i in range(n)], ("dp",)), ("dp", None)


class ShardedFlagshipStep:
    """The flagship step over the ``dp`` axis of a mesh (counterpart of
    the callable ``xmtpu.batch.flagship_step_sharded`` returns):
    ``step(voice_i16 (B, n), bgm_i16 (B, n))`` splits the clips over the
    ``dp`` shards, runs each shard's rows on its device and concatenates
    the int16 output on the input's device. Pure data parallelism: no
    exchange. One :class:`FlagshipStep` per distinct device (and branch),
    built at first use, serves every shard on that device; every
    shard's step is launched before the output is gathered. On a card
    the output can differ from the unsharded step's by 1 LSB: the
    ``mixfirst`` front's ``torch.matmul`` (``ops.resample.apply_aligned``)
    gets a cuBLAS kernel by its row count, which rounds otherwise at
    B/n rows than at B; K1 and K2 give every row bit for bit."""

    def __init__(self, mesh, **kw):
        if "device" in kw:
            raise ConfigError("the mesh names the devices; flagship_step_"
                              "sharded takes no device=")
        check_interpret(kw.get("interpret"), *mesh.devices.flat)
        check_options(kw.get("iir_backend", "pallas"),
                      kw.get("resample_backend", "mixfirst"),
                      kw.get("envelope_block"))
        mesh.axis_size("dp")
        self.mesh = mesh
        self.kw = kw
        self._steps: dict = {}

    def fused_for(self, batch: int) -> bool:
        """The branch from the GLOBAL batch (``fused=None``: the JAX
        rule, fused from 128 rows up with ``iir_backend="pallas"``): a
        global batch of 128 split into shards of fewer rows still runs
        the fused branch, as it would unsharded."""
        fused = self.kw.get("fused")
        if fused is None:
            fused = (self.kw.get("iir_backend", "pallas") == "pallas"
                     and batch >= 128)
        return bool(fused)

    def step_on(self, device, fused: bool) -> FlagshipStep:
        key = (str(device), fused)
        if key not in self._steps:
            self._steps[key] = make_flagship_step(
                **{**self.kw, "fused": fused}, device=device)
        return self._steps[key]

    @torch.no_grad()
    def __call__(self, voice_i16, bgm_i16) -> torch.Tensor:
        voice = torch.as_tensor(voice_i16)
        bgm = torch.as_tensor(bgm_i16)
        fused = self.fused_for(int(np.prod(voice.shape[:-1])))
        spec = ("dp", None)
        vs = self.mesh.split(voice, spec)
        bs = self.mesh.split(bgm, spec)
        out = np.empty(vs.shape, dtype=object)
        for idx in np.ndindex(vs.shape):
            out[idx] = self.step_on(self.mesh.devices[idx], fused)(
                vs[idx], bs[idx])
        return self.mesh.concat(out, spec, voice.device)


def flagship_step_sharded(mesh, **kw) -> ShardedFlagshipStep:
    """The flagship step over the mesh's ``dp`` axis (counterpart of
    ``xmtpu.batch.flagship_step_sharded``); ``kw`` as
    :func:`make_flagship_step`'s, without ``device`` (the mesh names the
    devices); ``interpret=True`` is refused unless every device of the
    mesh is the CPU. See :class:`ShardedFlagshipStep`."""
    return ShardedFlagshipStep(mesh, **kw)
