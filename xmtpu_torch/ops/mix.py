"""Mixing primitives (counterpart of ``xmtpu.ops.mix``): the fade ramp
and dB gain (bit-exact with the JAX package's), the N-track sum, peak
and RMS normalization, side-chain ducking, and the float64 oracles.

Pinned ramp semantics:

* fade-in over ``F`` samples: sample ``i`` gets ``min(1, (i+1)/F)``;
* fade-out over ``F`` samples of a track of length ``N``: sample ``i``
  gets ``min(1, (N-i)/F)``;
* both ramps multiply (a short track may be inside both windows).

Normalization: ``peak`` scales so max |sample| == the target amplitude,
``rms`` (``loudness`` in the oracle) so the plain RMS does; both always
rescale, up or down, and pass silence through (scale 1). The optional
``where`` mask (True = a real sample) keeps padded batch entries out of
the peak and the mean (the ragged rule).

Ducking (:func:`duck_gain`): the limiter's detector on the voice bus,
float64 scans (``ops.limiter``), then a soft-edged gate: ``x =
clip((env_db - threshold_db)/knee_db + 0.5, 0, 1)``, gain ``10^(-depth_db
* x / 20)``; on a CUDA tensor the hand-written kernel ``kernels.duck``
computes the same in float64, and :func:`duck_apply` the ducked bus with
it in one call.
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


def mix_sum(tracks) -> torch.Tensor:
    """Sum aligned, already gained and faded tracks: [T, ..., n] (a
    tensor, or a sequence of equal-shaped tensors) -> [..., n]. No
    clipping: the final float32 -> int16 conversion clips."""
    if not torch.is_tensor(tracks):
        tracks = torch.stack([torch.as_tensor(t) for t in tracks])
    return torch.sum(tracks, dim=0)


def peak_normalize(x: torch.Tensor, target_amp: float, where=None):
    """Scale so max|x| == target_amp over the whole tensor. Returns
    (scaled, scale); silence (peak 0) keeps scale 1. ``where``: optional
    bool mask of the real samples."""
    ax = x.abs()
    if where is not None:
        ax = torch.where(torch.as_tensor(where, device=x.device), ax, 0.0)
    peak = torch.amax(ax)
    scale = torch.where(peak > 0,
                        torch.tensor(target_amp, dtype=x.dtype,
                                     device=x.device) / peak, 1.0)
    return x * scale, scale


def rms_normalize(x: torch.Tensor, target_amp: float, where=None):
    """Scale so the RMS of x == target_amp. Returns (scaled, scale);
    silence keeps scale 1. ``where``: optional bool mask of the real
    samples (the mean over them, at least one)."""
    sq = torch.square(x)
    if where is not None:
        w = torch.as_tensor(where, device=x.device)
        n = torch.clamp_min(torch.sum(w), 1)
        ms = torch.sum(torch.where(w, sq, 0.0)) / n
    else:
        ms = torch.mean(sq)
    rms = torch.sqrt(ms)
    scale = torch.where(rms > 0,
                        torch.tensor(target_amp, dtype=x.dtype,
                                     device=x.device) / rms, 1.0)
    return x * scale, scale


def duck_gain_block(voice_bus: torch.Tensor, sr: int, state,
                    threshold_db: float = -40.0, depth_db: float = 12.0,
                    knee_db: float = 10.0, attack_ms: float = 10.0,
                    release_ms: float = 300.0):
    """Stateful ducking gain for one block (..., n) -> (gain float64,
    state). ``state``: (env_last, smooth_last) shaped (...,) float64, or
    None for zeros; a stream that carries it gets the offline gain. On a
    CUDA tensor (float32) the duck kernel's gain form
    (``kernels.duck.gain``), elsewhere its twin, the float64 scans."""
    from xmtpu_torch.kernels import duck as _kduck
    from xmtpu_torch.ops import limiter as _lim

    return _kduck.gain(voice_bus, _lim._release_coeff(release_ms, sr),
                       _lim._attack_coeff(attack_ms, sr), threshold_db,
                       depth_db, knee_db, state)


def duck_gain(voice_bus: torch.Tensor, sr: int, threshold_db: float = -40.0,
              depth_db: float = 12.0, knee_db: float = 10.0,
              attack_ms: float = 10.0,
              release_ms: float = 300.0) -> torch.Tensor:
    """Side-chain ducking gain from a voice bus (..., n) -> gain (..., n)
    float64: :func:`duck_gain_block` from zero state."""
    g, _ = duck_gain_block(voice_bus, sr, None, threshold_db, depth_db,
                           knee_db, attack_ms, release_ms)
    return g


def duck_apply(side: torch.Tensor, ducked: torch.Tensor, sr: int,
               threshold_db: float = -40.0, depth_db: float = 12.0,
               knee_db: float = 10.0, attack_ms: float = 10.0,
               release_ms: float = 300.0,
               overwrite: bool = False) -> torch.Tensor:
    """The ducked bus ``side + ducked * duck_gain(side).to(float32)``,
    float32 of side's shape (``ducked`` the same shape). On a CUDA tensor
    one call of the duck kernel's mix form (``kernels.duck.apply``), the
    gain never stored; elsewhere that expression, through
    :func:`duck_gain`. With ``overwrite`` the result may be written over
    ``side``, which the caller then gives up."""
    kw = dict(threshold_db=threshold_db, depth_db=depth_db, knee_db=knee_db,
              attack_ms=attack_ms, release_ms=release_ms)
    if side.device.type != "cuda":
        prod = ducked * duck_gain(side, sr, **kw).to(torch.float32)
        return side.add_(prod) if overwrite else side + prod
    from xmtpu_torch.kernels import duck as _kduck
    from xmtpu_torch.ops import limiter as _lim

    return _kduck.apply(side, ducked, _lim._release_coeff(release_ms, sr),
                        _lim._attack_coeff(attack_ms, sr), threshold_db,
                        depth_db, knee_db, overwrite=overwrite)


def duck_gain_np(voice_bus, sr, threshold_db=-40.0, depth_db=12.0,
                 knee_db=10.0, attack_ms=10.0, release_ms=300.0):
    """Sequential float64 oracle for :func:`duck_gain`."""
    from xmtpu_torch.ops import limiter as _lim

    d = np.abs(np.asarray(voice_bus, np.float64))
    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)
    env_prev = np.zeros(d.shape[:-1])
    sm_prev = np.zeros(d.shape[:-1])
    e2 = np.empty_like(d)
    for i in range(d.shape[-1]):
        env_prev = np.maximum(d[..., i], k_rel * env_prev)
        sm_prev = (1 - c_att) * sm_prev + c_att * env_prev if c_att < 1.0 \
            else env_prev
        e2[..., i] = sm_prev
    env_db = 20.0 * np.log10(np.maximum(e2, 1e-12))
    x = np.clip((env_db - threshold_db) / knee_db + 0.5, 0.0, 1.0)
    return 10.0 ** (-depth_db * x / 20.0)


def mix_oracle_np(tracks, gains, fades_in, fades_out, normalize=None,
                  target_amp=None):
    """Float64 oracle of a mix: ``tracks`` equal-length arrays already
    aligned in time, each gained and faded, summed, then ``"peak"`` or
    ``"loudness"`` (RMS) normalized to ``target_amp``, or not."""
    out = np.zeros_like(np.asarray(tracks[0], np.float64))
    for x, g, fi, fo in zip(tracks, gains, fades_in, fades_out):
        x = np.asarray(x, np.float64)
        out = out + g * fade_ramp_np(len(x), fi, fo, len(x)) * x
    if normalize == "peak":
        peak = np.max(np.abs(out))
        if peak > 0:
            out = out * (target_amp / peak)
    elif normalize == "loudness":
        rms = np.sqrt(np.mean(out**2))
        if rms > 0:
            out = out * (target_amp / rms)
    return out
