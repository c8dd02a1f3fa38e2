"""Track alignment and mixing (counterpart of ``xmtpu.graph.mixer``):
N tracks (voice, BGM, music) resampled to the bus rate, placed, looped,
trimmed, gained and faded, summed on three buses, the voice bus through
its effect chain, side-chain ducking, then normalization.

Placement arithmetic is host integers from the config. There is nothing
to compile: effect chains come from ``fx.get_compiled_chain``'s
content-keyed LRU, and no cache holds a clip's PCM. Host PCM reaches the
device by blocking copies (``api._to_f32_device``), so no host buffer
is read after the call returns. A track off the bus rate is resampled by
``kernels.resample.resample``: the resample kernel on ``cuda`` (the
strided convolution for a band wider than 2M), its plain twin
``ops.resample.polyphase_resample`` on the CPU.

Every device operation of a call lies under a profiler range
(``utils.profiling.stage``) inside ``xmtpu_torch.mix``: ``mix_place``
(conversion, loop, gain and fade, pad and upmix, the bus sums; inside
it ``mix_resample``), ``voice_fx`` (the voice chain, its effects'
ranges nested), ``duck``, ``lufs`` (``ops.loudness``), the int16
conversion's ``to_pcm16`` and ``mix_out`` (the transpose and the copy to
the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from xmtpu_torch.api import _to_f32_device
from xmtpu_torch.kernels import resample as _kresample
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.ops import mix as _mix
from xmtpu_torch.ops import resample as _resample
from xmtpu_torch.utils.device import resolve_device
from xmtpu_torch.utils.errors import ConfigError
from xmtpu_torch.utils.profiling import stage


@dataclass(frozen=True)
class MixTrack:
    """One resolved mixer input: PCM + placement and gain parameters.

    ``pcm``: int16 or float, (n,) or (n, ch), a numpy array or a tensor.
    ``sr``: its native rate. ``gain``: linear amplitude. Times in ms,
    converted to samples at the bus rate.
    """

    pcm: object
    sr: int
    gain: float = 1.0
    start_ms: float = 0.0
    fade_in_ms: float = 0.0
    fade_out_ms: float = 0.0
    loop: bool = False
    kind: str = "voice"  # voice | bgm | music
    side_duck: bool = False  # duck this track under the voice bus

    @staticmethod
    def from_dict(d: dict) -> "MixTrack":
        return MixTrack(
            pcm=d["pcm"],
            sr=int(d.get("sr", d.get("sample_rate", 0)) or 0),
            gain=float(d.get("gain", _mix.db_to_amp(d["gain_db"])
                             if "gain_db" in d else 1.0)),
            start_ms=float(d.get("start_ms", 0.0)),
            fade_in_ms=float(d.get("fade_in_ms", 0.0)),
            fade_out_ms=float(d.get("fade_out_ms", 0.0)),
            loop=bool(d.get("loop", False)),
            kind=str(d.get("kind", "voice")),
            side_duck=bool(d.get("side_duck", False)),
        )


def _ms_to_samples(ms: float, sr: int) -> int:
    return int(round(ms * sr / 1000.0))


def _ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def _coerce_track(t) -> MixTrack:
    """A MixTrack, a config dict, or a bare ``(pcm, sr)`` pair."""
    if isinstance(t, MixTrack):
        return t
    if isinstance(t, dict):
        return MixTrack.from_dict(t)
    if (isinstance(t, (tuple, list)) and len(t) == 2
            and np.isscalar(t[1]) and not np.isscalar(t[0])):
        return MixTrack(pcm=t[0], sr=int(t[1]))
    raise ConfigError(
        f"mix() track must be a MixTrack, a dict with 'pcm'/'sr', or a "
        f"(pcm, sr) pair; got {type(t).__name__}")


def _pcm_of(t: MixTrack):
    """The track's PCM as (n, ch), without copying a tensor to the
    host."""
    pcm = t.pcm if hasattr(t.pcm, "ndim") else np.asarray(t.pcm)
    return pcm[:, None] if pcm.ndim == 1 else pcm


def _check_track(t: MixTrack) -> None:
    for nm, val in (("start_ms", t.start_ms), ("fade_in_ms", t.fade_in_ms),
                    ("fade_out_ms", t.fade_out_ms)):
        if not (val >= 0.0) or val == float("inf"):
            raise ConfigError(f"track {nm} must be finite and >= 0, "
                              f"got {val!r}")


def mix(tracks, sample_rate: int, normalize: str | None = "peak",
        target_db: float = -1.0, duration_ms: float | None = None,
        duck_params: dict | None = None, voice_effects=None, device=None,
        device_out: bool = False):
    """Mix tracks onto a common bus at ``sample_rate`` -> numpy (n,) or
    (n, ch), int16 when the first track is int16, else float32; with
    ``device_out``, the same layout and dtype as a contiguous tensor on
    the device, with no copy to the host.

    ``tracks``: MixTracks, dicts or ``(pcm, sr)`` pairs. Mono tracks are
    upmixed when any track is multichannel. Loop tracks repeat under the
    program and never extend it: the duration is the end of the last
    non-loop track (all loop: one pass of the longest), or
    ``duration_ms``. ``voice_effects``: an effect chain applied to the
    summed voice bus (kind "voice", not ducked) at the bus rate, after
    placement, gain and fades and before ducking. Side-ducked tracks are
    attenuated by ``ops.mix.duck_gain`` of the other buses' sum
    (``ops.mix.duck_apply``: one kernel call on ``cuda``).
    ``normalize``: "peak" (``target_db`` dBFS), "lufs" (BS.1770,
    ``target_db`` LUFS), "rms" (or its alias "loudness") or None. Runs on
    ``cuda`` unless ``device`` names another device."""
    with stage("mix"):
        return _mix_tracks(tracks, sample_rate, normalize, target_db,
                           duration_ms, duck_params, voice_effects, device,
                           device_out)


def _mix_tracks(tracks, sample_rate, normalize, target_db, duration_ms,
                duck_params, voice_effects, device, device_out):
    if not tracks:
        raise ValueError("mix() needs at least one track")
    dev = resolve_device(device)
    mts = [_coerce_track(t) for t in tracks]
    first = (mts[0].pcm if hasattr(mts[0].pcm, "ndim")
             else np.asarray(mts[0].pcm))
    first_1d = first.ndim == 1
    out_int16 = first.dtype in (np.int16, torch.int16)

    # host-side shape planning
    prepared = []  # (pcm (n, ch), native rate, length at the bus rate, track)
    nch = 1
    for t in mts:
        pcm = _pcm_of(t)
        nch = max(nch, pcm.shape[1])
        sr = t.sr or sample_rate
        _resample.check_rates(sr, sample_rate)
        _check_track(t)
        n_bus = _resample.resample_output_len(pcm.shape[0],
                                              *_ratio(sr, sample_rate))
        prepared.append((pcm, sr, n_bus, t))
    if duration_ms is not None and not (0 < float(duration_ms) < 1e12):
        raise ConfigError(f"duration_ms must be positive/finite, "
                          f"got {duration_ms!r}")
    for pcm, _, _, _ in prepared:
        if pcm.shape[1] not in (1, nch):
            raise ConfigError(
                f"cannot mix a {pcm.shape[1]}-channel track with "
                f"{nch}-channel material: only mono tracks upmix")
    has_voice = any(t.kind == "voice" and not t.side_duck for t in mts)
    if voice_effects and has_voice:  # a bad chain fails before device work
        from xmtpu_torch.graph import fx as _fx

        effs = _fx.get_compiled_chain(sample_rate, list(voice_effects),
                                      device_type=dev.type)

    if duration_ms is not None:
        total = _ms_to_samples(duration_ms, sample_rate)
    else:
        finite = [_ms_to_samples(t.start_ms, sample_rate) + n_bus
                  for (_, _, n_bus, t) in prepared if not t.loop]
        total = max(finite) if finite else max(
            _ms_to_samples(t.start_ms, sample_rate) + n_bus
            for (_, _, n_bus, t) in prepared)

    with stage("mix_place"):
        zeros = torch.zeros((nch, total), dtype=torch.float32, device=dev)
        voice, ducked, other = [], [], []
        for pcm, sr, _, t in prepared:
            y = _to_f32_device(pcm, dev)[0]  # (ch, n) f32, native rate
            if sr != sample_rate:
                with stage("mix_resample"):
                    y = _kresample.resample(y, sr, sample_rate)
            start = min(_ms_to_samples(t.start_ms, sample_rate), total)
            track_len = max(0, min(y.shape[-1], total - start))
            if t.loop and track_len and y.shape[-1] < total - start:
                y = y.repeat(1, -(-(total - start) // y.shape[-1]))
                track_len = total - start
            if track_len == 0:  # placed at or after the end: silence
                placed = zeros
            else:
                y = _mix.apply_gain_fade(
                    y[..., :track_len], t.gain,
                    _ms_to_samples(t.fade_in_ms, sample_rate),
                    _ms_to_samples(t.fade_out_ms, sample_rate),
                    offset=0, length=track_len)
                placed = torch.nn.functional.pad(
                    y.expand(nch, track_len),
                    (start, total - start - track_len))
            # three buses: voice (its effects; drives the duck envelope),
            # side-ducked, everything else
            if t.side_duck:
                ducked.append(placed)
            elif t.kind == "voice":
                voice.append(placed)
            else:
                other.append(placed)
            del y
        voice_bus = _mix.mix_sum(voice) if voice else zeros
        other_bus = _mix.mix_sum(other) if other else zeros
    if voice_effects and has_voice:
        # None states: the whole-clip paths (auto: the kernels on cuda,
        # the float64 scans on the CPU)
        with stage("voice_fx"):
            voice_bus, _ = _fx.chain_apply(effs, voice_bus.contiguous(),
                                           tuple(None for _ in effs))
    with stage("mix_place"):
        out = voice_bus + other_bus
    if ducked:
        with stage("duck"):
            bed = ducked[0] if len(ducked) == 1 else _mix.mix_sum(ducked)
            out = _mix.duck_apply(out, bed, sample_rate, overwrite=True,
                                  **(duck_params or {}))
    if normalize == "peak":
        out, _ = _mix.peak_normalize(out, _mix.db_to_amp(target_db))
    elif normalize == "lufs":
        from xmtpu_torch.ops.loudness import lufs_normalize

        out, _ = lufs_normalize(out, sample_rate, target_db, device=dev)
    elif normalize in ("rms", "loudness"):
        out, _ = _mix.rms_normalize(out, _mix.db_to_amp(target_db))
    elif normalize is not None:
        raise ValueError(f"unknown normalize mode: {normalize!r}")
    if out_int16:
        out = _convert.f32_to_pcm16(out)
    with stage("mix_out"):
        out = out.T.contiguous()  # (n, ch)
        if not device_out:
            out = out.cpu().numpy()
    if first_1d and out.shape[1] == 1:
        out = out[:, 0]
    return out
