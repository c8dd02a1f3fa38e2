"""Config schema: tracks + effects, JSON <-> frozen dataclasses
(counterpart of ``xmtpu.config.schema``: the same fields, JSON names,
checks and messages, with the port's error classes).

Field names keep the reference's JSON vocabulary (``url``, ``volume``,
``fadeInTimeMs``/``fadeOutTimeMs``, ``startTimeMs``/``endTimeMs``,
per-effect name + params). Values every consumer would reject fail at
parse time with :class:`ConfigError`; effect names are checked later,
by ``graph.fx.build_chain``.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field
from typing import Any

from xmtpu_torch.utils.errors import ConfigError


@dataclass(frozen=True)
class EffectConfig:
    """One effect in a chain: name + free-form params.

    Known names: ``equalizer`` (params: bands=[{freq_hz, gain_db, q}]),
    ``reverb`` (params: ir_seconds | ir_wav, wet, dry),
    ``limiter`` (params: threshold_db, knee_db, attack_ms, release_ms),
    ``volume`` (params: gain_db), ``noise_suppression``.
    """

    name: str
    params: dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class TrackConfig:
    """One input track of the mixer (a 'url' entry of the mixer JSON
    with timing, volume and fade fields)."""

    url: str | None = None  # file path; None when PCM is passed directly
    kind: str = "voice"  # voice | bgm | music
    volume: float = 1.0  # linear gain
    start_time_ms: float = 0.0  # placement offset in the output timeline
    end_time_ms: float | None = None  # trim point in the output timeline
    fade_in_ms: float = 0.0
    fade_out_ms: float = 0.0
    loop: bool = False  # loop the track under the program
    side_duck: bool = False  # duck this track under the voice

    def __post_init__(self):
        if not (self.volume >= 0) or math.isinf(self.volume):
            # NaN fails `>= 0` too: a NaN volume would poison the mix
            raise ValueError(
                f"track volume must be finite and >= 0, got {self.volume}")
        for name in ("start_time_ms", "fade_in_ms", "fade_out_ms"):
            v = getattr(self, name)
            if not math.isfinite(v):
                raise ValueError(f"track {name} must be finite, got {v}")
        if self.end_time_ms is not None and not math.isfinite(self.end_time_ms):
            raise ValueError(
                f"track end_time_ms must be finite, got {self.end_time_ms}")


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline description: tracks, effect chain, output format."""

    tracks: tuple[TrackConfig, ...] = ()
    effects: tuple[EffectConfig, ...] = ()  # applied to the voice bus
    master_effects: tuple[EffectConfig, ...] = ()  # applied post-mix
    sample_rate: int = 16000  # output rate; tracks are resampled to it
    channels: int = 1
    normalize: str | None = "peak"  # None | "peak" | "lufs" (BS.1770,
    # target_db means LUFS) | "rms" ("loudness" = legacy alias of rms)
    normalize_target_db: float = -1.0  # peak target (dBFS)
    block_size: int = 65536  # device block length (samples)
    bitrate: int | None = None  # encoder bits/s (compressed outputs;
    # None = codec default)


def _effect_from_json(d) -> EffectConfig:
    if not isinstance(d, dict) or "name" not in d:
        raise ConfigError(f"effect entry needs a 'name' field: {d!r}")
    params = d.get("params")
    if params is None:  # flat form: every non-name key is a param
        params = {k: v for k, v in d.items() if k != "name"}
    else:
        extra = set(d) - {"name", "params"}
        if extra:
            # the rule of graph.fx.build_chain: a key next to an
            # explicit 'params' dict would be dropped silently
            raise ConfigError(
                f"effect {d['name']!r}: unexpected key(s) "
                f"{sorted(extra)} alongside 'params' — put effect "
                f"parameters inside 'params'")
    return EffectConfig(name=d["name"], params=dict(params))


def _bool_field(d, key) -> bool:
    """Strict JSON boolean (0/1 tolerated): bool('false') is True."""
    v = d.get(key, False)
    if isinstance(v, bool):
        return v
    if v in (0, 1):
        return bool(v)
    raise ConfigError(f"track {key} must be a JSON boolean, got {v!r}")


_TRACK_KEYS = {"url", "kind", "volume", "startTimeMs", "endTimeMs",
               "fadeInTimeMs", "fadeOutTimeMs", "loop", "sideDuck"}


def _track_from_json(d) -> TrackConfig:
    if not isinstance(d, dict):
        raise ConfigError(f"track entry must be an object: {d!r}")
    unknown = set(d) - _TRACK_KEYS
    if unknown:  # a typo'd key would run the track with defaults
        raise ConfigError(
            f"track entry has unknown key(s) {sorted(unknown)}; "
            f"accepted: {sorted(_TRACK_KEYS)}")
    if d.get("kind", "voice") not in ("voice", "bgm", "music"):
        raise ConfigError(
            f"track kind must be voice|bgm|music, got {d['kind']!r}")
    url = d.get("url")
    if url is not None and not isinstance(url, str):
        raise ConfigError(f"track url must be a string: {url!r}")
    try:
        return TrackConfig(
            url=url,
            kind=d.get("kind", "voice"),
            volume=float(d.get("volume", 1.0)),
            start_time_ms=float(d.get("startTimeMs", 0.0)),
            end_time_ms=(None if d.get("endTimeMs") is None
                         else float(d["endTimeMs"])),
            fade_in_ms=float(d.get("fadeInTimeMs", 0.0)),
            fade_out_ms=float(d.get("fadeOutTimeMs", 0.0)),
            loop=_bool_field(d, "loop"),
            side_duck=_bool_field(d, "sideDuck"),
        )
    except (TypeError, ValueError) as e:
        raise ConfigError(f"bad track entry {d!r}: {e}") from e


_NORMALIZE_MODES = (None, "peak", "lufs", "rms", "loudness")
_TOP_KEYS = {"tracks", "effects", "masterEffects", "sampleRate", "channels",
             "normalize", "normalizeTargetDb", "blockSize", "bitrate"}


def config_from_dict(d: dict) -> PipelineConfig:
    if not isinstance(d, dict):
        raise ConfigError(f"pipeline config must be a JSON object: {d!r}")
    unknown = set(d) - _TOP_KEYS
    if unknown:  # {'masterEffect': [...]} would run with no effects
        raise ConfigError(
            f"pipeline config has unknown key(s) {sorted(unknown)}; "
            f"accepted: {sorted(_TOP_KEYS)}")
    try:
        cfg = PipelineConfig(
            tracks=tuple(_track_from_json(t) for t in d.get("tracks", [])),
            effects=tuple(_effect_from_json(e) for e in d.get("effects", [])),
            master_effects=tuple(
                _effect_from_json(e) for e in d.get("masterEffects", [])),
            sample_rate=int(d.get("sampleRate", 16000)),
            channels=int(d.get("channels", 1)),
            normalize=d.get("normalize", "peak"),
            normalize_target_db=float(d.get("normalizeTargetDb", -1.0)),
            block_size=int(d.get("blockSize", 65536)),
            bitrate=(None if d.get("bitrate") is None else int(d["bitrate"])),
        )
    except ConfigError:
        raise
    except (TypeError, ValueError, OverflowError) as e:
        # OverflowError: int(float('inf'))
        raise ConfigError(f"bad pipeline config field: {e}") from e
    if not math.isfinite(cfg.normalize_target_db):
        raise ConfigError(
            f"normalizeTargetDb must be finite, got {cfg.normalize_target_db}")
    if cfg.sample_rate < 1 or cfg.channels < 1 or cfg.block_size < 1:
        raise ConfigError(
            f"sampleRate/channels/blockSize must be positive: got "
            f"{cfg.sample_rate}/{cfg.channels}/{cfg.block_size}")
    if cfg.normalize not in _NORMALIZE_MODES:
        raise ConfigError(
            f"unknown normalize mode {cfg.normalize!r}; "
            f"use one of {_NORMALIZE_MODES[1:]} or null")
    return cfg


def config_to_dict(cfg: PipelineConfig) -> dict:
    return {
        "tracks": [
            {
                "url": t.url,
                "kind": t.kind,
                "volume": t.volume,
                "startTimeMs": t.start_time_ms,
                "endTimeMs": t.end_time_ms,
                "fadeInTimeMs": t.fade_in_ms,
                "fadeOutTimeMs": t.fade_out_ms,
                "loop": t.loop,
                "sideDuck": t.side_duck,
            }
            for t in cfg.tracks
        ],
        "effects": [asdict(e) for e in cfg.effects],
        "masterEffects": [asdict(e) for e in cfg.master_effects],
        "sampleRate": cfg.sample_rate,
        "channels": cfg.channels,
        "normalize": cfg.normalize,
        "normalizeTargetDb": cfg.normalize_target_db,
        "blockSize": cfg.block_size,
        "bitrate": cfg.bitrate,
    }


def load_json_source(path_or_str, what: str = "config"):
    """Parse a JSON literal or a JSON file -> the parsed value.

    A str/bytes whose first non-space character is ``{`` or ``[`` parses
    as a literal; anything else is opened as a file path. Every failure
    raises :class:`ConfigError` naming ``what``.
    """
    s = (path_or_str.decode("utf-8", "replace")
         if isinstance(path_or_str, bytes) else str(path_or_str))
    if s.lstrip()[:1] in ("{", "["):  # JSON literal, not a path
        try:
            return json.loads(s)
        except json.JSONDecodeError as e:
            raise ConfigError(f"invalid {what} JSON: {e}") from e
    try:
        f = open(os.fsdecode(path_or_str) if isinstance(path_or_str, bytes)
                 else s)
    except OSError as e:
        raise ConfigError(
            f"{what} is neither a JSON object string nor a readable "
            f"file: {s[:80]!r} ({e})") from e
    with f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            raise ConfigError(f"{s}: invalid {what} JSON: {e}") from e


def load_config(path_or_str) -> PipelineConfig:
    """Load a PipelineConfig from a JSON file path or a JSON string."""
    return config_from_dict(load_json_source(path_or_str))


def dump_config(cfg: PipelineConfig, path=None) -> str:
    s = json.dumps(config_to_dict(cfg), indent=2)
    if path is not None:
        with open(path, "w") as f:
            f.write(s)
    return s
