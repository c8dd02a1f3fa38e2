"""One-shot file -> file pipeline (counterpart of
``xmtpu.graph.pipeline``): decode the tracks, mix them with the voice
effects and normalization on the device, run the master chain, encode.

Progress has stage granularity: 0 before decoding, 10 after it, 80
after the mix, 95 after the master chain and the int16 conversion, and
100 (``process_file``) after encoding.
"""

from __future__ import annotations

import numpy as np

from xmtpu_torch.config.schema import PipelineConfig
from xmtpu_torch.graph import mixer as _mixer
from xmtpu_torch.io import encode_audio, open_audio
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.utils.device import resolve_device
from xmtpu_torch.utils.errors import ConfigError


def resolve_source(track, sources, default_sr: int, index: int = 0):
    """One track's (pcm, native_sr): an in-memory ``sources`` entry
    (pcm or (pcm, sr)) by url, else the url decoded from disk."""
    if sources and track.url in sources:
        src = sources[track.url]
        return src if isinstance(src, tuple) else (src, default_sr)
    if track.url:
        with open_audio(track.url) as d:
            return d.read_all(), d.sample_rate
    raise ConfigError(f"track {index}: no url and no in-memory input")


def _resolve_tracks(inputs, config: PipelineConfig):
    """MixTracks from ``config.tracks``, decoding urls from disk;
    ``inputs`` (a dict name -> pcm or (pcm, sr)) overrides urls."""
    tracks = []
    for i, t in enumerate(config.tracks):
        pcm, sr = resolve_source(t, inputs, config.sample_rate, i)
        # endTimeMs is a point on the output timeline: the playable
        # content is end - start ms
        end = t.end_time_ms
        if end is not None:
            keep_ms = max(0.0, end - t.start_time_ms)
            if keep_ms < pcm.shape[0] * 1000.0 / sr:
                pcm = pcm[: int(round(keep_ms * sr / 1000.0))]
        tracks.append(_mixer.MixTrack(
            pcm=pcm, sr=sr, gain=t.volume, start_ms=t.start_time_ms,
            fade_in_ms=t.fade_in_ms, fade_out_ms=t.fade_out_ms, loop=t.loop,
            kind=t.kind, side_duck=t.side_duck))
    return tracks


def process(inputs, config: PipelineConfig, progress=None,
            device=None) -> np.ndarray:
    """Run the configured pipeline -> int16 PCM at the config's rate.
    Runs on ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)

    def report(p):
        if progress:
            progress(p)

    report(0.0)
    tracks = _resolve_tracks(inputs, config)
    report(10.0)
    # the voice effects run inside the mixer on the voice bus at the bus
    # rate, after placement, gain and fades
    mixed = _mixer.mix(
        tracks, config.sample_rate, normalize=config.normalize,
        target_db=config.normalize_target_db,
        voice_effects=list(config.effects) if config.effects else None,
        device=dev)
    report(80.0)
    if config.master_effects:
        from xmtpu_torch.graph import fx as _fx

        try:  # long clips run blocked, with carried state
            mixed = _fx.apply_chain(mixed, config.sample_rate,
                                    list(config.master_effects),
                                    block_size=config.block_size, device=dev)
        except ConfigError as e:
            # whole clip only for the blocked chain's offline-only
            # refusal (noise suppression); other errors stand
            if "offline-only" not in str(e):
                raise
            mixed = _fx.apply_chain(mixed, config.sample_rate,
                                    list(config.master_effects), device=dev)
    if mixed.dtype != np.int16:
        mixed = _convert.f32_to_pcm16_np(mixed)
    report(95.0)
    return mixed


def process_file(inputs, config: PipelineConfig, out_path, progress=None,
                 device=None):
    """Decode -> pipeline -> encoded file; the format follows the
    extension (``io.encode_audio``: WAV, or a registered backend; an
    unknown extension raises and writes nothing). ``config.bitrate``
    goes to the encoder. Returns ``out_path``."""
    pcm = process(inputs, config, progress=progress, device=device)
    encode_audio(out_path, pcm, config.sample_rate, bitrate=config.bitrate)
    if progress:
        progress(100.0)
    return out_path
