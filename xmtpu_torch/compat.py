"""Handle-style compatibility facade over the port's functional API
(counterpart of ``xmtpu.compat``).

The reference's public C surface, ``xm_audio_utils_create / mixer_init
/ mixer_seek / mixer_get_frame / freep`` and ``xm_audio_generator_start
/ get_progress / stop``, keeps its call shape: each method maps onto
the port's :class:`~xmtpu_torch.graph.streaming.StreamSession`,
``io.open_audio`` and ``graph.pipeline.process_file``. Both classes
take ``device=`` (None: ``cuda``, :class:`DeviceError` without a card
when a session or the generator starts; ``"cpu"`` runs the kernels'
plain twins) and pass it on. The decoder handle is host-only.

The generator runs on a host thread with a pollable progress and
status, as the reference's pthread and atomic progress; progress moves
at the pipeline's stage marks.
"""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np

from xmtpu_torch.config.schema import load_config
from xmtpu_torch.utils.errors import ConfigError, XmtpuError

# reference-style status codes (generator)
GS_IDLE = 0
GS_RUNNING = 1
GS_COMPLETED = 2
GS_ERROR = -1
GS_STOPPED = -2


class XmAudioUtils:
    """Interactive handle: mixer and voice-effects sessions with seek and
    frame reads, and a chunked decoder."""

    def __init__(self, device=None):
        self.device = device
        self._session = None
        self._fx_session = None
        self._decoder = None

    # -- mixer path (xm_audio_utils_mixer_*) --
    def mixer_init(self, config_json, sources=None, frame_ms: float = 20.0):
        """Parse a mixer JSON config and open its tracks (reference:
        ``xm_audio_utils_mixer_init``)."""
        from xmtpu_torch.graph.streaming import StreamSession

        cfg = load_config(config_json)
        self._session = StreamSession(cfg, frame_ms=frame_ms, sources=sources,
                                      device=self.device)
        return 0

    def mixer_seek(self, ms: float) -> int:
        self._require().seek(float(ms))
        return 0

    def mixer_get_frame(self) -> np.ndarray | None:
        """Next int16 frame, or None at the end of the stream (the
        reference returns a byte count <= 0)."""
        return _next_frame(self._require())

    def _require(self):
        if self._session is None:
            raise XmtpuError("call mixer_init first")
        return self._session

    # -- voice-effects path (xm_audio_effects_*) --
    def effects_init(self, config_json, voice, frame_ms: float = 20.0):
        """Open a voice-effects session: ONE voice stream through the
        configured chain, with seek and frame reads (reference:
        ``xm_audio_effects_create/init``).

        ``config_json``: an effect chain, a list of ``{"name", ...}``
        entries (a Python list or JSON), or an object with an
        ``effects`` key (``sampleRate`` and ``blockSize`` honored).
        Multi-track configs belong to :meth:`mixer_init`. ``voice``: a
        file path, a ``(pcm, sr)`` pair, or a bare array at the config's
        rate. A config without ``sampleRate`` runs at the voice's own
        rate, as the reference processes at the input PCM's rate."""
        from xmtpu_torch.config.schema import (TrackConfig, config_from_dict,
                                               load_json_source)
        from xmtpu_torch.graph.streaming import StreamSession

        d = config_json
        if isinstance(d, (str, bytes)):
            d = load_json_source(d, what="effects config")
        if isinstance(d, (list, tuple)):
            d = {"effects": list(d)}
        if not isinstance(d, dict):
            raise ConfigError(
                f"effects config must be a chain list or an object with "
                f"'effects', got {type(d).__name__}")
        if d.get("tracks"):
            raise ConfigError(
                "effects_init takes a single voice stream; multi-track "
                "configs go through mixer_init")
        has_rate = "sampleRate" in d
        cfg = config_from_dict({k: v for k, v in d.items() if k != "tracks"})
        native_sr = None  # the voice's rate, when the config names none
        if isinstance(voice, (str, bytes)):
            url, sources = os.fsdecode(voice), None
            if not has_rate:
                from xmtpu_torch.io import open_audio

                with open_audio(url) as dec:
                    native_sr = int(dec.sample_rate)
        elif (isinstance(voice, (tuple, list)) and len(voice) == 2
                and isinstance(voice[0], (str, bytes))):
            raise ConfigError(
                "voice must be a path, a (pcm, sr) pair, or an array; got "
                "a (path, rate) pair: pass the path alone (the session "
                "adopts the file's own rate)")
        elif (isinstance(voice, (tuple, list)) and len(voice) == 2
                and np.isscalar(voice[1]) and not np.isscalar(voice[0])):
            url = "__voice__"
            sources = {"__voice__": (np.asarray(voice[0]), int(voice[1]))}
            native_sr = None if has_rate else int(voice[1])
        else:  # a bare array, at the config's rate
            url = "__voice__"
            sources = {"__voice__": (np.asarray(voice), cfg.sample_rate)}
        if native_sr is not None:
            cfg = dataclasses.replace(cfg, sample_rate=native_sr)
        cfg = dataclasses.replace(cfg, tracks=(TrackConfig(url=url),))
        self._fx_session = StreamSession(cfg, frame_ms=frame_ms,
                                         sources=sources, device=self.device)
        return 0

    def effects_seek(self, ms: float) -> int:
        self._require_fx().seek(float(ms))
        return 0

    def effects_get_frame(self) -> np.ndarray | None:
        """Next processed int16 frame, or None past the voice's end."""
        return _next_frame(self._require_fx())

    def _require_fx(self):
        if self._fx_session is None:
            raise XmtpuError("call effects_init first")
        return self._fx_session

    # -- decoder path (audio_decoder_create / seekTo /
    #    get_decoded_frame / freep) --
    def decoder_create(self, path) -> int:
        """Open a decoder handle on an audio file (WAV or raw PCM; the
        port has no FFmpeg backend). A previous handle is closed."""
        from xmtpu_torch.io import open_audio

        self.decoder_freep()
        self._decoder = open_audio(str(path))
        return 0

    def decoder_seek(self, ms: float) -> int:
        self._require_dec().seek(float(ms))
        return 0

    def decoder_get_pcm(self, num_samples: int) -> np.ndarray | None:
        """Next (n, ch) int16 chunk, or None at EOF (the reference
        returns a byte count <= 0)."""
        out = self._require_dec().read(int(num_samples))
        return out if len(out) else None

    def decoder_freep(self) -> None:
        if self._decoder is not None:
            self._decoder.close()
        self._decoder = None

    def _require_dec(self):
        if self._decoder is None:
            raise XmtpuError("call decoder_create first")
        return self._decoder

    def freep(self) -> None:
        self._session = None
        self._fx_session = None
        self.decoder_freep()


def _next_frame(s) -> np.ndarray | None:
    """One frame of a StreamSession, or None at the end of the stream:
    every non-loop track is past its end at the frame about to be
    produced. Loop tracks (BGM) never end on their own, as in the
    offline mixer; a stream of loop tracks only has no natural end (the
    caller bounds it)."""
    finite = [ts for ts in s.tracks if not ts.cfg.loop]
    if not finite:
        return s.read() if s.tracks else None
    if all((s.frame_idx * s.frame_out - ts.start_bus) >= ts.n_out
           for ts in finite):
        return None
    return s.read()


class XmAudioGenerator:
    """One-shot async generator: config -> mixed file, pollable progress."""

    def __init__(self, device=None):
        self.device = device
        self._thread = None
        self._progress = 0.0
        self._status = GS_IDLE
        self._error = None
        self._stop = threading.Event()
        self._start_lock = threading.Lock()

    def start(self, config_json, out_path, inputs=None) -> int:
        """Begin processing on a host thread (reference:
        ``xm_audio_generator_start``). Returns -1 if already running:
        the claim is atomic, so two near-simultaneous starts never race
        two pipelines onto one file. A bad config or a missing card
        raises here, and releases the claim."""
        from xmtpu_torch.utils.device import resolve_device

        with self._start_lock:
            if self._status == GS_RUNNING:
                return -1
            self._status = GS_RUNNING
        try:
            cfg = load_config(config_json)
            dev = resolve_device(self.device)
        except Exception:
            self._status = GS_IDLE  # the claim is released; nothing ran
            raise
        self._progress = 0.0
        self._error = None
        self._stop.clear()

        def work():
            from xmtpu_torch.graph import pipeline

            def report(p):
                self._progress = float(p)
                if self._stop.is_set():
                    raise InterruptedError("stopped")

            try:
                pipeline.process_file(inputs, cfg, out_path, progress=report,
                                      device=dev)
                self._status = GS_COMPLETED
            except InterruptedError:
                self._status = GS_STOPPED
            except Exception as e:  # a pollable error, reference-style
                self._error = e
                self._status = GS_ERROR

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return 0

    def get_progress(self) -> float:
        """0..100 (reference: ``xm_audio_generator_get_progress``)."""
        return self._progress

    @property
    def status(self) -> int:
        return self._status

    @property
    def error(self):
        return self._error

    def stop(self) -> None:
        """Request cancellation; it takes effect at the next stage mark
        (a device computation in flight runs to its end)."""
        self._stop.set()

    def wait(self, timeout: float | None = None) -> int:
        if self._thread is not None:
            self._thread.join(timeout)
        return self._status
