"""Decoder interface: handle-style access to audio files (counterpart
of ``xmtpu.io.decoder``).

:func:`open_audio` picks a backend by the file's extension: WAV
(``io.wav``) and headerless PCM (``.pcm``/``.raw``) are built in, others
are registered with :func:`register_backend`. Decoding returns the
file's own rate; rate conversion is a device op
(``xmtpu_torch.ops.resample``).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from xmtpu_torch.io.wav import read_wav
from xmtpu_torch.ops.convert import f32_to_pcm16_np
from xmtpu_torch.utils.errors import DecodeError


class Decoder:
    """Handle-style PCM reader over a fully decoded in-memory clip.

    The buffer is made read-only, the caller's base array too: ``read``
    returns views into it, and a scratch write into one would corrupt
    every later read (and race an asynchronous device copy from it)."""

    def __init__(self, pcm: np.ndarray, sample_rate: int):
        if pcm.ndim == 1:
            pcm.setflags(write=False)  # the base, not only the view
            pcm = pcm[:, None]
        pcm.setflags(write=False)
        self._pcm = pcm
        self.sample_rate = int(sample_rate)
        self.num_channels = pcm.shape[1]
        self.num_samples = pcm.shape[0]
        self._pos = 0

    def seek(self, ms: float) -> None:
        self._pos = min(self.num_samples,
                        max(0, int(round(ms * self.sample_rate / 1000.0))))

    def read(self, num_samples: int) -> np.ndarray:
        """Read up to num_samples frames; short read at EOF (empty at end)."""
        out = self._pcm[self._pos: self._pos + num_samples]
        self._pos += out.shape[0]
        return out

    def read_all(self) -> np.ndarray:
        return self._pcm

    @property
    def position_ms(self) -> float:
        return self._pos * 1000.0 / self.sample_rate

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _wav_backend(path: str, **kw) -> Decoder:
    pcm, sr = read_wav(path)
    return Decoder(pcm, sr)


def _raw_pcm_backend(path: str, sample_rate: int | None = None,
                     channels: int = 1, dtype="int16", **kw) -> Decoder:
    """Headerless PCM; the caller supplies the format. Other dtypes than
    int16 are scaled to [-1, 1) floats first, then pinned-converted."""
    if sample_rate is None:
        raise ValueError("raw PCM needs sample_rate= (headerless format)")
    if int(sample_rate) < 1 or int(channels) < 1:
        raise ValueError(
            f"raw PCM needs sample_rate >= 1 and channels >= 1, got "
            f"{sample_rate}/{channels}")
    data = np.fromfile(path, dtype=np.dtype(dtype))
    n = data.size // channels
    pcm = data[: n * channels].reshape(n, channels)
    if pcm.dtype != np.int16:
        kind = pcm.dtype.kind
        if kind == "f":
            f = pcm.astype(np.float32)
        elif kind == "u":  # unsigned: remove midpoint offset
            span = float(np.iinfo(pcm.dtype).max) + 1.0
            f = (pcm.astype(np.float32) - span / 2.0) / (span / 2.0)
        elif kind == "i":
            f = pcm.astype(np.float32) / (float(np.iinfo(pcm.dtype).max) + 1.0)
        else:
            raise ValueError(f"unsupported raw PCM dtype: {dtype}")
        pcm = f32_to_pcm16_np(f)
    return Decoder(pcm, int(sample_rate))


_BACKENDS: dict[str, Callable[..., Decoder]] = {
    "wav": _wav_backend,
    "pcm": _raw_pcm_backend,
    "raw": _raw_pcm_backend,
}


def register_backend(extension: str, factory: Callable[..., Decoder]) -> None:
    """Register a decoder backend for a file extension."""
    _BACKENDS[extension.lower().lstrip(".")] = factory


def open_audio(path, **kw) -> Decoder:
    """Open an audio file with the backend registered for its extension
    (:class:`DecodeError` when none is). Extra keywords go to the
    backend (raw PCM needs ``sample_rate=``, optional ``channels=`` and
    ``dtype=``)."""
    ext = os.path.splitext(os.path.basename(str(path)))[1].lstrip(".").lower()
    backend = _BACKENDS.get(ext)
    if backend is None:
        raise DecodeError(
            f"no decoder backend for '.{ext}' (available: {sorted(_BACKENDS)}); "
            "WAV is always supported; register a backend for compressed formats"
        )
    return backend(str(path), **kw)
