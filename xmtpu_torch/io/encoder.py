"""Encoder interface: int16 PCM -> audio file by extension (counterpart
of ``xmtpu.io.encoder``): WAV is built in, others are registered with
:func:`register_encoder`; an extension with no backend raises
:class:`ConfigError` and writes nothing."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from xmtpu_torch.io.wav import write_wav
from xmtpu_torch.utils.errors import ConfigError


def _wav_encode(path: str, pcm: np.ndarray, sample_rate: int, **kw) -> None:
    write_wav(path, pcm, sample_rate)


_BACKENDS: dict[str, Callable] = {"wav": _wav_encode}


def register_encoder(extension: str, factory: Callable) -> None:
    """Register an encoder backend for a file extension."""
    _BACKENDS[extension.lower().lstrip(".")] = factory


def encode_audio(path, pcm: np.ndarray, sample_rate: int, **kw) -> str:
    """Encode int16 PCM to ``path``; the format follows the extension."""
    ext = os.path.splitext(os.path.basename(str(path)))[1].lstrip(".").lower()
    backend = _BACKENDS.get(ext)
    if backend is None:
        raise ConfigError(
            f"no encoder backend for '.{ext}' (available: {sorted(_BACKENDS)}); "
            "WAV is always supported; register a backend for AAC/M4A"
        )
    backend(str(path), pcm, int(sample_rate), **kw)
    return str(path)
