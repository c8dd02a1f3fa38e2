"""Host-side I/O (counterpart of ``xmtpu.io``): decode audio files to
numpy int16 PCM and encode back, by extension.

WAV and headerless PCM are built in. Compressed formats (``mp3``,
``aac``, ``m4a``, ``ogg``, ``flac``, ...) go through the FFmpeg shim,
:mod:`xmtpu_torch.native.ffmpeg`, registered here for the JAX package's
extensions and built at their first use, not at import.
``HAVE_FFMPEG`` is the shim's cheap estimate, as in the JAX package:
the shim is built, or libav's headers are there to build it. Where the
shim cannot work, decoding a compressed file raises
:class:`~xmtpu_torch.utils.errors.DecodeError` and encoding to one
raises rather than writing RIFF bytes under that name.
"""

from xmtpu_torch.io.decoder import Decoder, open_audio, register_backend
from xmtpu_torch.io.encoder import encode_audio, register_encoder
from xmtpu_torch.io.wav import read_wav, write_wav
from xmtpu_torch.native import ffmpeg as _ffmpeg

HAVE_FFMPEG = _ffmpeg.register()

__all__ = [
    "read_wav", "write_wav", "open_audio", "Decoder", "register_backend",
    "encode_audio", "register_encoder", "HAVE_FFMPEG",
]
