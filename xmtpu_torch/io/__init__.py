"""Host-side I/O (counterpart of ``xmtpu.io``): decode audio files to
numpy int16 PCM and encode back, by extension.

WAV and headerless PCM are built in. The JAX package's FFmpeg shim for
compressed formats is not ported: ``HAVE_FFMPEG`` is False, as in the
JAX package where its shim is absent, so decoding a compressed
extension raises :class:`~xmtpu_torch.utils.errors.DecodeError` and
encoding to one raises rather than writing RIFF bytes under that name.
"""

from xmtpu_torch.io.decoder import Decoder, open_audio, register_backend
from xmtpu_torch.io.encoder import encode_audio, register_encoder
from xmtpu_torch.io.wav import read_wav, write_wav

HAVE_FFMPEG = False

__all__ = [
    "read_wav", "write_wav", "open_audio", "Decoder", "register_backend",
    "encode_audio", "register_encoder", "HAVE_FFMPEG",
]
