"""WAV codec: file -> int16 numpy PCM and back (counterpart of
``xmtpu.io.wav``, byte- and bit-identical with it).

PCM layout throughout: ``(num_samples, num_channels)`` int16, C order
(interleaved on disk, deinterleaved in memory). :func:`read_wav` takes
the native C++ parser (``xmtpu_torch.native``: 16- and 24-bit PCM and
float32 WAV) when the library is built, and the stdlib ``wave`` path
for what the parser refuses (8- and 32-bit PCM, a truncated file) or
when it cannot be built: 8-bit unsigned is recentred and shifted up,
24- and 32-bit truncated to their top 16 bits, a truncated final frame
dropped; both paths give the same int16 for 16- and 24-bit PCM.
:func:`write_wav` writes 16-bit PCM through the native writer when it
is built, else through ``wave``: the same bytes. The JAX package's
FFmpeg fallback for other encodings is not ported; every failure is a
:class:`DecodeError`.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass

import numpy as np

from xmtpu_torch.utils.errors import DecodeError


@dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    num_channels: int
    num_samples: int
    sample_width: int  # bytes per sample on disk


def _native():
    """The native library's module when it is built, else None."""
    from xmtpu_torch import native

    return native if native.available() else None


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (int16 array (n, channels), sample_rate);
    :class:`DecodeError` on anything it cannot decode."""
    n = _native()
    if n is not None:
        try:
            return n.read_wav_native(str(path))
        except ValueError:
            pass  # an encoding or a file the parser refuses: stdlib decides
    try:
        return _read_wav_stdlib(path)
    except Exception as e:
        raise DecodeError(
            f"cannot decode WAV {path}: {type(e).__name__}: {e}") from e


def _read_wav_stdlib(path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
    frame = width * nch
    if frame > 0 and len(raw) % frame:
        # truncated final frame (a cut-off file): drop the partial frame
        raw = raw[: len(raw) - (len(raw) % frame)]
    if width == 2:
        pcm = np.frombuffer(raw, dtype="<i2")
    elif width == 1:
        # 8-bit WAV is unsigned; recenter and scale to int16
        pcm = ((np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128) << 8)
    elif width == 3:
        # 24-bit PCM: little-endian 3-byte signed -> top 16 bits
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = (v ^ 0x800000) - 0x800000  # sign-extend bit 23
        pcm = (v >> 8).astype(np.int16)
    elif width == 4:
        pcm = (np.frombuffer(raw, dtype="<i4") >> 16).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    pcm = pcm.astype(np.int16, copy=False).reshape(-1, nch)
    return pcm, sr


def write_wav(path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write an int16 array (n,) or (n, channels) as 16-bit PCM WAV."""
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        raise TypeError(f"write_wav expects int16 PCM, got {pcm.dtype}")
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n = _native()
    if n is not None:
        n.write_wav_native(str(path), pcm, int(sample_rate))
        return
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(np.ascontiguousarray(pcm).astype("<i2").tobytes())


def wav_info(path) -> WavInfo:
    """Rate, channels, frames and on-disk sample width; a file the
    header parser rejects is probed by decoding it."""
    try:
        with wave.open(str(path), "rb") as w:
            return WavInfo(
                sample_rate=w.getframerate(),
                num_channels=w.getnchannels(),
                num_samples=w.getnframes(),
                sample_width=w.getsampwidth(),
            )
    except (wave.Error, EOFError):
        # EOFError: wave.open raises it on empty or truncated headers
        pcm, sr = read_wav(path)
        bits = _fmt_chunk_bits(path)
        return WavInfo(sample_rate=sr, num_channels=pcm.shape[1],
                       num_samples=pcm.shape[0],
                       sample_width=(bits // 8) if bits
                       else pcm.dtype.itemsize)


def _fmt_chunk_bits(path) -> int | None:
    """bits-per-sample straight from the RIFF fmt chunk; None when the
    header is not parseable."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
            if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
                return None
            while True:
                ck = f.read(8)
                if len(ck) < 8:
                    return None
                sz = int.from_bytes(ck[4:8], "little")
                if ck[:4] == b"fmt ":
                    body = f.read(min(sz, 40))
                    if len(body) >= 16:
                        bits = int.from_bytes(body[14:16], "little")
                        return bits or None
                    return None
                f.seek(sz + (sz & 1), 1)
    except OSError:
        return None
