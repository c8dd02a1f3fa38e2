"""FFmpeg shim: compressed-audio decode and encode through the system's
libav (counterpart of ``xmtpu.native.ffmpeg``; the same C ABI, from the
port's own copy of the source, ``xm_ffmpeg.cpp``).

The shim is compiled with ``g++`` against libavformat, libavcodec,
libavutil and libswresample at the first use of a compressed format,
never at import, into ``xmtpu_torch/_build/ffmpeg/<key>/`` (``key``
hashes the flags and the source) by :func:`xmtpu_torch.native.
build_shared`: an exclusive file lock, a private temporary file, a
rename. Concurrent first users compile once and none loads a
half-written library; the package directory is never written.

Where libav's headers or libraries are missing the build fails once per
process, :func:`available` is False and every entry point raises: the
decoder backends registered by :func:`register` raise
:class:`~xmtpu_torch.utils.errors.DecodeError`, the encoder backends
:class:`~xmtpu_torch.utils.errors.ConfigError`, and nothing writes WAV
bytes under a compressed name.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from xmtpu_torch.utils.errors import ConfigError, DecodeError

log = logging.getLogger("xmtpu_torch.native.ffmpeg")

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "xm_ffmpeg.cpp"
BUILD_ROOT = _HERE.parent / "_build" / "ffmpeg"
LIB_NAME = "libxm_ffmpeg.so"
LIBAV_INCLUDE = "/usr/include/x86_64-linux-gnu"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", f"-I{LIBAV_INCLUDE}")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

DECODE_EXTS = ("mp3", "aac", "m4a", "mp4", "ogg", "opus", "flac", "wma", "ac3")
ENCODE_EXTS = ("mp3", "aac", "m4a", "ogg", "flac")

_lock = threading.Lock()
_lib = None
_tried = False


def source_key(source: bytes | None = None) -> str:
    """Hash of the flags, the libraries and the source bytes
    (``SOURCE``'s unless given)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes() if source is None else source)
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_key() / LIB_NAME


def build() -> Path:
    """Compile the shim unless it exists for the current source; return
    its path. Raises ``OSError`` or ``subprocess`` errors when ``g++``
    or libav is missing; ``build.log`` beside the library holds each
    compile's command and output."""
    from xmtpu_torch.native import build_shared

    return build_shared(SOURCE, library_path(), CXX_FLAGS, LIBS)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i16p = ctypes.POINTER(ctypes.c_int16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.xm_ff_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(i16p), i64p,
                                 i32p, i32p]
    lib.xm_ff_decode.restype = ctypes.c_int
    lib.xm_ff_encode.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.xm_ff_encode.restype = ctypes.c_int
    lib.xm_ff_free.argtypes = [ctypes.c_void_p]
    lib.xm_ff_free.restype = None
    lib.xm_ff_open.argtypes = [ctypes.c_char_p, i32p, i32p, i64p]
    lib.xm_ff_open.restype = ctypes.c_void_p
    lib.xm_ff_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64]
    lib.xm_ff_read.restype = ctypes.c_int64
    lib.xm_ff_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.xm_ff_seek.restype = ctypes.c_int
    lib.xm_ff_buffered.argtypes = [ctypes.c_void_p]
    lib.xm_ff_buffered.restype = ctypes.c_int64
    lib.xm_ff_close.argtypes = [ctypes.c_void_p]
    lib.xm_ff_close.restype = None
    return lib


def load():
    """Load (building if needed) the shim, or None when it cannot be
    built or loaded in this process (tried once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, subprocess.SubprocessError) as e:
            log.info("ffmpeg shim unavailable (%s)", e)
        return _lib


def available() -> bool:
    return load() is not None


def _require(what: str):
    if not available():
        raise DecodeError(f"ffmpeg shim unavailable (cannot {what}): libav "
                          "headers or libraries missing, or g++ failed; "
                          f"see {library_path().parent / 'build.log'}")
    return load()


def decode(path) -> tuple[np.ndarray, int]:
    """-> (int16 (n, ch), the file's own sample rate);
    :class:`DecodeError` on failure."""
    lib = _require(f"decode {path!r}")
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = lib.xm_ff_decode(os.fsencode(str(path)), ctypes.byref(out),
                          ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise DecodeError(f"xm_ff_decode({str(path)!r}) failed with code {rc}")
    try:
        pcm = np.ctypeslib.as_array(out, shape=(n.value * ch.value,)).copy()
    finally:
        lib.xm_ff_free(out)
    return pcm.reshape(n.value, ch.value), int(sr.value)


def encode(path, pcm: np.ndarray, sample_rate: int,
           bitrate: int | None = None) -> None:
    """Encode PCM to ``path``, the codec from its extension. ``pcm``:
    int16, or normalized float (converted by the pinned rounding rule),
    (n,) or (n, ch). ``bitrate`` in bits/s; None = the codec's default
    (128 kb/s); lossless codecs (FLAC) ignore it. ``ValueError`` when
    the encode fails."""
    from xmtpu_torch.ops.convert import f32_to_pcm16_np

    lib = _require(f"encode {path!r}")
    pcm = np.asarray(pcm)
    if pcm.dtype != np.int16:
        if pcm.dtype.kind != "f":
            raise TypeError(f"encode() needs int16 or normalized float PCM, "
                            f"got {pcm.dtype}")
        pcm = f32_to_pcm16_np(pcm.astype(np.float32))
    pcm = np.ascontiguousarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    rc = lib.xm_ff_encode(os.fsencode(str(path)), pcm.ctypes.data,
                          pcm.shape[0], pcm.shape[1], int(sample_rate),
                          int(bitrate) if bitrate else 0)
    if rc != 0:
        raise ValueError(f"xm_ff_encode({str(path)!r}) failed with code {rc}")


class StreamDecoder:
    """Chunked decoder over ``xm_ff_open/seek/read/close`` at constant
    memory (one packet, one frame and a small PCM buffer, however long
    the file), with the :class:`xmtpu_torch.io.decoder.Decoder` surface
    (``seek`` in ms, ``read(n)``, ``read_all``, ``position_ms``,
    ``close``, a context manager) plus ``seek_sample`` and
    ``max_buffered``, the most frames it has held decoded and unread.
    Failures raise :class:`DecodeError`."""

    def __init__(self, path):
        self._lib = _require(f"decode {path!r}")
        self._h = None
        ch = ctypes.c_int32()
        sr = ctypes.c_int32()
        dur = ctypes.c_int64()
        self._h = self._lib.xm_ff_open(os.fsencode(str(path)),
                                       ctypes.byref(ch), ctypes.byref(sr),
                                       ctypes.byref(dur))
        if not self._h:
            raise DecodeError(f"xm_ff_open({str(path)!r}) failed")
        self.num_channels = int(ch.value)
        self.sample_rate = int(sr.value)
        self.num_samples = int(dur.value)  # best effort; -1 unknown
        self.max_buffered = 0
        self._pos = 0

    def _handle(self):
        if not self._h:
            raise DecodeError("the decoder is closed")
        return self._h

    def seek_sample(self, sample: int) -> None:
        if self._lib.xm_ff_seek(self._handle(), int(sample)) != 0:
            raise DecodeError(f"seek to sample {sample} failed")
        self._pos = int(sample)

    def seek(self, ms: float) -> None:
        self.seek_sample(int(round(ms * self.sample_rate / 1000.0)))

    def read(self, num_samples: int) -> np.ndarray:
        """Up to ``num_samples`` frames as int16 (n, ch); empty at the
        end."""
        h = self._handle()
        out = np.empty((int(num_samples), self.num_channels), np.int16)
        got = int(self._lib.xm_ff_read(h, out.ctypes.data, int(num_samples)))
        if got < 0:
            raise DecodeError("xm_ff_read failed")
        self._pos += got
        self.max_buffered = max(self.max_buffered,
                                int(self._lib.xm_ff_buffered(h)))
        return out[:got]

    def read_all(self) -> np.ndarray:
        """The whole clip, whatever the read position, which is put
        back afterwards (as ``Decoder.read_all``)."""
        pos = self._pos
        self.seek(0.0)
        chunks = []
        while True:
            c = self.read(1 << 18)
            if not len(c):
                break
            chunks.append(c)
        self.seek_sample(pos)
        return (np.concatenate(chunks) if chunks
                else np.empty((0, self.num_channels), np.int16))

    @property
    def position_ms(self) -> float:
        return self._pos * 1000.0 / self.sample_rate

    def close(self) -> None:
        if self._h:
            self._lib.xm_ff_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def _decode_backend(path: str, **kw) -> StreamDecoder:
    return StreamDecoder(path)


def _encode_backend(path: str, pcm, sample_rate: int, **kw) -> None:
    if not available():
        raise ConfigError(f"ffmpeg shim unavailable: cannot encode {path!r}; "
                          "use a .wav output path on this machine")
    encode(path, pcm, sample_rate, bitrate=kw.get("bitrate"))


def register() -> bool:
    """Register the shim as the decoder of ``DECODE_EXTS`` and the
    encoder of ``ENCODE_EXTS`` in ``xmtpu_torch.io``; nothing is built
    until a compressed file is opened or written. Returns a cheap
    estimate of whether the shim will work, as the JAX package's
    ``register`` does: the library is built, or libav's headers are
    there to build it (``io.HAVE_FFMPEG``). :func:`available` is the
    certain answer; it builds."""
    from xmtpu_torch.io.decoder import register_backend
    from xmtpu_torch.io.encoder import register_encoder

    for ext in DECODE_EXTS:
        register_backend(ext, _decode_backend)
    for ext in ENCODE_EXTS:
        register_encoder(ext, _encode_backend)
    if library_path().exists():
        return True
    return all(any(Path(d, h).exists() for d in (LIBAV_INCLUDE,
                                                 "/usr/include",
                                                 "/usr/local/include"))
               for h in ("libavcodec/avcodec.h", "libavformat/avformat.h",
                         "libswresample/swresample.h"))
