"""Native host runtime (C++, bound with ctypes) with a pure-Python
fallback (counterpart of ``xmtpu.native``; the same C ABI).

``xm_native.cpp`` holds the host side of the reference's C layer: the
WAV codec, the pinned int16 <-> float32 conversions and a lock-free
single-producer single-consumer byte ring. It is compiled with ``g++``
at first use into ``xmtpu_torch/_build/native/<key>/``, where ``key``
hashes the compiler flags and the source, so an edited source rebuilds
and the package directory is never written. The build is safe under
concurrent first use: every process takes an exclusive ``fcntl`` lock
on the directory's ``lock`` file before it looks for the library,
compiles into a private temporary file and renames it into place, so
concurrent workers compile once and none loads a half-written file. The
lock dies with its process, so a build cut off midway blocks nobody.

Without a compiler the entry points raise and :func:`available` is
False; the WAV codec then takes its stdlib path and :class:`PcmChannel`
a bounded deque. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("xmtpu_torch.native")

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "xm_native.cpp"
BUILD_ROOT = _HERE.parent / "_build" / "native"
LIB_NAME = "libxm_native.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None
_tried = False


def source_key(source: bytes | None = None) -> str:
    """Hash of the compiler flags and the source bytes (``SOURCE``'s
    unless given)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes() if source is None else source)
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_key() / LIB_NAME


def build() -> Path:
    """Compile the library unless it exists for the current source;
    return its path. Raises ``OSError`` or ``subprocess`` errors when
    ``g++`` is missing or fails. Each compile appends its command to
    ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released on close, or on exit
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            with open(out.parent / "build.log", "a") as f:
                f.write(f"pid {os.getpid()}: {' '.join(cmd)}\n{proc.stdout}"
                        f"{proc.stderr}")
            proc.check_returncode()
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.xm_wav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.xm_wav_read.restype = ctypes.c_int
    lib.xm_wav_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.xm_wav_write.restype = ctypes.c_int
    lib.xm_free.argtypes = [ctypes.c_void_p]
    lib.xm_free.restype = None
    for name in ("xm_i16_to_f32", "xm_f32_to_i16"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
        ]
        getattr(lib, name).restype = None
    lib.xm_fifo_create.argtypes = [ctypes.c_int64]
    lib.xm_fifo_create.restype = ctypes.c_void_p
    lib.xm_fifo_free.argtypes = [ctypes.c_void_p]
    lib.xm_fifo_free.restype = None
    for name in ("xm_fifo_size", "xm_fifo_space"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int64
    for name in ("xm_fifo_write", "xm_fifo_read"):
        getattr(lib, name).argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
        ]
        getattr(lib, name).restype = ctypes.c_int64
    return lib


def load():
    """Load (building if needed) the native library, or None when it
    cannot be built or loaded in this process (tried once)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, subprocess.SubprocessError) as e:
            log.info("native library unavailable (%s); using the Python "
                     "fallback", e)
        return _lib


def available() -> bool:
    return load() is not None


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


# ---------------------------------------------------------------------------
# WAV codec
# ---------------------------------------------------------------------------


def read_wav_native(path: str):
    """-> (int16 (n, ch), sample_rate): 16- and 24-bit PCM and float32
    WAV. Raises ``ValueError`` for anything else or a failed read."""
    lib = _require()
    out = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = lib.xm_wav_read(os.fsencode(path), ctypes.byref(out),
                         ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"xm_wav_read({path!r}) failed with code {rc}")
    try:
        total = n.value * ch.value
        pcm = (np.ctypeslib.as_array(out, shape=(total,)).copy() if total
               else np.zeros(0, np.int16))
    finally:
        lib.xm_free(out)
    return pcm.reshape(n.value, ch.value), int(sr.value)


def write_wav_native(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    lib = _require()
    pcm = np.ascontiguousarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    rc = lib.xm_wav_write(os.fsencode(path), pcm.ctypes.data, pcm.shape[0],
                          pcm.shape[1], int(sample_rate))
    if rc != 0:
        raise ValueError(f"xm_wav_write({path!r}) failed with code {rc}")


# ---------------------------------------------------------------------------
# Conversion twins (host side; the device ones are in ops.convert)
# ---------------------------------------------------------------------------


def i16_to_f32_native(x: np.ndarray) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    lib.xm_i16_to_f32(x.ctypes.data, out.ctypes.data, x.size)
    return out


def f32_to_i16_native(x: np.ndarray) -> np.ndarray:
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.xm_f32_to_i16(x.ctypes.data, out.ctypes.data, x.size)
    return out


# ---------------------------------------------------------------------------
# FIFO (SPSC ring buffer)
# ---------------------------------------------------------------------------


class Fifo:
    """Byte ring buffer backed by the native SPSC implementation."""

    def __init__(self, capacity: int):
        self._lib = _require()
        self._h = self._lib.xm_fifo_create(int(capacity))
        if not self._h:
            # the C side returns nullptr for capacity < 1 or OOM; a
            # write through it would crash the process
            raise ValueError(f"xm_fifo_create failed (capacity {capacity})")
        self.capacity = int(capacity)

    def write(self, data: bytes | np.ndarray) -> int:
        buf = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else \
            np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        return int(self._lib.xm_fifo_write(self._h, buf.ctypes.data, buf.size))

    def read(self, n: int) -> bytes:
        out = np.empty(n, np.uint8)
        got = int(self._lib.xm_fifo_read(self._h, out.ctypes.data, n))
        return out[:got].tobytes()

    def __len__(self) -> int:
        return int(self._lib.xm_fifo_size(self._h))

    @property
    def space(self) -> int:
        return int(self._lib.xm_fifo_space(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.xm_fifo_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PcmChannel:
    """Blocking, framed SPSC channel: ONE producer thread streams numpy
    arrays to ONE consumer thread through the native lock-free
    :class:`Fifo`, with a condition variable for the blocking
    discipline.

    The batch runner's decode -> dispatch stage. Frames may exceed the
    ring's capacity: the producer streams a frame in pieces while the
    consumer drains it (its meta is published first, so both sides loop
    at once). Without the native library a deque bounded by the same
    capacity stands in (a single frame larger than it is admitted alone).
    """

    def __init__(self, capacity: int = 64 << 20):
        import queue

        self._meta = queue.Queue()
        self._cv = threading.Condition()
        self._closed = False
        self._capacity = int(capacity)
        self._qbytes = 0  # the fallback's backpressure accounting
        try:
            self._fifo = Fifo(int(capacity))
        except (RuntimeError, ValueError):
            self._fifo = None  # pure-Python fallback
            self._deque = []

    def put(self, arrays, meta) -> None:
        """Producer side: enqueue a frame (a list of ndarrays / None)."""
        descs, conts = [], []
        for a in arrays:
            if a is None:
                descs.append(None)
                conts.append(None)
            else:
                a = np.ascontiguousarray(a)
                descs.append((a.dtype.str, a.shape))
                conts.append(a)
        self._meta.put((descs, meta))
        if self._fifo is None:
            frame = [None if a is None else a.copy() for a in conts]
            nbytes = sum(a.nbytes for a in frame if a is not None)
            with self._cv:
                while (self._qbytes > 0
                       and self._qbytes + nbytes > self._capacity
                       and not self._closed):
                    self._cv.wait(timeout=0.1)
                self._deque.append(frame)
                self._qbytes += nbytes
                self._cv.notify_all()
            return
        for a in conts:
            if a is None:
                continue
            buf = a.view(np.uint8).reshape(-1)
            off = 0
            while off < buf.size:
                wrote = int(self._fifo._lib.xm_fifo_write(
                    self._fifo._h, buf.ctypes.data + off, buf.size - off))
                if wrote > 0:
                    off += wrote
                    with self._cv:
                        self._cv.notify_all()
                else:  # ring full: wait for the consumer to drain
                    with self._cv:
                        if self._closed:
                            # a closed channel's consumer never drains
                            raise RuntimeError(
                                "PcmChannel closed while writing")
                        self._cv.wait(timeout=0.1)

    def get(self):
        """Consumer side: -> (arrays, meta), or None when closed and
        empty. Blocks until a whole frame is available."""
        import queue

        while True:
            try:
                descs, meta = self._meta.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed and self._meta.empty():
                    return None
        if self._fifo is None:
            with self._cv:
                while not self._deque:
                    if self._closed:
                        raise RuntimeError(
                            "PcmChannel closed mid-frame (producer died "
                            "between meta and payload)")
                    self._cv.wait(timeout=0.1)
                frame = self._deque.pop(0)
                self._qbytes -= sum(a.nbytes for a in frame if a is not None)
                self._cv.notify_all()  # wake a backpressured producer
                return frame, meta
        arrays = []
        for d in descs:
            if d is None:
                arrays.append(None)
                continue
            dtype, shape = d
            out = np.empty(int(np.prod(shape)) * np.dtype(dtype).itemsize,
                           np.uint8)
            off = 0
            while off < out.size:
                got = int(self._fifo._lib.xm_fifo_read(
                    self._fifo._h, out.ctypes.data + off, out.size - off))
                if got > 0:
                    off += got
                    with self._cv:
                        self._cv.notify_all()
                    continue
                with self._cv:
                    if not self._closed:
                        self._cv.wait(timeout=0.1)
                        continue
                # closed, but close() comes after the producer's last
                # write: the frame's bytes may have landed between the
                # empty read and the flag check. Drain once more; only a
                # ring still empty is a dead frame.
                got = int(self._fifo._lib.xm_fifo_read(
                    self._fifo._h, out.ctypes.data + off, out.size - off))
                if got > 0:
                    off += got
                    continue
                raise RuntimeError(
                    f"PcmChannel closed mid-frame ({off}/{out.size} bytes)")
            arrays.append(out.view(dtype).reshape(shape))
        return arrays, meta

    def close(self) -> None:
        self._closed = True
        with self._cv:
            self._cv.notify_all()
