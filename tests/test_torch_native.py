"""The port's native host runtime (``xmtpu_torch.native``): the C++ WAV
codec, the pinned int16 <-> float32 conversions, the SPSC ring and the
framed channel over it, and the build.

Every native entry point is bit-identical to its twin: the WAV parser
and writer to the stdlib paths of both packages (16- and 24-bit PCM)
and to the pinned rounding rule (float32 WAV), the conversions to
``ops.convert``'s numpy twins (which equal the JAX package's). The
build lands under ``xmtpu_torch/_build/native/<key>/``, the key changes
with the source, and four processes that start the first build at once
compile it once and all load it. Tests that need ``g++`` skip, with
that reason, where it is absent.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest

from xmtpu.io import wav as xwav
from xmtpu.ops import convert as xconvert
from xmtpu_torch import native
from xmtpu_torch.io import wav as twav
from xmtpu_torch.ops import convert as tconvert

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    assert native.available(), "g++ is present but the build failed"
    return native.load()


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(1515)
    return (rng.standard_normal((3001, 2)) * 12000).astype(np.int16)


def _stdlib_write(path, pcm, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.ascontiguousarray(pcm).astype("<i2").tobytes())


def test_wav_16bit_read_and_write_bit_exact(lib, tmp_path, pcm,
                                            monkeypatch):
    """The native reader and writer against the stdlib paths of both
    packages: the same int16, the same bytes, mono and stereo."""
    monkeypatch.setattr(xwav, "_native", lambda: None)
    for x in (pcm, pcm[:, :1].copy()):
        p = tmp_path / f"s{x.shape[1]}.wav"
        _stdlib_write(p, x, 22050)
        got, sr = native.read_wav_native(str(p))
        assert sr == 22050 and got.shape == x.shape
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(got, twav._read_wav_stdlib(p)[0])
        np.testing.assert_array_equal(got, xwav.read_wav(p)[0])
        q = tmp_path / f"n{x.shape[1]}.wav"
        native.write_wav_native(str(q), x, 22050)
        assert q.read_bytes() == p.read_bytes()
        xwav.write_wav(tmp_path / "j.wav", x, 22050)
        assert q.read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_read_wav_takes_the_native_parser(lib, tmp_path, pcm, monkeypatch):
    """``io.read_wav`` and ``write_wav`` go through the native library
    when it is built; the parser's refusals (8-bit) fall back to the
    stdlib path."""
    calls = []
    real = native.read_wav_native

    def spy(path):
        calls.append(path)
        return real(path)

    monkeypatch.setattr(native, "read_wav_native", spy)
    p = tmp_path / "a.wav"
    twav.write_wav(p, pcm, 16000)
    got, sr = twav.read_wav(p)
    assert calls == [str(p)] and sr == 16000
    np.testing.assert_array_equal(got, pcm)
    with wave.open(str(tmp_path / "u8.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(8000)
        w.writeframes(bytes(range(256)))
    got8, _ = twav.read_wav(tmp_path / "u8.wav")
    assert len(calls) == 2
    np.testing.assert_array_equal(
        got8[:, 0], (np.arange(256, dtype=np.int16) - 128) << 8)


def test_wav_24bit_and_float32(lib, tmp_path, monkeypatch):
    """24-bit PCM: the native and stdlib paths of both packages keep the
    top 16 bits (sign extension at the edges); float32 WAV: the pinned
    round-half-away rule, the JAX package's numpy twin."""
    monkeypatch.setattr(xwav, "_native", lambda: None)
    v = np.array([0, 1, -1, 255, 256, -256, 8388607, -8388608, 123456,
                  -654321], np.int64)
    b = b"".join(int(x).to_bytes(3, "little", signed=True) for x in v)
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(b)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 24000, 3, 24)
           + b"data" + struct.pack("<I", len(b)))
    p = tmp_path / "w24.wav"
    p.write_bytes(hdr + b)
    got, _ = native.read_wav_native(str(p))
    np.testing.assert_array_equal(got[:, 0], (v >> 8).astype(np.int16))
    np.testing.assert_array_equal(got, twav._read_wav_stdlib(p)[0])
    np.testing.assert_array_equal(got, xwav.read_wav(p)[0])
    x = (0.4 * np.random.default_rng(2).standard_normal(500)).astype(
        np.float32)
    x[:4] = [1.0, -1.0, 0.5 / 32768, -0.5 / 32768]
    data = x.tobytes()
    f32 = tmp_path / "f32.wav"
    f32.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
                    + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 48000,
                                            48000 * 4, 4, 32)
                    + b"data" + struct.pack("<I", len(data)) + data)
    got, sr = twav.read_wav(f32)
    assert sr == 48000
    np.testing.assert_array_equal(got[:, 0], xconvert.f32_to_pcm16_np(x))
    assert twav.wav_info(f32).sample_width == 4


def test_garbage_and_missing_files_refused(lib, tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunkjunkjunk")
    for p in (bad, tmp_path / "missing.wav"):
        with pytest.raises(ValueError, match="xm_wav_read"):
            native.read_wav_native(str(p))
    with pytest.raises(ValueError, match="xm_wav_write"):
        native.write_wav_native(str(tmp_path / "no" / "x.wav"),
                                np.zeros(4, np.int16), 8000)


def test_conversions_bit_exact(lib):
    rng = np.random.default_rng(3)
    i16 = np.concatenate([np.array([-32768, -1, 0, 1, 32767], np.int16),
                          rng.integers(-32768, 32767, 20000).astype(
                              np.int16)])
    np.testing.assert_array_equal(native.i16_to_f32_native(i16),
                                  tconvert.pcm16_to_f32_np(i16))
    f = np.concatenate([
        np.array([1.0, -1.0, 1.5, -1.5, 0.0, -0.0, 0.5 / 32768,
                  -0.5 / 32768, 1.5 / 32768, 32767.5 / 32768],
                 np.float32),
        (rng.standard_normal(20000) * 0.7).astype(np.float32)])
    got = native.f32_to_i16_native(f)
    np.testing.assert_array_equal(got, tconvert.f32_to_pcm16_np(f))
    np.testing.assert_array_equal(got, xconvert.f32_to_pcm16_np(f))


def test_fifo_round_trips(lib):
    f = native.Fifo(10)
    assert len(f) == 0 and f.space == 10
    assert f.write(b"abcdefgh") == 8
    assert f.read(5) == b"abcde"
    assert f.write(b"123456789") == 7  # wraps; capacity bounds it
    assert len(f) == 10 and f.space == 0
    assert f.read(100) == b"fgh1234567"
    assert f.read(1) == b""
    f.close()
    with pytest.raises(ValueError, match="capacity 0"):
        native.Fifo(0)


@pytest.mark.parametrize("path", ["native ring", "fallback deque"])
def test_pcm_channel_frames_larger_than_the_ring(lib, path):
    """Frames of up to ~120 KiB through a 16 KiB channel, on a producer
    thread, arrive intact and in order (None arrays and meta too), on
    the native ring and on the fallback."""
    chan = native.PcmChannel(capacity=1 << 14)
    if path == "fallback deque":
        chan._fifo = None
        chan._deque = []
    else:
        assert chan._fifo is not None
    rng = np.random.default_rng(4)
    frames = [[(rng.standard_normal(int(rng.integers(1, 60000))) * 1000
                ).astype(np.int16),
               None if i % 3 == 0 else rng.standard_normal(
                   int(rng.integers(1, 300))).astype(np.float32)]
              for i in range(24)]

    def producer():
        try:
            for i, arrs in enumerate(frames):
                chan.put(arrs, ("meta", i))
        finally:
            chan.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    got = []
    while (item := chan.get()) is not None:
        got.append(item)
    t.join(30)
    assert not t.is_alive() and len(got) == len(frames)
    for i, ((arrs, meta), want) in enumerate(zip(got, frames)):
        assert meta == ("meta", i)
        np.testing.assert_array_equal(arrs[0], want[0])
        if want[1] is None:
            assert arrs[1] is None
        else:
            assert arrs[1].dtype == np.float32
            np.testing.assert_array_equal(arrs[1], want[1])


def test_pcm_channel_close_mid_frame_and_full(lib):
    """A frame whose payload never comes raises at get() after close; a
    put into a full ring of a closed channel raises instead of spinning."""
    ch = native.PcmChannel(capacity=1 << 10)
    ch._meta.put(([("<i2", (4,))], "meta"))
    ch.close()
    with pytest.raises(RuntimeError, match="mid-frame"):
        ch.get()
    ch2 = native.PcmChannel(capacity=1 << 10)
    ch2.close()
    with pytest.raises(RuntimeError, match="closed while writing"):
        ch2.put([np.zeros(4096, np.int16)], "m")


def test_build_key_and_location(lib):
    """The library sits under the package's ``_build/native/<key>/``,
    never in the package directory; the key follows the source."""
    src = native.SOURCE.read_bytes()
    assert native.source_key() == native.source_key(src)
    assert native.source_key(src + b"\n// edited") != native.source_key(src)
    path = native.library_path()
    assert path.exists()
    assert path.parent.parent == REPO / "xmtpu_torch" / "_build" / "native"
    assert path.parent.name == native.source_key()
    assert not list((REPO / "xmtpu_torch" / "native").glob("*.so"))


def test_concurrent_first_build(lib, tmp_path):
    """Four processes that start the first build at once into an empty
    build root: one compiles (one entry in build.log), all four load
    the library, no temporary file is left behind."""
    root = tmp_path / "build_root"
    code = (
        "import sys, time, pathlib\n"
        "from xmtpu_torch import native\n"
        "native.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
        "go = pathlib.Path(sys.argv[2])\n"
        "pathlib.Path(sys.argv[3]).touch()\n"
        "while not go.exists():\n"
        "    time.sleep(0.01)\n"
        "assert native.available(), 'load failed'\n"
        "print(native.library_path())\n")
    go = tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(root), str(go),
         str(tmp_path / f"ready{i}")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(4)]
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready{i}").exists() for i in range(4)):
            assert time.monotonic() < deadline, "workers did not start"
            assert all(p.poll() is None for p in procs), [
                p.communicate() for p in procs]
            time.sleep(0.02)
        go.touch()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    lib_path = Path(paths.pop())
    assert lib_path.exists() and lib_path.parent.parent == root
    log = (lib_path.parent / "build.log").read_text()
    assert log.count("pid ") == 1, log
    assert not list(lib_path.parent.glob("*.tmp"))
