"""The port's FFmpeg shim (``xmtpu_torch.native.ffmpeg``): the cases of
the JAX package's ``tests/test_ffmpeg.py`` against the port, then the
two shims against each other on this machine's libav, and the first
build raced by several processes.

The module's tests skip only where the JAX file's do: when a shim
cannot be built and loaded (``available()`` false, checked in
fixtures: the port's for every case, the JAX package's too for the
cross-package ones). Tolerances are the JAX file's (duration within 60 ms of codec
padding, the dominant frequency within 2 Hz, FLAC sample-exact); across
the shims every decode is bit for bit: a file encoded by either shim
decodes to the same int16 through both, whole and in chunks.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from xmtpu.io import wav as xwav
from xmtpu.native import ffmpeg as xff
from xmtpu_torch.io import wav as twav
from xmtpu_torch.native import ffmpeg as ff
from xmtpu_torch.utils.errors import DecodeError, XmtpuError

SR = 44100
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def shim():
    if not ff.available():
        pytest.skip("no FFmpeg libraries (the shim does not build)")


@pytest.fixture
def jax_shim():
    """The JAX package's shim, for the cross-package cases: they skip
    where ``tests/test_ffmpeg.py`` skips."""
    if not xff.available():
        pytest.skip("the JAX package's FFmpeg shim does not build")


def _tone(seconds=1.0, freq=440.0, amp=12000):
    t = np.arange(int(SR * seconds)) / SR
    return (np.sin(2 * np.pi * freq * t) * amp).astype(np.int16)


def _dominant(pcm, sr):
    x = pcm.reshape(-1).astype(np.float64)
    f = np.fft.rfftfreq(len(x), 1 / sr)
    return f[np.argmax(np.abs(np.fft.rfft(x)))]


# -- the JAX package's cases, against the port --------------------------------


@pytest.mark.parametrize("ext", ["mp3", "m4a", "flac"])
def test_encode_decode_roundtrip(tmp_path, ext):
    pcm = _tone()
    p = str(tmp_path / f"tone.{ext}")
    ff.encode(p, pcm, SR)
    got, sr = ff.decode(p)
    assert sr == SR
    assert abs(got.shape[0] - len(pcm)) < 0.06 * SR
    assert abs(_dominant(got, sr) - 440.0) < 2.0
    if ext == "flac":
        n = min(got.shape[0], len(pcm))
        np.testing.assert_allclose(got[:n, 0], pcm[:n], atol=1)


def test_io_registry_roundtrip(tmp_path):
    from xmtpu_torch.io import HAVE_FFMPEG, encode_audio, open_audio

    assert HAVE_FFMPEG
    pcm = _tone(0.5)
    p = str(tmp_path / "t.mp3")
    encode_audio(p, pcm, SR)
    with open_audio(p) as d:
        assert d.sample_rate == SR
        got = d.read_all()
    assert abs(_dominant(got, SR) - 440.0) < 2.0


def test_pipeline_with_mp3_input(tmp_path):
    """A compressed input through the generator (compat handle)."""
    from xmtpu_torch import compat
    from xmtpu_torch.io import read_wav

    pcm = _tone(0.6)
    mp3 = str(tmp_path / "voice.mp3")
    ff.encode(mp3, pcm, SR)
    cfg = json.dumps({"sampleRate": 16000,
                      "tracks": [{"url": mp3, "volume": 1.0}]})
    out = str(tmp_path / "out.wav")
    g = compat.XmAudioGenerator(device="cpu")
    g.start(cfg, out)
    assert g.wait(180) == compat.GS_COMPLETED, g.error
    got, sr = read_wav(out)
    assert sr == 16000
    assert abs(_dominant(got, sr) - 440.0) < 2.0


def test_decode_rejects_garbage(tmp_path):
    p = tmp_path / "junk.mp3"
    p.write_bytes(b"\x00" * 100)
    with pytest.raises(DecodeError):
        ff.decode(str(p))
    with pytest.raises(DecodeError):
        ff.StreamDecoder(str(p))


def test_stream_decoder_chunked_flac_exact(tmp_path, rng):
    """Chunked reads and sample-accurate seeks of a 60 s FLAC reproduce
    the source PCM at constant memory."""
    sr = 16000
    pcm = (rng.standard_normal(sr * 60) * 8000).astype(np.int16)
    p = str(tmp_path / "long.flac")
    ff.encode(p, pcm, sr)
    with ff.StreamDecoder(p) as d:
        assert d.sample_rate == sr and d.num_channels == 1
        assert abs(d.num_samples - len(pcm)) < 0.01 * sr
        np.testing.assert_array_equal(d.read(4000)[:, 0], pcm[:4000])
        d.seek_sample(123_457)
        np.testing.assert_array_equal(
            d.read(5000)[:, 0], pcm[123_457:128_457])
        d.seek(0.0)
        total = 0
        while True:
            c = d.read(4096)
            if not len(c):
                break
            total += len(c)
        assert total == len(pcm)
        assert d.max_buffered <= 16384, d.max_buffered


def test_stream_decoder_registered_backend(tmp_path, rng):
    """``open_audio`` on a compressed file returns the chunked decoder."""
    from xmtpu_torch.io import open_audio

    sr = 16000
    pcm = (rng.standard_normal(sr * 2) * 8000).astype(np.int16)
    p = str(tmp_path / "x.flac")
    ff.encode(p, pcm, sr)
    with open_audio(p) as d:
        assert isinstance(d, ff.StreamDecoder)
        np.testing.assert_array_equal(d.read_all()[:, 0], pcm)


def test_compat_decoder_surface(tmp_path, rng):
    from xmtpu_torch.compat import XmAudioUtils

    sr = 16000
    pcm = (rng.standard_normal(sr * 3) * 8000).astype(np.int16)
    p = str(tmp_path / "h.flac")
    ff.encode(p, pcm, sr)
    u = XmAudioUtils(device="cpu")
    assert u.decoder_create(p) == 0
    a = u.decoder_get_pcm(2000)
    np.testing.assert_array_equal(a[:, 0], pcm[:2000])
    assert u.decoder_seek(1000.0) == 0
    b = u.decoder_get_pcm(2000)
    np.testing.assert_array_equal(b[:, 0], pcm[16000:18000])
    while u.decoder_get_pcm(1 << 16) is not None:
        pass
    u.freep()


def test_encode_float_pcm(tmp_path):
    """Float PCM encodes through the pinned int16 conversion."""
    from xmtpu_torch.io import encode_audio, open_audio

    pcm = _tone(0.4).astype(np.float32) / 32768.0
    p = str(tmp_path / "f.mp3")
    encode_audio(p, pcm, SR)
    with open_audio(p) as d:
        got = d.read_all()
    assert np.abs(got).max() > 5000
    assert abs(_dominant(got, SR) - 440.0) < 2.0


def test_stream_read_all_position_independent(tmp_path):
    from xmtpu_torch.io import encode_audio, open_audio

    p = str(tmp_path / "s.flac")
    encode_audio(p, _tone(1.0), SR)
    with open_audio(p) as d:
        full = d.read_all()
        d.seek(500.0)
        again = d.read_all()
        np.testing.assert_array_equal(d.read(100), full[22050:22150])
    assert again.shape == full.shape
    np.testing.assert_array_equal(again, full)


def test_process_file_compressed_extension(tmp_path):
    """process_file writes compressed bytes for a compressed name."""
    from xmtpu_torch.config.schema import PipelineConfig, TrackConfig
    from xmtpu_torch.graph.pipeline import process_file

    cfg = PipelineConfig(sample_rate=SR, tracks=[
        TrackConfig(url="v", kind="voice")])
    out = str(tmp_path / "g.mp3")
    process_file({"v": (_tone(0.5), SR)}, cfg, out, device="cpu")
    assert open(out, "rb").read(4) != b"RIFF"


@pytest.mark.parametrize("ext", ["mp3", "m4a"])
def test_encode_bitrate_controls_size(tmp_path, ext):
    pcm = _tone(2.0, freq=440.0)
    lo = str(tmp_path / f"lo.{ext}")
    hi = str(tmp_path / f"hi.{ext}")
    ff.encode(lo, pcm, SR, bitrate=48000)
    ff.encode(hi, pcm, SR, bitrate=256000)
    assert os.path.getsize(hi) > 1.5 * os.path.getsize(lo), (
        os.path.getsize(lo), os.path.getsize(hi))
    for p in (lo, hi):
        got, sr = ff.decode(p)
        assert sr == SR
        assert abs(_dominant(got, sr) - 440.0) < 2.0


def test_encode_bitrate_via_registry(tmp_path):
    from xmtpu_torch.io import encode_audio

    pcm = _tone(2.0)
    lo = str(tmp_path / "lo.mp3")
    hi = str(tmp_path / "hi.mp3")
    encode_audio(lo, pcm, SR, bitrate=48000)
    encode_audio(hi, pcm, SR, bitrate=256000)
    assert os.path.getsize(hi) > 1.5 * os.path.getsize(lo)


def test_pipeline_config_bitrate_roundtrip(tmp_path):
    """The config's bitrate survives JSON and reaches the encoder
    through process_file."""
    from xmtpu_torch.config.schema import config_from_dict, config_to_dict
    from xmtpu_torch.graph.pipeline import process_file

    d = {"tracks": [{"url": "v"}], "sampleRate": SR, "bitrate": 48000}
    cfg = config_from_dict(d)
    assert cfg.bitrate == 48000
    assert config_to_dict(cfg)["bitrate"] == 48000
    rng = np.random.default_rng(0)
    voice = (rng.standard_normal(SR) * 9000).astype(np.int16)
    lo = str(tmp_path / "lo.mp3")
    hi = str(tmp_path / "hi.mp3")
    process_file({"v": (voice, SR)}, cfg, lo, device="cpu")
    process_file({"v": (voice, SR)}, config_from_dict({**d, "bitrate": 256000}),
                 hi, device="cpu")
    assert os.path.getsize(hi) > 1.5 * os.path.getsize(lo)


def test_decode_corrupt_files_fail_typed_never_crash(tmp_path):
    """Truncated and bit-flipped FLACs through the whole-file decode and
    the chunked decoder raise typed errors or decode leniently."""
    rng = np.random.default_rng(3)
    pcm = (rng.standard_normal(16000) * 8000).astype(np.int16)
    src = str(tmp_path / "t.flac")
    ff.encode(src, pcm, SR)
    data = open(src, "rb").read()
    bad = str(tmp_path / "bad.flac")
    for trial in range(24):
        b = bytearray(data)
        if trial % 3 == 0:
            b = b[: int(rng.integers(10, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        open(bad, "wb").write(bytes(b))
        try:
            ff.decode(bad)
        except (ValueError, RuntimeError, OSError):
            pass
        try:
            h = ff.StreamDecoder(bad)
            try:
                h.read(1024)
                h.seek(200.0)
                h.read(4096)
            finally:
                h.close()
        except (ValueError, RuntimeError, OSError):
            pass


def test_encode_without_shim_raises_not_riff(tmp_path, monkeypatch):
    """With the shim unavailable a compressed name raises a typed error
    and nothing is written; decoding one raises DecodeError."""
    from xmtpu_torch.io import encode_audio, open_audio

    monkeypatch.setattr(ff, "available", lambda: False)
    p = str(tmp_path / "x.m4a")
    with pytest.raises(XmtpuError, match="shim unavailable"):
        encode_audio(p, _tone(0.3), SR)
    assert not os.path.exists(p)
    q = tmp_path / "y.flac"
    q.write_bytes(b"fLaC" + b"\x00" * 60)
    with pytest.raises(DecodeError, match="shim unavailable"):
        open_audio(q)


# -- the two shims against each other ----------------------------------------


@pytest.mark.parametrize("ext", ["flac", "mp3", "m4a"])
def test_files_decode_alike_across_the_shims(tmp_path, ext, jax_shim):
    """A file encoded by either shim decodes to the same int16 through
    both."""
    rng = np.random.default_rng(16)
    pcm = (rng.standard_normal((SR, 2)) * 6000).astype(np.int16)
    for enc, name in ((ff.encode, "port"), (xff.encode, "jax")):
        p = str(tmp_path / f"{name}.{ext}")
        enc(p, pcm, SR)
        got, sr = ff.decode(p)
        want, sr_j = xff.decode(p)
        assert sr == sr_j == SR and got.shape[1] == 2
        np.testing.assert_array_equal(got, want)
        if ext == "flac":
            np.testing.assert_array_equal(got, pcm)


def test_stream_decoders_read_alike(tmp_path, jax_shim):
    """Chunked reads and seeks of one mp3 through both shims' handles."""
    rng = np.random.default_rng(17)
    pcm = (rng.standard_normal(SR * 3) * 6000).astype(np.int16)
    p = str(tmp_path / "s.mp3")
    ff.encode(p, pcm, SR)
    with ff.StreamDecoder(p) as a:
        b = xff.StreamDecoder(p)
        try:
            assert (a.sample_rate, a.num_channels, a.num_samples) == (
                b.sample_rate, b.num_channels, b.num_samples)
            for op, arg in (("read", 1000), ("read", 4096), ("seek", 1500.0),
                            ("read", 777), ("seek_sample", 100_003),
                            ("read", 50_000), ("read", 1 << 20)):
                if op == "read":
                    np.testing.assert_array_equal(a.read(arg), b.read(arg))
                else:
                    getattr(a, op)(arg)
                    getattr(b, op)(arg)
                assert a.position_ms == b.position_ms
            np.testing.assert_array_equal(a.read_all(), b.read_all())
        finally:
            b.close()


def test_exotic_wav_through_the_shims(tmp_path, jax_shim):
    """A float64 WAV, which neither WAV parser takes: both packages'
    ``read_wav`` decode it through their FFmpeg shims, alike."""
    x = np.sin(np.arange(4000) / 7.0) * 0.5
    data = x.astype("<f8").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 3, 1, 16000, 16000 * 8, 8, 64)
           + b"data" + struct.pack("<I", len(data)))
    p = tmp_path / "f64.wav"
    p.write_bytes(hdr + data)
    got, sr = twav.read_wav(p)
    want, sr_j = xwav.read_wav(p)
    assert sr == sr_j == 16000 and got.shape == (4000, 1)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[:, 0] - x * 32768.0).max() <= 1.0


def test_concurrent_first_build(tmp_path):
    """Four processes start the shim's first build at once into an
    empty build root: one compiles, all four load it, no temporary file
    is left."""
    root = tmp_path / "build_root"
    code = (
        "import sys, time, pathlib\n"
        "from xmtpu_torch.native import ffmpeg\n"
        "ffmpeg.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
        "go = pathlib.Path(sys.argv[2])\n"
        "pathlib.Path(sys.argv[3]).touch()\n"
        "while not go.exists():\n"
        "    time.sleep(0.01)\n"
        "assert ffmpeg.available(), 'load failed'\n"
        "print(ffmpeg.library_path())\n")
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
