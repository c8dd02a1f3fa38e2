"""Parity of the port's WAV/PCM I/O (``xmtpu_torch.io``) with the JAX
package's stdlib path (``xmtpu.io``): both packages' native C++ parsers
are switched off here, so these tests hold the two stdlib paths against
each other; ``tests/test_torch_native.py`` holds the native paths.

One size: 1,000 frames at 16 kHz. Tolerance: none. The bytes written and
the arrays decoded are identical (8-, 16-, 24- and 32-bit PCM, a
truncated final frame, raw PCM of four dtypes); a corrupt or cut file
is a ``DecodeError`` in the port wherever the JAX package raises one.
"""

from __future__ import annotations

import struct
import wave

import numpy as np
import pytest

import xmtpu_torch
from xmtpu.io import decoder as xdec
from xmtpu.io import encoder as xenc
from xmtpu.io import wav as xwav
from xmtpu.utils.errors import DecodeError as XDecodeError
from xmtpu.utils.errors import XmtpuError as XXmtpuError
from xmtpu_torch import io as tio
from xmtpu_torch.io import wav as twav
from xmtpu_torch.utils.errors import ConfigError, DecodeError, XmtpuError

SR = 16000
N = 1000


@pytest.fixture(autouse=True)
def stdlib_reference(monkeypatch):
    """Both packages' stdlib codecs (no native library)."""
    monkeypatch.setattr(xwav, "_native", lambda: None)
    monkeypatch.setattr(twav, "_native", lambda: None)


@pytest.fixture(scope="module")
def pcm():
    rng = np.random.default_rng(61)
    return (rng.standard_normal((N, 2)) * 9000).astype(np.int16)


@pytest.mark.parametrize("layout", ["mono (n,)", "stereo (n, 2)"])
def test_written_bytes_identical(tmp_path, pcm, layout):
    x = pcm[:, 0].copy() if layout.startswith("mono") else pcm
    tio.write_wav(tmp_path / "t.wav", x, SR)
    xwav.write_wav(tmp_path / "j.wav", x, SR)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back, sr = tio.read_wav(tmp_path / "t.wav")
    assert sr == SR and back.shape == (N, 1 if x.ndim == 1 else 2)
    np.testing.assert_array_equal(back.reshape(x.shape), x)


def _write_width(path, pcm, width):
    """A PCM WAV with ``width``-byte samples from int16 content (low
    bytes filled so that truncation to 16 bits is exercised)."""
    v = pcm.astype(np.int32)
    if width == 1:
        raw = ((v >> 8) + 128).astype(np.uint8).tobytes()
    elif width == 2:
        raw = pcm.astype("<i2").tobytes()
    elif width == 3:
        w24 = (v << 8) | (np.abs(v) & 0xFF)
        b = w24.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        raw = b.tobytes()
    else:
        raw = ((v << 16) | (np.abs(v) & 0xFFFF)).astype("<i4").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(raw)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_decoded_identical_by_width(tmp_path, pcm, width):
    p = tmp_path / f"w{width}.wav"
    _write_width(p, pcm, width)
    got, sr = tio.read_wav(p)
    want, sr_j = xwav.read_wav(p)
    assert sr == sr_j == SR and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if width > 1:  # 16 bits and more keep the int16 content
        np.testing.assert_array_equal(got, pcm)
    info, info_j = twav.wav_info(p), xwav.wav_info(p)
    assert (info.sample_rate, info.num_channels, info.num_samples,
            info.sample_width) == (info_j.sample_rate, info_j.num_channels,
                                   info_j.num_samples, info_j.sample_width)


@pytest.mark.parametrize("cut", [0, 11, 44, 45, 47, 1001])
def test_truncated_file(tmp_path, pcm, cut):
    """A file cut at any byte: both packages drop a partial final frame
    alike, or both raise DecodeError."""
    full = tmp_path / "full.wav"
    tio.write_wav(full, pcm, SR)
    p = tmp_path / "cut.wav"
    p.write_bytes(full.read_bytes()[:cut])
    try:
        want = xwav.read_wav(p)
    except XDecodeError:
        with pytest.raises(DecodeError):
            tio.read_wav(p)
        return
    got = tio.read_wav(p)
    assert got[1] == want[1] and got[0].ndim == 2
    np.testing.assert_array_equal(got[0], want[0])


def test_corrupt_file_is_decode_error(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunkjunkjunk")
    with pytest.raises(DecodeError, match="cannot decode WAV"):
        tio.read_wav(p)
    with pytest.raises(XDecodeError):
        xwav.read_wav(p)
    with pytest.raises(DecodeError):
        tio.read_wav(tmp_path / "missing.wav")
    assert issubclass(DecodeError, ValueError)
    assert issubclass(DecodeError, XmtpuError)


def test_float32_wav_not_decoded(tmp_path):
    """A float32 WAV (format tag 3): the stdlib path refuses it in both
    packages (the JAX package decodes it only through its native or
    FFmpeg backends)."""
    x = np.zeros(50, np.float32).tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(x)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 3, 1, SR, SR * 4, 4, 32)
           + b"data" + struct.pack("<I", len(x)))
    p = tmp_path / "f32.wav"
    p.write_bytes(hdr + x)
    assert twav._fmt_chunk_bits(p) == xwav._fmt_chunk_bits(p) == 32
    with pytest.raises(DecodeError):
        twav.wav_info(p)


def test_decoder_seek_read(tmp_path, pcm):
    p = tmp_path / "s.wav"
    tio.write_wav(p, pcm, SR)
    with tio.open_audio(p) as d, xdec.open_audio(p) as dj:
        assert (d.sample_rate, d.num_channels, d.num_samples) == (
            dj.sample_rate, dj.num_channels, dj.num_samples)
        for dd in (d, dj):
            dd.seek(12.5)
        np.testing.assert_array_equal(d.read(300), dj.read(300))
        assert d.position_ms == dj.position_ms
        np.testing.assert_array_equal(d.read(10000), dj.read(10000))
        assert d.read(5).shape == (0, 2)
        with pytest.raises(ValueError):  # the buffer is read-only
            d.read_all()[0, 0] = 1


def test_decoder_freezes_1d_base():
    x = np.zeros(100, np.float32)
    tio.Decoder(x, SR)
    with pytest.raises(ValueError):
        x[0] = 1.0


@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "float32"])
def test_raw_pcm_identical(tmp_path, pcm, dtype):
    rng = np.random.default_rng(62)
    f = np.clip(rng.standard_normal(2 * N) * 0.25, -0.9, 0.9)
    data = {"int16": (f * 32767).astype(np.int16),
            "int32": (f * (1 << 31)).astype(np.int32),
            "uint8": np.clip((f + 1.0) * 128.0, 0, 255).astype(np.uint8),
            "float32": f.astype(np.float32)}[dtype]
    p = tmp_path / "a.pcm"
    p.write_bytes(data.tobytes())
    with tio.open_audio(p, sample_rate=SR, channels=2, dtype=dtype) as d:
        got = d.read_all()
    with xdec.open_audio(str(p), sample_rate=SR, channels=2,
                         dtype=dtype) as dj:
        want = dj.read_all()
    assert got.dtype == np.int16 and got.shape == (N, 2)
    np.testing.assert_array_equal(got, want)


def test_raw_pcm_argument_errors(tmp_path):
    p = tmp_path / "a.raw"
    p.write_bytes(b"\x00" * 8)
    with pytest.raises(ValueError, match="sample_rate="):
        tio.open_audio(p)
    with pytest.raises(ValueError, match=">= 1"):
        tio.open_audio(p, sample_rate=SR, channels=0)


@pytest.mark.parametrize("ext", ["mp3", "m4a", "xyzcodec"])
def test_compressed_and_unknown_extensions(tmp_path, pcm, ext):
    """No FFmpeg shim: decoding raises DecodeError, encoding raises and
    writes nothing, as the JAX package does without its shim."""
    assert tio.HAVE_FFMPEG is False
    p = tmp_path / f"x.{ext}"
    p.write_bytes(b"\x00" * 64)
    with pytest.raises(DecodeError, match="no decoder backend"):
        tio.open_audio(p)
    q = tmp_path / f"out.{ext}"
    with pytest.raises(ConfigError, match="no encoder backend"):
        tio.encode_audio(q, pcm, SR)
    assert not q.exists()
    if ext == "xyzcodec":  # the JAX package's own registries agree
        with pytest.raises(XDecodeError):
            xdec.open_audio(p)
        with pytest.raises(XXmtpuError):
            xenc.encode_audio(str(q), pcm, SR)


def test_encode_wav_and_registry(tmp_path, pcm):
    p = tmp_path / "o.WAV"
    assert tio.encode_audio(p, pcm, SR) == str(p)
    np.testing.assert_array_equal(tio.read_wav(p)[0], pcm)
    seen = []
    tio.register_encoder(".fake", lambda path, x, sr, **kw: seen.append(
        (path, x.shape, sr, kw)))
    tio.encode_audio(tmp_path / "o.fake", pcm, SR, bitrate=64000)
    assert seen == [(str(tmp_path / "o.fake"), (N, 2), SR,
                     {"bitrate": 64000})]
    with pytest.raises(TypeError, match="int16"):
        tio.write_wav(tmp_path / "f.wav", pcm.astype(np.float32), SR)
    assert xmtpu_torch.io is tio
