"""The port's handle-style API (``xmtpu_torch.compat``) against the JAX
package's (``xmtpu.compat``) on the CPU: the mixer, voice-effects and
decoder handles frame by frame, and the async generator's file, on
``device="cpu"``; the generator's status codes (``GS_COMPLETED``,
``GS_STOPPED``, ``GS_ERROR``), its atomic start, and the device rule.

One signal: 1 s of int16 noise at 16 kHz. Tolerance: within 1 LSB and
-80 dB of the JAX package's output.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from xmtpu import compat as xcompat
from xmtpu_torch import compat as tcompat
from xmtpu_torch.graph import pipeline as tpipeline
from xmtpu_torch.io.wav import read_wav, write_wav
from xmtpu_torch.utils.errors import DeviceError, XmtpuError

from .conftest import rms_db

SR = 16000
CHAIN = [{"name": "equalizer",
          "params": {"bands": [{"freq_hz": 1000.0, "gain_db": 3.0,
                                "q": 1.0}]}},
         {"name": "limiter", "params": {"threshold_db": -6.0}}]


@pytest.fixture()
def voice(tmp_path):
    pcm = (np.random.default_rng(1616).standard_normal(SR) * 9000).astype(
        np.int16)
    p = tmp_path / "v.wav"
    write_wav(p, pcm, SR)
    return str(p), pcm


def _close(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.int16
    lsb = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
    db = rms_db(a.astype(np.float64) - b, b.astype(np.float64))
    print(f"{a.shape}: {lsb} LSB, {db:.1f} dB")
    assert lsb <= 1 and db <= -80.0


def _drain(get, limit=200):
    frames = []
    while (f := get()) is not None:
        frames.append(f)
        assert len(frames) < limit
    return frames


def test_mixer_handle_vs_jax(voice):
    path, pcm = voice
    cfg = json.dumps({"sampleRate": SR, "tracks": [
        {"url": path, "volume": 0.9, "fadeInTimeMs": 50}]})
    got = {}
    for name, h in (("t", tcompat.XmAudioUtils(device="cpu")),
                    ("j", xcompat.XmAudioUtils())):
        assert h.mixer_init(cfg) == 0
        assert h.mixer_seek(100.0) == 0
        first = h.mixer_get_frame()
        h.mixer_seek(0.0)
        got[name] = (first, _drain(h.mixer_get_frame))
        h.freep()
    assert len(got["t"][1]) == len(got["j"][1]) == 50
    _close(got["t"][0], got["j"][0])
    _close(np.concatenate(got["t"][1]), np.concatenate(got["j"][1]))


@pytest.mark.parametrize("form", ["path", "(pcm, sr)", "chain JSON"])
def test_effects_handle_vs_jax(voice, form):
    """The voice-effects handle, from 250 ms to the end of the voice, in
    each voice/config form; the session adopts the voice's rate when the
    config names none."""
    path, pcm = voice
    cfg, src = {"effects": CHAIN}, path
    if form == "(pcm, sr)":
        src = (pcm, SR)
    elif form == "chain JSON":
        cfg = json.dumps(CHAIN)
    got = {}
    for name, h in (("t", tcompat.XmAudioUtils(device="cpu")),
                    ("j", xcompat.XmAudioUtils())):
        assert h.effects_init(cfg, src) == 0
        assert h.effects_seek(250.0) == 0
        got[name] = _drain(h.effects_get_frame)
        h.freep()
    assert len(got["t"]) == len(got["j"]) > 0
    _close(np.concatenate(got["t"]), np.concatenate(got["j"]))


def test_handle_errors_and_decoder(voice, tmp_path):
    path, pcm = voice
    h = tcompat.XmAudioUtils(device="cpu")
    for call in (h.mixer_get_frame, h.effects_get_frame,
                 lambda: h.decoder_get_pcm(10)):
        with pytest.raises(XmtpuError, match="first"):
            call()
    with pytest.raises(XmtpuError, match="single voice"):
        h.effects_init({"effects": CHAIN, "tracks": [{"url": path}]}, path)
    with pytest.raises(XmtpuError, match="path alone"):
        h.effects_init(CHAIN, (path, SR))
    j = xcompat.XmAudioUtils()
    for hh in (h, j):
        assert hh.decoder_create(path) == 0
        assert hh.decoder_create(path) == 0  # the first handle is closed
        hh.decoder_seek(500.0)
    a = [h.decoder_get_pcm(1024) for _ in range(9)]
    b = [j.decoder_get_pcm(1024) for _ in range(9)]
    assert a[-1] is None and b[-1] is None
    np.testing.assert_array_equal(np.concatenate(a[:-1]),
                                  np.concatenate(b[:-1]))
    np.testing.assert_array_equal(np.concatenate(a[:-1])[:, 0], pcm[8000:])
    h.freep()
    j.freep()


def test_generator_vs_jax(voice, tmp_path):
    path, pcm = voice
    cfg = json.dumps({"sampleRate": SR, "normalize": "peak", "tracks": [
        {"url": path, "volume": 0.8, "fadeInTimeMs": 10}]})
    outs = {}
    for name, g in (("t", tcompat.XmAudioGenerator(device="cpu")),
                    ("j", xcompat.XmAudioGenerator())):
        outs[name] = str(tmp_path / f"{name}.wav")
        assert g.start(cfg, outs[name]) == 0
        assert g.wait(120) == tcompat.GS_COMPLETED == xcompat.GS_COMPLETED, \
            g.error
        assert g.get_progress() == 100.0
    a, sa = read_wav(outs["t"])
    b, sb = read_wav(outs["j"])
    assert sa == sb == SR and a.shape[0] == len(pcm)
    _close(a, b)


def test_generator_stop_error_and_atomic_start(voice, tmp_path,
                                               monkeypatch):
    """stop() ends the run at the next stage mark (GS_STOPPED); a second
    start while one runs returns -1; a failing pipeline is a pollable
    GS_ERROR; the codes are the JAX package's."""
    path, _ = voice
    gate, started = threading.Event(), threading.Event()

    def slow(inputs, cfg, out_path, progress=None, device=None):
        assert device == torch.device("cpu")
        progress(0.0)
        started.set()
        gate.wait(10)
        progress(10.0)

    monkeypatch.setattr(tpipeline, "process_file", slow)
    cfg = json.dumps({"sampleRate": SR, "tracks": [{"url": path}]})
    g = tcompat.XmAudioGenerator(device="cpu")
    assert g.start(cfg, str(tmp_path / "o.wav")) == 0
    assert started.wait(10)
    assert g.status == tcompat.GS_RUNNING
    assert g.start(cfg, str(tmp_path / "o2.wav")) == -1
    g.stop()
    gate.set()
    assert g.wait(30) == tcompat.GS_STOPPED == xcompat.GS_STOPPED
    monkeypatch.undo()
    bad = json.dumps({"sampleRate": SR, "tracks": [
        {"url": str(tmp_path / "nonexistent.wav")}]})
    assert g.start(bad, str(tmp_path / "o3.wav")) == 0
    assert g.wait(60) == tcompat.GS_ERROR == xcompat.GS_ERROR
    assert g.error is not None
    assert (tcompat.GS_IDLE, tcompat.GS_RUNNING) == (xcompat.GS_IDLE,
                                                     xcompat.GS_RUNNING)


def test_no_card_raises_device_error(voice, tmp_path, monkeypatch):
    """Without a card and without ``device=``, the sessions and the
    generator raise DeviceError; the generator's claim is released."""
    path, _ = voice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = json.dumps({"sampleRate": SR, "tracks": [{"url": path}]})
    h = tcompat.XmAudioUtils()
    with pytest.raises(DeviceError):
        h.mixer_init(cfg)
    with pytest.raises(DeviceError):
        h.effects_init(CHAIN, path)
    assert h.decoder_create(path) == 0  # the decoder is host-only
    g = tcompat.XmAudioGenerator()
    with pytest.raises(DeviceError):
        g.start(cfg, str(tmp_path / "o.wav"))
    assert g.status == tcompat.GS_IDLE and g.wait(1) == tcompat.GS_IDLE
