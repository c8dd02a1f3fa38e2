"""Parity of the port's mixer (``xmtpu_torch.graph.mixer``, ``api.mix``)
and file pipeline (``xmtpu_torch.graph.pipeline``,
``api.process_file``) with the JAX package's, on the CPU: the port on
``device="cpu"`` (under ``auto`` the voice and master chains run the
float64 scan engine, as the JAX package's do on its CPU; the
K-weighting and the resample on their kernels' plain twins), the JAX
package as its own tests run it (``measure_lufs`` through
``sosfilt_pallas`` in interpret mode). The JAX WAV codec runs its stdlib
path.

One size: a 1 s voice at 16 kHz on a 16 kHz bus, placed at 0.5 s; a
1 s stereo BGM at 8 kHz (resampled, looped under the 1.5 s program,
side-ducked); a 0.05 s IR at 8 kHz (resampled) for ``ir_wav``.

Tolerances: float output against the JAX package at -80 dB; int16
output within 1 LSB; peak, lufs and rms normalization, loop, placement,
``side_duck`` and ``voice_effects`` (noise suppression, EQ, reverb from
a WAV) all covered.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu.config import schema as xs
from xmtpu.graph import mixer as xmix
from xmtpu.graph import pipeline as xpipe
from xmtpu.io import wav as xwav
from xmtpu_torch import api
from xmtpu_torch.config import schema as ts
from xmtpu_torch.graph import fx as tfx
from xmtpu_torch.graph import mixer as tmix
from xmtpu_torch.graph import pipeline as tpipe
from xmtpu_torch.io import read_wav, register_encoder, write_wav
from xmtpu_torch.ops import convert
from xmtpu_torch.ops.reverb import synthetic_ir
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR = 16000
BGM_SR = 8000
FIVE_BANDS = [
    {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
    {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
    {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
    {"freq_hz": 3000.0, "gain_db": -2.0, "q": 1.1},
    {"freq_hz": 6000.0, "gain_db": 3.0, "q": 0.8},
]


@pytest.fixture(autouse=True)
def stdlib_reference(monkeypatch):
    """The JAX package's stdlib WAV codec (no native library)."""
    monkeypatch.setattr(xwav, "_native", lambda: None)


@pytest.fixture(scope="module")
def sources():
    """(voice (n,) float32 at 16 kHz: amplitude-modulated noise over a
    noise floor, BGM (n, 2) float32 at 8 kHz: two tones, IR (m,)
    float32 at 8 kHz)."""
    rng = np.random.default_rng(81)
    t = np.arange(SR) / SR
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    voice = 0.2 * env * rng.standard_normal(SR) + 0.01 * rng.standard_normal(SR)
    voice[:2000] = 0.01 * rng.standard_normal(2000)  # noise-only lead-in
    tb = np.arange(BGM_SR) / BGM_SR
    bgm = 0.3 * np.stack([np.sin(2 * np.pi * 220 * tb),
                          np.sin(2 * np.pi * 330 * tb)], -1)
    ir = synthetic_ir(0.05, BGM_SR, seed=3)
    return (voice.astype(np.float32), bgm.astype(np.float32),
            (0.5 * ir / np.abs(ir).max()).astype(np.float32))


@pytest.fixture(scope="module")
def files(tmp_path_factory, sources):
    voice, bgm, ir = sources
    d = tmp_path_factory.mktemp("pipe")
    for name, x, sr in (("voice.wav", voice, SR), ("bgm.wav", bgm, BGM_SR),
                        ("ir.wav", ir, BGM_SR)):
        write_wav(d / name, convert.f32_to_pcm16_np(x), sr)
    return d


def _voice_effects(files):
    return [{"name": "noise_suppression"},
            {"name": "equalizer", "bands": FIVE_BANDS},
            {"name": "reverb", "ir_wav": str(files / "ir.wav"), "wet": 0.2,
             "dry": 0.8}]


def _tracks(voice, bgm):
    return [dict(pcm=voice, sr=SR, start_ms=500.0, fade_in_ms=100.0),
            dict(pcm=bgm, sr=BGM_SR, kind="bgm", loop=True, side_duck=True,
                 gain=0.5, fade_in_ms=200.0)]


def _lsb(got, ref):
    return int(np.abs(np.asarray(got, np.int32)
                      - np.asarray(ref, np.int32)).max())


@pytest.mark.parametrize("normalize,target", [("peak", -1.0), ("rms", -20.0),
                                              ("lufs", -16.0)])
def test_mix_vs_jax(sources, files, normalize, target):
    """Placement, loop, fades, side_duck, voice_effects (NS, EQ, reverb
    from a WAV) and each normalize mode."""
    voice, bgm, _ = sources
    kw = dict(normalize=normalize, target_db=target,
              voice_effects=_voice_effects(files))
    y = api.mix(_tracks(voice, bgm), SR, device="cpu", **kw)
    yj = xmix.mix(_tracks(voice, bgm), SR, **kw)
    assert y.shape == yj.shape == (SR + SR // 2, 2) and y.dtype == np.float32
    print(f"{normalize}: {refs.db(y, yj):.1f} dB vs JAX")
    assert refs.db(y, yj) <= -80.0


def test_mix_int16_within_one_lsb(sources):
    voice, bgm, _ = sources
    tr = [dict(t, pcm=convert.f32_to_pcm16_np(t["pcm"]))
          for t in _tracks(voice, bgm)]
    y = api.mix(tr, SR, device="cpu")
    yj = xmix.mix(tr, SR)
    assert y.dtype == np.int16 and y.shape == yj.shape
    assert _lsb(y, yj) <= 1


def test_mix_resamples_through_the_kernel_wrapper(monkeypatch, sources):
    """A track off the bus rate goes through kernels.resample.resample
    (the resample kernel on a card, its plain twin here) once, on its
    time-last float32 channels; a track at the bus rate does not."""
    voice, bgm, _ = sources
    real, calls = tmix._kresample.resample, []

    def counting(x, sr_in, sr_out, *args, **kw):
        calls.append((tuple(x.shape), x.dtype, sr_in, sr_out))
        return real(x, sr_in, sr_out, *args, **kw)

    want = api.mix(_tracks(voice, bgm), SR, device="cpu")
    monkeypatch.setattr(tmix._kresample, "resample", counting)
    got = api.mix(_tracks(voice, bgm), SR, device="cpu")
    assert calls == [((2, len(bgm)), torch.float32, BGM_SR, SR)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["duration, past end", "all loop",
                                  "mono upmix, pairs", "music bus"])
def test_mix_layouts_vs_jax(sources, case):
    voice, bgm, _ = sources
    kw = {"normalize": None}
    if case == "duration, past end":
        tr = [dict(pcm=voice, sr=SR),
              tmix.MixTrack(pcm=voice, sr=SR, start_ms=2000.0)]
        kw["duration_ms"] = 500.0
        trj = [tr[0], xmix.MixTrack(pcm=voice, sr=SR, start_ms=2000.0)]
    elif case == "all loop":
        tr = trj = [dict(pcm=voice[:3200], sr=SR, loop=True, start_ms=50.0)]
    elif case == "mono upmix, pairs":
        tr = trj = [(voice, SR), (bgm, BGM_SR)]
    else:
        tr = trj = [dict(pcm=voice, sr=SR, gain_db=-3.0),
                    dict(pcm=voice[::-1].copy(), sr=SR, kind="music",
                         fade_out_ms=300.0)]
    y = api.mix(tr, SR, device="cpu", **kw)
    yj = xmix.mix(trj, SR, **kw)
    assert y.shape == yj.shape and y.dtype == yj.dtype
    assert refs.db(y, yj) <= -80.0


@pytest.mark.parametrize("case,exc,match", [
    ("no tracks", ValueError, "at least one"),
    ("bare array", ConfigError, "MixTrack"),
    ("negative start", ConfigError, "start_ms"),
    ("bad rate", ConfigError, "unreasonable"),
    ("2 vs 4 channels", ConfigError, "only mono tracks upmix"),
    ("duration", ConfigError, "duration_ms"),
    ("bad voice effect", ConfigError, "unknown effect"),
])
def test_mix_typed_errors(sources, case, exc, match):
    voice, _, _ = sources
    x2 = np.zeros((100, 2), np.float32)
    args = {
        "no tracks": ([],),
        "bare array": ([voice],),
        "negative start": ([dict(pcm=voice, sr=SR, start_ms=-5.0)],),
        "bad rate": ([dict(pcm=voice, sr=44101)],),
        "2 vs 4 channels": ([(x2, SR), (np.zeros((100, 4), np.float32),
                                        SR)],),
        "duration": ([(voice, SR)],),
    }.get(case, ([(voice, SR)],))
    kw = {"duration": {"duration_ms": 0.0},
          "bad voice effect": {"voice_effects": [{"name": "flanger"}]}
          }.get(case, {})
    with pytest.raises(exc, match=match):
        api.mix(*args, SR, device="cpu", **kw)
    with pytest.raises(Exception):  # the JAX mixer refuses each too
        xmix.mix(*args, SR, **kw)


def _config_doc(files, normalize, target, block_size=4096):
    return {
        "sampleRate": SR, "channels": 2, "normalize": normalize,
        "normalizeTargetDb": target, "blockSize": block_size,
        "tracks": [
            {"url": str(files / "voice.wav"), "kind": "voice",
             "startTimeMs": 500.0, "fadeInTimeMs": 100.0},
            {"url": str(files / "bgm.wav"), "kind": "bgm", "volume": 0.5,
             "loop": True, "sideDuck": True, "fadeInTimeMs": 200.0},
        ],
        "effects": _voice_effects(files),
        "masterEffects": [{"name": "limiter", "threshold_db": -1.0,
                           "ceiling_db": -1.0}],
    }


@pytest.mark.parametrize("normalize,target", [("peak", -1.0),
                                              ("lufs", -16.0)])
def test_process_file_vs_jax(tmp_path, files, normalize, target):
    """Decode, mix with the voice effects, normalize, the master
    limiter in blocks of 4,096 samples, encode: the written files agree
    within 1 LSB, and the limiter holds its ceiling."""
    doc = _config_doc(files, normalize, target)
    seen = []
    out = api.process_file(None, ts.config_from_dict(doc),
                           tmp_path / "t.wav", progress=seen.append,
                           device="cpu")
    xpipe.process_file(None, xs.config_from_dict(doc), tmp_path / "j.wav")
    assert out == tmp_path / "t.wav" and seen == [0.0, 10.0, 80.0, 95.0,
                                                  100.0]
    y, sr = read_wav(tmp_path / "t.wav")
    yj, _ = read_wav(tmp_path / "j.wav")
    assert sr == SR and y.shape == yj.shape == (SR + SR // 2, 2)
    assert _lsb(y, yj) <= 1
    ceiling = int(np.round(10 ** (-1.0 / 20.0) * 32768))
    assert int(np.abs(y.astype(np.int32)).max()) <= ceiling


def test_process_in_memory_inputs_and_end_trim(sources):
    """In-memory sources override urls; endTimeMs trims on the output
    timeline."""
    voice, bgm, _ = sources
    doc = {"sampleRate": SR, "normalize": "peak",
           "tracks": [{"url": "v", "startTimeMs": 100.0,
                       "endTimeMs": 700.0},
                      {"url": "b", "kind": "bgm", "volume": 0.3}]}
    inputs = {"v": voice, "b": (bgm, BGM_SR)}
    y = tpipe.process(inputs, ts.config_from_dict(doc), device="cpu")
    yj = xpipe.process(inputs, xs.config_from_dict(doc))
    assert y.dtype == np.int16 and y.shape == yj.shape == (SR, 2)
    assert _lsb(y, yj) <= 1


def test_master_noise_suppression_runs_whole_clip(sources):
    """A master chain holding noise suppression cannot run blocked
    (offline-only): the pipeline runs it on the whole clip; any other
    ConfigError stands."""
    voice, _, _ = sources
    doc = {"sampleRate": SR, "normalize": None, "blockSize": 1024,
           "tracks": [{"url": "v"}],
           "masterEffects": [{"name": "noise_suppression"}]}
    y = tpipe.process({"v": voice}, ts.config_from_dict(doc), device="cpu")
    yj = xpipe.process({"v": voice}, xs.config_from_dict(doc))
    assert _lsb(y, yj) <= 1
    whole = tfx.apply_chain(voice, SR, [{"name": "noise_suppression"}],
                            device="cpu")
    assert _lsb(y, convert.f32_to_pcm16_np(whole)) == 0
    doc["masterEffects"] = [{"name": "limiter", "bogus": 1}]
    with pytest.raises(ConfigError, match="unknown parameter"):
        tpipe.process({"v": voice}, ts.config_from_dict(doc), device="cpu")


def test_bitrate_reaches_the_encoder_and_missing_url(tmp_path, sources,
                                                     monkeypatch):
    """The config's bitrate reaches a registered encoder; an m4a output
    with the FFmpeg shim unavailable raises and writes nothing."""
    from xmtpu_torch.native import ffmpeg

    voice, _, _ = sources
    seen = []
    register_encoder("fakeaac", lambda path, pcm, sr, **kw: seen.append(
        (pcm.shape, sr, kw["bitrate"])))
    cfg = ts.config_from_dict({"sampleRate": SR, "bitrate": 96000,
                               "tracks": [{"url": "v"}]})
    tpipe.process_file({"v": voice}, cfg, tmp_path / "o.fakeaac",
                       device="cpu")
    assert seen == [((SR,), SR, 96000)]
    with pytest.raises(ConfigError, match="no url"):
        tpipe.process(None, ts.config_from_dict({"tracks": [{}]}),
                      device="cpu")
    monkeypatch.setattr(ffmpeg, "available", lambda: False)
    with pytest.raises(ConfigError, match="shim unavailable"):
        api.process_file({"v": voice}, cfg, tmp_path / "o.m4a", device="cpu")
    assert not (tmp_path / "o.m4a").exists()


@pytest.mark.parametrize("entry", ["mix", "process_file", "measure_lufs",
                                   "lufs_normalize", "suppress"])
def test_entry_points_run_on_cuda_unless_told(monkeypatch, tmp_path,
                                              sources, entry):
    """Without a card and without device=, every new entry point raises
    DeviceError; it never continues on the CPU."""
    voice, _, _ = sources
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "mix": lambda: xmtpu_torch.mix([(voice, SR)], SR),
        "process_file": lambda: xmtpu_torch.process_file(
            {"v": voice}, ts.PipelineConfig(tracks=(ts.TrackConfig("v"),)),
            tmp_path / "o.wav"),
        "measure_lufs": lambda: xmtpu_torch.measure_lufs(voice, SR),
        "lufs_normalize": lambda: xmtpu_torch.lufs_normalize(voice, SR),
        "suppress": lambda: xmtpu_torch.suppress(voice),
    }[entry]
    with pytest.raises(DeviceError, match='device="cpu"'):
        call()
    assert not (tmp_path / "o.wav").exists()


def test_load_config_file_drives_process_file(tmp_path, files):
    """A JSON file on disk, loaded by the port, drives the port's
    generator; the same file through the JAX package agrees."""
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(_config_doc(files, "rms", -20.0,
                                        block_size=65536)))
    api.process_file(None, ts.load_config(p), tmp_path / "t.wav",
                     device="cpu")
    xpipe.process_file(None, xs.load_config(str(p)), tmp_path / "j.wav")
    assert _lsb(read_wav(tmp_path / "t.wav")[0],
                read_wav(tmp_path / "j.wav")[0]) <= 1
