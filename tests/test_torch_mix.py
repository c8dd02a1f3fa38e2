"""Parity of the port's mix ops (``xmtpu_torch.ops.mix``), public
``resample`` (``xmtpu_torch.api.resample``) and the bench's configs 1-2
with the JAX package, on the CPU.

One signal length: 8,820 samples (0.2 s at 44.1 kHz), two rows or two
channels.

Tolerances:
- float32 mix ops and the normalize scales: <= -120 dB against the JAX
  functions (float32 on both sides, reductions in another order);
- ducking: float64 scans, <= -200 dB against the JAX scans, <= -100 dB
  against the float64 oracle ``duck_gain_np`` (the JAX package's own
  oracle gate, tests/test_effects.py:92);
- ``mix_oracle_np`` and ``duck_gain_np``: bit-exact (the same numpy);
- ``api.resample``: float32 out <= -120 dB against ``xmtpu.api.resample``
  (tests/test_resample.py:84's gate); int16 out: at most 1 LSB apart and
  <= -100 dB.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu import api as xapi
from xmtpu.ops import mix as xmix
from xmtpu_torch import api, bench
from xmtpu_torch.ops import convert
from xmtpu_torch.ops import mix as tmix
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from .conftest import rms_db

N = 8820
SR = 16000


def _db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return rms_db(got - ref, ref)


@pytest.fixture(scope="module")
def tracks():
    """(3, 2, N) float32: three tracks of two rows, the second track
    hot."""
    rng = np.random.default_rng(11)
    t = (0.3 * rng.standard_normal((3, 2, N))).astype(np.float32)
    t[1] *= 3.0
    return t


def test_mix_sum(tracks):
    y_j = np.asarray(xmix.mix_sum(jnp.asarray(tracks)))
    for arg in (torch.from_numpy(tracks), list(torch.from_numpy(tracks))):
        y_t = tmix.mix_sum(arg).numpy()
        assert y_t.shape == y_j.shape and y_t.dtype == np.float32
        assert _db(y_t, y_j) <= -120.0


@pytest.mark.parametrize("fn", ["peak_normalize", "rms_normalize"])
@pytest.mark.parametrize("case", ["whole", "where", "silence",
                                  "silence where", "empty where"])
def test_normalize_vs_jax(tracks, fn, case):
    """Both normalizers against the JAX ones: with and without the
    ragged ``where`` mask (padding kept out of the peak and the mean),
    and silence, which keeps scale 1."""
    x = tracks[1].copy()
    where = None
    if "where" in case:
        where = np.ones(x.shape, bool)
        where[1, N // 2:] = False  # a padded second row
        x[1, N // 2:] = 50.0  # pad that must not count
    if "silence" in case:
        x[:] = 0.0
    if case == "empty where":
        where[:] = False
    y_j, s_j = getattr(xmix, fn)(jnp.asarray(x), 0.7,
                                 where=None if where is None
                                 else jnp.asarray(where))
    y_t, s_t = getattr(tmix, fn)(torch.from_numpy(x), 0.7,
                                 where=None if where is None
                                 else torch.from_numpy(where))
    s_j, s_t = float(s_j), float(s_t)
    assert abs(s_t - s_j) <= 1e-6 * abs(s_j), (s_t, s_j)
    assert y_t.dtype == torch.float32
    if "silence" in case or case == "empty where":
        assert s_t == 1.0 or case == "empty where"
    if not np.any(np.asarray(y_j)):
        assert not y_t.any()
    else:
        assert _db(y_t.numpy(), np.asarray(y_j)) <= -120.0


def test_mix_oracle_bit_exact(tracks):
    args = ([tracks[0, 0], tracks[1, 0]], [0.9, 0.4], [400, 0], [400, 800])
    for mode in (None, "peak", "loudness"):
        assert np.array_equal(
            tmix.mix_oracle_np(*args, normalize=mode, target_amp=0.5),
            xmix.mix_oracle_np(*args, normalize=mode, target_amp=0.5))


def test_duck_gain_vs_jax_and_oracle(tracks):
    """duck_gain (float64 scans) against the JAX scans and the float64
    oracle; duck_gain_np bit-exact; duck_gain_block carried across blocks
    equal to the offline gain."""
    voice = tracks[1]
    kw = dict(threshold_db=-30.0, depth_db=9.0, attack_ms=5.0)
    g_j = np.asarray(xmix.duck_gain(jnp.asarray(voice), SR, **kw))
    g_t = tmix.duck_gain(torch.from_numpy(voice), SR, **kw)
    assert g_t.dtype == torch.float64 and g_t.shape == voice.shape
    db_j = _db(g_t.numpy(), g_j)
    oracle = xmix.duck_gain_np(voice, SR, **kw)
    db_o = _db(g_t.numpy(), oracle)
    print(f"duck_gain vs JAX {db_j:.1f} dB (gate -200), vs oracle "
          f"{db_o:.1f} dB (gate -100)")
    assert db_j <= -200.0 and db_o <= -100.0
    assert np.array_equal(tmix.duck_gain_np(voice, SR, **kw), oracle)
    state, parts = None, []
    for i in range(0, N, 2940):
        g, state = tmix.duck_gain_block(
            torch.from_numpy(voice[:, i:i + 2940]), SR, state, **kw)
        parts.append(g)
    g_b, st_j = xmix.duck_gain_block(jnp.asarray(voice), SR, None, **kw)
    assert _db(torch.cat(parts, -1).numpy(), g_t.numpy()) <= -200.0
    for a, b in zip(state, st_j):
        assert _db(a.numpy(), np.asarray(b)) <= -200.0


@pytest.mark.parametrize("rates", [(44100, 16000), (48000, 44100),
                                   (16000, 48000)])
@pytest.mark.parametrize("layout", ["(n,)", "(n, 2)"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_api_resample_vs_jax(tracks, rates, layout, dtype):
    """xmtpu_torch.resample (= api.resample) on the CPU against
    xmtpu.api.resample: same dtype, layout and length out."""
    x = tracks[0, 0] if layout == "(n,)" else tracks[0].T.copy()
    if dtype == "int16":
        x = convert.f32_to_pcm16_np(x)
    y_j = np.asarray(xapi.resample(x, *rates))
    y_t = xmtpu_torch.resample(x, *rates, device="cpu")
    assert xmtpu_torch.resample is api.resample
    assert y_t.shape == y_j.shape and y_t.dtype == y_j.dtype == x.dtype
    db = _db(y_t, y_j)
    print(f"api.resample {rates} {layout} {dtype}: {db:.1f} dB")
    if dtype == "int16":
        diff = np.abs(y_t.astype(np.int32) - y_j.astype(np.int32))
        assert diff.max() <= 1 and db <= -100.0
    else:
        assert db <= -120.0


def test_api_resample_device_and_errors(tracks):
    """It runs on cuda unless a device is given; rates pass check_rates;
    a batched stack is refused, as the JAX function's layout rule."""
    x = tracks[0, 0]
    orig = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(DeviceError, match='device="cpu"'):
            api.resample(x, 44100, 16000)
    finally:
        torch.cuda.is_available = orig
    with pytest.raises(ConfigError, match="unreasonable"):
        api.resample(x, 44101, 16000, device="cpu")
    with pytest.raises(ValueError, match="PCM must be"):
        api.resample(tracks, 44100, 16000, device="cpu")
    same = api.resample(x, 16000, 16000, device="cpu")
    assert np.array_equal(same, x)


def test_bench_configs_1_2(monkeypatch, tracks):
    """--config=1|2: the JAX harness's inputs, their functions equal to
    the JAX benchmark's on the CPU (a prefix), and the option handling
    with the card faked absent; config 6's smoke run on the CPU."""
    x = bench.config1_inputs(2, 0.2)
    assert x.shape == (2, N) and x.dtype == np.int16
    np.testing.assert_array_equal(
        x, (np.random.default_rng(0).standard_normal((2, N)) * 9000
            ).astype(np.int16))
    y = bench.config1_step(torch.from_numpy(x)).numpy()
    y_b = bench.config1_step(torch.from_numpy(x), banded=True).numpy()
    ref = np.asarray(xapi._resample_op.polyphase_resample(
        xapi._convert.pcm16_to_f32(jnp.asarray(x)), 44100, 16000))
    assert _db(y, ref) <= -120.0 and _db(y_b, ref) <= -120.0
    v, b = bench.config2_inputs(2, 0.5)
    assert v.shape == b.shape == (2, 8000) and not np.array_equal(v, b)
    out = bench.config2_step(torch.from_numpy(v), torch.from_numpy(b))
    fade = 4000
    ref = xmix.apply_gain_fade(jnp.asarray(v), 0.9, fade, fade, length=8000) \
        + xmix.apply_gain_fade(jnp.asarray(b), 0.4, fade, fade, length=8000)
    peak = jnp.max(jnp.abs(ref), axis=-1, keepdims=True)
    ref = np.asarray(ref * jnp.where(peak > 0, xmix.db_to_amp(-1.0) / peak,
                                     1.0))
    assert _db(out.numpy(), ref) <= -120.0
    oracle = tmix.mix_oracle_np([v[0], b[0]], [0.9, 0.4], [fade] * 2,
                                [fade] * 2, normalize="peak",
                                target_amp=tmix.db_to_amp(-1.0))
    assert _db(out[0].numpy(), oracle) <= -100.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in ("1", "2"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench._cli([f"--config={cfg}", "--batch=4"])
        with pytest.raises(SystemExit, match="takes batch"):
            bench._cli([f"--config={cfg}", "--iir_backend=scan"])
    # config 6, the file-fed batch: exits without a card; its smoke run on
    # the CPU; an unknown config is refused
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench._cli(["--config=6"])
    with pytest.raises(SystemExit, match="takes no other arguments"):
        bench._cli(["--config=6", "--batch=4"])
    r = bench.config6_file_batch(n_clips=2, seconds=0.2, device="cpu")
    assert r["config"] == 6 and r["device"] == "cpu"
    assert r["audio_sec_per_sec"] > 0 and r["cold_audio_sec_per_sec"] > 0
    with pytest.raises(SystemExit, match="are ported"):
        bench._cli(["--config=7"])
