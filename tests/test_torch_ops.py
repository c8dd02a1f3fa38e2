"""Parity of the PyTorch port's ops and host tables (``xmtpu_torch.ops``)
with the JAX package (``xmtpu.ops``) on the same numpy inputs.

One shape for the signal tests: 2 rows of 22050 input samples (50
frames of 441 at 44.1 kHz), 8000 samples at the 16 kHz bus rate.

Tolerances:
- host tables, oracles and conversions: bit-exact (same numpy math);
- resample: <= -90 dB against the JAX package's HIGH (3-pass bf16)
  resample, which itself reads about -98 dB against the float64 oracle;
  the port's float32 matmul is closer to the oracle than that;
- the torch limiter curve: <= -100 dB (float32 transcendental rounding
  only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import biquad as xbiquad
from xmtpu.ops import convert as xconvert
from xmtpu.ops import limiter as xlimiter
from xmtpu.ops import mix as xmix
from xmtpu.ops import resample as xresample
from xmtpu.ops import reverb as xreverb
from xmtpu_torch.ops import (biquad, convert, limiter, mix, precision,
                              resample, reverb)
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

SR_IN, SR_BUS = 44100, 16000
N_IN = 22050  # 50 frames of 441
N_BUS = 8000


@pytest.fixture(scope="module")
def sig():
    rng = np.random.default_rng(20261016)
    return (0.3 * rng.standard_normal((2, N_IN))).astype(np.float32)


# ---------------------------------------------------------------- convert


def test_pcm16_roundtrip_bit_exact():
    """int16 -> f32 over the whole int16 range, and f32 -> int16 on
    values at and around the rounding halves and beyond full scale:
    torch, JAX and both numpy oracles agree bit for bit."""
    i16 = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    f_t = convert.pcm16_to_f32(torch.from_numpy(i16)).numpy()
    f_j = np.asarray(xconvert.pcm16_to_f32(jnp.asarray(i16)))
    assert f_t.dtype == np.float32
    assert np.array_equal(f_t.view(np.int32), f_j.view(np.int32))
    assert np.array_equal(convert.pcm16_to_f32_np(i16),
                          xconvert.pcm16_to_f32_np(i16))
    rng = np.random.default_rng(3)
    halves = (np.arange(-40, 40) + 0.5) / 32768.0
    f = np.concatenate([
        halves, halves + 1e-9, halves - 1e-9, [-1.5, -1.0, 0.0, 0.99997, 1.0,
                                              2.0],
        rng.uniform(-1.2, 1.2, 4000)]).astype(np.float32)
    i_t = convert.f32_to_pcm16(torch.from_numpy(f)).numpy()
    i_j = np.asarray(xconvert.f32_to_pcm16(jnp.asarray(f)))
    assert i_t.dtype == np.int16
    assert np.array_equal(i_t, i_j)
    assert np.array_equal(convert.f32_to_pcm16_np(f),
                          xconvert.f32_to_pcm16_np(f))
    assert np.array_equal(i_t, convert.f32_to_pcm16_np(f))


# -------------------------------------------------------------------- mix


@pytest.mark.parametrize("n,fi,fo,length,offset", [
    (N_BUS, 4000, 4000, N_BUS, 0),     # the chain's 250 ms fades
    (N_BUS, 0, 300, N_BUS + 500, 200),  # fade-out only, offset window
    (N_BUS, 300, 0, N_BUS, 0),          # fade-in only
])
def test_fade_ramp_bit_exact(n, fi, fo, length, offset):
    r_t = mix.fade_ramp(n, fi, fo, length, offset).numpy()
    r_j = np.asarray(xmix.fade_ramp(n, fi, fo, length, offset))
    assert r_t.dtype == np.float32
    assert np.array_equal(r_t.view(np.int32), r_j.view(np.int32))
    assert np.array_equal(mix.fade_ramp_np(n, fi, fo, length, offset),
                          xmix.fade_ramp_np(n, fi, fo, length, offset))
    assert mix.db_to_amp(-1.0) == xmix.db_to_amp(-1.0)


@pytest.mark.parametrize("gain,fi,fo,offset,length", [
    (1.0, 4000, 4000, 0, None),   # the two-track front's voice
    (0.4, 4000, 4000, 0, None),   # its BGM (0.4 is not a float32)
    (0.7, 0, 300, 200, N_BUS + 500),
])
def test_apply_gain_fade_bit_exact(gain, fi, fo, offset, length):
    x = (0.3 * np.random.default_rng(2).standard_normal((2, N_BUS))).astype(
        np.float32)
    y_t = mix.apply_gain_fade(torch.from_numpy(x), gain, fi, fo, offset,
                              length).numpy()
    y_j = np.asarray(xmix.apply_gain_fade(jnp.asarray(x), gain, fi, fo,
                                          offset, length))
    assert y_t.dtype == np.float32
    assert np.array_equal(y_t.view(np.int32), y_j.view(np.int32))


# ----------------------------------------------------------------- biquad


@pytest.mark.parametrize("kind", ["peaking", "lowshelf", "highshelf",
                                  "lowpass", "highpass", "bandpass", "notch"])
def test_rbj_coeffs_bit_exact(kind):
    a = biquad.rbj_coeffs(kind, 1234.5, SR_BUS, q=0.9, gain_db=-4.5)
    b = xbiquad.rbj_coeffs(kind, 1234.5, SR_BUS, q=0.9, gain_db=-4.5)
    assert np.array_equal(a, b)


def test_eq_host_design_bit_exact(sig):
    """eq_sos, the truncated impulse response and the sequential DF2T
    oracle of the chain's default 5-band EQ."""
    from xmtpu.batch import DEFAULT_BANDS

    sos = biquad.eq_sos(list(DEFAULT_BANDS), SR_BUS)
    assert np.array_equal(sos, xbiquad.eq_sos(list(DEFAULT_BANDS), SR_BUS))
    h = biquad.sos_impulse_np(sos)
    assert np.array_equal(h, xbiquad.sos_impulse_np(sos))
    y, zf = biquad.sosfilt_np(sos, sig[:, :2000])
    yj, zfj = xbiquad.sosfilt_np(sos, sig[:, :2000])
    assert np.array_equal(y, yj) and np.array_equal(zf, zfj)
    with pytest.raises(ValueError):
        biquad.eq_sos([{"freq_hz": 100.0, "gain": 3.0}], SR_BUS)


# --------------------------------------------------------------- resample


def test_resample_tables_bit_exact():
    L, M = 160, 441
    assert np.array_equal(resample.design_polyphase_filter(L, M),
                          xresample.design_polyphase_filter(L, M))
    p, q = resample.make_plan(L, M, 24, 9.0), xresample._make_plan(
        L, M, 24, 9.0)
    for f in ("L", "M", "K2", "base", "width", "pad_left"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("taps", "col_start", "hsel", "hbank"):
        assert np.array_equal(getattr(p, f), getattr(q, f)), f
    t, u = resample.aligned_tables(p), xresample.aligned_tables(q)
    for f in ("lo", "hi", "r0", "r2"):
        assert getattr(t, f) == getattr(u, f), f
    for f in ("H1", "H0", "H2"):
        assert np.array_equal(getattr(t, f), getattr(u, f)), f
    for n in (N_IN, 441000, 441, 882, 22051):
        assert (resample.aligned_supported(n, SR_IN, SR_BUS)
                == xresample.aligned_supported(n, SR_IN, SR_BUS)), n
        assert (resample.resample_output_len(n, L, M)
                == xresample.resample_output_len(n, L, M))


@pytest.mark.parametrize("rates", [(1000, 16000), (44100, 200000),
                                   (191999, 4001)])
def test_check_rates_typed(rates):
    with pytest.raises(ConfigError) as e:
        resample.check_rates(*rates)
    with pytest.raises(Exception) as ej:
        xresample.check_rates(*rates)
    assert str(e.value) == str(ej.value)


def test_check_rates_accepts_flagship():
    resample.check_rates(SR_IN, SR_BUS)


def test_resample_framed_vs_jax(sig):
    """The aligned banded form on pre-framed input against the JAX
    package's HIGH-precision twin (-90 dB gate) and the float64
    oracle."""
    A = sig.reshape(2, N_IN // 441, 441)
    y_t = resample.polyphase_resample_framed(
        torch.from_numpy(A), SR_IN, SR_BUS).reshape(2, -1).numpy()
    y_j = np.asarray(xresample.polyphase_resample_framed(
        jnp.asarray(A), SR_IN, SR_BUS,
        precision=jax.lax.Precision.HIGH)).reshape(2, -1)
    ref = resample.resample_oracle_np(sig, SR_IN, SR_BUS)
    assert y_t.shape == y_j.shape == ref.shape == (2, N_BUS)
    db_j = refs.db(y_t, y_j)
    db_ref = refs.db(y_t, ref)
    print(f"framed resample: {db_j:.1f} dB vs JAX HIGH, {db_ref:.1f} dB "
          "vs float64 oracle")
    assert db_j <= -90.0 and db_ref <= -90.0


def test_resample_banded_unaligned_vs_jax(sig):
    """polyphase_resample on a length that is not a multiple of M takes
    the windowed banded path."""
    x = sig[:, : N_IN - 101]
    y_t = resample.polyphase_resample(torch.from_numpy(x), SR_IN,
                                      SR_BUS).numpy()
    y_j = np.asarray(xresample.polyphase_resample(jnp.asarray(x), SR_IN,
                                                  SR_BUS))
    assert y_t.shape == y_j.shape
    assert refs.db(y_t, y_j) <= -90.0
    y_a = resample.polyphase_resample(torch.from_numpy(sig), SR_IN,
                                      SR_BUS).numpy()
    ref = xresample.resample_oracle_np(sig, SR_IN, SR_BUS)
    assert refs.db(y_a, ref) <= -90.0


def test_resample_oracle_bit_exact(sig):
    assert np.array_equal(resample.resample_oracle_np(sig, SR_IN, SR_BUS),
                          xresample.resample_oracle_np(sig, SR_IN, SR_BUS))


def test_resample_refuses_unported():
    """A band wider than 2M (8k -> 48k) runs the strided conv, the JAX
    package's path there, to -120 dB against it (its own gate,
    tests/test_resample.py:84); the framed form refuses a last axis
    below M, as the JAX one does, and takes one above M as lane padding
    (zero filter rows: the output of the first M lanes)."""
    x = np.random.default_rng(3).standard_normal((1, 1000)).astype(
        np.float32)
    y_t = resample.polyphase_resample(torch.from_numpy(x), 8000,
                                      48000).numpy()
    y_j = np.asarray(xresample.polyphase_resample(jnp.asarray(x), 8000,
                                                  48000))
    assert y_t.shape == y_j.shape == (1, 6000)
    assert refs.db(y_t, y_j) <= -120.0
    with pytest.raises(ValueError, match="< M=441"):
        resample.polyphase_resample_framed(torch.zeros(1, 4, 440), SR_IN,
                                           SR_BUS)
    with pytest.raises(ValueError, match="< M=441"):
        xresample.polyphase_resample_framed(jnp.zeros((1, 4, 440)), SR_IN,
                                            SR_BUS)
    a = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 4, 441)).astype(np.float32))
    padded = torch.nn.functional.pad(a, (0, 512 - 441), value=3.0)
    y = resample.polyphase_resample_framed(a, SR_IN, SR_BUS)
    y_pad = resample.polyphase_resample_framed(padded, SR_IN, SR_BUS)
    assert refs.db(y_pad, y) <= -130.0


def test_require_fp32_matmul_refuses_tf32():
    """On CUDA the DSP matmuls refuse TF32; the check reads the global
    flags and flips none."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        precision.require_fp32_matmul(torch.device("cuda"))
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ConfigError):
            precision.require_fp32_matmul(torch.device("cuda"))
        assert torch.backends.cuda.matmul.allow_tf32  # not flipped back
        precision.require_fp32_matmul(torch.device("cpu"))  # CPU: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("high")
        with pytest.raises(ConfigError):
            precision.require_fp32_matmul(torch.device("cuda"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


# ----------------------------------------------------------------- reverb


def test_reverb_host_bit_exact(sig):
    ir = reverb.synthetic_ir(0.25, SR_BUS)
    assert np.array_equal(ir, xreverb.synthetic_ir(0.25, SR_BUS))
    h = np.convolve(ir, np.hanning(64))
    assert np.array_equal(reverb.trim_ir_tail(h), xreverb.trim_ir_tail(h))
    assert np.array_equal(reverb.reverb_np(sig, ir, 0.25, 0.75),
                          xreverb.reverb_np(sig, ir, 0.25, 0.75))


# ---------------------------------------------------------------- limiter


def test_limiter_coefficients_bit_exact():
    for ms in (0.0, 1.0, 100.0):
        assert limiter._release_coeff(ms, SR_BUS) == \
            xlimiter._release_coeff(ms, SR_BUS)
        assert limiter._attack_coeff(ms, SR_BUS) == \
            xlimiter._attack_coeff(ms, SR_BUS)
    for r in (1.0, 4.0, float("inf")):
        assert limiter._knee_slope(r) == xlimiter._knee_slope(r)
    with pytest.raises(ValueError):
        limiter._knee_slope(0.5)
    assert limiter._EPS == xlimiter._EPS


def test_gain_curve_vs_jax(sig):
    """soft_knee_gain_db and apply_gain_curve (log10/pow in float32)
    across the knee: -100 dB (rounding of the transcendentals only)."""
    x = (3.0 * sig[:, None, :N_BUS]).astype(np.float32)
    e2 = np.abs(x[:, 0, :]) + np.float32(1e-3)
    lvl = np.linspace(-20.0, 10.0, 4001).astype(np.float32)
    for ratio in (float("inf"), 4.0):
        g_t = limiter.soft_knee_gain_db(torch.from_numpy(lvl), -3.0, 6.0,
                                        ratio).numpy()
        g_j = np.asarray(xlimiter.soft_knee_gain_db(jnp.asarray(lvl), -3.0,
                                                    6.0, ratio))
        assert np.allclose(g_t, g_j, rtol=1e-6, atol=1e-6)
        y_t = limiter.apply_gain_curve(torch.from_numpy(x),
                                       torch.from_numpy(e2), -3.0,
                                       ratio=ratio, makeup_db=1.0).numpy()
        y_j = np.asarray(xlimiter.apply_gain_curve(
            jnp.asarray(x), jnp.asarray(e2), -3.0, ratio=ratio,
            makeup_db=1.0))
        assert refs.db(y_t, y_j) <= -100.0


def test_limiter_np_bit_exact(sig):
    x = 3.0 * sig[:, None, :N_BUS]
    y, st = limiter.limiter_np(x, SR_BUS, threshold_db=-3.0,
                               state=(0.1, 0.05))
    yj, stj = xlimiter.limiter_np(x, SR_BUS, threshold_db=-3.0,
                                  state=(0.1, 0.05))
    assert np.array_equal(y, yj)
    assert all(np.array_equal(a, b) for a, b in zip(st, stj))
    assert float(np.max(np.abs(y))) <= 1.0  # 0 dB ceiling
