"""Parity of the port's BS.1770 loudness (``xmtpu_torch.ops.loudness``)
with the JAX package's (``xmtpu.ops.loudness``) on the CPU: the port on
``device="cpu"`` (the K-weighting on the IIR kernel's plain twin), the JAX
``measure_lufs`` as its own tests run it there (``sosfilt_pallas`` in
interpret mode).

One size: 1.5 s at 16 kHz (24,000 samples, 11 blocks of 400 ms), noise
with a loud middle and a quiet tail so that both gates act.

Tolerances: ``k_weighting_sos`` bit-exact; LUFS against the JAX package
and against the float64 oracle ``measure_lufs_np`` within 0.02 LU;
``lufs_normalize``'s gain within 0.02 LU of the JAX gain, its output at
the target within 0.02 LU.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu.ops import loudness as xl
from xmtpu_torch.ops import convert
from xmtpu_torch.ops import loudness as tl

SR = 16000
N = 24000
LU_TOL = 0.02


@pytest.fixture(scope="module")
def stereo():
    """(2, N) float32: noise, 10 dB louder in the middle, the last
    0.3 s 40 dB down (below the relative gate)."""
    rng = np.random.default_rng(41)
    x = 0.1 * rng.standard_normal((2, N))
    x[:, 8000:14000] *= 3.0
    x[:, -4800:] *= 0.01
    return x.astype(np.float32)


def _lu(v) -> float:
    return float(v.item() if torch.is_tensor(v) else np.asarray(v))


@pytest.mark.parametrize("sr", [16000, 44100, 48000])
def test_k_weighting_sos_bit_exact(sr):
    np.testing.assert_array_equal(tl.k_weighting_sos(sr),
                                  xl.k_weighting_sos(sr))


def test_k_weighting_matches_bs1770_table():
    """At 48 kHz the cascade is the standard's printed table."""
    sos = tl.k_weighting_sos(48000)
    np.testing.assert_allclose(
        sos[0], [1.53512485958697, -2.69169618940638, 1.19839281085285,
                 1.0, -1.69065929318241, 0.73248077421585], atol=1e-6)
    np.testing.assert_allclose(
        sos[1], [1.0, -2.0, 1.0, 1.0, -1.99004745483398,
                 0.99007225036621], atol=1e-6)


@pytest.mark.parametrize("case", ["stereo", "mono", "int16 stereo"])
def test_measure_lufs_vs_jax_and_oracle(stereo, case):
    x = stereo[:1] if case == "mono" else stereo
    if case == "int16 stereo":
        x = convert.f32_to_pcm16_np(x)
        ref = tl.measure_lufs_np(x.astype(np.float64) / 32768.0, SR)
    else:
        ref = tl.measure_lufs_np(x, SR)
    got = tl.measure_lufs(x, SR, device="cpu")
    want = _lu(xl.measure_lufs(jnp.asarray(x), SR))
    assert torch.is_tensor(got) and got.dim() == 0
    assert got.dtype == torch.float64
    print(f"{case}: port {_lu(got):.5f}, JAX {want:.5f}, oracle {ref:.5f}")
    assert abs(_lu(got) - want) <= LU_TOL
    assert abs(_lu(got) - ref) <= LU_TOL


def test_measure_lufs_1d_is_mono(stereo):
    a = tl.measure_lufs(stereo[0], SR, device="cpu")
    b = tl.measure_lufs(stereo[:1], SR, device="cpu")
    assert _lu(a) == _lu(b)


def test_silence_and_short_signal():
    """Silence: -inf (no block passes the absolute gate), as the oracle;
    a signal shorter than one block is one block of everything."""
    assert _lu(tl.measure_lufs(np.zeros((2, N), np.float32), SR,
                               device="cpu")) == -math.inf
    assert tl.measure_lufs_np(np.zeros((2, N)), SR) == -math.inf
    short = (0.2 * np.random.default_rng(3).standard_normal(3000)).astype(
        np.float32)
    assert tl._block_geometry(3000, SR) == (3000, 3000, 1)
    assert abs(_lu(tl.measure_lufs(short, SR, device="cpu"))
               - tl.measure_lufs_np(short, SR)) <= LU_TOL


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_lufs_normalize_vs_jax(stereo, dtype):
    """The gain matches the JAX gain and stays float32; the output reads
    the target; int16 in gives pinned-converted int16 out."""
    x = stereo if dtype == "float32" else convert.f32_to_pcm16_np(stereo)
    y, g = tl.lufs_normalize(x, SR, -20.0, device="cpu")
    yj, gj = xl.lufs_normalize(jnp.asarray(x), SR, -20.0)
    assert g.dtype == torch.float32 and y.dtype == getattr(torch, dtype)
    assert abs(20 * math.log10(float(g) / float(gj))) <= LU_TOL
    yf = y.numpy().astype(np.float64)
    if dtype == "int16":
        yf /= 32768.0
        assert np.abs(y.numpy().astype(np.int32)
                      - np.asarray(yj).astype(np.int32)).max() <= 1
    assert abs(tl.measure_lufs_np(yf, SR) + 20.0) <= LU_TOL


def test_lufs_normalize_small_gain_keeps_int16_signal():
    """A gain far below 1 stays a float32 gain: int16 input does not
    truncate to silence."""
    rng = np.random.default_rng(5)
    x = (20000 * np.clip(rng.standard_normal(N), -1.5, 1.5)).astype(np.int16)
    y, g = tl.lufs_normalize(x, SR, -50.0, device="cpu")
    assert 0 < float(g) < 0.1 and g.dtype == torch.float32
    assert y.dtype == torch.int16 and int(y.abs().max()) > 0


def test_silence_normalize_passes_through():
    x = np.zeros(N, np.float32)
    y, g = tl.lufs_normalize(x, SR, -16.0, device="cpu")
    assert float(g) == 1.0 and not y.any()


def test_public_exports():
    assert xmtpu_torch.measure_lufs is tl.measure_lufs
    assert xmtpu_torch.lufs_normalize is tl.lufs_normalize
