"""Parity of the port's biquad cascade (``xmtpu_torch.kernels.iir``)
with the JAX package's (``xmtpu.kernels.iir``, Pallas in interpret mode),
on the CPU.

On a CPU tensor the wrapper runs the kernel's plain torch twin; the CUDA
kernel itself is compared with the twin on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 2 rows x 32768 samples of the chain's 5-band EQ (the JAX
package's own segmented-IIR test shape), where ``pick_segments`` is 8.

Tolerances:
- host tables (``pick_segments``, ``_seg_consts``): bit-exact;
- the twin against the Pallas kernel: -90 dB (float32 on both sides;
  XLA may contract the interpret-mode arithmetic into FMAs, the twin
  rounds every operation, and the correction matmuls sum in another
  order), against scipy's float64 ``sosfilt``: -80 dB (the chain gate);
  final states within 1e-4;
- the twin against a numpy float32 loop in the kernel's operation
  order: bit-exact (no contraction anywhere).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from xmtpu import batch as xbatch
from xmtpu.kernels import iir as xiir
from xmtpu_torch.kernels import _build, iir

from . import torch_refs as refs

R, N, SR_BUS = 2, 32768, 16000


@pytest.fixture(scope="module")
def sos():
    return xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR_BUS)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(11)
    return (0.4 * rng.standard_normal((R, N))).astype(np.float32)


def _resonator(r_pole: float) -> np.ndarray:
    """One section with poles at radius r_pole (1.0: on the unit
    circle, which _seg_consts rejects)."""
    w = 2 * np.pi * 0.05
    return np.array([[0.1, 0.0, -0.1, 1.0, -2 * r_pole * np.cos(w),
                      r_pole ** 2]])


def test_pick_segments_bit_exact():
    for lanes in (128, 256):
        for rows in (1, 2, 3, 16, 32, 64, 128, 256):
            for n in (1, 4095, 8192, 32000, 32768, 160000, 480000):
                assert (iir.pick_segments(rows, n, lanes=lanes)
                        == xiir.pick_segments(rows, n, lanes=lanes))
    assert iir.pick_segments(32, 160000) == 4  # the small-batch chain's EQ
    assert iir.pick_segments(R, N) == 8


@pytest.mark.parametrize("seglen", [4096, 8000, 40000])
def test_seg_consts_bit_exact(sos, seglen):
    ours = iir._seg_consts(np.asarray(sos, np.float64), seglen)
    ref = xiir._seg_consts(np.asarray(sos, np.float64), seglen)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(
            ours[k], ref[k]), k
    if seglen == 40000:
        assert ours["Lr"].shape == (10, 5907)  # t_cut of the chain's EQ
    bad = _resonator(1.0)
    assert iir._seg_consts(bad, seglen) is None
    assert xiir._seg_consts(bad, seglen) is None


@pytest.mark.parametrize("with_zi", [False, True])
def test_sosfilt_vs_pallas(sos, x, with_zi):
    zi = None
    if with_zi:
        zi = (0.1 * np.random.default_rng(3).standard_normal(
            (5, R, 2))).astype(np.float32)
    y_j, zf_j = xiir.sosfilt_pallas(
        sos, jnp.asarray(x), zi=None if zi is None else jnp.asarray(zi),
        interpret=True)
    y_j, zf_j = np.asarray(y_j), np.asarray(zf_j)
    y_t, zf_t = iir.sosfilt(sos, torch.from_numpy(x),
                            zi=None if zi is None else torch.from_numpy(zi))
    y_t, zf_t = y_t.numpy(), zf_t.numpy()
    db = refs.db(y_t, y_j)
    x64 = x.astype(np.float64)
    ref = (sps.sosfilt(sos, x64, axis=-1) if zi is None else
           sps.sosfilt(sos, x64, axis=-1, zi=zi.astype(np.float64))[0])
    db64 = refs.db(y_t, ref)
    print(f"sosfilt twin (S=8) vs Pallas: {db:.1f} dB (gate -90), vs "
          f"float64: {db64:.1f} dB (gate -80)")
    assert y_t.shape == (R, N) and zf_t.shape == (5, R, 2)
    assert db <= -90.0 and db64 <= -80.0
    np.testing.assert_allclose(zf_t, zf_j, atol=1e-4)


def test_sosfilt_unsegmented_vs_pallas(sos, x):
    """segments=1: one pass of the cascade over the whole row."""
    y_j, zf_j = xiir.sosfilt_pallas(sos, jnp.asarray(x), interpret=True,
                                    segments=1)
    y_t, zf_t = iir.sosfilt(sos, torch.from_numpy(x), segments=1)
    db = refs.db(y_t.numpy(), np.asarray(y_j))
    print(f"sosfilt twin (S=1) vs Pallas: {db:.1f} dB (gate -90)")
    assert db <= -90.0
    np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), atol=1e-4)


def test_rejected_cascade_runs_unsegmented():
    """A cascade _seg_consts rejects (poles on the unit circle) takes
    the one-pass path even where pick_segments asks for 2 segments."""
    bad = _resonator(1.0)
    n = 8192
    assert iir.pick_segments(R, n) == 2
    rng = np.random.default_rng(5)
    xb = (0.1 * rng.standard_normal((R, n))).astype(np.float32)
    y_auto, _ = iir.sosfilt(bad, torch.from_numpy(xb))
    y_one, _ = iir.sosfilt(bad, torch.from_numpy(xb), segments=1)
    assert torch.equal(y_auto, y_one)
    y_j, _ = xiir.sosfilt_pallas(bad, jnp.asarray(xb), interpret=True)
    assert refs.db(y_auto.numpy(), np.asarray(y_j)) <= -90


def test_plain_twin_rounds_like_the_kernel(sos):
    """The twin equals a numpy float32 loop in the kernel's operation
    order, bit for bit: every product and sum rounds on its own, as the
    kernel's __fmul_rn/__fadd_rn/__fsub_rn do."""
    rng = np.random.default_rng(9)
    xs = (0.5 * rng.standard_normal((3, 300))).astype(np.float32)
    zi = (0.05 * rng.standard_normal((5, 2, 3))).astype(np.float32)
    c = np.asarray(sos, np.float32)
    z = zi.copy()
    ref = np.empty_like(xs)
    for t in range(xs.shape[1]):
        v = xs[:, t]
        for s in range(5):
            b0, b1, b2, _, a1, a2 = c[s]
            y = b0 * v + z[s, 0]
            z1 = b1 * v - a1 * y + z[s, 1]
            z[s, 1] = b2 * v - a2 * y
            z[s, 0] = z1
            v = y
        ref[:, t] = v
    y_t, zf_t = iir.sosfilt_plain(torch.from_numpy(xs),
                                  torch.from_numpy(c), torch.from_numpy(zi))
    assert np.array_equal(y_t.numpy(), ref)
    assert np.array_equal(zf_t.numpy(), z)


def test_empty_cascade_is_identity(x):
    y, zf = iir.sosfilt(np.zeros((0, 6)), torch.from_numpy(x))
    assert torch.equal(y, torch.from_numpy(x)) and zf.shape == (0, R, 2)


def test_wrapper_contract(sos, x):
    """Bad operands raise; a CPU tensor runs the twin and counts no
    launch; any other non-CUDA device raises instead of falling back."""
    xt = torch.from_numpy(x[:, :64].copy())
    s32 = torch.from_numpy(np.asarray(sos, np.float32))
    zi = torch.zeros((5, 2, R))
    before = iir.launches
    iir.sosfilt_pass(xt, s32, zi)
    assert iir.launches == before
    with pytest.raises(ValueError, match="sections"):
        iir.sosfilt_pass(xt, torch.zeros((iir.MAX_SECTIONS + 1, 6)),
                         torch.zeros((iir.MAX_SECTIONS + 1, 2, R)))
    with pytest.raises(ValueError):
        iir.sosfilt_pass(xt, s32, torch.zeros((5, 2, R + 1)))
    with pytest.raises(ValueError):
        iir.sosfilt_pass(xt.double(), s32, zi)
    with pytest.raises(ValueError, match="does not divide"):
        iir.sosfilt(sos, torch.from_numpy(x), segments=3)
    with pytest.raises(ValueError, match="no IIR kernel"):
        iir.sosfilt_pass(xt.to("meta"), s32.to("meta"), zi.to("meta"))
    assert "iir.cu" in {p.name for p in _build.sources()}
    assert "xm_sosfilt_f32" in _build._SIGNATURES
