"""Parity of the port's fused EQ + envelope (``xmtpu_torch.kernels.
eq_env``) with the JAX package's (``xmtpu.kernels.eq_env``, Pallas in
interpret mode), on the CPU.

On a CPU tensor the wrapper runs the kernel's plain torch twin; the CUDA
kernel itself is compared with the twin on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``), where it must read max
abs 0.

Shape: 3 rows x 9000 samples (the JAX package's own eq_env test shape,
``time_chunk=1024`` on the JAX side) of the chain's 5-band EQ at its
16 kHz bus rate with the limiter's 100 ms / 1 ms detector.

Tolerances:
- the twin against the Pallas kernel (float32 on both sides; XLA may
  contract the interpret-mode arithmetic into FMAs, the twin rounds
  every operation; the margins are printed): y, e2 and the final
  envelope states at -90 dB (measured -99.6 to -110 dB); the final
  cascade states zf at -85 dB (measured -88.3 and -89.5 dB) and within
  1e-5 absolute (measured 6.2e-6, y's own is 1.1e-5): the states are
  small differences of products, so the same absolute error is a larger
  share of their RMS;
- the twin against the port's own ``sosfilt_plain`` -> ``envelope_plain
  (|y|)`` composition, against a numpy float32 loop in the kernel's
  operation order, and blockwise with carried state against one shot:
  bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu.kernels import eq_env as xeq_env
from xmtpu.ops import biquad as xbiquad
from xmtpu.ops import limiter as xlimiter
from xmtpu_torch.kernels import _build, envelope, eq_env, iir

from . import torch_refs as refs

SR = 16000
R, N = 3, 9000
K_REL = xlimiter._release_coeff(100.0, SR)
C_ATT = xlimiter._attack_coeff(1.0, SR)


@pytest.fixture(scope="module")
def sos():
    return xbiquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(20261016)
    return (0.3 * rng.standard_normal((R, N))).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_eq_env_vs_pallas(sos, x, with_state):
    """All four outputs against the JAX kernel, from zero state and from
    a carried (zi, env, e2) state in the JAX layouts."""
    zi = ei = None
    if with_state:
        rng = np.random.default_rng(3)
        zi = (0.05 * rng.standard_normal((5, R, 2))).astype(np.float32)
        ei = tuple(rng.uniform(0.0, 0.5, R).astype(np.float32)
                   for _ in range(2))
    y_j, e2_j, zf_j, (el_j, sl_j) = xeq_env.eq_env_pallas(
        sos, jnp.asarray(x), K_REL, C_ATT,
        zi=None if zi is None else jnp.asarray(zi),
        env_init=None if ei is None else tuple(map(jnp.asarray, ei)),
        time_chunk=1024, interpret=True)
    y, e2, zf, (el, sl) = eq_env.eq_env(
        sos, torch.from_numpy(x), K_REL, C_ATT,
        zi=None if zi is None else torch.from_numpy(zi),
        env_init=None if ei is None else tuple(map(torch.from_numpy, ei)))
    assert y.shape == e2.shape == (R, N) and zf.shape == (5, R, 2)
    assert el.shape == sl.shape == (R,)
    dbs = {"y": refs.db(y, y_j), "e2": refs.db(e2, e2_j),
           "zf": refs.db(zf, zf_j), "env_last": refs.db(el, el_j),
           "e2_last": refs.db(sl, sl_j)}
    print("eq_env twin vs Pallas (gates: zf -85 dB, the others -90 dB): "
          + ", ".join(f"{k} {v:.1f}" for k, v in dbs.items()))
    assert dbs.pop("zf") <= -85.0
    assert all(v <= -90.0 for v in dbs.values()), dbs
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), rtol=0,
                               atol=1e-5)


def test_twin_is_the_iir_envelope_composition(sos, x):
    """The twin equals the port's own one-pass IIR twin followed by the
    envelope-only twin on |y|, bit for bit (outputs and final states)."""
    s32 = torch.from_numpy(np.asarray(sos, np.float32))
    xt = torch.from_numpy(x)
    zi = torch.zeros((5, 2, R))
    ei = torch.zeros((2, R))
    y, e2, zf, ef = eq_env.eq_env_plain(xt, s32, zi, ei, K_REL, C_ATT)
    y_r, zf_r = iir.sosfilt_plain(xt, s32, zi)
    e2_r, ef_r = envelope.envelope_plain(y_r.abs().contiguous(), K_REL,
                                         C_ATT, ei)
    for a, b in ((y, y_r), (zf, zf_r), (e2, e2_r), (ef, ef_r)):
        assert torch.equal(a, b)


def test_plain_twin_rounds_like_the_kernel(sos):
    """The twin equals a numpy float32 loop in the kernel's operation
    order, bit for bit: every product and sum rounds on its own, as the
    kernel's __fmul_rn/__fadd_rn/__fsub_rn do."""
    rng = np.random.default_rng(9)
    xs = (0.5 * rng.standard_normal((3, 300))).astype(np.float32)
    zi = (0.05 * rng.standard_normal((5, 2, 3))).astype(np.float32)
    ei = rng.uniform(0.0, 0.5, (2, 3)).astype(np.float32)
    c = np.asarray(sos, np.float32)
    k, ca = np.float32(K_REL), np.float32(C_ATT)
    a = np.float32(1.0) - ca
    z = zi.copy()
    env, e2 = ei[0].copy(), ei[1].copy()
    y_ref = np.empty_like(xs)
    e_ref = np.empty_like(xs)
    for t in range(xs.shape[1]):
        v = xs[:, t]
        for s in range(5):
            b0, b1, b2, _, a1, a2 = c[s]
            y = b0 * v + z[s, 0]
            z1 = b1 * v - a1 * y + z[s, 1]
            z[s, 1] = b2 * v - a2 * y
            z[s, 0] = z1
            v = y
        y_ref[:, t] = v
        env = np.maximum(np.abs(v), k * env)
        e2 = a * e2 + ca * env
        e_ref[:, t] = e2
    y_t, e_t, zf_t, ef_t = eq_env.eq_env_plain(
        torch.from_numpy(xs), torch.from_numpy(c), torch.from_numpy(zi),
        torch.from_numpy(ei), K_REL, C_ATT)
    assert np.array_equal(y_t.numpy(), y_ref)
    assert np.array_equal(e_t.numpy(), e_ref)
    assert np.array_equal(zf_t.numpy(), z)
    assert np.array_equal(ef_t.numpy(), np.stack([env, e2]))


def test_state_carry_bit_exact(sos):
    """Two blocks of 4096 with carried (zi, env, e2) == one shot of
    8192, bit for bit (the JAX package's state-carry test)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 8192))).astype(
        np.float32))
    y_full, e_full, zf_full, st_full = eq_env.eq_env(sos, x, K_REL, C_ATT)
    y1, e1, z1, s1 = eq_env.eq_env(sos, x[:, :4096], K_REL, C_ATT)
    y2, e2, z2, s2 = eq_env.eq_env(sos, x[:, 4096:], K_REL, C_ATT, zi=z1,
                                   env_init=s1)
    assert torch.equal(y_full, torch.cat([y1, y2], -1))
    assert torch.equal(e_full, torch.cat([e1, e2], -1))
    assert torch.equal(zf_full, z2)
    assert all(torch.equal(a, b) for a, b in zip(st_full, s2))


def test_wrapper_contract(sos, x):
    """Bad operands raise; a CPU tensor runs the twin and counts no
    launch; any other non-CUDA device raises instead of falling back."""
    xt = torch.from_numpy(x[:, :64].copy())
    s32 = torch.from_numpy(np.asarray(sos, np.float32))
    zi = torch.zeros((5, 2, R))
    ei = torch.zeros((2, R))
    before = eq_env.launches
    eq_env.eq_env_pass(xt, s32, zi, ei, K_REL, C_ATT)
    assert eq_env.launches == before
    with pytest.raises(ValueError, match="sections"):
        eq_env.eq_env_pass(xt, torch.zeros((eq_env.MAX_SECTIONS + 1, 6)),
                           torch.zeros((eq_env.MAX_SECTIONS + 1, 2, R)), ei,
                           K_REL, C_ATT)
    with pytest.raises(ValueError, match="ei"):
        eq_env.eq_env_pass(xt, s32, zi, torch.zeros((2, R + 1)), K_REL,
                           C_ATT)
    with pytest.raises(ValueError):
        eq_env.eq_env_pass(xt.double(), s32, zi, ei, K_REL, C_ATT)
    with pytest.raises(ValueError, match="no eq_env kernel"):
        eq_env.eq_env_pass(xt.to("meta"), s32.to("meta"), zi.to("meta"),
                           ei.to("meta"), K_REL, C_ATT)
    assert "eq_env.cu" in {p.name for p in _build.sources()}
    assert "xm_eq_env_f32" in _build._SIGNATURES
