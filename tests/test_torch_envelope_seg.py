"""Parity of the port's envelope-only kernel path
(``xmtpu_torch.kernels.envelope.envelope``, time-segmented) and of the
limiter op built on it (``xmtpu_torch.ops.limiter.limiter``) with the
JAX package's (``envelope_pallas``, ``ops.limiter.limiter`` on its
Pallas backend), on the CPU, Pallas in interpret mode.

On a CPU tensor the wrapper runs the kernel's plain torch twin; the CUDA
kernel itself is compared with the twin on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 2 rows x 32000 samples (the small-batch step's bus length
for 2 s clips), where ``pick_segments(.., lanes=256)`` is 4; the
limiter's own coefficients at 16 kHz.

Tolerances:
- host tables (``_decay_cut``, ``ktab``, ``atab``): bit-exact;
- the envelope against the Pallas kernel: -100 dB (float32 on both
  sides; the JAX default block-8 lookahead and the correction order
  reassociate), against a float64 loop of the same recurrences: -80 dB;
- the limiter op against the JAX op: -80 dB (the chain gate);
- the twin against a numpy float32 loop in the kernel's order:
  bit-exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels import envelope as xenv
from xmtpu.ops import limiter as xlimiter
from xmtpu_torch.kernels import envelope
from xmtpu_torch.ops import limiter
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

R, N, SR_BUS = 2, 32000, 16000
K_REL = limiter._release_coeff(100.0, SR_BUS)
C_ATT = limiter._attack_coeff(1.0, SR_BUS)


@pytest.fixture(scope="module")
def d():
    """A bursty nonnegative detector: noise under a slow on/off gate, so
    the envelope both holds and decays across segment boundaries."""
    rng = np.random.default_rng(17)
    gate = (np.sin(np.arange(N) / 900.0) > 0.3).astype(np.float32)
    return np.abs(rng.standard_normal((R, N)) * (0.05 + gate)).astype(
        np.float32)


def _envelope_f64(d, k_rel, c_att, init):
    """The recurrences in float64 (ops.limiter.limiter_np's loop)."""
    env, e2 = (np.asarray(v, np.float64).copy() for v in init)
    out = np.empty(d.shape, np.float64)
    for t in range(d.shape[-1]):
        env = np.maximum(d[:, t], k_rel * env)
        e2 = (1.0 - c_att) * e2 + c_att * env
        out[:, t] = e2
    return out


def test_host_tables_bit_exact():
    for r, n in ((0.0, 50), (0.5, 50), (1.0 - C_ATT, 8000), (K_REL, 8000),
                 (K_REL, 10 ** 6), (1.0, 77)):
        assert envelope._decay_cut(r, n) == xenv._decay_cut(r, n)
    # the small-batch chain's one-pole correction window
    assert envelope._decay_cut(1.0 - C_ATT, 20000) == 1474
    seglen = N // 4
    g = xenv._seg_pass_a(jnp.zeros((R, N), jnp.float32), K_REL,
                         jnp.zeros((2, R), jnp.float32), 4, 2000, True,
                         None)
    kt = envelope.seg_ktab(K_REL, seglen)
    assert kt.dtype == np.float32
    assert np.array_equal(kt, np.asarray(g.ktab)[:seglen, 0])
    a = 1.0 - float(C_ATT)
    ref = (a ** np.arange(1, xenv._decay_cut(a, seglen) + 1,
                          dtype=np.float64)).astype(np.float32)
    assert np.array_equal(envelope.seg_atab(C_ATT, seglen), ref)


@pytest.mark.parametrize("block", [None, 1])
def test_envelope_vs_pallas(d, block):
    """Segmented (S = 4) with a nonzero carried state, against the JAX
    kernel at its default block-8 lookahead and per sample."""
    assert envelope.pick_segments(R, N, lanes=256) == 4
    init = (np.array([0.7, 0.2], np.float32), np.array([0.3, 0.05],
                                                        np.float32))
    e2_j, st_j = xenv.envelope_pallas(
        jnp.asarray(d), K_REL, C_ATT, init=tuple(map(jnp.asarray, init)),
        interpret=True, block=block)
    e2_j = np.asarray(e2_j)
    e2_t, st_t = envelope.envelope(torch.from_numpy(d), K_REL, C_ATT,
                                   init=tuple(map(torch.from_numpy, init)))
    e2_t = e2_t.numpy()
    db = refs.db(e2_t, e2_j)
    ref = _envelope_f64(d, K_REL, C_ATT, init)
    db64 = refs.db(e2_t, ref)
    print(f"envelope twin (S=4) vs Pallas (block={block}): {db:.1f} dB "
          f"(gate -100); vs float64: {db64:.1f} dB (gate -80)")
    assert e2_t.shape == (R, N) and db <= -100.0 and db64 <= -80.0
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_envelope_n_valid_and_one_segment(d):
    """n_valid trims a padded detector before segmenting (S = 4 on the
    valid 32000); segments=1 is one pass with (k_rel, c_att)."""
    padded = np.pad(d, ((0, 0), (0, 40)), constant_values=9.0)
    e2_j, _ = xenv.envelope_pallas(jnp.asarray(padded), K_REL, C_ATT,
                                   n_valid=N, interpret=True)
    e2_t, _ = envelope.envelope(torch.from_numpy(padded), K_REL, C_ATT,
                                n_valid=N)
    assert e2_t.shape == (R, N)
    assert refs.db(e2_t.numpy(), np.asarray(e2_j)) <= -100
    e1_j, st_j = xenv.envelope_pallas(jnp.asarray(d), K_REL, C_ATT,
                                      segments=1, interpret=True)
    e1_t, st_t = envelope.envelope(torch.from_numpy(d), K_REL, C_ATT,
                                   segments=1)
    db = refs.db(e1_t.numpy(), np.asarray(e1_j))
    print(f"envelope twin (S=1) vs Pallas: {db:.1f} dB (gate -100)")
    assert db <= -100.0
    # segmented and one-pass agree too (exact corrections)
    e_seg, _ = envelope.envelope(torch.from_numpy(d), K_REL, C_ATT)
    assert refs.db(e_seg.numpy(), e1_t.numpy()) <= -100.0
    with pytest.raises(ValueError, match="does not divide"):
        envelope.envelope(torch.from_numpy(d), K_REL, C_ATT, segments=7)
    with pytest.raises(ValueError, match="n_valid"):
        envelope.envelope(torch.from_numpy(d), K_REL, C_ATT, n_valid=N + 1)


def test_limiter_op_vs_jax(d):
    """ops.limiter.limiter on (2, 1, 32000) against the JAX op on its
    Pallas backend (interpret mode)."""
    rng = np.random.default_rng(23)
    x = (3.0 * d * np.sign(rng.standard_normal(d.shape)))[:, None, :]
    x = x.astype(np.float32)
    y_j, st_j = xlimiter.limiter(jnp.asarray(x), SR_BUS, threshold_db=-3.0,
                                 backend="pallas_interpret")
    y_j = np.asarray(y_j)
    y_t, st_t = limiter.limiter(torch.from_numpy(x), SR_BUS,
                                threshold_db=-3.0)
    db = refs.db(y_t.numpy(), y_j)
    print(f"limiter op vs JAX (pallas_interpret): {db:.1f} dB (gate -80)")
    assert y_t.shape == (R, 1, N) and db <= -80.0
    assert np.abs(y_t.numpy()).max() <= 1.0
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    # linked_fuse=True runs the gain form (tests/test_torch_linked.py):
    # one channel, so the same function to float32 rounding
    y_l, _ = limiter.limiter(torch.from_numpy(x), SR_BUS, threshold_db=-3.0,
                             linked_fuse=True)
    assert refs.db(y_l.numpy(), y_t.numpy()) <= -100.0
    # a power-of-two envelope_block runs the per-sample kernels
    y_8, _ = limiter.limiter(torch.from_numpy(x), SR_BUS, threshold_db=-3.0,
                             envelope_block=8)
    assert torch.equal(y_8, y_t)
    with pytest.raises(ConfigError, match="power of two"):
        limiter.limiter(torch.from_numpy(x), SR_BUS, envelope_block=3)
    # the scan backend runs: the JAX float64 scan limiter to -120 dB
    y_s, st_s = limiter.limiter(torch.from_numpy(x), SR_BUS,
                                threshold_db=-3.0, backend="scan")
    y_sj, st_sj = xlimiter.limiter(jnp.asarray(x), SR_BUS, threshold_db=-3.0,
                                   backend="scan")
    assert y_s.dtype == torch.float32 and st_s[0].dtype == torch.float64
    assert refs.db(y_s.numpy(), np.asarray(y_sj)) <= -120.0


def test_plain_twin_rounds_like_the_kernel(d):
    """One corrected pass of the twin equals a numpy float32 loop in
    the kernel's operation order, bit for bit."""
    rows = d[:, :500].copy()
    ktab = envelope.seg_ktab(K_REL, 500)
    ecorr = np.array([0.8, 1.3], np.float32)
    init = np.array([[0.1, 0.4], [0.2, 0.0]], np.float32)
    k, c = np.float32(K_REL), np.float32(C_ATT)
    a = np.float32(1.0) - c
    dc = np.maximum(rows, ecorr[:, None] * ktab[None, :])
    env, e2 = init[0].copy(), init[1].copy()
    ref = np.empty_like(rows)
    for t in range(rows.shape[1]):
        env = np.maximum(dc[:, t], k * env)
        e2 = a * e2 + c * env
        ref[:, t] = e2
    e2_t, zf_t = envelope.envelope_plain(
        torch.from_numpy(rows), K_REL, C_ATT, torch.from_numpy(init),
        torch.from_numpy(ktab), torch.from_numpy(ecorr))
    assert np.array_equal(e2_t.numpy(), ref)
    assert np.array_equal(zf_t.numpy(), np.stack([env, e2]))


def test_envelope_pass_contract(d):
    """Bad operands raise; a CPU tensor runs the twin and counts no
    launch; any other non-CUDA device raises instead of falling back."""
    x = torch.from_numpy(d[:, :100].copy())
    init = torch.zeros((2, R))
    kt = torch.ones(100)
    before = (envelope.launches, envelope.envelope_launches)
    envelope.envelope_pass(x, K_REL, C_ATT, init, kt, torch.ones(R))
    assert (envelope.launches, envelope.envelope_launches) == before
    with pytest.raises(ValueError, match="together"):
        envelope.envelope_pass(x, K_REL, C_ATT, init, kt)
    with pytest.raises(ValueError, match="ktab"):
        envelope.envelope_pass(x, K_REL, C_ATT, init, torch.ones(99),
                               torch.ones(R))
    with pytest.raises(ValueError, match="no envelope kernel"):
        envelope.envelope_pass(x.to("meta"), K_REL, C_ATT, init.to("meta"))
