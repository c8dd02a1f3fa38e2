"""The segment rules of the port's envelope drivers
(``xmtpu_torch.kernels.envelope.envelope`` and ``linked_limiter``): on
a card, ``_seg.card_segments`` fed the envelope core's occupancy query
(``xm_envelope_blocks_per_sm``, form 0 the envelope-only form, 1 the
gain form) and its 32 rows a block, segments a multiple of 4 samples
(the core's tensor-map staging); on the CPU the JAX package's
``pick_segments(R, n, lanes=256)``. Then the twin path at an S the
card's rule picks against the JAX kernels at the same ``segments=``, on
the CPU, Pallas in interpret mode.

The card is faked by replacing ``_seg.card_slots`` (SMs, resident
blocks per SM), so the rules run here without one; the kernels' own
comparisons run on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phases 7 and 14).

One signal length: 16384 samples at 48 kHz (the limiter's 1 ms attack
and 100 ms release), where the card's rule and the JAX rule disagree:
at 32 rows the envelope's S is 8 on a card (segments of at least 2048
samples) and 4 by the JAX lane target, and the linked limiter's S on 4
rows is 2 on a card (its e2 carries need segments of at least 4,421
samples) and 4 by the JAX rule.

Tolerances: the twin path against the Pallas kernels -100 dB (float32 on
both sides; the JAX default block-8 lookahead and the correction order
reassociate); the final states rtol 1e-5 at the linked limiter's S = 2,
3e-5 at the envelope's S = 8, where the float32 rounding of a decay over
16384 steps, stepped or carried over 8 segments by the chains' powers,
puts the JAX kernel's own segmented states up to 1.6e-5 from its
one-pass states (measured); the segment counts exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels import envelope as xenv
from xmtpu.kernels.iir import pick_segments as jax_pick_segments
from xmtpu_torch.kernels import _seg, envelope
from xmtpu_torch.kernels._seg import gpu_segments
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff

from . import torch_refs as refs

N, SR = 16384, 48000
K_REL = _release_coeff(100.0, SR)
C_ATT = _attack_coeff(1.0, SR)
LINKED_FLOOR = 4421  # _decay_cut(1 - c_att) at a 1 ms attack, 48 kHz


def _fake_card(monkeypatch, sms, per_sm):
    """Replace the occupancy lookup; returns the list of its calls."""
    seen = []

    def slots(query, index, *args):
        seen.append((query, index, *args))
        return sms, per_sm

    monkeypatch.setattr(_seg, "card_slots", slots)
    return seen


def _expect(R, n, sms, per_sm, floor):
    """The least waves x chain over the allowed S (segments of at least
    ``floor`` samples, a multiple of 4), the larger on a tie."""
    best, best_cost, s = 1, None, 1
    while n % s == 0 and (s == 1 or (n // s >= floor and n // s % 4 == 0)):
        cost = -(-(-(-R * s // 32)) // (sms * per_sm)) * (n // s)
        if best_cost is None or cost <= best_cost:
            best, best_cost = s, cost
        s *= 2
    return best


@pytest.mark.parametrize("R,n,sms,per_sm,want", [
    (32, 160000, 132, 4, 64),    # the 32-clip unfused step
    (64, 160000, 132, 4, 64),    # the 64-clip ragged step
    (16, 480000, 132, 4, 64),    # config 3's rows and length: 3750 % 4
    (1, 160000, 132, 4, 64),     # one row
    (32, 160001, 132, 4, 1),     # n odd
    (32, N, 132, 4, 8),          # where the JAX rule gives 4
    (8192, 5000, 132, 4, 2),     # 2500-sample segments, one wave
    (8192, 4100, 132, 4, 1),     # 2050-sample segments: not a multiple of 4
    (4096, 160000, 4, 1, None),  # a tiny card: waves decide
])
def test_envelope_segment_rule(monkeypatch, R, n, sms, per_sm, want):
    """On a card: ``gpu_segments`` over the SM count and the
    envelope-only form's resident blocks per SM, 32 rows a block,
    segments of at least 2048 samples and a multiple of 4."""
    seen = _fake_card(monkeypatch, sms, per_sm)
    S = envelope.envelope_segments(R, n, "cuda:0")
    assert seen == [("xm_envelope_blocks_per_sm", 0, 0)]
    assert S == gpu_segments(R, n, sms, per_sm, 32, 2048, 4)
    assert S == (_expect(R, n, sms, per_sm, 2048) if want is None else want)
    assert S >= 1 and S & (S - 1) == 0 and n % S == 0
    assert S == 1 or (n // S >= 2048 and n // S % 4 == 0)


@pytest.mark.parametrize("R,n,sms,per_sm,want", [
    (16, 480000, 132, 4, 64),    # config 3's linked_fuse limiter
    (32, 160000, 132, 4, 32),
    (1, 160000, 132, 4, 32),     # one row
    (16, 480001, 132, 4, 1),     # n odd
    (4, N, 132, 4, 2),           # 4096 < the floor: the JAX rule gives 4
    (4096, 480000, 4, 1, None),  # a tiny card
])
def test_linked_segment_rule(monkeypatch, R, n, sms, per_sm, want):
    """On a card: ``gpu_segments`` over the gain form's resident blocks
    per SM, 32 rows a block, segments at least the e2 carries' decay
    window (``carry_min_seglen``: 4,421 samples here) and a multiple of
    4."""
    assert envelope.carry_min_seglen(C_ATT, n) == LINKED_FLOOR
    seen = _fake_card(monkeypatch, sms, per_sm)
    S = envelope.linked_segments(R, n, C_ATT, "cuda:0")
    assert seen == [("xm_envelope_blocks_per_sm", 0, 1)]
    assert S == gpu_segments(R, n, sms, per_sm, 32, LINKED_FLOOR, 4)
    assert S == (_expect(R, n, sms, per_sm, LINKED_FLOOR) if want is None
                 else want)
    assert S == 1 or (n // S >= LINKED_FLOOR and n // S % 4 == 0)


def test_fused_rule_keeps_its_rows(monkeypatch):
    """The fused limiter's rule is unchanged: its own occupancy query
    and 8 rows a block (S = 32 at the flagship's 256 x 160000)."""
    seen = _fake_card(monkeypatch, 132, 3)
    S = envelope.limiter_segments(256, 160000, C_ATT, "cuda:0")
    assert seen == [("xm_limiter_blocks_per_sm", 0)]
    assert S == gpu_segments(256, 160000, 132, 3, 8,
                             envelope.carry_min_seglen(C_ATT, 160000)) == 32


@pytest.mark.parametrize("R,n", [
    (32, 160000), (16, 480000), (1, 160000), (32, 160001), (32, N),
    (2, 32000), (4, N),
])
def test_cpu_default_is_the_jax_rule(monkeypatch, R, n):
    """Off a card both drivers pick S as the JAX package does, and never
    ask the card."""
    def no_card(*args):
        raise AssertionError("the CPU path asked for a card")

    monkeypatch.setattr(_seg, "card_slots", no_card)
    want = jax_pick_segments(R, n, lanes=256)
    assert envelope.envelope_segments(R, n, "cpu") == want
    assert envelope.linked_segments(R, n, C_ATT, "cpu") == want


def _recording(rows):
    def run(*args, **kw):
        rows.append(tuple(args[0].shape))
        return envelope.envelope_plain(*args, **kw)
    return run


def test_cpu_envelope_runs_at_the_jax_rule():
    """segments=None on a CPU tensor: both passes see R*S rows with the
    JAX rule's S (4 at 32 rows)."""
    rng = np.random.default_rng(3)
    d = torch.from_numpy(np.abs(rng.standard_normal((32, N))).astype(
        np.float32))
    rows = []
    envelope.envelope(d, K_REL, C_ATT, run=_recording(rows))
    assert rows == [(128, N // 4)] * 2


@pytest.fixture(scope="module")
def d32():
    """A bursty nonnegative detector over 32 rows: noise under a slow
    on/off gate, so the envelope holds and decays across segment
    boundaries."""
    rng = np.random.default_rng(19)
    gate = (np.sin(np.arange(N) / 700.0) > 0.2).astype(np.float32)
    return np.abs(rng.standard_normal((32, N)) * (0.05 + gate)).astype(
        np.float32)


def test_envelope_at_the_card_S_vs_pallas(monkeypatch, d32):
    """The twin path at the S a card picks for 32 x 16384 (8, where the
    JAX rule gives 4), with a carried state, against the JAX kernel at
    the same segments=."""
    _fake_card(monkeypatch, 132, 4)
    S = envelope.envelope_segments(32, N, "cuda:0")
    assert S == 8 and envelope.envelope_segments(32, N, "cpu") == 4
    rng = np.random.default_rng(4)
    init = tuple(rng.uniform(0.0, 0.5, 32).astype(np.float32)
                 for _ in range(2))
    e2_j, st_j = xenv.envelope_pallas(
        jnp.asarray(d32), K_REL, C_ATT, init=tuple(map(jnp.asarray, init)),
        segments=S, interpret=True)
    e2_j = np.asarray(e2_j)
    rows = []
    e2_t, st_t = envelope.envelope(torch.from_numpy(d32), K_REL, C_ATT,
                                   init=tuple(map(torch.from_numpy, init)),
                                   segments=S, run=_recording(rows))
    assert rows == [(32 * S, N // S)] * 2
    db = refs.db(e2_t.numpy(), e2_j)
    print(f"envelope twin at the card's S = {S} vs Pallas: {db:.1f} dB "
          "(gate -100)")
    assert db <= -100.0
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5)


def test_linked_at_the_card_S_vs_pallas(monkeypatch):
    """The twin path at the S a card picks for 4 stereo clips of 16384
    samples (2: the carries' floor of 4,421 rules out 4096-sample
    segments, which the JAX rule takes) against the JAX kernel at the
    same segments=."""
    _fake_card(monkeypatch, 132, 4)
    S = envelope.linked_segments(4, N, C_ATT, "cuda:0")
    assert S == 2 and envelope.linked_segments(4, N, C_ATT, "cpu") == 4
    rng = np.random.default_rng(43)
    x = (0.5 * rng.standard_normal((4, 2, N))).astype(np.float32)
    x[1, :, 8000:8400] *= 5.0  # a burst across the segment boundary
    y_j, st_j = xenv.linked_limiter_pallas(jnp.asarray(x), K_REL, C_ATT,
                                           -3.0, segments=S, interpret=True)
    y_j = np.asarray(y_j)
    rows = []
    y_t, st_t = envelope.linked_limiter(torch.from_numpy(x), K_REL, C_ATT,
                                        -3.0, segments=S,
                                        run=_recording(rows))
    assert rows == [(4 * S, N // S)] * 2
    db = refs.db(y_t.numpy(), y_j)
    print(f"linked limiter twin at the card's S = {S} vs Pallas: {db:.1f} "
          "dB (gate -100)")
    assert db <= -100.0 and np.abs(y_t.numpy()).max() <= 1.0
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
