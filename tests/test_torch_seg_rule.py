"""The card's segment rule past the powers of two
(``xmtpu_torch.kernels._seg.gpu_segments``), and the segmented drivers
at a segment count with odd factors.

The rule walks the powers of two as before; where the largest divisor
of n whose blocks fit one an SM shortens the waves x chain at least
``_seg._STARVED`` times, it takes that divisor and counts the pick in
``_seg.wide_picks``. The card is faked by replacing
``_seg.card_slots`` (SMs, resident blocks per SM), so the rule runs here
without one. The picks that the port's cells and the other
``test_torch_seg_*`` files pin are held to what the powers-of-two rule
gives (``_pow2``, its code before the divisors).

Then each driver the rule feeds runs its twin path on the CPU at an S
with odd factors against the JAX kernels in interpret mode, at the
drivers' own gates: the envelope and the linked limiter at S = 105
(segments of 256 samples) -100 dB against the JAX kernel at the same
``segments=`` and the envelope against its own S = 1; the fused limiter
(K2) at S = 105 -100 dB against the JAX limiter's one pass; K5 at S = 15
-90 dB against the JAX kernel at the same ``segments=`` and -80 dB
against scipy's float64 ``sosfilt``; K6 at S = 15 -90 dB against the
JAX kernel's one pass. Every case carries a nonzero state in.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from xmtpu import batch as xbatch
from xmtpu.kernels import envelope as xenv
from xmtpu.kernels import eq_env as xeq_env
from xmtpu.kernels import iir as xiir
from xmtpu_torch.kernels import _seg, envelope, eq_env, iir
from xmtpu_torch.kernels._seg import gpu_segments
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff

from . import torch_refs as refs

VOICE = (32, 2646000)  # the voice cell's limiter rows: 60 s at 44.1 kHz


def _fake_card(monkeypatch, sms, per_sm):
    monkeypatch.setattr(_seg, "card_slots",
                        lambda query, index, *args: (sms, per_sm))


def _pow2(R, n, slots, rows_per_block, min_seglen, align):
    """The rule before the divisors: powers of two only."""
    best, best_cost, s = 1, None, 1
    while True:
        cost = -(-(-(-R * s // rows_per_block)) // slots) * (n // s)
        if best_cost is None or cost <= best_cost:
            best, best_cost = s, cost
        if (n % (2 * s) or n // (2 * s) < min_seglen
                or n // (2 * s) % align):
            return best
        s *= 2


def _cost(R, n, slots, rows_per_block, S):
    return -(-(-(-R * S // rows_per_block)) // slots) * (n // S)


def _coeffs(sr):
    return _release_coeff(100.0, sr), _attack_coeff(1.0, sr)


# (driver, R, n, sample rate): each driver's rule as its caller asks it
def _rule(name, R, n, sr):
    """(S from the driver's rule on the fake card, rows per block, the
    floor, the alignment)."""
    k_rel, c_att = _coeffs(sr)
    if name == "envelope":
        return (envelope.envelope_segments(R, n, "cuda:0"), 32,
                envelope._ENVELOPE_MIN_SEGLEN, 4)
    floor = envelope.carry_min_seglen(c_att, n)
    if name == "linked":
        return envelope.linked_segments(R, n, c_att, "cuda:0"), 32, floor, 4
    if name == "limiter":
        return envelope.limiter_segments(R, n, c_att, "cuda:0"), 8, floor, 1
    if name == "sosfilt":
        return (iir.sosfilt_segments(R, n, "cuda:0", 5), iir.rows_per_block(5),
                iir.MIN_SEGLEN, 1)
    return eq_env.eq_env_segments(R, n, c_att, "cuda:0", 5), 32, floor, 1


@pytest.mark.parametrize("name,R,n,sr,sms,per_sm", [
    ("envelope", *VOICE, 44100, 132, 4),      # the voice cell's envelope
    ("linked", *VOICE, 44100, 132, 4),
    ("envelope", 1, 43200000, 48000, 132, 4),  # an hour clip's shard
    ("envelope", 2, 2646000, 44100, 132, 4),
    ("limiter", 2, 2646000, 44100, 132, 3),
    ("sosfilt", 2, 1323000, 44100, 132, 32),
    ("eq_env", 2, 2646000, 44100, 132, 5),
])
def test_a_starved_card_takes_a_divisor(monkeypatch, name, R, n, sr, sms,
                                        per_sm):
    """Where the powers of two leave a few blocks each running a long
    chain, the pick is a divisor of n that is no power of two: segments
    of at least the floor and a multiple of the alignment, a block an SM
    at most, a waves x chain at least ``_STARVED`` times shorter; the
    counter advances by one."""
    _fake_card(monkeypatch, sms, per_sm)
    before = _seg.wide_picks
    S, rpb, floor, align = _rule(name, R, n, sr)
    slots = sms * per_sm
    old = _pow2(R, n, slots, rpb, floor, align)
    assert _seg.wide_picks == before + 1
    assert S & (S - 1) and n % S == 0
    assert n // S >= floor and n // S % align == 0
    assert -(-R * S // rpb) <= sms
    assert _seg._STARVED * _cost(R, n, slots, rpb, S) <= _cost(
        R, n, slots, rpb, old)


def test_the_voice_pick(monkeypatch):
    """32 x 2,646,000 on an H100's 132 SMs at the envelope core's 4
    blocks an SM: the powers of two stop at S = 4 (4 blocks, chains of
    661,500 steps); the rule takes S = 126, a block on 126 of the 132
    SMs and chains of 21,000 steps, the least time of the envelope()
    call in an S sweep on an H100 (1 to 1,050: 0.700 ms, against 10.07
    at S = 4 and 1.27 at S = 525, where the glue has grown)."""
    _fake_card(monkeypatch, 132, 4)
    assert _pow2(*VOICE, 528, 32, 2048, 4) == 4
    assert envelope.envelope_segments(*VOICE, "cuda:0") == 126
    assert gpu_segments(*VOICE, 132, 4, 32, 2048, 4) == 126
    assert envelope.linked_segments(*VOICE, _coeffs(44100)[1],
                                    "cuda:0") == 126


@pytest.mark.parametrize("name,R,n,sr,sms,per_sm,want", [
    ("envelope", 64, 480000, 48000, 132, 4, 64),   # the effects cell
    ("limiter", 256, 160000, 16000, 132, 3, 32),   # the podcast cell's K2
    ("envelope", 32, 160000, 16000, 132, 4, 64),   # the 32-clip step
    ("envelope", 1, 65536, 48000, 132, 4, 32),     # the episode's block
    ("envelope", 16, 480000, 48000, 132, 4, 64),   # config 3
    ("linked", 16, 480000, 48000, 132, 4, 64),
    ("linked", 4, 16384, 48000, 132, 4, 2),
    ("envelope", 1, 160000, 16000, 132, 4, 64),
    ("sosfilt", 32, 160000, 16000, 132, 32, 64),
    ("sosfilt", 2, 32000, 16000, 132, 32, 8),
    ("eq_env", 256, 160000, 16000, 132, 5, 32),
    ("eq_env", 2, 32000, 16000, 132, 5, 4),
    ("limiter", 2, 32000, 16000, 132, 3, 4),
])
def test_picks_that_fill_the_card_stay(monkeypatch, name, R, n, sr, sms,
                                       per_sm, want):
    """The cells' and the pinned shapes' picks are the powers-of-two
    rule's, and the counter stays."""
    _fake_card(monkeypatch, sms, per_sm)
    before = _seg.wide_picks
    S, rpb, floor, align = _rule(name, R, n, sr)
    assert S == want == _pow2(R, n, sms * per_sm, rpb, floor, align)
    assert _seg.wide_picks == before


@pytest.mark.parametrize("rpb,floor,align,sms,per_sm", [
    (32, 2048, 4, 132, 4), (32, 4421, 4, 132, 4), (8, 4096, 1, 132, 3),
    (6, 2048, 1, 132, 32), (32, 4096, 1, 132, 5), (32, 2048, 4, 4, 1),
])
def test_the_rule_over_a_grid(rpb, floor, align, sms, per_sm):
    """Over rows x lengths: the pick is the powers-of-two rule's, or a
    divisor of a block an SM at most, at least ``_STARVED`` times
    cheaper; never one that breaks the floor or the alignment."""
    slots = sms * per_sm
    for R in (1, 2, 3, 8, 16, 32, 64, 256, 4096):
        for n in (8000, 16384, 32000, 96000, 160000, 160001, 441000,
                  480000, 1323000, 2646000, 28800000, 43200000, 2**31 - 1):
            S = gpu_segments(R, n, sms, per_sm, rpb, floor, align)
            old = _pow2(R, n, slots, rpb, floor, align)
            assert n % S == 0
            assert S == 1 or (n // S >= floor and n // S % align == 0)
            if S != old:
                assert -(-R * S // rpb) <= sms
                assert _seg._STARVED * _cost(R, n, slots, rpb, S) <= _cost(
                    R, n, slots, rpb, old)


def test_divisors():
    assert _seg._divisors(1) == [1]
    assert _seg._divisors(2**31 - 1) == [1, 2**31 - 1]
    d = _seg._divisors(2646000)
    assert d == sorted(d) and len(d) == 5 * 4 * 4 * 3
    assert d == [k for k in range(1, 2646001) if 2646000 % k == 0]


def test_cpu_never_asks_the_rule(monkeypatch):
    """Off a card the drivers' defaults are unchanged (the JAX rule, or
    1), and no pick is counted."""
    def no_card(*a):
        raise AssertionError("the CPU asked the card")

    monkeypatch.setattr(_seg, "card_slots", no_card)
    before = _seg.wide_picks
    assert envelope.envelope_segments(*VOICE, "cpu") == _seg.pick_segments(
        *VOICE, lanes=256)
    assert envelope.limiter_segments(*VOICE, 0.02, "cpu") == 1
    assert _seg.wide_picks == before


# ------------------------------------------------ exactness at odd S


SR = 48000
K_REL, C_ATT = _coeffs(SR)
S_ODD, N_ODD = 105, 26880  # 3 x 5 x 7 segments of 256 samples


def _rows(rng, R, n):
    gate = (np.sin(np.arange(n) / 700.0) > 0.2).astype(np.float32)
    return (rng.standard_normal((R, n)) * (0.05 + gate)).astype(np.float32)


def _recording(rows, run):
    def rec(*args, **kw):
        rows.append(tuple(args[0].shape))
        return run(*args, **kw)
    return rec


def _case_envelope():
    rng = np.random.default_rng(23)
    d = np.abs(_rows(rng, 4, N_ODD))
    init = tuple(rng.uniform(0.0, 0.5, 4).astype(np.float32)
                 for _ in range(2))
    e2_j, st_j = xenv.envelope_pallas(
        jnp.asarray(d), K_REL, C_ATT, init=tuple(map(jnp.asarray, init)),
        segments=S_ODD, interpret=True)
    rows = []
    e2_t, st_t = envelope.envelope(
        torch.from_numpy(d), K_REL, C_ATT,
        init=tuple(map(torch.from_numpy, init)), segments=S_ODD,
        run=_recording(rows, envelope.envelope_plain))
    e2_1, st_1 = envelope.envelope(
        torch.from_numpy(d), K_REL, C_ATT,
        init=tuple(map(torch.from_numpy, init)), segments=1,
        run=envelope.envelope_plain)
    assert rows == [(4 * S_ODD, N_ODD // S_ODD)] * 2
    dbs = {"pallas": refs.db(e2_t.numpy(), e2_j),
           "S = 1": refs.db(e2_t.numpy(), e2_1.numpy())}
    for a, b, c in zip(st_t, st_j, st_1):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=3e-5)
    return dbs, -100.0


def _case_linked():
    rng = np.random.default_rng(29)
    x = np.stack([_rows(rng, 2, N_ODD) for _ in range(3)])  # (3, 2, n)
    init = tuple(rng.uniform(0.0, 0.5, 3).astype(np.float32)
                 for _ in range(2))
    y_j, st_j = xenv.linked_limiter_pallas(
        jnp.asarray(x), K_REL, C_ATT, -3.0,
        init=tuple(map(jnp.asarray, init)), segments=S_ODD, interpret=True)
    rows = []
    y_t, st_t = envelope.linked_limiter(
        torch.from_numpy(x), K_REL, C_ATT, -3.0,
        init=tuple(map(torch.from_numpy, init)), segments=S_ODD,
        run=_recording(rows, envelope.envelope_plain))
    assert rows == [(3 * S_ODD, N_ODD // S_ODD)] * 2
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5)
    y_j = np.asarray(y_j)
    return {"pallas": refs.db(y_t.numpy(), y_j)}, -100.0


def _case_limiter():
    rng = np.random.default_rng(31)
    x = 3.0 * _rows(rng, 2, N_ODD)
    init = (0.4, 0.2)
    y_j, st_j = xenv.limiter_pallas(
        jnp.asarray(x), K_REL, C_ATT, -3.0,
        init=tuple(jnp.full((2,), v, jnp.float32) for v in init),
        interpret=True)
    rows = []
    y_t, zf_t = envelope.limiter(
        torch.from_numpy(x), K_REL, C_ATT, envelope.curve_of(-3.0),
        init=torch.tensor([[init[0]] * 2, [init[1]] * 2]), segments=S_ODD,
        run=_recording(rows, envelope.envelope_plain))
    assert rows == [(2 * S_ODD, N_ODD // S_ODD)]
    np.testing.assert_allclose(zf_t.numpy(), np.stack(
        [np.asarray(s) for s in st_j]), rtol=1e-5)
    y_j = np.asarray(y_j)
    return {"pallas": refs.db(y_t.numpy(), y_j)}, -100.0


N_IIR, S_IIR = 15360, 15  # 3 x 5 segments of 1024 samples


def _case_sosfilt():
    sos = xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), 16000)
    rng = np.random.default_rng(37)
    x = (0.4 * rng.standard_normal((3, N_IIR))).astype(np.float32)
    zi = (0.1 * rng.standard_normal((5, 3, 2))).astype(np.float32)
    y_j, zf_j = xiir.sosfilt_pallas(sos, jnp.asarray(x), zi=jnp.asarray(zi),
                                    interpret=True, segments=S_IIR)
    rows = []
    y_t, zf_t = iir.sosfilt(sos, torch.from_numpy(x),
                            zi=torch.from_numpy(zi), segments=S_IIR,
                            run=_recording(rows, iir.sosfilt_plain))
    assert rows == [(3 * S_IIR, N_IIR // S_IIR)]
    np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), atol=1e-4)
    ref = sps.sosfilt(sos, x.astype(np.float64), axis=-1,
                      zi=zi.astype(np.float64))[0]
    y_j, y_t = np.asarray(y_j), y_t.numpy()
    assert refs.db(y_t, ref) <= -80.0
    return {"pallas": refs.db(y_t, y_j)}, -90.0


def _case_eq_env():
    sos = xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), 16000)
    k_rel, c_att = _coeffs(16000)
    rng = np.random.default_rng(41)
    x = (0.3 * rng.standard_normal((3, N_IIR))).astype(np.float32)
    zi = (0.05 * rng.standard_normal((5, 3, 2))).astype(np.float32)
    ei = tuple(rng.uniform(0.0, 0.5, 3).astype(np.float32) for _ in range(2))
    y_j, e2_j, zf_j, (el_j, sl_j) = xeq_env.eq_env_pallas(
        sos, jnp.asarray(x), k_rel, c_att, zi=jnp.asarray(zi),
        env_init=tuple(map(jnp.asarray, ei)), time_chunk=1024,
        interpret=True)
    rows = []
    y, e2, zf, (el, sl) = eq_env.eq_env(
        sos, torch.from_numpy(x), k_rel, c_att, zi=torch.from_numpy(zi),
        env_init=tuple(map(torch.from_numpy, ei)), segments=S_IIR,
        run=(_recording(rows, eq_env.eq_env_plain), envelope.envelope_plain))
    assert rows == [(3 * S_IIR, N_IIR // S_IIR)] * 2
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), atol=1e-5)
    return {k: refs.db(a, b)
            for k, a, b in (("y", y, y_j), ("e2", e2, e2_j),
                            ("env_last", el, el_j),
                            ("e2_last", sl, sl_j))}, -90.0


CASES = {"envelope": _case_envelope, "linked": _case_linked,
         "limiter": _case_limiter, "sosfilt": _case_sosfilt,
         "eq_env": _case_eq_env}


@pytest.mark.parametrize("name", list(CASES))
def test_a_segment_count_with_odd_factors_is_exact(name):
    """Each driver's twin path at S = 105 or 15 against the JAX kernels
    (and the envelope against its one pass), from a carried state."""
    dbs, gate = CASES[name]()
    print(f"{name} at odd S: "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in dbs.items())
          + f" (gate {gate})")
    assert all(v <= gate for v in dbs.values()), dbs
