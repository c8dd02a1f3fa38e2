"""The port's time-segmented fused EQ + envelope
(``xmtpu_torch.kernels.eq_env.eq_env(segments=S)``: pass 0 for the
segments' final cascade states, the float64 state chain, pass A from the
exact entering states, the envelope's pass B and chains) on the plain
twins, against the JAX package's ``eq_env_pallas`` (interpret mode) and
a float64 oracle; the card's segment rule (``eq_env_segments``).

On a CPU tensor every pass runs its kernel's plain torch twin; the
kernels themselves are compared with the twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape, ``tests/test_torch_eq_env.py``'s: 3 rows x 9000 samples of
the chain's 5-band EQ at its 16 kHz bus rate with the limiter's 100 ms /
1 ms detector; S = 4 and 8 (segments of 2250 and 1125 samples).

Tolerances:
- against the Pallas kernel, as the unsegmented twin's: y, e2 and the
  final envelope states at -90 dB (also the segmented IIR's gate,
  ``tests/test_torch_iir.py``), the final cascade states zf at -85 dB
  and within 1e-5 absolute (float32 on both sides; pass A starts each
  segment from the float64 state rounded to float32, and the envelope's
  chains reassociate the recurrences);
- against the float64 oracle: -80 dB (the chain's gate);
- the segmented final states against the unsegmented twin's: zf within
  1e-5 absolute, the envelope states rtol 1e-5;
- S = 1 against the one-pass twin: bit for bit; NaN masks: equal.
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
from xmtpu_torch.kernels import _seg, envelope, eq_env
from xmtpu_torch.kernels._seg import gpu_segments
from xmtpu_torch.ops.biquad import sosfilt_np

from . import torch_refs as refs

SR = 16000
R, N = 3, 9000
K_REL = xlimiter._release_coeff(100.0, SR)
C_ATT = xlimiter._attack_coeff(1.0, SR)
STATES = ("zeros", "carried")


@pytest.fixture(scope="module")
def sos():
    return xbiquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(20261016)
    return (0.3 * rng.standard_normal((R, N))).astype(np.float32)


def _state(name):
    """(zi (5, R, 2), (env, e2)) in the JAX layouts, or (None, None)."""
    if name == "zeros":
        return None, None
    rng = np.random.default_rng(3)
    zi = (0.05 * rng.standard_normal((5, R, 2))).astype(np.float32)
    ei = tuple(rng.uniform(0.0, 0.5, R).astype(np.float32)
               for _ in range(2))
    return zi, ei


def _port(sos, x, name, **kw):
    zi, ei = _state(name)
    return eq_env.eq_env(
        sos, torch.from_numpy(x), K_REL, C_ATT,
        zi=None if zi is None else torch.from_numpy(zi),
        env_init=None if ei is None else tuple(map(torch.from_numpy, ei)),
        **kw)


@pytest.fixture(scope="module")
def runs(sos, x):
    """The port's eq_env at (S, state), each computed once."""
    cache = {}

    def get(S, name):
        if (S, name) not in cache:
            cache[S, name] = _port(sos, x, name, segments=S)
        return cache[S, name]

    return get


@pytest.fixture(scope="module")
def pallas(sos, x):
    out = {}
    for name in STATES:
        zi, ei = _state(name)
        y, e2, zf, (el, sl) = xeq_env.eq_env_pallas(
            sos, jnp.asarray(x), K_REL, C_ATT,
            zi=None if zi is None else jnp.asarray(zi),
            env_init=None if ei is None else tuple(map(jnp.asarray, ei)),
            time_chunk=1024, interpret=True)
        out[name] = tuple(np.asarray(a) for a in (y, e2, zf, el, sl))
    return out


def _oracle(sos, x):
    """float64: the cascade (``sosfilt_np``), then the envelope
    recurrence on |y| in a numpy loop, from zero state."""
    y, zf = sosfilt_np(sos, x.astype(np.float64))
    env = np.zeros(R)
    e2 = np.zeros(R)
    e2_t = np.empty_like(y)
    for t in range(N):
        env = np.maximum(np.abs(y[:, t]), K_REL * env)
        e2 = (1.0 - C_ATT) * e2 + C_ATT * env
        e2_t[:, t] = e2
    return y, e2_t, zf, env, e2


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("S", [1, 4, 8])
def test_segmented_eq_env_vs_pallas(runs, pallas, S, state):
    y, e2, zf, (el, sl) = runs(S, state)
    y_j, e2_j, zf_j, el_j, sl_j = pallas[state]
    assert y.shape == e2.shape == (R, N) and zf.shape == (5, R, 2)
    dbs = {"y": refs.db(y, y_j), "e2": refs.db(e2, e2_j),
           "zf": refs.db(zf, zf_j), "env_last": refs.db(el, el_j),
           "e2_last": refs.db(sl, sl_j)}
    print(f"segmented eq_env (S={S}, {state}) vs Pallas (gates: zf -85 dB, "
          "the others -90 dB): "
          + ", ".join(f"{k} {v:.1f}" for k, v in dbs.items()))
    assert dbs.pop("zf") <= -85.0
    assert all(v <= -90.0 for v in dbs.values()), dbs
    np.testing.assert_allclose(zf.numpy(), zf_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S", [4, 8])
def test_segmented_eq_env_vs_oracle(sos, x, runs, S):
    y, e2, zf, (el, sl) = runs(S, "zeros")
    ref = _oracle(sos, x)
    dbs = [refs.db(a, b) for a, b in zip((y, e2, zf, el, sl), ref)]
    print(f"segmented eq_env (S={S}) vs float64 oracle (y, e2, zf, "
          f"env_last, e2_last; gate -80 dB): {[round(d, 1) for d in dbs]}")
    assert all(d <= -80.0 for d in dbs), dbs


def test_one_segment_is_todays_eq_env(sos, x, runs):
    """segments=1 and the CPU default (None) are today's one pass of the
    twin, bit for bit (from a carried state)."""
    state = "carried"
    zi, ei = _state(state)
    s32 = torch.from_numpy(np.asarray(sos, np.float32))
    zi3 = torch.from_numpy(zi).permute(0, 2, 1).contiguous()
    ei2 = torch.from_numpy(np.stack(ei))
    y, e2, zf, ef = eq_env.eq_env_plain(torch.from_numpy(x), s32, zi3, ei2,
                                        K_REL, C_ATT)
    want = (y, e2, zf.permute(0, 2, 1), ef[0], ef[1])
    assert eq_env.eq_env_segments(R, N, C_ATT, "cpu", 5) == 1
    for out in (runs(1, state), _port(sos, x, state)):  # segments=1, None
        y, e2, zf, (el, sl) = out
        for a, b in zip((y, e2, zf, el, sl), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("S", [4, 8])
def test_segmented_final_states_match(runs, S):
    """zf from the float64 chain and the last envelope states from the
    max and sum chains, against the unsegmented twin's."""
    for state in STATES:
        _, _, zf, last = runs(S, state)
        _, _, zf1, last1 = runs(1, state)
        np.testing.assert_allclose(zf.numpy(), zf1.numpy(), rtol=0,
                                   atol=1e-5)
        for a, b in zip(last, last1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_segmented_passes(sos, x, runs):
    """The passes the path runs, through ``run``: K6's finals-only pass
    and pass A over the segment rows (c_att = 1, zero envelope state),
    then one envelope-only pass B with the inline correction."""
    calls = []

    def rec_eq(*args, **kw):
        calls.append(("eq_env", args[0].shape, args[5], kw))
        return eq_env.eq_env_plain(*args, **kw)

    def rec_env(*args, **kw):
        calls.append(("envelope", args[0].shape, args[1], len(args)))
        return envelope.envelope_plain(*args, **kw)

    out = eq_env.eq_env(sos, torch.from_numpy(x), K_REL, C_ATT,
                        segments=4, run=(rec_eq, rec_env))
    seg = (R * 4, N // 4)
    assert calls == [("eq_env", seg, C_ATT, {"finals_only": True}),
                     ("eq_env", seg, 1.0, {}),
                     ("envelope", seg, 0.0, 6)]
    assert all(torch.equal(a, b) for a, b in zip(out[:3], runs(4, "zeros")))


def test_segment_refusals(sos, x):
    xt = torch.from_numpy(x)
    for bad in (7, 0, -2):
        with pytest.raises(ValueError, match="does not divide"):
            eq_env.eq_env(sos, xt, K_REL, C_ATT, segments=bad)
    with pytest.raises(ValueError, match="sections"):
        eq_env.eq_env(np.zeros((0, 6)), xt, K_REL, C_ATT, segments=4)
    with pytest.raises(ValueError, match="no eq_env kernel"):
        eq_env.eq_env(sos, xt.to("meta"), K_REL, C_ATT, segments=1)


def test_unstable_cascade_runs_one_pass(x):
    """A cascade that ``_seg_consts`` rejects (a double pole at z = 1)
    runs in one pass at any segments=, still on the one-pass function."""
    sos = np.array([[1.0, 0.0, 0.0, 1.0, -2.0, 1.0]])
    calls = []

    def rec_eq(*args, **kw):
        calls.append(kw)
        return eq_env.eq_env_plain(*args, **kw)

    xt = torch.from_numpy(x)
    out = eq_env.eq_env(sos, xt, K_REL, C_ATT, segments=4,
                        run=(rec_eq, envelope.envelope_plain))
    assert calls == [{}]
    ref = eq_env.eq_env(sos, xt, K_REL, C_ATT, segments=1)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))


def test_segmented_nan_masks(sos, x):
    """A NaN sample in segment 2 of row 1 and a NaN initial envelope on
    row 2: at S = 4 NaN lands exactly where the unsegmented twin puts it
    (from the sample on, in both chains, never in earlier segments) and
    the finite values still agree."""
    xn = x.copy()
    xn[1, 5000] = np.nan
    xt = torch.from_numpy(xn)
    ei = (torch.tensor([0.1, 0.2, float("nan")]), torch.tensor([0.1] * 3))
    seg = eq_env.eq_env(sos, xt, K_REL, C_ATT, env_init=ei, segments=4)
    one = eq_env.eq_env(sos, xt, K_REL, C_ATT, env_init=ei, segments=1)
    assert bool(one[0][1, 5000:].isnan().all())
    assert not bool(one[0][1, :5000].isnan().any())
    assert bool(one[1][2].isnan().all()) and not bool(one[0][2].isnan().any())
    for a, b in zip((*seg[:3], *seg[3]), (*one[:3], *one[3])):
        assert torch.equal(a.isnan(), b.isnan())
        ok = ~b.isnan()
        assert refs.db(a[ok], b[ok]) <= -90.0


@pytest.mark.parametrize("R_,n,sms,per_sm", [
    (256, 160000, 132, 5),   # the unfolded flagship shape on an H100
    (256, 160000, 132, 2),
    (64, 160000, 132, 5),    # the ragged step's rows
    (2, 32000, 132, 5),
    (2, 8000, 132, 5),       # too short to split
    (1024, 160000, 132, 5),  # the unsegmented grid already fills the card
    (256, 160001, 132, 5),   # n odd
])
def test_eq_env_segment_rule(monkeypatch, R_, n, sms, per_sm):
    """On a card the rule is ``gpu_segments`` over the SM count and the
    kernel's resident blocks per SM at the section count that runs, 32
    rows per block, segments at least 4096 samples and the one-pole's
    decay window."""
    seen = []

    def slots(query, index, *args):
        seen.append((query, index, *args))
        return sms, per_sm

    monkeypatch.setattr(_seg, "card_slots", slots)
    S = eq_env.eq_env_segments(R_, n, C_ATT, "cuda:0", 5)
    assert seen == [("xm_eq_env_blocks_per_sm", 0, 5)]
    min_seglen = max(4096, envelope._decay_cut(1.0 - C_ATT, n))
    assert S == gpu_segments(R_, n, sms, per_sm, 32, min_seglen)
    assert S >= 1 and S & (S - 1) == 0 and n % S == 0
    assert S == 1 or n // S >= 4096
    expect = {(256, 160000): 32, (64, 160000): 32, (2, 32000): 4,
              (2, 8000): 1, (1024, 160000): 32, (256, 160001): 1}
    if per_sm == 5:
        assert S == expect[R_, n]
