"""The duck kernel's design on the CPU (``kernels.duck``,
``csrc/duck.cu``; the kernel itself runs only on a card:
``tests/test_torch_gpu.py -k duck``):

- a float64 numpy model of the kernel's split (segments of ``SEG``
  samples, ``THREADS`` of them a tile, their pairs composed in order
  within a tile and the tiles chained along the row, then each segment
  replayed from its carries) against the sequential recurrence: the
  algebra of the carries, ragged tiles, a carried state, the identity
  one-pole and a release of 0;
- the knee's clamped ends (``knee_bounds``): past them the twin's knee
  gives exactly the gain at x = 0 or 1, so the kernel may skip the log
  and the power there;
- ``ops.mix.duck_apply`` on the CPU: the mixer's old expression bit for
  bit, through ``ops.mix.duck_gain`` by its module name;
- ``kernels.duck.gain`` off a card runs its twin, the float64 scans;
  ``kernels.duck.apply`` raises there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import torch_refs as refs
from xmtpu_torch.kernels import duck as kduck
from xmtpu_torch.ops import limiter
from xmtpu_torch.ops import mix as mixops

SR = 48000
KW = dict(threshold_db=-40.0, depth_db=12.0, knee_db=10.0)


def _knee_np(e2, threshold_db, depth_db, knee_db):
    env_db = 20.0 * np.log10(np.maximum(e2, 1e-12))
    x = np.clip((env_db - threshold_db) / knee_db + 0.5, 0.0, 1.0)
    return 10.0 ** (-depth_db * x / 20.0)


def _sequential(d, k, c, env0, e20):
    """e2 of the recurrences sample by sample, from (env0, e20) a row."""
    env = np.array(env0, np.float64)
    e2 = np.array(e20, np.float64)
    out = np.empty_like(d)
    for t in range(d.shape[-1]):
        env = np.maximum(d[:, t], k * env)
        e2 = env if c >= 1.0 else (1.0 - c) * e2 + c * env
        out[:, t] = e2
    return out


# f(x) = max(v, p x) and f(x) = u + q x, composed `early` then `late`
_MAX = (lambda e, l: (np.maximum(l[0], l[1] * e[0]), e[1] * l[1]),
        lambda f, x: np.maximum(f[0], f[1] * x))
_SUM = (lambda e, l: (l[1] * e[0] + l[0], e[1] * l[1]),
        lambda f, x: f[0] + f[1] * x)


def _carries(val, pw, op, init):
    """The state entering each segment (R, nseg): the segments' pairs
    composed in order within each tile of THREADS (exclusive), the
    tiles' totals chained from ``init`` along the row."""
    compose, apply_ = op
    R, nseg = val.shape
    out = np.empty((R, nseg))
    tile_in = np.asarray(init, np.float64)
    for j0 in range(0, nseg, kduck.THREADS):
        pre = (np.zeros(R), 1.0)
        for i in range(j0, min(nseg, j0 + kduck.THREADS)):
            out[:, i] = apply_(pre, tile_in)
            pre = compose(pre, (val[:, i], pw[i]))
        tile_in = apply_(pre, tile_in)
    return out


def _split_model(d, k, c, env0, e20):
    """e2 (R, n) by the kernel's three passes over |s| = ``d``."""
    R, n = d.shape
    SEG = kduck.SEG
    nseg = -(-n // SEG)
    seg = np.zeros((R, nseg * SEG))
    seg[:, :n] = d
    seg = seg.reshape(R, nseg, SEG)
    lens = np.clip(n - np.arange(nseg) * SEG, 0, SEG)
    a = 1.0 - c
    v = np.zeros((R, nseg))  # pass A: each segment's max from zero
    for t in range(SEG):
        v = np.where(t < lens, np.maximum(seg[..., t], k * v), v)
    E = _carries(v, float(k) ** lens, _MAX, env0)
    env, u = E.copy(), np.zeros((R, nseg))  # pass B: the one-pole from zero
    for t in range(SEG):
        on = t < lens
        env = np.where(on, np.maximum(seg[..., t], k * env), env)
        u = np.where(on, a * u + c * env, u)
    Sx = _carries(u, a ** lens, _SUM, e20)
    env, e2, out = E, Sx, np.empty((R, nseg, SEG))  # pass C
    for t in range(SEG):
        env = np.maximum(seg[..., t], k * env)
        e2 = env if c >= 1.0 else a * e2 + c * env
        out[..., t] = e2
    return out.reshape(R, -1)[:, :n]


@pytest.mark.parametrize("n,attack_ms,release_ms,state", [
    (3 * kduck.TILE + 1234, 10.0, 300.0, None),   # ragged last tile
    (2 * kduck.TILE, 10.0, 300.0, (0.3, 0.05)),  # whole tiles, a state
    (997, 10.0, 300.0, (0.2, 0.4)),              # one tile (S = 1), prime
    (kduck.TILE + 17, 0.0, 300.0, None),         # the identity one-pole
    (kduck.TILE + 5, 1.0, 0.0, (0.5, 0.5)),      # no release
])
def test_the_kernel_s_split_is_the_recurrence(n, attack_ms, release_ms,
                                              state):
    """The split's e2 and gain against the sequential recurrence from the
    same state: 1e-12 of the level, 1e-12 of the gain."""
    s = refs.speech_with_pauses(n / SR + 0.01, SR, 7)[:, :n]
    d = np.abs(s)
    k = limiter._release_coeff(release_ms, SR)
    c = limiter._attack_coeff(attack_ms, SR)
    env0, e20 = (np.zeros(2), np.zeros(2)) if state is None else (
        np.full(2, state[0]), np.full(2, state[1]))
    want = _sequential(d, k, c, env0, e20)
    got = _split_model(d, k, c, env0, e20)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(want)
    g_w, g_g = _knee_np(want, **KW), _knee_np(got, **KW)
    assert np.max(np.abs(g_g - g_w)) <= 1e-12


@pytest.mark.parametrize("threshold_db,knee_db", [
    (-40.0, 10.0), (-30.0, 0.5), (-60.0, 24.0), (-3.0, 1e-3),
    (-235.0, 9.0), (12.0, 100.0)])
def test_past_the_knee_bounds_the_gain_is_the_clamped_end(threshold_db,
                                                          knee_db):
    """At and past (e_lo, e_hi) the twin's knee reads exactly its value
    at x = 0 (1.0) and at x = 1, the kernel's shortcut; inside them it
    is left to the log and the power."""
    e_lo, e_hi = kduck.knee_bounds(threshold_db, knee_db)
    kw = dict(threshold_db=threshold_db, depth_db=12.0, knee_db=knee_db)
    ends = kduck.knee(torch.tensor([0.0, 1e300], dtype=torch.float64), **kw)
    assert ends[0].item() == 1.0
    hi = torch.tensor([e_hi, np.nextafter(e_hi, np.inf), e_hi * 1.5, 1.0,
                       1e300], dtype=torch.float64)
    assert torch.equal(kduck.knee(hi[hi >= e_hi], **kw),
                       ends[1].expand(int((hi >= e_hi).sum())))
    if np.isnan(e_lo):  # below the meter's floor: never taken
        assert 10.0 ** ((threshold_db - knee_db / 2) / 20.0) < 1e-12 * 1.01
        return
    lo = torch.tensor([0.0, 1e-13, e_lo / 3.0, np.nextafter(e_lo, 0.0),
                       e_lo], dtype=torch.float64)
    assert torch.equal(kduck.knee(lo, **kw),
                       torch.ones(5, dtype=torch.float64))
    # the margin is thin: just inside the ends x leaves 0 and 1
    mid = 10.0 ** ((threshold_db + np.array([-1, 1]) * knee_db / 2 * 0.999)
                   / 20.0)
    g = kduck.knee(torch.from_numpy(mid), **kw)
    assert 1.0 > g[0].item() and g[1].item() > ends[1].item()


@pytest.mark.parametrize("threshold_db,knee_db", [
    (-40.0, 0.0), (-40.0, -3.0), (-40.0, 2e4), (2e4, 10.0),
    (float("nan"), 10.0)])
def test_no_knee_bounds_where_the_margin_is_not_proven(threshold_db,
                                                       knee_db):
    assert all(np.isnan(kduck.knee_bounds(threshold_db, knee_db)))


@pytest.mark.parametrize("tracks", [1, 2])
@pytest.mark.parametrize("overwrite", [False, True])
def test_duck_apply_on_the_cpu_is_the_old_expression(tracks, overwrite):
    """``duck_apply`` off a card: ``out + mix_sum(ducked) *
    duck_gain(out).to(float32)``, the mixer's expression before the
    kernel, bit for bit; with ``overwrite`` in ``side`` itself."""
    rng = np.random.default_rng(29)
    side = torch.from_numpy(
        refs.speech_with_pauses(3.0, SR, 29).astype(np.float32))
    ducked = [torch.from_numpy((0.3 * rng.standard_normal(side.shape))
                               .astype(np.float32)) for _ in range(tracks)]
    bed = mixops.mix_sum(ducked)
    params = dict(KW, attack_ms=5.0, release_ms=200.0)
    want = side + mixops.mix_sum(ducked) * mixops.duck_gain(
        side, SR, **params).to(torch.float32)
    arg = side.clone()
    got = mixops.duck_apply(arg, bed, SR, overwrite=overwrite, **params)
    assert torch.equal(got, want)
    assert (got.data_ptr() == arg.data_ptr()) is overwrite
    assert got.dtype == torch.float32 and got.shape == side.shape


def test_duck_apply_on_the_cpu_runs_duck_gain_by_name(monkeypatch):
    """A fault planted at ``ops.mix.duck_gain`` (the bed left unducked)
    reaches ``duck_apply``: the planted-fault tests of the mix cell
    rely on it."""
    side = torch.from_numpy(
        refs.speech_with_pauses(1.0, SR, 3).astype(np.float32))
    bed = torch.ones_like(side)
    monkeypatch.setattr(mixops, "duck_gain",
                        lambda bus, sr, **kw: torch.ones_like(
                            bus, dtype=torch.float64))
    assert torch.equal(mixops.duck_apply(side, bed, SR), side + bed)


def test_the_wrapper_off_a_card_runs_the_scans(monkeypatch):
    """``kernels.duck.gain`` on the CPU is the float64 scans (a fault
    planted in ``ops.limiter.onepole_scan`` shows), and no launch is
    counted; ``tiles`` follows the length."""
    s = torch.from_numpy(refs.speech_with_pauses(2.0, SR, 5)
                         .astype(np.float32))
    k = limiter._release_coeff(300.0, SR)
    c = limiter._attack_coeff(10.0, SR)
    before = kduck.launches
    g, (env, e2) = kduck.gain(s, k, c, **KW)
    assert g.dtype == torch.float64 and env.shape == e2.shape == (2,)
    monkeypatch.setattr(limiter, "onepole_scan",
                        lambda u, c_, init: (u, u[..., -1]))
    g2, _ = kduck.gain(s, k, c, **KW)
    assert torch.max(torch.abs(g2 - g)) > 1e-3
    assert kduck.launches == before
    assert [kduck.tiles(n) for n in (1, kduck.TILE, kduck.TILE + 1,
                                     28_800_000)] == [1, 1, 2, 7032]


def test_the_mix_form_off_a_card_raises():
    """``kernels.duck.apply`` is the kernel alone: off a card it raises
    (the CPU's expression lives in ``ops.mix.duck_apply``), and counts
    no launch."""
    s = torch.zeros((2, 64))
    before = kduck.launches
    with pytest.raises(ValueError, match="CUDA"):
        kduck.apply(s, s, 0.99, 0.01, **KW)
    assert kduck.launches == before
