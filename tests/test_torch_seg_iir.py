"""The port's time-segmented biquad cascade
(``xmtpu_torch.kernels.iir.sosfilt``: one pass over the R*S segment
rows, the float64 state chain, the FP32 correction) on the plain twin,
against the JAX package's ``sosfilt_pallas`` (interpret mode) and a
float64 oracle; the card's segment rule (``sosfilt_segments``); and a
torch model of the CUDA kernel's schedule (``csrc/iir.cu``).

On a CPU tensor the pass runs the kernel's plain torch twin and the
state chain its torch loop; the kernels themselves are compared with
them on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 3 rows x 8192 samples of the chain's 5-band EQ at its 16 kHz
bus rate; S = 1, 4, 8 and 16 (segments of 8192 down to 512 samples).

Tolerances:
- against the Pallas kernel: -90 dB, final states within 1e-4 (as
  ``tests/test_torch_iir.py``: float32 on both sides, XLA may contract
  the interpret-mode arithmetic into FMAs, and the corrections sum in
  another order); against scipy's float64 ``sosfilt``: -80 dB (the
  chain's gate);
- NaN masks: equal;
- the schedule model against the twin: bit for bit (each section sees
  the same inputs in the same order and rounds every operation).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from xmtpu import batch as xbatch
from xmtpu.kernels import iir as xiir
from xmtpu_torch.kernels import _seg, iir
from xmtpu_torch.kernels._seg import gpu_segments, pick_segments

from . import torch_refs as refs

R, N, SR_BUS = 3, 8192, 16000


@pytest.fixture(scope="module")
def sos():
    return xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR_BUS)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(20261017)
    return (0.4 * rng.standard_normal((R, N))).astype(np.float32)


@pytest.fixture(scope="module")
def zi():
    rng = np.random.default_rng(8)
    return (0.1 * rng.standard_normal((5, R, 2))).astype(np.float32)


@pytest.mark.parametrize("R_,n,ns,sms,per_sm", [
    (32, 160000, 5, 132, 32),    # the unfused step on an H100: 2,048 rows
    (64, 160000, 5, 132, 32),    # the ragged step's rows
    (32, 160000, 8, 132, 16),
    (2, 32000, 5, 132, 32),
    (2, 4000, 5, 132, 32),       # too short to split
    (32, 160001, 5, 132, 32),    # n odd
    (4096, 160000, 5, 4, 1),     # a tiny card: waves decide
])
def test_sosfilt_segment_rule(monkeypatch, R_, n, ns, sms, per_sm):
    """On a card the rule is ``gpu_segments`` over the SM count and the
    kernel's resident blocks per SM at the section count that runs,
    32 // ns rows per block, segments of at least ``MIN_SEGLEN``
    (2048) samples."""
    seen = []

    def slots(query, index, *args):
        seen.append((query, index, *args))
        return sms, per_sm

    monkeypatch.setattr(_seg, "card_slots", slots)
    S = iir.sosfilt_segments(R_, n, "cuda:0", ns)
    assert seen == [("xm_sosfilt_blocks_per_sm", 0, ns)]
    assert iir.rows_per_block(ns) == 32 // ns
    assert S == gpu_segments(R_, n, sms, per_sm, 32 // ns, iir.MIN_SEGLEN)
    assert S >= 1 and S & (S - 1) == 0 and n % S == 0
    assert iir.MIN_SEGLEN == 2048
    assert S == 1 or n // S >= iir.MIN_SEGLEN
    expect = {(32, 160000): 64, (64, 160000): 64, (2, 32000): 8,
              (2, 4000): 1, (32, 160001): 1}
    if (R_, n) in expect:
        assert S == expect[R_, n]
    else:  # 4 slots: every S is many waves; least waves x chain wins
        cost, s = {}, 1
        while n % s == 0 and n // s >= iir.MIN_SEGLEN:
            cost[s] = -(-(-(-R_ * s // 6)) // 4) * (n // s)
            s *= 2
        assert cost[S] == min(cost.values())


def test_sosfilt_default_segments_by_device(monkeypatch, sos, x):
    """segments=None: the JAX rule (pick_segments) on the CPU, the
    card's rule on CUDA (here with a fake card); the pass sees R*S
    rows."""
    assert iir.sosfilt_segments(R, N, "cpu", 5) == pick_segments(R, N) == 2
    monkeypatch.setattr(_seg, "card_slots", lambda query, index, ns: (132, 32))
    assert iir.sosfilt_segments(R, N, "cuda:0", 5) == 4  # 8192 / 8 < 2048
    assert iir.sosfilt_segments(8, 160000, "cuda:0", 5) == 64
    assert iir.sosfilt_segments(8, 160000, "cpu", 5) == 16
    rows = []

    def recording(xs, s32, z):
        rows.append(xs.shape)
        return iir.sosfilt_plain(xs, s32, z)

    iir.sosfilt(sos, torch.from_numpy(x), run=recording)
    assert rows == [(R * 2, N // 2)]


@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("S", [1, 4, 8, 16])
def test_segmented_sosfilt_vs_pallas(sos, x, zi, S, with_zi):
    z = zi if with_zi else None
    y_j, zf_j = xiir.sosfilt_pallas(
        sos, jnp.asarray(x), zi=None if z is None else jnp.asarray(z),
        interpret=True, segments=S)
    y_j, zf_j = np.asarray(y_j), np.asarray(zf_j)
    y_t, zf_t = iir.sosfilt(sos, torch.from_numpy(x), segments=S,
                            zi=None if z is None else torch.from_numpy(z))
    y_t, zf_t = y_t.numpy(), zf_t.numpy()
    x64 = x.astype(np.float64)
    ref = (sps.sosfilt(sos, x64, axis=-1) if z is None else
           sps.sosfilt(sos, x64, axis=-1, zi=z.astype(np.float64))[0])
    db, db64 = refs.db(y_t, y_j), refs.db(y_t, ref)
    print(f"sosfilt twin (S={S}, zi={with_zi}) vs Pallas: {db:.1f} dB "
          f"(gate -90), vs float64: {db64:.1f} dB (gate -80)")
    assert y_t.shape == (R, N) and zf_t.shape == (5, R, 2)
    assert db <= -90.0 and db64 <= -80.0
    np.testing.assert_allclose(zf_t, zf_j, atol=1e-4)


def test_segmented_sosfilt_nan_masks_vs_pallas(sos, x, zi):
    """A NaN sample in segment 2 of row 1 at S = 4: NaN from that
    sample to the row's end and in its final states, in no earlier
    segment and no other row, as in the JAX package."""
    xn = x.copy()
    xn[1, 5000] = np.nan
    y_j, zf_j = xiir.sosfilt_pallas(sos, jnp.asarray(xn),
                                    zi=jnp.asarray(zi), interpret=True,
                                    segments=4)
    y_j, zf_j = np.asarray(y_j), np.asarray(zf_j)
    y_t, zf_t = iir.sosfilt(sos, torch.from_numpy(xn),
                            zi=torch.from_numpy(zi), segments=4)
    y_t, zf_t = y_t.numpy(), zf_t.numpy()
    assert np.isnan(y_t[1, 5000:]).all() and not np.isnan(y_t[1, :5000]).any()
    assert np.array_equal(np.isnan(y_t), np.isnan(y_j))
    assert np.array_equal(np.isnan(zf_t), np.isnan(zf_j))
    ok = ~np.isnan(y_j)
    assert refs.db(y_t[ok], y_j[ok]) <= -90.0


def _schedule_model(x, sos32, zi, chunk):
    """The kernel's schedule in torch (csrc/iir.cu, sosfilt_kernel):
    section s of every row on sample k - s*skew at tick k (skew =
    ``iir.SKEW``), its input section s-1's output of ``skew`` ticks
    before, x staged ``chunk`` samples at
    a time, y written into a two-chunk ring at sample k - lag and
    flushed as the kernel flushes it: chunk c-1 after chunk c's ticks
    unless c is the first or the last, then the drain's lag ticks and
    the last two. Guarded ticks (the first and the last chunk, the
    drain) freeze a section whose sample lies outside the row; the
    other chunks update every section unconditionally."""
    rows, n = x.shape
    ns = sos32.shape[0]
    skew = iir.SKEW
    b0, b1, b2, _, a1, a2 = sos32.T
    s_idx = torch.arange(ns)
    z1, z2 = zi[:, 0].T.clone(), zi[:, 1].T.clone()  # (rows, ns)
    hist = [torch.zeros(rows, ns) for _ in range(skew)]
    lag = (ns - 1) * skew
    assert lag < chunk
    ring = [torch.full((rows, chunk), float("nan")) for _ in range(2)]
    y = torch.full((rows, n), float("nan"))
    nch = -(-n // chunk)

    def tick(xv, k, guard):
        # __shfl_up_sync: section s takes section s-1's output
        v = torch.cat([xv[:, None], hist[0][:, :-1]], 1)
        yv = b0 * v + z1
        n1 = b1 * v - a1 * yv + z2
        n2 = b2 * v - a2 * yv
        if guard:
            live = ((k - s_idx * skew) >= 0) & ((k - s_idx * skew) < n)
            n1, n2 = torch.where(live, n1, z1), torch.where(live, n2, z2)
        z1.copy_(n1)
        z2.copy_(n2)
        hist.pop(0)
        hist.append(yv)
        return yv[:, -1]

    def put(c, t, k, yv):
        if k >= lag:
            if t >= lag:
                ring[c % 2][:, t - lag] = yv
            else:
                ring[(c + 1) % 2][:, chunk + t - lag] = yv

    def flush(c):
        ln = min(chunk, n - c * chunk)
        y[:, c * chunk:c * chunk + ln] = ring[c % 2][:, :ln]

    for c in range(nch):
        t0, ln = c * chunk, min(chunk, n - c * chunk)
        guard = not 0 < c < nch - 1
        for t in range(ln):
            put(c, t, t0 + t, tick(x[:, t0 + t], t0 + t, guard))
        if 0 < c < nch - 1:
            flush(c - 1)
    c = nch - 1
    t0, ln = c * chunk, n - c * chunk
    for t in range(ln, ln + lag):
        put(c, t, t0 + t, tick(torch.zeros(rows), t0 + t, True))
    if c > 0:
        flush(c - 1)
    flush(c)
    return y, torch.stack([z1.T, z2.T], 1)


@pytest.mark.parametrize("ns,chunk,n", [
    (5, iir.CHUNK, 3 * iir.CHUNK + 3),  # last chunk < lag
    (5, iir.CHUNK, 2 * iir.CHUNK),      # n a multiple of it
    (5, iir.CHUNK, 5),                  # one chunk, < lag
    (8, iir.CHUNK, 3 * iir.CHUNK + 1),  # the longest lag
    (8, 32, 101),                       # many boundaries
    (1, 16, 40),
    (3, 16, 37),                        # a ragged last chunk at 3 sections
    (8, 32, 1),                         # one sample: fill and drain only
])
def test_wavefront_schedule_model(sos, ns, chunk, n):
    """The kernel's schedule, modelled in torch, equals the plain twin
    bit for bit (y and zf) from a carried state, across chunk
    boundaries, a ragged last chunk and the pipeline's fill and
    drain."""
    rng = np.random.default_rng(ns * 1000 + n)
    sos_all = np.tile(np.asarray(sos, np.float32), (2, 1))[:ns]
    s32 = torch.from_numpy(np.ascontiguousarray(sos_all))
    rows = 32 // ns
    xs = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    z0 = torch.from_numpy((0.1 * rng.standard_normal((ns, 2, rows))).astype(
        np.float32))
    y_m, zf_m = _schedule_model(xs, s32, z0, chunk)
    y_p, zf_p = iir.sosfilt_plain(xs, s32, z0)
    assert torch.equal(y_m, y_p)
    assert torch.equal(zf_m, zf_p)


def test_state_chain_plain_is_the_reference_loop(sos):
    """The state chain's plain version (the kernel's twin): zin_k =
    z_k, z_{k+1} = z_k A^T + v_k in float64, segment k of row r at row
    r*S + k; a NaN final reaches only the later segments of its row."""
    ns, Rr, S = 5, 2, 6
    rng = np.random.default_rng(4)
    zf0 = rng.standard_normal((ns, 2, Rr * S)).astype(np.float32)
    zf0[1, 0, 0 * S + 2] = np.nan  # row 0, segment 2
    zi3 = rng.standard_normal((ns, 2, Rr)).astype(np.float32)
    A = iir._seg_consts(np.asarray(sos, np.float64), 512)["A_seg"]
    zin, z = iir._state_chain(torch.from_numpy(zf0), torch.from_numpy(zi3),
                              torch.from_numpy(A).T, S)
    D = 2 * ns
    for r in range(Rr):
        zr = zi3[:, :, r].reshape(D).astype(np.float64)
        for k in range(S):
            got = zin[r * S + k].numpy()
            assert np.array_equal(np.isnan(got), np.isnan(zr))
            np.testing.assert_allclose(got, zr, rtol=1e-12, atol=0)
            zr = A @ zr + zf0[:, :, r * S + k].reshape(D)
        np.testing.assert_allclose(z[r].numpy(), zr, rtol=1e-12, atol=0)
    assert not torch.isnan(zin[:3]).any()
    assert torch.isnan(zin[3:S]).any(1).all() and torch.isnan(z[0]).any()
    assert not torch.isnan(zin[S:]).any() and not torch.isnan(z[1]).any()


def test_device_cache_keeps_recently_used(monkeypatch):
    """The per-device table cache drops its least recently used entry:
    a table looked up again is kept when new ones push the cache past
    its size, so a call made once before a CUDA-graph capture finds all
    its tables during the capture."""
    from xmtpu_torch.kernels import _seg

    monkeypatch.setattr(_seg, "_DEVICE_CACHE", {})
    made = []

    def table(i):
        return _seg.on_device(("t", i), "cpu",
                              lambda: made.append(i) or {"v": np.full(2, i)})

    for i in range(32):
        table(i)
    assert made == list(range(32))
    table(0)  # a hit: refreshed, not rebuilt
    table(32)  # evicts 1, the least recently used
    assert made == list(range(33))
    table(0)
    assert made == list(range(33))
    table(1)
    assert made == list(range(33)) + [1]
    assert float(table(5)["v"][0]) == 5.0
