"""Parity of the port's session pool (``xmtpu_torch.graph.pool``,
``xmtpu_torch.SessionPool``) with the JAX package's ``SessionPool``, on
the CPU: the port on ``device="cpu"``, the JAX package as its own tests
run it (``pallas_interpret`` for its kernel engine).

One size: K <= 4 slots (32 in one group), voices of 0.3-1.4 s at 44.1
kHz on a 16 kHz bus, 20 ms frames; the JAX tests' EQ + limiter chain,
and noise suppression. Gates: int16 output within 1 LSB of the JAX pool
and of independent port sessions on the scan engine; float32 output at
-120 dB (scan) and the port's twins (``effects_backend="pallas"``)
against JAX ``pallas_interpret`` at -100 dB. Also the slot lifecycle,
the slot axes of the state, snapshots in both directions and their
refusals, the legacy counter, threads.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from xmtpu.config import schema as xs
from xmtpu.graph import pool as xpool
from xmtpu_torch import SessionPool as PublicPool
from xmtpu_torch.config import schema as ts
from xmtpu_torch.graph import pool as tpool
from xmtpu_torch.graph import streaming as tstream
from xmtpu_torch.parallel import Mesh
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR = 16000


def _cfg(S, effects=True, ns=False):
    eff = (S.EffectConfig("equalizer", {"bands": [
        {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0},
        {"freq_hz": 3000.0, "gain_db": -3.0, "q": 0.8}]}),
        S.EffectConfig("limiter", {})) if effects else ()
    if ns:
        eff = (S.EffectConfig("noise_suppression", {"nfft": 320}),) + eff
    return S.PipelineConfig(
        tracks=(S.TrackConfig(url="v", fade_in_ms=50.0, fade_out_ms=80.0),),
        effects=eff, sample_rate=SR, normalize=None)


def _voices(k, seconds=1.0, seed=0, sr=44100):
    rng = np.random.default_rng(seed)
    return [{"v": ((0.3 * rng.standard_normal(int(sr * (seconds + 0.2 * i))))
                   .astype(np.float32), sr)} for i in range(k)]


def _pool(cfg, k, srcs, **kw):
    return tpool.SessionPool(cfg, k, frame_ms=20.0, sources=srcs,
                             device="cpu", **kw)


def _lsb(got, ref):
    return int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())


@pytest.fixture(scope="module")
def srcs3():
    return _voices(3)


@pytest.fixture(scope="module")
def jax_groups(srcs3):
    """The JAX pool's three groups of 8 frames (int16, scan engine)."""
    p = xpool.SessionPool(_cfg(xs), 3, frame_ms=20.0, sources=srcs3)
    return [p.read(8) for _ in range(3)]


def test_pool_matches_jax_pool(srcs3, jax_groups):
    """Three groups of 8 frames: state carries across reads."""
    p = _pool(_cfg(ts), 3, srcs3)
    for ref in jax_groups:
        got = p.read(8)
        assert got.shape == ref.shape and got.dtype == np.int16
        assert _lsb(got, ref) <= 1


def test_pool_matches_independent_sessions(srcs3):
    """Every slot equals an independent port session (1 LSB)."""
    p = _pool(_cfg(ts), 3, srcs3)
    sessions = [tstream.StreamSession(_cfg(ts), frame_ms=20.0, sources=s,
                                      device="cpu") for s in srcs3]
    for _ in range(2):
        got = p.read(8)
        for i, sess in enumerate(sessions):
            assert _lsb(got[i], sess.read_many(8)) <= 1, i


@pytest.mark.parametrize("ns", [False, True])
def test_pool_float32_matches_jax(srcs3, ns):
    """Float32 output of the scan engine at -120 dB against the JAX pool,
    with and without noise suppression (two groups of 4)."""
    j = xpool.SessionPool(_cfg(xs, ns=ns), 3, frame_ms=20.0, sources=srcs3,
                          output_dtype=np.float32)
    t = _pool(_cfg(ts, ns=ns), 3, srcs3, output_dtype=np.float32)
    for _ in range(2):
        ref, got = j.read(4).astype(np.float64), t.read(4)
        assert refs.db(got, ref) <= -120.0


def test_kernel_engine_twins_match_jax_interpret(srcs3):
    """effects_backend="pallas" (the kernels' twins on the CPU) against
    the JAX pool's "pallas_interpret": -100 dB on float32 output; against
    the scan engine -60 dB on int16 (the JAX test's 2-frame gate)."""
    j = xpool.SessionPool(_cfg(xs), 3, frame_ms=20.0, sources=srcs3,
                          output_dtype=np.float32,
                          effects_backend="pallas_interpret")
    t = _pool(_cfg(ts), 3, srcs3, output_dtype=np.float32,
              effects_backend="pallas")
    for _ in range(2):
        ref, got = j.read(2).astype(np.float64), t.read(2)
        assert refs.db(got, ref) <= -100.0
    scan = _pool(_cfg(ts), 3, srcs3).read(2).astype(np.float64)
    ker = _pool(_cfg(ts), 3, srcs3, effects_backend="pallas_interpret")
    got = ker.read(2).astype(np.float64)
    assert refs.db(got, scan) <= -60.0
    with pytest.raises(ConfigError, match="effects_backend"):
        _pool(_cfg(ts), 3, srcs3, effects_backend="cuda")


def test_join_leave_seek_matches_jax(srcs3):
    """The JAX test's lifecycle on both pools: an empty slot is silent, a
    later (longer) join, a leave, a seek; every read within 1 LSB."""
    long = _voices(1, seconds=1.7, seed=5)[0]
    pools = [xpool.SessionPool(_cfg(xs), 3, frame_ms=20.0,
                               sources=srcs3[:2], max_seconds=2.0),
             _pool(_cfg(ts), 3, srcs3[:2], max_seconds=2.0)]
    outs = [[] for _ in pools]
    for p, o in zip(pools, outs):
        o.append(p.read(4))
        assert p.active() == [0, 1]
        p.join(2, long)
        o.append(p.read(6))
        p.leave(1)
        o.append(p.read(4))
        p.seek(0, 200.0)
        o.append(p.read(4))
    assert np.all(outs[1][0][2] == 0) and np.all(outs[1][2][1] == 0)
    for ref, got in zip(*outs):
        assert _lsb(got, ref) <= 1


def test_ducking_pool_matches_jax():
    cfgs = [S.PipelineConfig(
        tracks=(S.TrackConfig(url="v"),
                S.TrackConfig(url="b", kind="bgm", side_duck=True,
                              loop=True)),
        sample_rate=SR, normalize=None) for S in (xs, ts)]
    rng = np.random.default_rng(7)
    v = (0.3 * rng.standard_normal(32000)).astype(np.float32)
    b = (0.2 * np.sin(np.arange(8000) / 20.0)).astype(np.float32)
    srcs = [{"v": (v, SR), "b": (b, SR)},
            {"v": (0.5 * v[::-1].copy(), SR), "b": (b, SR)}]
    ref = xpool.SessionPool(cfgs[0], 2, frame_ms=20.0, sources=srcs).read(10)
    got = _pool(cfgs[1], 2, srcs).read(10)
    assert _lsb(got, ref) <= 1


def test_ns_late_join_reruns_leadin():
    """A slot joined after the pool has passed the NS lead-in runs its
    own (the per-slot counter resets with the slot's state): it equals a
    fresh session."""
    srcs = _voices(2, seconds=0.8, seed=2)
    p = _pool(_cfg(ts, effects=False, ns=True), 2, srcs)
    p.leave(1)
    p.read(8)
    p.join(1, srcs[1])
    got = p.read(8)[1]
    sess = tstream.StreamSession(_cfg(ts, effects=False, ns=True),
                                 frame_ms=20.0, sources=srcs[1],
                                 device="cpu")
    assert _lsb(got, sess.read_many(8)) <= 1


def test_slot_axes_and_slot_reset(srcs3):
    """The state is built for (K, nch): the slot axis is 1 in the EQ
    state and the NS lead buffer, 0 elsewhere. A seek resets exactly the
    slot's slice of every leaf along its own axis."""
    p = _pool(_cfg(ts, ns=True), 3, srcs3)
    paths = [pa for pa, _ in tstream.state_paths(p.states)]
    axes = dict(zip(paths, p._slot_axes))
    assert axes[(0, 0, "lead")] == 1 and axes[(0, 1)] == 1
    assert all(a == 0 for pa, a in axes.items()
               if pa not in ((0, 0, "lead"), (0, 1)))
    p.read(8)
    before = [v.clone() for _, v in tstream.state_paths(p.states)]
    p.seek(1, 0.0)
    for (pa, v), b, ax in zip(tstream.state_paths(p.states), before,
                              p._slot_axes):
        assert not v.select(ax, 1).any(), pa
        for s in (0, 2):
            assert torch.equal(v.select(ax, s), b.select(ax, s)), pa
    assert any(b.select(ax, 1).any() for b, ax in zip(before, p._slot_axes))


def test_geometry_capacity_and_slot_checks():
    srcs = _voices(1, seconds=0.5)
    p = _pool(_cfg(ts), 2, srcs)
    with pytest.raises(ConfigError, match="polyphase"):
        p.join(1, {"v": (np.zeros(8000, np.float32), 48000)})
    with pytest.raises(ConfigError, match="max_seconds"):
        p.join(1, _voices(1, seconds=3.0)[0])
    with pytest.raises(ConfigError, match="slot"):
        p.seek(7, 0.0)
    with pytest.raises(ConfigError, match="sources for slot 0"):
        tpool.SessionPool(_cfg(ts), 2, device="cpu")
    mesh = Mesh(["cpu"] * 2, ("dp",))
    with pytest.raises(ConfigError, match="divide evenly"):
        tpool.SessionPool(_cfg(ts), 3, sources=srcs, mesh=mesh)
    with pytest.raises(ConfigError, match="no axis"):
        tpool.SessionPool(_cfg(ts), 2, sources=srcs, mesh=mesh,
                          mesh_axis="tp")


def test_pool_drops_host_pcm_and_rejoins():
    srcs = _voices(2, seconds=0.3)
    p = _pool(_cfg(ts), 2, srcs)
    assert all(ts_.pcm is None for tr in p._slot_tracks for ts_ in tr)
    assert np.any(p.read(2) != 0)
    p.join(1, srcs[1])
    assert all(ts_.pcm is None for ts_ in p._slot_tracks[1])


def test_dispatch_snapshots_host_clocks():
    """_dispatch uploads a snapshot: clocks and lengths changed right
    after it (as read/join/leave do) do not reach the group."""
    srcs = _voices(2)
    p = _pool(_cfg(ts), 2, srcs)
    pend = p._dispatch(4)
    p._frame_idx[:] = 10**6
    p._n_nat[0][:] = 0
    out = np.moveaxis(tstream._fetch(pend[2]), 1, 2)
    for i, s in enumerate(srcs):
        sess = tstream.StreamSession(_cfg(ts), frame_ms=20.0, sources=s,
                                     device="cpu")
        assert _lsb(out[i], sess.read_many(4)) <= 1


def test_checkpoint_resume_and_refusals(srcs3, tmp_path):
    p = _pool(_cfg(ts), 3, srcs3)
    p.read(6)
    path = tmp_path / "pool.npz"
    p.save_state(path)
    expect = p.read(4)
    p2 = _pool(_cfg(ts), 3, srcs3)
    p2.load_state_file(path)
    assert np.array_equal(p2.read(4), expect)
    with pytest.raises(ConfigError, match="active-slot"):
        _pool(_cfg(ts), 3, srcs3[:2]).load_state_file(path)
    with pytest.raises(ConfigError, match="source lengths"):
        _pool(_cfg(ts), 3, _voices(3, seconds=1.7, seed=9),
              max_seconds=2.0).load_state_file(path)
    with pytest.raises(ConfigError, match="state leaves"):
        _pool(_cfg(ts, effects=False), 3, srcs3).load_state_file(path)
    cfg2 = ts.PipelineConfig(
        tracks=(ts.TrackConfig(url="v", fade_in_ms=50.0, fade_out_ms=80.0),
                ts.TrackConfig(url="w")),
        sample_rate=SR, normalize=None)
    with pytest.raises(ConfigError, match="track table shape"):
        _pool(cfg2, 3, [dict(s, w=s["v"]) for s in srcs3]).load_state_file(
            path)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_across_packages(tmp_path, direction):
    """A pool snapshot of either package restores in the other (the
    slot axis first in every leaf, the JAX layout), NS included; the
    next group equals the saving pool's within 1 LSB."""
    srcs = _voices(2, seconds=0.8, seed=4)
    j = xpool.SessionPool(_cfg(xs, ns=True), 2, frame_ms=20.0, sources=srcs)
    t = _pool(_cfg(ts, ns=True), 2, srcs)
    path = tmp_path / "snap.npz"
    src, dst = (j, t) if direction == "jax_to_port" else (t, j)
    src.read(8)
    src.save_state(path)
    expect = src.read(8)
    dst.load_state_file(path)
    assert _lsb(dst.read(8), expect) <= 1


def test_legacy_ns_counter_snapshot_restores(tmp_path):
    """The sanctioned widening in a pool snapshot: the NS counter saved
    as (K,) restores into the (K, ch) state; a float leaf of another
    shape refuses."""
    srcs = _voices(2, seconds=0.8, seed=4)
    p = _pool(_cfg(ts, effects=False, ns=True), 2, srcs)
    p.read(8)
    path = tmp_path / "st.npz"
    p.save_state(path)
    expect = p.read(8)
    z = dict(np.load(path))
    squeezed = [k for k, v in z.items()
                if k.startswith("leaf_") and v.dtype == np.int32]
    assert len(squeezed) == 1
    z[squeezed[0]] = z[squeezed[0]][:, 0]
    np.savez(path, **z)
    p2 = _pool(_cfg(ts, effects=False, ns=True), 2, srcs)
    p2.load_state_file(path)
    assert np.array_equal(p2.read(8), expect)
    z2 = dict(np.load(path))
    k = next(k for k, v in z2.items() if k.startswith("leaf_")
             and v.dtype != np.int32 and v.ndim >= 2)
    z2[k] = z2[k][..., :1]
    np.savez(path, **z2)
    with pytest.raises(ConfigError, match="leaf"):
        _pool(_cfg(ts, effects=False, ns=True), 2, srcs).load_state_file(
            path)


def test_parity_at_32_slots():
    """One group of 4 frames at 32 slots against the JAX pool, every
    slot (1 LSB)."""
    srcs = _voices(32, seconds=0.3, seed=11)
    srcs = [{"v": (s["v"][0][:int(44100 * (0.3 + 0.01 * i))], 44100)}
            for i, s in enumerate(srcs)]
    ref = xpool.SessionPool(_cfg(xs), 32, frame_ms=20.0,
                            sources=srcs).read(4)
    got = _pool(_cfg(ts), 32, srcs).read(4)
    for i in range(32):
        assert _lsb(got[i], ref[i]) <= 1, i


def test_thread_safety_join_leave_during_reads():
    """One thread reads while another churns join/leave/seek on other
    slots: no exception, one shape, a slot left last stays silent."""
    K = 4
    srcs = _voices(K, seconds=0.4, seed=6)
    p = _pool(_cfg(ts), K, srcs)
    errs: list = []
    stop = threading.Event()

    def churn():
        try:
            for i in range(30):
                s = 1 + (i % (K - 1))
                p.leave(s)
                p.seek(0, 40.0 * (i % 3))
                p.join(s, srcs[s])
            p.leave(K - 1)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=churn)
    t.start()
    outs = []
    while not stop.is_set():
        outs.append(p.read(4))
    t.join(60.0)
    assert not t.is_alive() and not errs, errs
    assert all(o.shape == outs[0].shape for o in outs)
    p.seek(0, 0.0)
    out = p.read(4)
    assert np.all(out[K - 1] == 0) and np.any(out[0] != 0)


def test_public_pool_wrapper(monkeypatch):
    srcs = _voices(2, seconds=0.3)
    p = PublicPool(_cfg(ts), 2, frame_ms=20.0, sources=srcs, device="cpu")
    assert (p.n_slots, p.frame_out, p.sr) == (2, 320, SR)
    assert p.read(2).shape == (2, 640, 1)
    p.leave(1)
    assert p.active() == [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        PublicPool(_cfg(ts), 2, frame_ms=20.0, sources=srcs)


def test_gather_negative_clock_and_short_clips():
    """The batched window gather at its edges, against the JAX pool
    (1 LSB): tracks placed late (negative source indices for the first
    frames), a looped track placed late (a floor modulo of a negative
    index), and clips shorter than one window (each window straddles
    the clip's start and its end), at the bus rate and resampled."""
    cfgs = [S.PipelineConfig(
        tracks=(S.TrackConfig(url="v", start_time_ms=30.0),
                S.TrackConfig(url="b", kind="bgm", loop=True,
                              start_time_ms=10.0, volume=0.5),
                S.TrackConfig(url="c", kind="music", start_time_ms=5.0)),
        sample_rate=SR, normalize=None) for S in (xs, ts)]
    rng = np.random.default_rng(12)

    def noise(n):
        return (0.3 * rng.standard_normal(n)).astype(np.float32)

    srcs = [{"v": (noise(int(44100 * s)), 44100), "b": (noise(nb), SR),
             "c": (noise(nc), 44100)}
            for s, nb, nc in ((0.5, 100, 500), (0.3, 700, 1500))]
    ref = xpool.SessionPool(cfgs[0], 2, frame_ms=20.0, sources=srcs)
    got = _pool(cfgs[1], 2, srcs)
    for _ in range(2):
        assert _lsb(got.read(4), ref.read(4)) <= 1
    for i, s in enumerate(srcs):
        sess = tstream.StreamSession(cfgs[1], frame_ms=20.0, sources=s,
                                     device="cpu")
        got.seek(i, 0.0)
        assert _lsb(got.read(3)[i], sess.read_many(3)) <= 1
