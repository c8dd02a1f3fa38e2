"""Parity of the port's serving front end (``xmtpu_torch.graph.serve``,
``xmtpu_torch.PoolServer``) with the JAX package's ``PoolServer``, on the
CPU (``device="cpu"``).

One size: effect-free 16 kHz configs (a 30 ms fade-in, volume 1 or
0.5), voices of 0.2-0.9 s at the bus rate clipped to +-0.9, 20 ms
frames, pools of 1-4 slots. Served frames are held against the JAX
package's ``StreamSession`` and ``PoolServer`` on the same inputs,
within 1 LSB of int16; the rest are the server's own rules: buckets,
pool growth, end of stream, seeks, the laggard refusal, power-of-two
pump sizes, idle pools, threads.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from xmtpu.config import schema as xs
from xmtpu.graph import serve as xserve
from xmtpu.graph import streaming as xstream
from xmtpu_torch import PoolServer
from xmtpu_torch.config import schema as ts
from xmtpu_torch.graph import pool as tpool
from xmtpu_torch.parallel import Mesh
from xmtpu_torch.utils.errors import ConfigError, DeviceError, XmtpuError

SR = 16000


def _cfg(S=ts, volume: float = 1.0, loop: bool = False):
    return S.PipelineConfig(
        tracks=(S.TrackConfig(url="v", volume=volume, fade_in_ms=30.0,
                              loop=loop),),
        sample_rate=SR, normalize=None)


_SEEDS = iter(range(1000, 100000))


def _src(seconds: float = 0.5) -> dict:
    rng = np.random.default_rng(next(_SEEDS))
    pcm = (0.3 * rng.standard_normal(int(SR * seconds))).astype(np.float32)
    return {"v": (pcm.clip(-0.9, 0.9), SR)}


def _jax_frames(src, n, cfg=None):
    sess = xstream.StreamSession(cfg or _cfg(xs), frame_ms=20.0, sources=src)
    return np.concatenate([sess.read() for _ in range(n)], axis=0)


def _lsb(got, ref):
    return int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())


def _server(**kw):
    return PoolServer(frame_ms=20.0, device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    return _server(n_slots=2, max_seconds=1.0)


def test_read_matches_jax_session(server):
    srcs = [_src(), _src()]
    sids = [server.open(_cfg(), s) for s in srcs]
    got = server.read(sids[1], 4)
    assert _lsb(got, _jax_frames(srcs[1], 4)) <= 1
    # sid 0 advanced in the same groups: its frames drain without a
    # further pool advance
    s0 = server._sessions[sids[0]]
    fi = int(s0.pool._frame_idx[s0.slot])
    got0 = server.read(sids[0], 4)
    assert _lsb(got0, _jax_frames(srcs[0], 4)) <= 1
    assert int(s0.pool._frame_idx[s0.slot]) == fi
    for sid in sids:
        server.close(sid)


def test_churn_matches_jax_server():
    """One sequence of open, read, pump, seek and close on both servers:
    every returned frame within 1 LSB."""
    srcs = [_src(0.6), _src(0.6), _src(0.4)]
    outs = []
    for srv, S in ((xserve.PoolServer(n_slots=2, frame_ms=20.0,
                                      max_seconds=1.0), xs),
                   (_server(n_slots=2, max_seconds=1.0), ts)):
        o = []
        a, b = srv.open(_cfg(S), srcs[0]), srv.open(_cfg(S), srcs[1])
        c = srv.open(_cfg(S, volume=0.5), srcs[2])  # its own bucket
        o.append(srv.read(a, 3))
        o.extend(srv.pump(2)[k] for k in (a, b, c))
        srv.seek(b, 60.0)
        srv.close(a)
        d = srv.open(_cfg(S), srcs[2])  # a's slot again
        o.extend(srv.pump(4)[k] for k in (b, c, d))
        o.append(srv.read(d, 5))
        outs.append(o)
    for ref, got in zip(*outs):
        assert got.shape == ref.shape and _lsb(got, ref) <= 1


def test_pump_drains_every_session(server):
    sids = [server.open(_cfg(), _src()) for _ in range(2)]
    out = server.pump(2)
    assert set(out) == set(sids)
    for sid in sids:
        assert out[sid].shape[0] == 2 * server._sessions[sid].pool.frame_out
        assert np.any(out[sid] != 0)
    assert server.pump(1).keys() == set(sids)
    for sid in sids:
        server.close(sid)
    assert server.pump(1) == {}


def test_eos_short_tail_then_none(server):
    # 0.205 s at 20 ms frames = 10 frames and a 5 ms tail frame
    sid = server.open(_cfg(), _src(seconds=0.205))
    got = server.read(sid, 64)
    assert got.shape[0] == 11 * server._sessions[sid].pool.frame_out
    assert server.at_end(sid)
    assert server.read(sid) is None
    server.close(sid)


def test_seek_drops_stale_buffer(server):
    src = _src()
    sids = [server.open(_cfg(), src), server.open(_cfg(), _src())]
    server.read(sids[1], 3)  # sid 0 buffers 3 frames
    server.seek(sids[0], 0.0)
    assert server.stats()["buffered_frames"][sids[0]] == 0
    assert _lsb(server.read(sids[0], 2), _jax_frames(src, 2)) <= 1
    for sid in sids:
        server.close(sid)


def test_close_frees_slot_for_reuse(server):
    a = server.open(_cfg(), _src())
    b = server.open(_cfg(), _src())
    pools_before = server.stats()["pools"]
    server.close(a)
    c = server.open(_cfg(), _src())
    assert server.stats()["pools"] == pools_before
    assert np.any(server.read(c, 1) != 0)
    with pytest.raises(XmtpuError, match="unknown session"):
        server.read(a)
    server.close(b)
    server.close(c)


def test_per_client_files_share_one_pool(server):
    """Same pipeline, another url: one pool, the joiner's audio re-keyed
    by the pool's urls (its frames equal a JAX session of its own
    source)."""
    cfg_w = ts.PipelineConfig(
        tracks=(ts.TrackConfig(url="w", volume=1.0, fade_in_ms=30.0),),
        sample_rate=SR, normalize=None)
    src_w = {"w": _src()["v"]}
    a = server.open(_cfg(), _src())
    pools_before = server.stats()["pools"]
    b = server.open(cfg_w, src_w)
    assert server.stats()["pools"] == pools_before
    assert server._sessions[a].pool is server._sessions[b].pool
    cfg_wj = xs.PipelineConfig(
        tracks=(xs.TrackConfig(url="w", volume=1.0, fade_in_ms=30.0),),
        sample_rate=SR, normalize=None)
    assert _lsb(server.read(b, 3), _jax_frames(src_w, 3, cfg_wj)) <= 1
    server.close(a)
    server.close(b)


def test_heterogeneous_configs_bucket_separately(server):
    src = _src()
    a = server.open(_cfg(volume=1.0), src)
    b = server.open(_cfg(volume=0.5), src)
    assert server.stats()["buckets"] >= 2
    ga = server.read(a, 2).astype(np.float64)
    gb = server.read(b, 2).astype(np.float64)
    assert np.abs(gb - 0.5 * ga).max() <= 1.0  # rounding of each side
    server.close(a)
    server.close(b)
    assert server.release_idle_pools() >= 1


def test_pool_growth_capacity_and_laggard():
    srv = _server(n_slots=1, max_buffer_frames=2)
    a = srv.open(_cfg(), _src(seconds=0.3))
    b = srv.open(_cfg(), _src(seconds=0.3))  # full -> a second pool
    assert srv.stats()["pools"] == 2
    srv.close(a)
    c = srv.open(_cfg(), _src(seconds=0.9))  # past the free slot's capacity
    assert srv.stats()["pools"] == 3
    assert np.any(srv.read(c, 1) != 0)
    srv.close(b)
    srv.close(c)
    srv2 = _server(n_slots=2, max_buffer_frames=2)
    x = srv2.open(_cfg(), _src())
    y = srv2.open(_cfg(), _src())
    srv2.read(x, 2)  # y holds 2 unread frames, the cap
    with pytest.raises(XmtpuError, match=f"session {y} .*unread frames"):
        srv2.read(x, 1)
    srv2.read(y, 2)
    assert np.any(srv2.read(x, 1) != 0)


def test_duplicate_file_urls_decode_once(server, tmp_path, monkeypatch):
    from xmtpu_torch.graph import pipeline as tpipe
    from xmtpu_torch.io import write_wav

    rng = np.random.default_rng(3)
    p = str(tmp_path / "bed.wav")
    write_wav(p, (6000 * rng.standard_normal(SR // 2)).clip(
        -32768, 32767).astype(np.int16), SR)
    cfg = ts.PipelineConfig(
        tracks=(ts.TrackConfig(url=p, volume=0.5),
                ts.TrackConfig(url=p, volume=0.5)),
        sample_rate=SR, normalize=None)
    n = []
    real_open = tpipe.open_audio
    monkeypatch.setattr(tpipe, "open_audio",
                        lambda url: (n.append(url), real_open(url))[1])
    sid = server.open(cfg, None)
    assert len(n) == 1
    got = server.read(sid, 2)
    assert got is not None and np.any(got != 0)
    server.close(sid)


def test_buffered_frames_do_not_pin_group_buffer(server):
    sids = [server.open(_cfg(), _src()) for _ in range(2)]
    server.read(sids[1], 3)
    s0 = server._sessions[sids[0]]
    f = s0.pool.frame_out
    for frame in s0.frames:
        root = frame.base if frame.base is not None else frame
        assert root.ndim == 2
        assert root.nbytes <= 3 * f * frame.shape[1] * frame.itemsize
    for sid in sids:
        server.close(sid)


def test_thread_safety_open_close_during_reads():
    srv = _server(n_slots=4, max_seconds=1.0, max_buffer_frames=4096)
    r = srv.open(_cfg(loop=True), _src())
    errs: list = []
    stop = threading.Event()

    def churn():
        try:
            for i in range(20):
                sid = srv.open(_cfg(loop=True), _src())
                other = srv.open(_cfg(volume=0.5), _src())
                srv.seek(sid, 20.0 * (i % 3))
                srv.close(sid)
                srv.close(other)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=churn)
    t.start()
    outs = []
    while not stop.is_set():
        outs.append(srv.read(r, 2))
    t.join(60.0)
    assert not t.is_alive() and not errs, errs
    assert all(o.shape == outs[0].shape for o in outs)
    assert any(np.any(o != 0) for o in outs)
    assert srv.stats()["sessions"] == 1
    srv.close(r)


def test_open_rejects_bad_inputs(server):
    with pytest.raises(ConfigError, match="no tracks"):
        server.open(ts.PipelineConfig(sample_rate=SR), None)
    with pytest.raises(ConfigError, match="PipelineConfig or dict"):
        server.open("nonsense", None)
    with pytest.raises(XmtpuError, match="unknown session"):
        server.seek(10**9, 0.0)
    with pytest.raises(ConfigError, match="max_buffer_frames"):
        server.read(0, k=10**6)
    with pytest.raises(ConfigError, match="max_buffer_frames"):
        server.pump(k=10**6)
    mesh = Mesh(["cpu"] * 2, ("dp",))
    with pytest.raises(ConfigError, match="divide evenly"):
        PoolServer(n_slots=3, mesh=mesh)
    with pytest.raises(ConfigError, match="no axis"):
        PoolServer(n_slots=2, mesh=mesh, mesh_axis="tp")


def test_server_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        PoolServer()


def test_read_pumps_power_of_two_group_sizes(monkeypatch):
    """Every pool read of a server read is a power of two (an 11-frame
    read ladders 8, 2, 1; the 14-frame tail too)."""
    srv = _server(n_slots=2, max_seconds=1.0)
    sizes = []
    real = tpool.SessionPool.read
    monkeypatch.setattr(tpool.SessionPool, "read",
                        lambda self, k=1: (sizes.append(k), real(self, k))[1])
    sid = srv.open(_cfg(), _src(seconds=0.5))  # 25 frames
    f = srv._sessions[sid].pool.frame_out
    assert srv.read(sid, 11).shape[0] == 11 * f
    assert sizes == [8, 2, 1]
    assert srv.read(sid, 1024).shape[0] == 14 * f
    assert all(v & (v - 1) == 0 for v in sizes), sizes
    srv.close(sid)


def test_pump_skips_laggard_pool_but_advances_others():
    srv = _server(n_slots=2, max_buffer_frames=2, max_seconds=1.0)
    lag = srv.open(_cfg(), _src())
    a2 = srv.open(_cfg(), _src())
    other = srv.open(_cfg(volume=0.5), _src())
    srv.read(a2, 2)
    out = srv.pump(1)
    assert other in out and lag in out and a2 not in out
    assert {lag, a2, other} <= set(srv.pump(1))
    for sid in (lag, a2, other):
        srv.close(sid)


def test_pump_costs_no_dispatch_when_all_ended():
    srv = _server(n_slots=2, max_seconds=1.0)
    sid = srv.open(_cfg(), _src(seconds=0.2))
    while srv.read(sid, 4) is not None:
        pass
    s = srv._sessions[sid]
    calls = []
    real_read = s.pool.read
    s.pool.read = lambda k=1: (calls.append(k), real_read(k))[1]
    assert srv.pump(1) == {} and srv.pump(1) == {}
    assert calls == []
    del s.pool.read
    srv.close(sid)


def test_open_upload_does_not_block_other_pools():
    srv = _server(n_slots=2, max_seconds=1.0)
    a = srv.open(_cfg(), _src())
    gate, entered = threading.Event(), threading.Event()
    real_pool = tpool.SessionPool

    class SlowPool(real_pool):
        def __init__(self, *args, **kw):
            entered.set()
            assert gate.wait(30.0), "test gate never opened"
            super().__init__(*args, **kw)

    tpool.SessionPool = SlowPool
    try:
        t = threading.Thread(
            target=lambda: srv.open(_cfg(volume=0.25), _src()))
        t.start()
        assert entered.wait(30.0)
        got = srv.read(a, 1)  # must not wait for the slow open
        assert got.shape[0] == srv._sessions[a].pool.frame_out
    finally:
        gate.set()
        t.join(60.0)
        tpool.SessionPool = real_pool
    assert not t.is_alive()
    assert srv.stats()["sessions"] == 2
    srv.close(a)


def test_open_failure_leaves_no_phantom_bucket(monkeypatch):
    srv = _server(n_slots=2, max_seconds=1.0)

    def boom(*a, **k):
        raise ConfigError("synthetic constructor failure")

    monkeypatch.setattr(tpool, "SessionPool", boom)
    for _ in range(3):
        with pytest.raises(ConfigError, match="synthetic"):
            srv.open(_cfg(), _src())
    st = srv.stats()
    assert st["buckets"] == 0 and st["pools"] == 0 and st["sessions"] == 0
