"""The port's data parallelism on the CPU, over 4 virtual shards
(``Mesh(["cpu"] * 4, ...)``): the mesh and its split / concat /
exchange helpers, ``batch.shard_over_batch`` and
``batch.flagship_step_sharded``, ``SessionPool(mesh=)`` and
``PoolServer(mesh=)``, and ``parallel.dryrun.dryrun_multichip``.

Each sharded path is held against its unsharded form in the port: the
sharded flagship step within 1 LSB (the same work per row; the fftconv
kernel's CPU twin, ``torch.fft``, rounds by batch shape), the sharded
pool bit for bit on the scans, slots after
leave/join/seek and served streams against a ``StreamSession`` (1 LSB).
One size: clips of 4410 samples at 44.1 kHz (the JAX dryrun's), voices
of 0.4 s at 16 kHz.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xmtpu_torch import batch as tbatch
from xmtpu_torch.graph import pool as tpool
from xmtpu_torch.graph.serve import PoolServer
from xmtpu_torch.graph.streaming import StreamSession
from xmtpu_torch.parallel import Mesh
from xmtpu_torch.parallel import mesh as tmesh
from xmtpu_torch.entry import example_batch
from xmtpu_torch.parallel.dryrun import dryrun_multichip
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR = 16000
CFG = {"tracks": [{"url": "v", "fadeInTimeMs": 30.0}], "sampleRate": SR,
       "normalize": None,
       "effects": [{"name": "equalizer", "bands": [
           {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]},
           {"name": "limiter"}]}


def _voices(k, seed=2):
    rng = np.random.default_rng(seed)
    return [{"v": ((0.3 * rng.standard_normal(int(0.4 * SR) + 160 * i))
                   .astype(np.float32), SR)} for i in range(k)]


def _clips(batch):
    return (torch.from_numpy(a) for a in example_batch(batch, 4410))


@pytest.fixture(scope="module")
def dp4():
    return Mesh(["cpu"] * 4, ("dp",))


def test_mesh_split_concat_and_exchanges():
    m = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2), ("dp", "sp"))
    assert m.shape == {"dp": 2, "sp": 2} and m.axis_names == ("dp", "sp")
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    x = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    blocks = m.split(x, ("dp", None, "sp"))
    assert blocks.shape == (2, 2)
    assert torch.equal(blocks[1, 0], x[2:, :, :4])
    assert torch.equal(m.concat(blocks, ("dp", None, "sp"), "cpu"), x)
    # a mesh axis the spec does not name replicates: index 0's is taken
    rep = m.split(x, ("dp",))
    assert torch.equal(rep[0, 0], rep[0, 1])
    assert torch.equal(m.concat(rep, ("dp",), "cpu"), x)
    # shard_map refuses an uneven split; nothing is padded
    with pytest.raises(ValueError, match="divide evenly"):
        m.split(x, (None, "dp"))
    with pytest.raises(ValueError, match="no axis"):
        m.split(x, ("tp",))
    # rows scope the exchanges to one axis
    out = m.map_rows(blocks, "sp", lambda parts, devs: tmesh.shift_right(
        parts, devs))
    assert torch.equal(out[1, 1], blocks[1, 0])
    assert not out[1, 0].any() and not out[0, 0].any()
    g = tmesh.all_gather([torch.tensor([1.0]), torch.tensor([2.0])], "cpu")
    assert g.tolist() == [[1.0], [2.0]]


def test_mesh_on_cards_needs_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        Mesh(["cuda:0"] * 4, ("sp",))
    with pytest.raises(DeviceError):
        tbatch.shard_over_batch(2)
    with pytest.raises(DeviceError):
        dryrun_multichip(2)
    mesh, spec = tbatch.shard_over_batch(4, device="cpu")
    assert mesh.shape == {"dp": 4} and spec == ("dp", None)


def test_flagship_step_sharded_equals_unsharded(dp4):
    v, b = _clips(8)
    got = tbatch.flagship_step_sharded(dp4, iir_backend="pallas")(v, b)
    ref = tbatch.make_flagship_step(device="cpu")(v, b)
    assert got.shape == (8, 1600) and got.dtype == torch.int16
    err = int((got.int() - ref.int()).abs().max())
    db = refs.db(got, ref)
    print(f"sharded step (8 clips, 4 shards): max abs {err}, {db:.1f} dB")
    assert err <= 1  # the CPU twin's torch.fft rounds by batch shape
    with pytest.raises(ConfigError, match="device"):
        tbatch.flagship_step_sharded(dp4, device="cpu")


def test_flagship_step_sharded_takes_the_global_batch_branch(dp4):
    """128 clips over 4 shards of 32: the fused branch, as unsharded (a
    shard alone would take the unfused one)."""
    step = tbatch.flagship_step_sharded(dp4)
    assert step.fused_for(128) and not step.fused_for(127)
    v, b = _clips(128)
    got = step(v, b)
    assert {k[1] for k in step._steps} == {True}
    assert len(step._steps) == 1  # one step per distinct device
    ref = tbatch.make_flagship_step(device="cpu")(v, b)
    err = int((got.int() - ref.int()).abs().max())
    db = refs.db(got, ref)
    print(f"sharded fused step (128 clips): max abs {err}, {db:.1f} dB")
    assert err <= 1


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_sharded_pool_equals_unsharded(dp4, engine):
    srcs = _voices(8)
    kw = dict(frame_ms=20.0, sources=srcs, effects_backend=engine)
    p1 = tpool.SessionPool(CFG, 8, device="cpu", **kw)
    p4 = tpool.SessionPool(CFG, 8, mesh=dp4, **kw)
    assert [sh.device for sh in p4._shards] == [torch.device("cpu")] * 4
    for _ in range(2):  # two groups: the state carries across
        a, b = p1.read(3), p4.read(3)
        assert a.shape == b.shape == (8, 3 * 320, 1)
        if engine == "scan":
            np.testing.assert_array_equal(a, b)
        else:
            assert int(np.abs(a.astype(np.int32) - b).max()) <= 1


def test_sharded_pool_lifecycle_against_sessions(dp4):
    srcs = _voices(8)
    p = tpool.SessionPool(CFG, 8, frame_ms=20.0, sources=srcs, mesh=dp4)
    p.read(2)
    p.leave(5)
    p.join(6, srcs[2])
    p.seek(1, 100.0)
    got = p.read(4)
    assert not got[5].any()
    for slot, src, ms in ((6, srcs[2], 0.0), (1, srcs[1], 100.0)):
        s = StreamSession(CFG, frame_ms=20.0, sources=src, device="cpu")
        s.seek(ms)
        ref = s.read_many(4)
        assert int(np.abs(got[slot].astype(np.int32) - ref).max()) <= 1


def test_sharded_pool_snapshot_loads_unsharded_and_back(dp4, tmp_path):
    srcs = _voices(4)
    kw = dict(frame_ms=20.0, sources=srcs)
    p4 = tpool.SessionPool(CFG, 4, mesh=Mesh(["cpu"] * 2, ("dp",)), **kw)
    p4.read(3)
    p4.save_state(tmp_path / "a.npz")
    p1 = tpool.SessionPool(CFG, 4, device="cpu", **kw)
    p1.load_state_file(tmp_path / "a.npz")
    np.testing.assert_array_equal(p1.read(2), p4.read(2))
    p1.save_state(tmp_path / "b.npz")
    q4 = tpool.SessionPool(CFG, 4, mesh=Mesh(["cpu"] * 2, ("dp",)), **kw)
    q4.load_state_file(tmp_path / "b.npz")
    np.testing.assert_array_equal(q4.read(2), p1.read(2))
    for (_, a), (_, b) in zip(*(tpool.state_paths(p.states)
                               for p in (q4, p1))):
        assert torch.equal(a, b)


def test_pool_and_server_mesh_refusals(dp4):
    srcs = _voices(1)
    with pytest.raises(ConfigError, match="disagrees"):
        tpool.SessionPool(CFG, 4, sources=srcs, mesh=dp4, device="meta")
    with pytest.raises(ConfigError, match="divide evenly"):
        PoolServer(n_slots=6, mesh=dp4)


def test_server_with_mesh_serves_two_configs(dp4):
    srcs = _voices(3, seed=9)
    cfg_b = dict(CFG, tracks=[{"url": "v", "volume": 0.5}])
    srv = PoolServer(n_slots=4, frame_ms=20.0, max_seconds=1.0, mesh=dp4)
    sids = [(srv.open(c, sources=s), c, s)
            for c, s in ((CFG, srcs[0]), (cfg_b, srcs[1]), (CFG, srcs[2]))]
    assert srv.stats()["pools"] == 2
    for sid, cfg, src in sids:
        got = srv.read(sid, 3)
        ref = StreamSession(cfg, frame_ms=20.0, sources=src,
                            device="cpu").read_many(3)
        assert int(np.abs(got.astype(np.int32) - ref).max()) <= 1


def test_dryrun_multichip_on_virtual_cpu_shards(capsys):
    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    for leg in ("dp OK", "sp OK", "pool OK", "serve OK", "dp x sp OK"):
        assert leg in out, out
    with pytest.raises(ValueError, match="unknown legs"):
        dryrun_multichip(2, device="cpu", legs=("tp",))
