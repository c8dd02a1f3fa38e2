"""Parity of the port's streaming session (``xmtpu_torch.graph.streaming``,
``xmtpu_torch.Session``) with the JAX package's ``StreamSession``, on
the CPU: the port on ``device="cpu"`` (the float64 scan engine unless an
effect names a backend), the JAX package as its own tests run it.

One size: a 2 s voice at 44.1 kHz (resampled to the 16 kHz bus) over a
1 s looped BGM at the bus rate, 20 ms frames (320 samples). Gates:
float32 output at -120 dB against the JAX session, int16 output within
1 LSB; the port's session against the port's offline mixer at -80 dB
(the JAX package's streaming == offline invariant). Also the state: the
in-memory resume, state files in both directions between the packages,
the legacy noise-suppression counter and the refusal of any other
widening.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from xmtpu.config import schema as xs
from xmtpu.graph import streaming as xstream
from xmtpu_torch import Session
from xmtpu_torch.config import schema as ts
from xmtpu_torch.graph import mixer as tmix
from xmtpu_torch.graph import streaming as tstream
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR = 16000
EQ_BANDS = [{"freq_hz": 120.0, "gain_db": 3.0, "q": 1.0},
            {"freq_hz": 2500.0, "gain_db": -2.0, "q": 1.0}]
GATE_F32_DB = -120.0


@pytest.fixture(scope="module")
def two_tracks():
    rng = np.random.default_rng(3)
    voice = (0.3 * rng.standard_normal(44100 * 2)).astype(np.float32)
    t = np.arange(SR) / SR
    bgm = (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    return {"voice": (voice, 44100), "bgm": (bgm, SR)}


def _chain(S):
    return (S.EffectConfig("equalizer", {"bands": EQ_BANDS}),
            S.EffectConfig("reverb", {"ir_seconds": 0.2, "wet": 0.25,
                                      "dry": 0.75}),
            S.EffectConfig("limiter", {"threshold_db": -6.0}))


def _config(S, case: str):
    """The JAX tests' session configs, built from schema module S."""
    voice = S.TrackConfig(url="voice", volume=0.9, fade_in_ms=50.0,
                          fade_out_ms=100.0)
    bgm = S.TrackConfig(url="bgm", kind="bgm", volume=0.4, loop=True)
    kw = dict(sample_rate=SR, normalize=None)
    if case == "mix":
        return S.PipelineConfig(tracks=(voice, bgm), **kw)
    if case == "master":
        return S.PipelineConfig(tracks=(voice, bgm),
                                master_effects=_chain(S), **kw)
    if case == "voice":
        return S.PipelineConfig(tracks=(voice, bgm), effects=_chain(S), **kw)
    if case == "duck":
        return S.PipelineConfig(
            tracks=(S.TrackConfig(url="voice", volume=0.9),
                    S.TrackConfig(url="bgm", kind="bgm", volume=0.4,
                                  loop=True, side_duck=True)), **kw)
    if case == "ns":  # noise suppression, EQ and limiter, ducked BGM
        return S.PipelineConfig(
            tracks=(S.TrackConfig(url="voice", volume=0.9),
                    S.TrackConfig(url="bgm", kind="bgm", volume=0.4,
                                  loop=True, side_duck=True)),
            effects=(S.EffectConfig("noise_suppression", {"nfft": 320}),
                     S.EffectConfig("equalizer", {"bands": EQ_BANDS})),
            master_effects=(S.EffectConfig("limiter", {}),), **kw)
    if case == "loop_trim":  # a looped BGM trimmed by end_time_ms
        return S.PipelineConfig(
            tracks=(S.TrackConfig(url="voice", kind="voice"),
                    S.TrackConfig(url="bgm", kind="bgm", loop=True,
                                  start_time_ms=0.0, end_time_ms=250.0)),
            **kw)
    raise ValueError(case)


DUCK = {"depth_db": 12.0, "threshold_db": -40.0, "attack_ms": 5.0,
        "release_ms": 50.0}


def _pair(case, src, dtype=np.float32, **kw):
    """(JAX session, port session) of one case."""
    duck = {"duck_params": DUCK} if case in ("duck", "ns") else {}
    j = xstream.StreamSession(_config(xs, case), frame_ms=20.0, sources=src,
                              output_dtype=dtype, **duck, **kw)
    t = tstream.StreamSession(_config(ts, case), frame_ms=20.0, sources=src,
                              output_dtype=dtype, device="cpu", **duck, **kw)
    return j, t


def _frames(sess, n):
    return np.concatenate([sess.read() for _ in range(n)], axis=0)


def _check(got, ref):
    if ref.dtype == np.int16:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
        assert d <= 1, d
    else:
        db = refs.db(got, ref)
        assert db <= GATE_F32_DB, db


@pytest.mark.parametrize("case,dtype", [
    ("mix", np.float32), ("master", np.float32), ("voice", np.float32),
    ("duck", np.float32), ("ns", np.float32), ("loop_trim", np.int16)])
def test_session_matches_jax(two_tracks, case, dtype):
    """100 frames (2 s) through both sessions; the port's frames equal
    the JAX package's at the gates."""
    j, t = _pair(case, two_tracks, dtype)
    assert t.frame_out == j.frame_out == 320
    ref, got = _frames(j, 100), _frames(t, 100)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    _check(got, ref)


def test_session_equals_offline_mixer(two_tracks):
    """The port's session == the port's mixer + master chain on the
    whole clip (-80 dB; the JAX package's invariant, here on the port)."""
    sess = tstream.StreamSession(_config(ts, "master"), frame_ms=20.0,
                                 sources=two_tracks,
                                 output_dtype=np.float32, device="cpu")
    got = _frames(sess, 100)[:, 0].astype(np.float64)
    voice, bgm = two_tracks["voice"][0], two_tracks["bgm"][0]
    out = tmix.mix([tmix.MixTrack(pcm=voice, sr=44100, gain=0.9,
                                  fade_in_ms=50.0, fade_out_ms=100.0),
                    tmix.MixTrack(pcm=bgm, sr=SR, gain=0.4, loop=True)],
                   SR, normalize=None, duration_ms=2000.0, device="cpu")
    from xmtpu_torch.graph import fx as tfx

    ref = tfx.apply_chain(out, SR, list(_chain(ts)), device="cpu")
    ref = np.asarray(ref[: len(got)], np.float64)
    assert refs.db(got, ref) <= -80.0


def test_seek_resume_and_read_many(two_tracks):
    """seek() repositions and resets (frame 5 again equals frame 5);
    load_state() resumes bit for bit; read_many(k) equals k reads,
    including after a read that engaged the prefetch."""
    cfg = _config(ts, "master")
    mk = lambda: tstream.StreamSession(cfg, frame_ms=20.0,  # noqa: E731
                                       sources=two_tracks,
                                       output_dtype=np.float32,
                                       device="cpu")
    s1 = mk()
    frames = [s1.read() for _ in range(10)]
    s1.seek(5 * 20.0)
    fresh = mk()
    fresh.seek(5 * 20.0)
    np.testing.assert_array_equal(s1.read(), fresh.read())
    s1.seek(0.0)
    assert np.array_equal(s1.read(), frames[0])
    st = s1.state
    nxt = s1.read()
    s2 = mk()
    s2.load_state(st)
    np.testing.assert_array_equal(s2.read(), nxt)
    seq = np.concatenate(frames, axis=0)
    s3 = mk()
    got = np.concatenate([s3.read(), s3.read_many(4), s3.read_many(5)])
    np.testing.assert_array_equal(got, seq)
    assert s3.frame_idx == 10


def test_prefetch_depth_matches_depth1(two_tracks):
    """Depth 4 (frames dispatched ahead, fetches started) equals depth
    1, across a seek that drops the frames ahead and the read ->
    read_many -> read transitions; depth 0 raises."""
    cfg = _config(ts, "master")
    s1 = tstream.StreamSession(cfg, frame_ms=20.0, sources=two_tracks,
                               device="cpu")
    s4 = tstream.StreamSession(cfg, frame_ms=20.0, sources=two_tracks,
                               prefetch_depth=4, device="cpu")
    for _ in range(7):
        np.testing.assert_array_equal(s4.read(), s1.read())
    s1.seek(310.0)
    s4.seek(310.0)
    for _ in range(3):
        np.testing.assert_array_equal(s4.read(), s1.read())
    np.testing.assert_array_equal(s4.read_many(3), s1.read_many(3))
    np.testing.assert_array_equal(s4.read(), s1.read())
    with pytest.raises(ConfigError, match="prefetch_depth"):
        tstream.StreamSession(cfg, frame_ms=20.0, sources=two_tracks,
                              prefetch_depth=0, device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_file_across_packages(two_tracks, tmp_path, direction):
    """A state file of either package restores in the other: the
    noise suppressor's dict, the float64 EQ and limiter states, the
    int32 counters and the duck envelope, in the JAX layout. The next
    frames of the restored session equal the saving session's."""
    j, t = _pair("ns", two_tracks, np.float32)
    p = str(tmp_path / "st.npz")
    if direction == "jax_to_port":
        _frames(j, 13)
        j.save_state(p)
        t.load_state_file(p)
        ref, got = _frames(j, 6), _frames(t, 6)
    else:
        _frames(t, 13)
        t.save_state(p)
        j.load_state_file(p)
        ref, got = _frames(t, 6), _frames(j, 6)
    assert t.frame_idx == j.frame_idx == 19
    _check(got, ref.astype(np.float64))


def test_jax_leaf_order_and_layout(two_tracks):
    """state_to_jax_leaves gives the JAX package's leaves: one count,
    order, shape and dtype."""
    import jax

    j, t = _pair("ns", two_tracks, np.float32)
    jl = jax.tree_util.tree_leaves(j.fx_state)
    tl = tstream.state_to_jax_leaves(t.fx_state)
    assert [(a.shape, np.dtype(a.dtype)) for a in jl] == \
        [(b.shape, b.dtype) for b in tl]


def test_legacy_scalar_ns_counter_loads(two_tracks):
    """The sanctioned widening: an NS state with one scalar lead-in
    counter (older snapshots) loads through load_state, as in the JAX
    package, and the next frame equals the uninterrupted one."""
    voice = two_tracks["voice"][0][: int(44100 * 0.8)]
    cfg = ts.PipelineConfig(
        tracks=(ts.TrackConfig(url="v"),),
        effects=(ts.EffectConfig("noise_suppression", {"nfft": 320}),),
        sample_rate=SR, normalize=None)
    src = {"v": (voice, 44100)}
    s1 = tstream.StreamSession(cfg, frame_ms=20.0, sources=src,
                               device="cpu")
    for _ in range(6):
        s1.read()
    st = dict(s1.state)
    nxt = s1.read()
    vfx = st["fx_state"][0]
    ns = dict(vfx[0], count=vfx[0]["count"][0].clone())  # (ch,) -> ()
    assert ns["count"].dim() == 0
    st["fx_state"] = ((ns,) + vfx[1:],) + st["fx_state"][1:]
    s2 = tstream.StreamSession(cfg, frame_ms=20.0, sources=src,
                               device="cpu")
    s2.load_state(st)
    np.testing.assert_array_equal(s2.read(), nxt)


def test_coerce_refuses_integer_leaf_off_the_counter():
    """The JAX package widens any integer leaf whose shape is a prefix
    of the template's; the port only the NS counter's path (ROADMAP
    Queue 3). Every other mismatch raises ConfigError."""
    import jax.numpy as jnp

    tmpl = torch.zeros((3, 2), dtype=torch.int32)
    saved = np.array([4, 5, 6], np.int32)
    assert xstream.coerce_legacy_state_leaf(
        saved, jnp.zeros((3, 2), jnp.int32)) is not None  # the fault
    got = tstream.coerce_legacy_state_leaf(saved, tmpl, (0, 0, "count"))
    np.testing.assert_array_equal(got, [[4, 4], [5, 5], [6, 6]])
    for path in [(0, 0, "lead"), (1, 2), (0, 0, "count", 0), ()]:
        with pytest.raises(ConfigError, match="leaf"):
            tstream.coerce_legacy_state_leaf(saved, tmpl, path)
    with pytest.raises(ConfigError, match="leaf"):  # float on the path
        tstream.coerce_legacy_state_leaf(
            saved.astype(np.float32), tmpl.float(), (0, 0, "count"))
    with pytest.raises(ConfigError, match="leaf"):  # not a prefix
        tstream.coerce_legacy_state_leaf(np.zeros(2, np.int32), tmpl,
                                         (0, 0, "count"))


def test_load_state_refusals(two_tracks, tmp_path):
    """A state of another chain refuses at restore (structure); a leaf
    of the right structure but another shape refuses (leaf); a file of
    another chain refuses too."""
    cfg = _config(ts, "mix")
    other = dataclasses.replace(cfg, master_effects=(
        ts.EffectConfig("volume", {"gain_db": -3.0}),
        ts.EffectConfig("limiter", {})))
    mk = lambda c: tstream.StreamSession(  # noqa: E731
        c, frame_ms=20.0, sources=two_tracks, output_dtype=np.float32,
        device="cpu")
    s1, s2 = mk(other), mk(cfg)
    s1.read()
    with pytest.raises(ConfigError, match="effects chain"):
        s2.load_state(s1.state)
    s3 = mk(other)
    st = dict(s1.state)
    lim = st["fx_state"][1][1]
    st["fx_state"] = (st["fx_state"][0], (st["fx_state"][1][0], (
        lim[0].reshape(1), lim[1])), st["fx_state"][2])
    with pytest.raises(ConfigError, match="leaf"):
        s3.load_state(st)
    p = str(tmp_path / "other.npz")
    s1.save_state(p)
    with pytest.raises(ConfigError, match="leaves"):
        s2.load_state_file(p)


def test_public_session_int16_and_device(two_tracks, monkeypatch):
    """xmtpu_torch.Session: int16 (frame, ch) frames, seek, state; no
    device and no card raises DeviceError."""
    s = Session(_config(ts, "mix"), frame_ms=20.0, sources=two_tracks,
                device="cpu")
    s.seek(100.0)
    f = s.read()
    assert f.dtype == np.int16 and f.shape == (320, 1)
    assert s.state["frame_idx"] == 6
    assert s.read_many(2).shape == (640, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        Session(_config(ts, "mix"), frame_ms=20.0, sources=two_tracks)


def test_voice_effects_apply_before_the_mix(two_tracks):
    """config.effects run on the voice bus before the BGM joins: a
    -100 dB volume on the voice leaves the BGM alone."""
    cfg = ts.PipelineConfig(
        tracks=(ts.TrackConfig(url="voice", volume=1.0),
                ts.TrackConfig(url="bgm", kind="bgm", volume=0.5,
                               loop=True)),
        effects=(ts.EffectConfig("volume", {"gain_db": -100.0}),),
        sample_rate=SR, normalize=None)
    sess = tstream.StreamSession(cfg, frame_ms=20.0, sources=two_tracks,
                                 output_dtype=np.float32, device="cpu")
    got = _frames(sess, 25)[:, 0].astype(np.float64)
    ref = 0.5 * two_tracks["bgm"][0][: len(got)].astype(np.float64)
    assert refs.db(got, ref) <= -80.0


def test_bench_config5_inputs_and_cli(monkeypatch):
    """--config=5: the JAX benchmark's draws and pipeline (the port's
    session on the CPU against the JAX session on them, 10 frames), and
    the option handling with the card faked absent."""
    from xmtpu_torch import bench

    src, pool = bench.config5_sources(seconds=0.5, pool_slots=2,
                                      pool_seconds=0.3)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(src["v"][0], (0.3 * rng.standard_normal(
        int(44100 * 0.5))).astype(np.float32))
    for slot in pool:
        np.testing.assert_array_equal(slot["v"][0], (0.3 * rng.standard_normal(
            int(44100 * 0.3))).astype(np.float32))
    cfg_j = xs.PipelineConfig(
        tracks=(xs.TrackConfig(url="v"),),
        master_effects=(xs.EffectConfig("equalizer", {"bands": [
            {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}),
            xs.EffectConfig("limiter", {})),
        sample_rate=16000, normalize=None)
    j = xstream.StreamSession(cfg_j, frame_ms=20.0, sources=src)
    t = tstream.StreamSession(bench.config5_config(), frame_ms=20.0,
                              sources=src, device="cpu")
    _check(_frames(t, 10), _frames(j, 10))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench._cli(["--config=5"])
    with pytest.raises(SystemExit, match="no other arguments"):
        bench._cli(["--config=5", "--batch=4"])
