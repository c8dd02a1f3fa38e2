"""Parity of the port's file-batch runner (``xmtpu_torch.runner``) with
the JAX package's (``xmtpu.runner``) on the CPU: the port on
``device="cpu"`` (the kernels' plain twins), the JAX package with
``step_kw={"interpret": True}`` (Pallas in interpret mode), as its own
tests run it.

One signal-length set: int16 noise clips of 8,000-22,050 samples at
44.1 kHz (and one of 11,025 at 22.05 kHz), ``batch_size=2``, so the
manifest spans three buckets and four chunks; one clip carries a BGM at
48 kHz (aligned to the voice's rate on the host), one a BGM at 44.1 kHz.

Tolerance: every output WAV within 1 LSB and -80 dB of the JAX
package's. Between the port's own modes (pipelined, serial,
``decode_threads``): identical bytes. Also the guards: failure
isolation and resume, malformed manifests, the producer-crash and
writer-crash accounting, ``interpret`` refused on ``cuda``,
:class:`DeviceError` before any decode without a card, and a kernel
build or device error failing the run instead of its clips.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu import runner as xrunner
from xmtpu.io.wav import write_wav as x_write_wav
from xmtpu_torch import native as tnative
from xmtpu_torch import runner as trunner
from xmtpu_torch.io.wav import read_wav, write_wav
from xmtpu_torch.utils.errors import (ConfigError, DeviceError,
                                      KernelBuildError)

from .conftest import rms_db

SR_IN, SR_BUS = 44100, 16000
LENGTHS = (8000, 12000, 16000, 22050)


def _noise(rng, n):
    return (rng.standard_normal(n) * 9000).astype(np.int16)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Input WAVs and a manifest: LENGTHS at 44.1 kHz (clip 1 with a
    44.1 kHz BGM, clip 2 with a 48 kHz one), then 11,025 samples at
    22.05 kHz."""
    d = tmp_path_factory.mktemp("runner_in")
    rng = np.random.default_rng(1414)
    jobs = []
    for i, n in enumerate(LENGTHS):
        p = d / f"in_{i}.wav"
        write_wav(p, _noise(rng, n), SR_IN)
        jobs.append({"voice": str(p), "out": f"out_{i}.wav"})
    t = np.arange(5000)
    write_wav(d / "bgm44.wav", (np.sin(t / 9.0) * 8000).astype(np.int16),
              SR_IN)
    write_wav(d / "bgm48.wav", (np.sin(t / 7.0) * 8000).astype(np.int16),
              48000)
    jobs[1]["bgm"] = str(d / "bgm44.wav")
    jobs[2]["bgm"] = str(d / "bgm48.wav")
    write_wav(d / "in_4.wav", _noise(rng, 11025), 22050)
    jobs.append({"voice": str(d / "in_4.wav"), "out": "out_4.wav"})
    return jobs


def _under(jobs, root):
    return [dict(j, out=str(root / j["out"])) for j in jobs]


def _outputs(jobs):
    outs = []
    for j in jobs:
        pcm, sr = read_wav(j["out"])
        assert sr == SR_BUS
        outs.append(pcm[:, 0])
    return outs


@pytest.fixture(scope="module")
def port_run(manifest, tmp_path_factory):
    """The port's pipelined run (the default) -> (jobs, report, outputs)."""
    jobs = _under(manifest, tmp_path_factory.mktemp("port"))
    rep = trunner.run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                            device="cpu")
    return jobs, rep, _outputs(jobs)


def test_run_batch_vs_jax(manifest, port_run, tmp_path):
    jobs_t, rep_t, outs_t = port_run
    jobs_j = _under(manifest, tmp_path)
    rep_j = xrunner.run_batch(jobs_j, sr_in=SR_IN, sr_bus=SR_BUS,
                              batch_size=2, step_kw={"interpret": True})
    assert rep_t.done == rep_j.done == 5 and not rep_t.failed
    assert not rep_j.failed
    assert rep_t.buckets == rep_j.buckets == 3
    assert rep_t.total == 5 and rep_t.audio_sec == pytest.approx(
        rep_j.audio_sec)
    for i, (a, b) in enumerate(zip(outs_t, _outputs(jobs_j))):
        assert a.shape == b.shape, i
        lsb = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
        db = rms_db(a.astype(np.float64) - b, b.astype(np.float64))
        print(f"clip {i} ({a.shape[0]} samples): {lsb} LSB, {db:.1f} dB")
        assert lsb <= 1 and db <= -80.0
    # ceil(n * L / M) per clip
    for j, n, rate in zip(jobs_t, LENGTHS + (11025,), (SR_IN,) * 4 + (22050,)):
        g = np.gcd(rate, SR_BUS)
        assert read_wav(j["out"])[0].shape[0] == -(-(n * (SR_BUS // g))
                                                   // (rate // g))


@pytest.mark.parametrize("mode", ["serial", "decode_threads=3"])
def test_modes_write_identical_bytes(manifest, port_run, tmp_path, mode):
    """Serial (with ``interpret=True``, the twins on the CPU) and
    threaded decode write the pipelined run's bytes."""
    jobs = _under(manifest, tmp_path)
    kw = (dict(pipeline=False, step_kw={"interpret": True})
          if mode == "serial" else dict(decode_threads=3))
    rep = trunner.run_batch(jobs, sr_in=SR_IN, sr_bus=SR_BUS, batch_size=2,
                            device="cpu", **kw)
    assert rep.done == 5 and not rep.failed and rep.buckets == 3
    for a, b in zip(jobs, port_run[0]):
        assert open(a["out"], "rb").read() == open(b["out"], "rb").read()


def test_resume_skips_done_clips(port_run):
    """The pipelined run wrote a marker per clip: a re-run steps none."""
    jobs, rep, _ = port_run
    assert all(os.path.exists(j["out"] + ".done") for j in jobs)
    again = trunner.run_batch(jobs, device="cpu")
    assert again.skipped_resume == 5 and again.done == 0 and not again.failed
    assert rep.peak_hbm_bytes is None  # the CPU reports no device memory
    assert "peak_hbm_bytes" in json.loads(rep.to_json())


@pytest.fixture()
def clip(tmp_path):
    p = tmp_path / "v.wav"
    write_wav(p, _noise(np.random.default_rng(7), 8000), SR_IN)
    return str(p)


@pytest.mark.parametrize("pipeline", [True, False])
def test_failure_isolation(tmp_path, clip, pipeline):
    """An undecodable clip and an unwritable output fail alone, in both
    modes; the good clip is written and a re-run retries only the
    failures."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFgarbage")
    jobs = [{"voice": clip, "out": str(tmp_path / "ok.wav")},
            {"voice": str(bad), "out": str(tmp_path / "obad.wav")},
            {"voice": clip, "out": str(tmp_path / "no_dir" / "x.wav")}]
    rep = trunner.run_batch(jobs, batch_size=2, pipeline=pipeline,
                            device="cpu")
    assert rep.done == 1 and len(rep.failed) == 2, rep
    failed = dict(rep.failed)
    assert "write failed" in failed[jobs[2]["out"]]
    assert jobs[1]["out"] in failed
    assert read_wav(tmp_path / "ok.wav")[0].size > 0
    rep2 = trunner.run_batch(jobs[:2], pipeline=pipeline, device="cpu")
    assert rep2.skipped_resume == 1 and rep2.done == 0
    assert len(rep2.failed) == 1


def test_malformed_manifest_and_arguments_raise(tmp_path, clip):
    """A bad manifest or a bad argument fails the run, typed, before any
    decode, as in the JAX package."""
    from xmtpu.utils.errors import ConfigError as XConfigError

    cases = [
        (("not a list",), {}, "list"),
        (([{"out": "x.wav"}],), {}, "voice"),
        ((["a string"],), {}, "voice"),
        (([{"voice": "v.wav", "out": "o.wav", "vioce": "t"}],), {},
         "unknown key"),
        (([{"voice": clip, "out": 3}],), {}, "'out' must be a path"),
        (([],), {"decode_threads": 0}, "decode_threads"),
        (([],), {"sr_in": 44101}, "unreasonable"),
    ]
    for bad in (0, -16000, 8_388_608):
        cases.append((([{"voice": clip, "out": "o.wav"}],),
                      {"sr_bus": bad}, "unreasonable"))
    for args, kw, match in cases:
        with pytest.raises(ConfigError, match=match):
            trunner.run_batch(*args, device="cpu", **kw)
        with pytest.raises(XConfigError, match=match):
            xrunner.run_batch(*args, **kw)


def test_per_clip_rate_failure_and_generators(tmp_path, clip):
    """A clip whose header rate gives an unreasonable ratio fails alone;
    a generator manifest runs; an empty one reports nothing."""
    weird = tmp_path / "weird.wav"
    write_wav(weird, np.ones(8000, np.int16), 44123)
    jobs = ({"voice": v, "out": str(tmp_path / f"o{i}.wav")}
            for i, v in enumerate((clip, str(weird))))
    rep = trunner.run_batch(jobs, device="cpu")
    assert rep.total == 2 and rep.done == 1
    assert len(rep.failed) == 1 and "unreasonable" in rep.failed[0][1]
    empty = trunner.run_batch([], device="cpu")
    assert empty.total == 0 and not empty.failed


def test_producer_crash_accounted(tmp_path, clip, monkeypatch):
    """A decode-stage crash outside the per-clip isolation (the ring's
    put failing) fails every job not yet published."""
    jobs = [{"voice": clip, "out": str(tmp_path / f"o{i}.wav")}
            for i in range(3)]
    calls = {"n": 0}
    real_put = tnative.PcmChannel.put

    def boom(self, arrays, meta):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise MemoryError("simulated publish failure")
        return real_put(self, arrays, meta)

    monkeypatch.setattr(tnative.PcmChannel, "put", boom)
    rep = trunner.run_batch(jobs, resume=False, device="cpu")
    assert rep.total == 3 and rep.done == 1 and len(rep.failed) == 2
    assert all("decode stage failed" in msg for _, msg in rep.failed)


def test_writer_crash_does_not_hang(tmp_path, clip, monkeypatch):
    """A crash of the write stage outside its per-job isolation fails the
    chunk's jobs; the run ends."""
    jobs = [{"voice": clip, "out": str(tmp_path / f"o{i}.wav")}
            for i in range(2)]

    def boom(*a, **kw):
        raise RuntimeError("synthetic write-stage failure")

    monkeypatch.setattr(trunner, "_write_chunk", boom)
    rep = trunner.run_batch(jobs, batch_size=2, device="cpu")
    assert rep.done == 0 and len(rep.failed) == 2
    assert all("write stage failed" in msg for _, msg in rep.failed)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("error", [KernelBuildError, DeviceError])
def test_fatal_errors_fail_the_run(tmp_path, clip, monkeypatch, pipeline,
                                   error):
    """A kernel build or device error is the run's, not 3 failed clips."""
    def broken(self, rate, edge, chunk):
        raise error("synthetic")

    monkeypatch.setattr(trunner._Dispatcher, "dispatch", broken)
    jobs = [{"voice": clip, "out": str(tmp_path / f"o{i}.wav")}
            for i in range(3)]
    with pytest.raises(error, match="synthetic"):
        trunner.run_batch(jobs, batch_size=2, pipeline=pipeline,
                          device="cpu")


def test_device_rules(tmp_path, clip, monkeypatch):
    """Without a card and without ``device=``, DeviceError before any
    decode; ``interpret=True`` is refused on ``cuda`` (the twins run on
    the CPU only), also before any decode."""
    decoded = []
    monkeypatch.setattr(trunner, "_decode_job",
                        lambda *a: decoded.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [{"voice": clip, "out": str(tmp_path / "o.wav")}]
    with pytest.raises(DeviceError, match="no CUDA device"):
        trunner.run_batch(jobs)
    with pytest.raises(ConfigError, match="interpret"):
        trunner.run_batch(jobs, device="cuda", step_kw={"interpret": True})
    assert not decoded and not os.path.exists(tmp_path / "o.wav")


def test_step_cache_and_bands(tmp_path):
    """A bands list in ``step_kw`` hashes into the step cache key; one
    step per (rate, bus rate, keywords, device)."""
    bands = [{"freq_hz": 300.0, "gain_db": 3.0, "q": 1.0}]
    key = trunner._freeze_kw({"bands": bands, "fused": None})
    assert key == xrunner._freeze_kw({"bands": bands, "fused": None})
    hash(key)
    d = trunner._Dispatcher(SR_BUS, {"bands": bands}, torch.device("cpu"))
    s1, s2 = d.step_for(22050), d.step_for(22050)
    assert s1 is s2 and s1 is not d.step_for(44100)
    assert s1.sr_in == 22050


def test_helpers_match_jax():
    """Bucket edges and the mono int16 downmix (every dtype by the
    channel mean) equal the JAX package's."""
    for n in (1, 16384, 16385, 44100, 441000, 4_410_000):
        assert trunner._bucket_edge(n) == xrunner._bucket_edge(n)
    st = (np.random.default_rng(3).standard_normal((1000, 2)) * 8000
          ).astype(np.int16)
    for src in ((st, SR_IN), (st.astype(np.float32) / 32768.0, SR_IN),
                st[:, 0].copy()):
        a, ra = trunner._load_mono_i16(src, SR_IN)
        b, rb = xrunner._load_mono_i16(src, SR_IN)
        assert ra == rb and a.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    a, _ = trunner._load_mono_i16((st, SR_IN), SR_IN)
    f, _ = trunner._load_mono_i16((st.astype(np.float32) / 32768.0, SR_IN),
                                  SR_IN)
    assert np.abs(a.astype(np.int32) - f.astype(np.int32)).max() <= 1


def test_wav_inputs_written_by_either_package(tmp_path):
    """A WAV the JAX package writes decodes to the same clip in the
    port's runner (the host decode of both packages)."""
    x = _noise(np.random.default_rng(5), 3000)
    x_write_wav(str(tmp_path / "j.wav"), x, SR_IN)
    job = trunner.ClipJob(voice=str(tmp_path / "j.wav"), out="o.wav")
    v, b, rate = trunner._decode_job(job, SR_IN, SR_BUS)
    assert rate == SR_IN and b is None
    np.testing.assert_array_equal(v, x)
    assert xmtpu_torch.run_batch is trunner.run_batch
