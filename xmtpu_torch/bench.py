"""Throughput benchmark of the flagship chain on one CUDA GPU
(counterpart of the root ``bench.py``; same JSON keys), and of the JAX
harness's configs 1-3 and 5 (``--config=1|2|3|5``, counterparts of
``xmtpu.benchmarks.config1_resample``, ``config2_mix``,
``config3_effects`` and ``config5_streaming``).

    python -m xmtpu_torch.bench [--batch=256] [--clip_seconds=10]
        [--iters=20] [--resample_backend=mixfirst|pallas|rsmix]
        [--limiter_fuse=1] [--iir_backend=pallas|scan] [--envelope_block=0]
    python -m xmtpu_torch.bench --config=1|2|3 [--batch=...]
        [--clip_seconds=10] [--iters=20]
    python -m xmtpu_torch.bench --config=5
    python -m xmtpu_torch.bench --config=6

The keys are the root ``bench.py``'s. The step takes the branch the JAX
package's auto rule picks: fused at the default 256 clips, unfused
(segmented IIR and envelope) below 128, e.g. ``--batch=32`` (the JAX
harness's config 4); ``--iir_backend=scan`` runs the unfused branch's EQ
and limiter as float64 scans. Values the step refuses (an unknown
``--iir_backend`` or ``--resample_backend``, an ``--envelope_block``
that is not a power of two) raise its error before any work; an
unknown key exits with the list.

Prints one JSON line: ``metric``, ``value`` (audio-seconds per second
per GPU), ``unit``, ``vs_baseline`` (ratio to the 500x-realtime
target), ``accuracy_db`` (clip 0 against the float64 oracle) and
``device`` (the GPU's name). Time is taken with CUDA events around
``iters`` back-to-back steps after one warm-up step, so it includes any
gap the host leaves between kernels. There is no CPU fallback: without
a CUDA device the command fails.

``--config=1`` times 32 int16 mono clips of 10 s at 44.1 kHz
(``default_rng(0)`` noise x 9000) through ``pcm16_to_f32`` and the
resample kernel (K7) to 16 kHz, and beside it the same conversion by
the banded FP32 matmuls (``ops.resample.polyphase_resample``), the
TPU kernel's form (key ``banded_audio_sec_per_sec``). ``--config=2``
times the two-track mix at 16 kHz: two float32 tracks of 32 x 160000
(``0.3 * default_rng(0)`` noise), each through ``apply_gain_fade``
(gains 0.9 and 0.4, 250 ms fades), summed and peak-normalized to -1
dBFS per row. Both on the card, inputs made there once.

``--config=3`` times ``xmtpu_torch.effects`` on the JAX benchmark's
config-3 input, 16 stereo clips of 10 s at 48 kHz (float32 ``0.3 *
default_rng(0).standard_normal``, public layout (B, n, 2), on the card),
through 5-band EQ -> the 0.5 s synthetic IR at wet 0.3 / dry 0.7 ->
the default limiter, and prints the JAX benchmark's keys ``config``, ``desc`` and
``audio_sec_per_sec``, and ``device``.

``--config=5`` (no other arguments) times 20 ms streaming frames of
the JAX benchmark's config 5 (a 4 s voice at 44.1 kHz, ``0.3 *
default_rng(0)`` noise, on a 16 kHz mono bus; master EQ at 300 Hz +2
dB, then the limiter): ``ms_per_frame_sequential`` and
``ms_per_frame_depth3`` (``read()`` at prefetch depth 1 and 3),
``audio_sec_per_sec`` (``read_many(25)``), and the aggregate rate of a
32-slot ``SessionPool`` of 8 s voices read 50 frames at a time on the
float64 scan engine (``pool32_audio_sec_per_sec``, the JAX key) and on
the kernels (``pool32_pallas_audio_sec_per_sec``). Host clock: every
read returns host data.

``--config=6`` (counterpart of ``xmtpu.benchmarks.config6_file_batch``)
times the file-fed batch: 64 int16 WAV clips of 10 s at 44.1 kHz
(``default_rng(0)`` noise x 9000; FLAC where an FFmpeg backend is
registered, which the port has none of) written to a temporary
directory, then ``xmtpu_torch.runner.run_batch`` to 16 kHz WAVs: decode
on the host, the ragged step on the card, WAV writes on the host, wall
clock with all I/O. Two passes; ``audio_sec_per_sec`` is the warm one,
``cold_audio_sec_per_sec`` the first (the step's tables, the kernels'
build when not yet built). Any failed clip raises.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

TARGET_RT = 500.0  # x realtime per GPU
SR_IN = 44100


def make_inputs(batch: int, clip_seconds: float):
    """int16 voice (noise) and BGM (tone) clips, as the root bench.py
    makes them (numpy ``default_rng(0)``)."""
    n = int(SR_IN * clip_seconds)
    rng = np.random.default_rng(0)
    voice = (rng.standard_normal((batch, n)) * 9000).astype(np.int16)
    bgm = (np.sin(np.arange(n) / 50.0)[None].repeat(batch, 0) * 12000).astype(
        np.int16)
    return voice, bgm


def median_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def back_to_back_ms(fn, calls: int = 20) -> float:
    """CUDA-event time of ``calls`` back-to-back calls of ``fn``, per
    call: the kernel's time on the card without the wrapper's host time
    that one timed call also holds."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def replay_ms(fn) -> float:
    """``fn``'s time on the card: the median of CUDA-graph replays of one
    call, without the host time its launches take."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return median_ms(graph.replay)


def rms_db(err: np.ndarray, ref: np.ndarray) -> float:
    """RMS error in dB relative to the reference signal power."""
    p_err = float(np.mean(np.asarray(err, np.float64) ** 2))
    p_ref = float(np.mean(np.asarray(ref, np.float64) ** 2))
    return -np.inf if p_err == 0 else 10.0 * np.log10(p_err / max(p_ref, 1e-300))


def step_seconds(step, *args, iters: int):
    """(seconds per step, last output) over ``iters`` back-to-back
    ``step(*args)`` calls, timed with CUDA events after one warm-up."""
    y = step(*args)
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        y = step(*args)
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / 1000.0 / iters, y


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("xmtpu_torch.bench: no CUDA device")
    return torch.device("cuda")


def config1_inputs(batch: int = 32, seconds: float = 10.0) -> np.ndarray:
    """The JAX benchmark's config-1 input: (batch, n) int16 at 44.1 kHz."""
    n = int(SR_IN * seconds)
    return (np.random.default_rng(0).standard_normal((batch, n)) * 9000
            ).astype(np.int16)


def config1_step(x_i16: torch.Tensor, banded: bool = False) -> torch.Tensor:
    """Config 1's function: int16 rows -> float32 at 16 kHz, on the
    resample kernel, or (``banded``) on the banded FP32 matmuls."""
    from xmtpu_torch.kernels import resample as kres
    from xmtpu_torch.ops import convert
    from xmtpu_torch.ops import resample as ores

    x = convert.pcm16_to_f32(x_i16)
    if banded:
        return ores.polyphase_resample(x, SR_IN, 16000)
    return kres.resample(x, SR_IN, 16000)


def config1_resample(batch: int = 32, seconds: float = 10.0,
                     iters: int = 20) -> dict:
    """Config 1 (44.1k -> 16k polyphase + int16 -> float32) on the card:
    K7, and the banded matmuls beside it."""
    dev = _require_card()
    xd = torch.from_numpy(config1_inputs(batch, seconds)).to(dev)
    sec, _ = step_seconds(config1_step, xd, iters=iters)
    sec_b, _ = step_seconds(lambda v: config1_step(v, banded=True), xd,
                            iters=iters)
    return {"config": 1, "desc": "44.1k->16k polyphase + i16->f32",
            "audio_sec_per_sec": batch * seconds / sec,
            "banded_audio_sec_per_sec": batch * seconds / sec_b,
            "device": torch.cuda.get_device_name(dev)}


def config2_inputs(batch: int = 32, seconds: float = 10.0,
                   sr: int = 16000) -> tuple[np.ndarray, np.ndarray]:
    """The JAX benchmark's config-2 tracks: voice and BGM, (batch, n)
    float32 each."""
    n = int(sr * seconds)
    rng = np.random.default_rng(0)
    v = (0.3 * rng.standard_normal((batch, n))).astype(np.float32)
    b = (0.3 * rng.standard_normal((batch, n))).astype(np.float32)
    return v, b


def config2_step(v: torch.Tensor, b: torch.Tensor,
                 sr: int = 16000) -> torch.Tensor:
    """Config 2's function: gain and fade each track (0.9 and 0.4, 250 ms
    fades), sum, peak-normalize each row to -1 dBFS."""
    from xmtpu_torch.ops import mix as mops

    n = v.shape[-1]
    fade = int(0.25 * sr)
    out = (mops.apply_gain_fade(v, 0.9, fade, fade, length=n)
           + mops.apply_gain_fade(b, 0.4, fade, fade, length=n))
    peak = torch.amax(out.abs(), dim=-1, keepdim=True)
    return out * torch.where(peak > 0, mops.db_to_amp(-1.0) / peak, 1.0)


def config2_mix(batch: int = 32, seconds: float = 10.0, sr: int = 16000,
                iters: int = 20) -> dict:
    """Config 2 (two-track gain/fade/sum/peak normalize at 16 kHz) on
    the card."""
    dev = _require_card()
    v, b = (torch.from_numpy(a).to(dev)
            for a in config2_inputs(batch, seconds, sr))
    sec, _ = step_seconds(lambda x, y: config2_step(x, y, sr), v, b,
                          iters=iters)
    return {"config": 2, "desc": "2-track mix gain/fade/normalize",
            "audio_sec_per_sec": batch * seconds / sec,
            "device": torch.cuda.get_device_name(dev)}


def config3_chain(sr: int = 48000, linked_fuse: bool = False) -> list:
    """The JAX benchmark's config-3 chain: the 5-band EQ, the 0.5 s
    synthetic IR at wet 0.3 / dry 0.7, the default limiter."""
    from xmtpu_torch.batch import DEFAULT_BANDS
    from xmtpu_torch.ops.reverb import synthetic_ir

    return [
        {"name": "equalizer", "params": {"bands": list(DEFAULT_BANDS)}},
        {"name": "reverb", "params": {
            "ir": synthetic_ir(0.5, sr).astype(np.float32), "wet": 0.3,
            "dry": 0.7}},
        {"name": "limiter",
         "params": {"linked_fuse": True} if linked_fuse else {}},
    ]


def config3_inputs(batch: int = 16, seconds: float = 10.0,
                   sr: int = 48000):
    """The JAX benchmark's config-3 input (B, n, 2) float32 and chain."""
    n = int(sr * seconds)
    x = (0.3 * np.random.default_rng(0).standard_normal((batch, n, 2))
         ).astype(np.float32)
    return x, config3_chain(sr)


def config3_effects(batch: int = 16, seconds: float = 10.0,
                    sr: int = 48000, iters: int = 20) -> dict:
    """Config 3 through the public ``xmtpu_torch.effects`` entry, input
    and output on the card (``device_out``)."""
    from xmtpu_torch import effects

    dev = _require_card()
    x, chain = config3_inputs(batch, seconds, sr)
    xd = torch.from_numpy(x).to(dev)
    sec, _ = step_seconds(
        lambda: effects(xd, sr, chain, device=dev, device_out=True),
        iters=iters)
    return {"config": 3, "desc": "stereo 48k EQ+reverb+limiter (public "
                                 "xmtpu_torch.effects entry)",
            "audio_sec_per_sec": batch * seconds / sec,
            "device": torch.cuda.get_device_name(dev)}


def config5_config():
    """The JAX benchmark's config-5 pipeline: one voice track on a 16 kHz
    mono bus, a master EQ (300 Hz, +2 dB) then the default limiter."""
    from xmtpu_torch.config import EffectConfig, PipelineConfig, TrackConfig

    return PipelineConfig(
        tracks=(TrackConfig(url="v"),),
        master_effects=(
            EffectConfig("equalizer", {"bands": [
                {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}),
            EffectConfig("limiter", {})),
        sample_rate=16000, normalize=None)


def config5_sources(seconds: float = 4.0, pool_slots: int = 32,
                    pool_seconds: float = 8.0):
    """The JAX benchmark's config-5 inputs, in its draw order from
    ``default_rng(0)``: the session's voice ``(n,)`` float32 at 44.1 kHz
    (``0.3 *`` noise), then one voice a pool slot."""
    rng = np.random.default_rng(0)
    voice = (0.3 * rng.standard_normal(int(SR_IN * seconds))).astype(
        np.float32)
    n_vp = int(SR_IN * pool_seconds)
    pool = [{"v": ((0.3 * rng.standard_normal(n_vp)).astype(np.float32),
                   SR_IN)} for _ in range(pool_slots)]
    return {"v": (voice, SR_IN)}, pool


def config5_streaming(seconds: float = 4.0, pool_slots: int = 32) -> dict:
    """Config 5, 20 ms streaming frames, the JAX benchmark's
    measurements on the card (host clock; every read returns host
    data): ``read()`` at prefetch depth 1 and 3 (ms a frame),
    ``read_many(25)`` (audio-seconds per second), and a ``SessionPool``
    of ``pool_slots`` 8 s voices read 50 frames at a time (aggregate
    audio-seconds per second) on the scan engine and on the kernels."""
    from xmtpu_torch.graph.pool import SessionPool
    from xmtpu_torch.graph.streaming import StreamSession

    dev = _require_card()
    cfg = config5_config()
    src, pool_srcs = config5_sources(seconds, pool_slots)
    n_frames = int(seconds * 1000 / 20) - 4
    reads = n_frames // 2

    def per_read(sess, warm: int) -> float:
        for _ in range(warm):
            sess.read()
        t0 = time.perf_counter()
        for _ in range(reads):
            sess.read()
        return (time.perf_counter() - t0) / reads

    sess = StreamSession(cfg, frame_ms=20.0, sources=src, device=dev)
    dt = per_read(sess, 1)
    dt_depth = per_read(StreamSession(cfg, frame_ms=20.0, sources=src,
                                      prefetch_depth=3, device=dev), 4)
    k = 25
    sess.seek(0.0)
    sess.read_many(k)
    t0 = time.perf_counter()
    audio = sum(sess.read_many(k).shape[0] / sess.sr
                for _ in range(max(1, (n_frames - k) // k)))
    dt_many = time.perf_counter() - t0
    pool_rate = {}
    for engine in ("scan", "pallas"):
        pool = SessionPool(cfg, pool_slots, frame_ms=20.0, sources=pool_srcs,
                           effects_backend=engine, device=dev)
        pool.read(50)
        pool.read(50)
        t0 = time.perf_counter()
        audio_pool = sum(o.shape[0] * o.shape[1] / pool.sr
                         for o in (pool.read(50) for _ in range(3)))
        pool_rate[engine] = audio_pool / (time.perf_counter() - t0)
    return {"config": 5, "desc": "20 ms streaming frames",
            "audio_sec_per_sec": audio / dt_many,
            "pool32_audio_sec_per_sec": pool_rate["scan"],
            "pool32_pallas_audio_sec_per_sec": pool_rate["pallas"],
            "ms_per_frame_sequential": dt * 1e3,
            "ms_per_frame_depth3": dt_depth * 1e3,
            "device": torch.cuda.get_device_name(dev)}


def config6_jobs(root, n_clips: int = 64, seconds: float = 10.0,
                 fmt: str = "wav") -> list:
    """The JAX benchmark's config-6 clips written under ``root``: int16
    noise x 9000 from ``default_rng(0)``, 44.1 kHz mono -> the runner's
    manifest (``in_<i>.<fmt>`` -> ``out_<i>.wav``)."""
    import os

    from xmtpu_torch.io import encode_audio

    rng = np.random.default_rng(0)
    n = int(SR_IN * seconds)
    jobs = []
    for i in range(n_clips):
        pcm = (rng.standard_normal(n) * 9000).astype(np.int16)
        p = os.path.join(root, f"in_{i}.{fmt}")
        encode_audio(p, pcm, SR_IN)
        jobs.append({"voice": p, "out": os.path.join(root, f"out_{i}.wav")})
    return jobs


def config6_file_batch(n_clips: int = 64, seconds: float = 10.0,
                       fmt: str = "flac", decode_threads: int = 1,
                       step_kw=None, device=None) -> dict:
    """Config 6, the file-fed batch, end to end on ``device`` (None: the
    card, else it exits): decode (host) -> the ragged step -> WAV write
    (host), wall clock with all I/O, the warm pass and the cold one. WAV
    inputs where no FFmpeg backend is registered."""
    import shutil
    import tempfile

    from xmtpu_torch.io import HAVE_FFMPEG
    from xmtpu_torch.runner import run_batch

    dev = _require_card() if device is None else torch.device(device)
    if fmt != "wav" and not HAVE_FFMPEG:
        fmt = "wav"
    d = tempfile.mkdtemp(prefix="xmtpu_torch_bench6_")
    try:
        jobs = config6_jobs(d, n_clips, seconds, fmt)
        reps = []
        for _ in range(2):  # cold, then warm
            rep = run_batch(jobs, sr_in=SR_IN, sr_bus=16000, resume=False,
                            write_done_markers=False, step_kw=step_kw,
                            decode_threads=decode_threads, device=dev)
            if rep.failed:
                raise RuntimeError(
                    f"file-batch bench had failures: {rep.failed}")
            reps.append(rep)
        cold, warm = reps
        return {"config": 6,
                "desc": f"file-fed batch ({fmt}, decode->device->write, "
                        f"decode_threads={decode_threads})",
                "audio_sec_per_sec": warm.audio_sec / warm.wall_sec,
                "cold_audio_sec_per_sec": cold.audio_sec / cold.wall_sec,
                "peak_hbm_bytes": warm.peak_hbm_bytes,
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else str(dev))}
    finally:
        shutil.rmtree(d, ignore_errors=True)


CONFIGS = (1, 2, 3, 4, 5, 6)


def run_config(config: int, device=None) -> dict:
    """One config's JSON result at its defaults. Configs 1-5 measure
    the card (``device`` None or a CUDA device); config 6, the file
    runner, also runs on ``device="cpu"``."""
    from xmtpu_torch.utils.errors import ConfigError

    if config == 6:
        return config6_file_batch(device=device)
    if device is not None and torch.device(device).type != "cuda":
        raise ConfigError(f"bench config {config} measures the card; only "
                          f"config 6 runs on {device}")
    return _cli([f"--config={config}"])


def main(batch: int = 256, clip_seconds: float = 10.0, iters: int = 20,
         iir_backend: str = "pallas", resample_backend: str = "mixfirst",
         envelope_block: int = 0, limiter_fuse: int = 1) -> dict:
    from xmtpu_torch import batch as tbatch

    # the root bench.py's options; a refused value raises here, before
    # the device check, so a typo never measures another configuration
    opts = dict(iir_backend=iir_backend, resample_backend=resample_backend,
                envelope_block=envelope_block or None)
    tbatch.check_options(**opts)
    dev = _require_card()
    voice, bgm = make_inputs(batch, clip_seconds)
    # the JAX auto rule, as the root bench.py: fused from 128 rows up
    step = tbatch.make_flagship_step(sr_in=SR_IN, sr_bus=16000, device=dev,
                                     limiter_fuse=bool(limiter_fuse), **opts)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    sec, y = step_seconds(step, v, b, iters=iters)
    value = batch * clip_seconds / sec
    ref = tbatch.flagship_oracle_np(voice[0], bgm[0])
    y0 = y[0].cpu().numpy().astype(np.float64)
    return {
        "metric": "audio_sec_per_sec_per_chip_full_chain",
        "value": round(value, 2),
        "unit": "audio-sec/sec/chip",
        "vs_baseline": round(value / TARGET_RT, 3),
        "accuracy_db": round(rms_db(y0 - ref, ref), 1),
        "device": torch.cuda.get_device_name(dev),
    }


_CONFIG_KEYS = ("batch", "clip_seconds", "iters")  # configs 1-3


def _cli(argv) -> dict:
    kw, config = {}, 4
    for arg in argv:
        k, _, val = arg.lstrip("-").partition("=")
        if k in ("batch", "iters", "envelope_block", "limiter_fuse"):
            kw[k] = int(val)
        elif k == "clip_seconds":
            kw[k] = float(val)
        elif k in ("iir_backend", "resample_backend"):
            kw[k] = val
        elif k == "config":
            config = int(val)
        else:
            sys.exit(f"xmtpu_torch.bench: unknown argument {arg!r} "
                     "(known: config, batch, iters, clip_seconds, "
                     "iir_backend, resample_backend, envelope_block, "
                     "limiter_fuse)")
    if config in (5, 6):
        if kw:
            sys.exit(f"xmtpu_torch.bench: --config={config} takes no other "
                     f"arguments; not {sorted(kw)}")
        return config5_streaming() if config == 5 else config6_file_batch()
    runs = {1: config1_resample, 2: config2_mix, 3: config3_effects}
    if config in runs:
        other = sorted(set(kw) - set(_CONFIG_KEYS))
        if other:
            sys.exit(f"xmtpu_torch.bench: --config={config} takes "
                     f"{', '.join(_CONFIG_KEYS)}; not {other}")
        if "clip_seconds" in kw:
            kw["seconds"] = kw.pop("clip_seconds")
        return runs[config](**kw)
    if config != 4:
        sys.exit("xmtpu_torch.bench: --config=1 (resample), 2 (mix), 3 "
                 "(effects), 4 (the flagship chain, the default), 5 "
                 "(streaming) or 6 (the file-fed batch) are ported")
    return main(**kw)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(_cli(sys.argv[1:])))
