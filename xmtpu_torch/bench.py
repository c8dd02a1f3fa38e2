"""Throughput benchmark of the flagship chain on one CUDA GPU
(counterpart of the root ``bench.py``; same JSON keys), and of the public
effect chain (``--config=3``, counterpart of
``xmtpu.benchmarks.config3_effects``).

    python -m xmtpu_torch.bench [--batch=256] [--clip_seconds=10]
        [--iters=20] [--resample_backend=mixfirst|pallas|rsmix]
        [--limiter_fuse=1] [--iir_backend=pallas] [--envelope_block=0]
    python -m xmtpu_torch.bench --config=3 [--batch=16] [--clip_seconds=10]
        [--iters=20]

The keys are the root ``bench.py``'s. The step takes the branch the JAX
package's auto rule picks: fused at the default 256 clips, unfused
(segmented IIR and envelope) below 128, e.g. ``--batch=32`` (the JAX
harness's config 4). Values the step refuses (``--iir_backend=scan``,
an ``--envelope_block`` that is not a power of two, an unknown
``--resample_backend``) raise
its error before any work; an unknown key exits with the list.

Prints one JSON line: ``metric``, ``value`` (audio-seconds per second
per GPU), ``unit``, ``vs_baseline`` (ratio to the 500x-realtime
target), ``accuracy_db`` (clip 0 against the float64 oracle) and
``device`` (the GPU's name). Time is taken with CUDA events around
``iters`` back-to-back steps after one warm-up step, so it includes any
gap the host leaves between kernels. There is no CPU fallback: without
a CUDA device the command fails.

``--config=3`` times ``xmtpu_torch.effects`` on the JAX benchmark's
config-3 input, 16 stereo clips of 10 s at 48 kHz (float32 ``0.3 *
default_rng(0).standard_normal``, public layout (B, n, 2), on the card),
through 5-band EQ -> the 0.5 s synthetic IR at wet 0.3 / dry 0.7 ->
the default limiter, and prints the JAX benchmark's keys ``config``, ``desc`` and
``audio_sec_per_sec``, and ``device``.
"""

from __future__ import annotations

import json
import sys

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

    if not torch.cuda.is_available():
        raise SystemExit("xmtpu_torch.bench: no CUDA device")
    dev = torch.device("cuda")
    x, chain = config3_inputs(batch, seconds, sr)
    xd = torch.from_numpy(x).to(dev)
    sec, _ = step_seconds(
        lambda: effects(xd, sr, chain, device=dev, device_out=True),
        iters=iters)
    return {"config": 3, "desc": "stereo 48k EQ+reverb+limiter (public "
                                 "xmtpu_torch.effects entry)",
            "audio_sec_per_sec": batch * seconds / sec,
            "device": torch.cuda.get_device_name(dev)}


def main(batch: int = 256, clip_seconds: float = 10.0, iters: int = 20,
         iir_backend: str = "pallas", resample_backend: str = "mixfirst",
         envelope_block: int = 0, limiter_fuse: int = 1) -> dict:
    from xmtpu_torch import batch as tbatch

    # the root bench.py's options; a refused value raises here, before
    # the device check, so a typo never measures another configuration
    opts = dict(iir_backend=iir_backend, resample_backend=resample_backend,
                envelope_block=envelope_block or None)
    tbatch.check_options(**opts)
    if not torch.cuda.is_available():
        raise SystemExit("xmtpu_torch.bench: no CUDA device")
    dev = torch.device("cuda")
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


_CONFIG3_KEYS = ("batch", "clip_seconds", "iters")


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
    if config == 3:
        other = sorted(set(kw) - set(_CONFIG3_KEYS))
        if other:
            sys.exit(f"xmtpu_torch.bench: --config=3 takes "
                     f"{', '.join(_CONFIG3_KEYS)}; not {other}")
        if "clip_seconds" in kw:
            kw["seconds"] = kw.pop("clip_seconds")
        return config3_effects(**kw)
    if config != 4:
        sys.exit("xmtpu_torch.bench: --config=3 (effects) or 4 (the "
                 "flagship chain, the default) are ported")
    return main(**kw)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(_cli(sys.argv[1:])))
