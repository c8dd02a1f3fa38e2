#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xmtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and the process exits
non-zero:

1. device: the card's name and power limit (``nvidia-smi``); both TF32
   flags set to False;
2. build: the CUDA kernels built from ``xmtpu_torch/csrc`` (seconds);
3. K1, the fftconv kernel, against its plain torch twin at the flagship
   shape (256 x 160000 bus samples, the 4093-tap combined EQ+reverb IR,
   the real normalize gains and fade ramp): gate RMS error <= -100 dB;
   both times (CUDA events, median of 7 runs after 2 warm-ups);
4. K2, the envelope kernel, against its plain twin on the K1 output:
   same gate; both times (the twin's time loop: median of 5 runs);
5. the flagship step on 256 clips of 10 s (the root bench.py's inputs):
   both launch counters must rise during one step; clip 0 must read
   <= -80 dB against the float64 oracle; throughput in audio-sec/sec;
6. a JSON line of the kernels, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Without a CUDA device it fails before printing any result. It imports
neither ``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

GATE_KERNEL_DB = -100.0
GATE_CHAIN_DB = -80.0
BATCH, CLIP_SECONDS = 256, 10.0


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from xmtpu_torch import batch as tbatch
    from xmtpu_torch.bench import (make_inputs, median_ms, rms_db,
                                   step_seconds)
    from xmtpu_torch.kernels import _build, envelope, fftconv
    from xmtpu_torch.ops.resample import resample_output_len

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card}")
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    lib = _build.library_path().relative_to(_build.BUILD_DIR.parent.parent)
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib})")

    step = tbatch.make_flagship_step(fused=True, device=dev)
    voice, bgm = make_inputs(BATCH, CLIP_SECONDS)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    m, scale, ramp = step.front(v, b)
    kernels = []

    def compare(name, route, source, replaces, kern, plain, rows):
        yk, yp = kern(), plain()
        torch.cuda.synchronize()
        err = (yk - yp).double()
        db = rms_db(err.cpu().numpy(), yp.double().cpu().numpy())
        max_abs = float(err.abs().max())
        ok = bool(torch.isfinite(yk).all()) and db <= GATE_KERNEL_DB
        return dict(name=name, route=route, source=source,
                    replaces=replaces, max_abs_err=max_abs, rms_db=db,
                    rows=rows, ok=ok)

    # 3. K1: fftconv kernel vs its plain twin
    ir = step.ir
    k1 = compare("fftconv", "cuda", "xmtpu_torch/csrc/fftconv.cu",
                 "xmtpu/kernels/fftconv.py:164",
                 lambda: fftconv.fir_convolve(m, ir, scale, ramp),
                 lambda: fftconv.fir_convolve_plain(m, ir, scale, ramp),
                 f"all {m.shape[0]}")
    k1["ms"] = median_ms(lambda: fftconv.fir_convolve(m, ir, scale, ramp))
    k1["plain_ms"] = median_ms(
        lambda: fftconv.fir_convolve_plain(m, ir, scale, ramp))
    print(f"K1 fftconv {tuple(m.shape)} x {ir.shape[0]} taps: "
          f"{k1['rms_db']:.1f} dB vs plain (gate {GATE_KERNEL_DB}), "
          f"max abs {k1['max_abs_err']:.3g}; kernel {k1['ms']:.3f} ms, "
          f"plain {k1['plain_ms']:.3f} ms [{card}]")
    kernels.append(k1)

    # 4. K2: envelope kernel vs its plain twin, on the K1 output
    x = fftconv.fir_convolve_plain(m, ir, scale, ramp)
    init = torch.zeros((2, x.shape[0]), dtype=torch.float32, device=dev)
    consts = envelope.curve_consts(step.curve)

    def k2_kern():
        return envelope.limiter(x, step.k_rel, step.c_att, step.curve)[0]

    def k2_plain():
        return envelope.limiter_plain(x, step.k_rel, step.c_att, consts,
                                      init)[0]

    k2 = compare("envelope", "cuda", "xmtpu_torch/csrc/envelope.cu",
                 "xmtpu/kernels/envelope.py:188", k2_kern, k2_plain,
                 f"all {x.shape[0]}")
    k2["ms"] = median_ms(k2_kern)
    k2["plain_ms"] = median_ms(k2_plain, warmup=1, runs=5)
    print(f"K2 envelope {tuple(x.shape)}, plain twin on {k2['rows']} "
          f"rows: {k2['rms_db']:.1f} dB vs plain "
          f"(gate {GATE_KERNEL_DB}), max abs {k2['max_abs_err']:.3g}; "
          f"kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.1f} ms "
          f"[{card}]")
    kernels.append(k2)
    del m, scale, ramp, x
    for k in kernels:
        if not k["ok"]:
            raise SystemExit(f"chip_smoke: kernel {k['name']} failed its "
                             f"check: {k}")

    # 5. the flagship step, driven once with fresh launch counters
    fftconv.launches = 0
    envelope.launches = 0
    y = step(v, b)
    torch.cuda.synchronize()
    launches = {"fftconv": fftconv.launches, "envelope": envelope.launches}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if min(launches.values()) < 1:
        raise SystemExit(f"chip_smoke: a kernel did not launch in the "
                         f"step: {launches}")
    g = math.gcd(step.sr_in, step.sr_bus)
    n_bus = resample_output_len(voice.shape[1], step.sr_bus // g, step.M)
    if tuple(y.shape) != (BATCH, n_bus) or y.dtype != torch.int16:
        raise SystemExit(f"chip_smoke: step output {tuple(y.shape)} "
                         f"{y.dtype}, expected ({BATCH}, {n_bus}) int16")
    ref = tbatch.flagship_oracle_np(voice[0], bgm[0])
    acc = rms_db(y[0].cpu().numpy().astype(np.float64) - ref, ref)
    print(f"step: launches {launches}; clip 0 {acc:.1f} dB vs float64 "
          f"oracle (gate {GATE_CHAIN_DB})")
    if not acc <= GATE_CHAIN_DB:
        raise SystemExit("chip_smoke: chain accuracy gate failed")
    sec, _ = step_seconds(step, v, b, iters=10)
    print(f"step: {BATCH}x{CLIP_SECONDS:g} s in {sec * 1e3:.2f} ms = "
          f"{BATCH * CLIP_SECONDS / sec:.1f} audio-sec/sec [{card}]; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 6. kernels line, then the contract line last
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
