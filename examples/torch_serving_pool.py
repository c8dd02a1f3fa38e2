"""Serving mode on the GPU: many concurrent streaming sessions, one
batched step (counterpart of ``serving_pool.py``).

The reference library's deployment shape is many independent
``xm_audio_utils`` handles in one process; ``SessionPool`` runs K of
them as one step at the leading shape (K,).

    python examples/torch_serving_pool.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import numpy as np

from xmtpu_torch.api import SessionPool


def main(device=None) -> None:
    sr = 16000
    rng = np.random.default_rng(11)
    config = {
        "sampleRate": sr,
        "normalize": None,
        "tracks": [{"url": "voice", "kind": "voice", "fadeInTimeMs": 50}],
        "effects": [
            {"name": "equalizer",
             "params": {"bands": [
                 {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}},
            {"name": "limiter", "params": {"threshold_db": -3.0}},
        ],
    }

    K = 8
    # each "user" brings their own audio (here: noise of varying length)
    sources = [
        {"voice": ((0.3 * rng.standard_normal(sr * (4 + i % 3))
                    ).astype(np.float32), sr)}
        for i in range(K)
    ]
    pool = SessionPool(config, K, frame_ms=20.0, sources=sources,
                       device=device)
    print(f"pool: {K} slots, frame_out={pool.frame_out} samples")

    out = pool.read(25)  # 25 frames (0.5 s) for EVERY slot, one dispatch
    print("group read:", out.shape, out.dtype)  # (K, 25*frame, 1)

    # users come and go; the step stays the same
    pool.leave(3)
    pool.seek(0, 1000.0)  # rewind user 0 to 1.0 s
    newcomer = {"voice": ((0.2 * rng.standard_normal(sr * 2)
                           ).astype(np.float32), sr)}
    pool.join(3, newcomer)
    out = pool.read(25)
    print("after churn:", out.shape, "active slots:", pool.active())

    t0 = time.perf_counter()
    groups = 4
    for _ in range(groups):
        out = pool.read(25)
    dt = time.perf_counter() - t0
    audio = groups * out.shape[0] * out.shape[1] / sr
    print(f"aggregate throughput: {audio / dt:.0f}x realtime "
          f"({K} sessions, grouped dispatch)")

    # serving failover: snapshot every slot's DSP state and clock,
    # restore into a fresh pool (same config, same sources re-joined)
    # and the streams continue exactly where the snapshot left off
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "pool_snapshot.npz")
        pool.save_state(snap)
        expect = pool.read(5)
        pool2 = SessionPool(config, K, frame_ms=20.0, sources=sources,
                            device=device)
        pool2.join(3, newcomer)  # restore needs the SAME sources re-joined
        pool2.load_state_file(snap)
        got = pool2.read(5)
    print("checkpoint/resume bit-exact:", bool(np.array_equal(got, expect)))

    # ------------------------------------------------------------------
    # PoolServer: the same serving mode WITHOUT the shared-config
    # restriction: each client opens with its OWN config; the server
    # buckets same-config sessions into shared-step pools itself.
    from xmtpu_torch import PoolServer

    srv = PoolServer(n_slots=8, frame_ms=20.0, max_seconds=8.0,
                     device=device)
    quiet = dict(config)  # a second, different program: -6 dB voice
    quiet["tracks"] = [dict(config["tracks"][0], volume=0.5)]
    a = srv.open(config, sources[0])
    b = srv.open(quiet, sources[1])
    c = srv.open(config, sources[2])  # same config as a -> same pool
    pcm_b = srv.read(b, 25)  # per-session read (co-residents buffer)
    print("per-session read:", pcm_b.shape, "| stats:", srv.stats())
    ready = srv.pump(25)  # synchronous serving loop: one group, all buckets
    print("pump fan-out:", {sid: v.shape[0] for sid, v in ready.items()})
    for sid in (a, b, c):
        srv.close(sid)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
