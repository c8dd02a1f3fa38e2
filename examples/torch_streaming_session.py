"""Interactive-style streaming on the GPU: seek, 20 ms frame reads and
grouped reads (counterpart of ``streaming_session.py``).

    python examples/torch_streaming_session.py [--device cpu]
"""

import argparse

import numpy as np

from xmtpu_torch.api import Session


def main(device=None) -> None:
    sr = 16000
    rng = np.random.default_rng(3)
    voice = (0.3 * rng.standard_normal(sr * 8)).astype(np.float32)
    bgm = (0.1 * np.sin(2 * np.pi * 110 * np.arange(sr * 2) / sr)).astype(
        np.float32)
    config = {
        "sampleRate": sr,
        "normalize": None,
        "tracks": [
            {"url": "voice", "kind": "voice"},
            {"url": "bgm", "kind": "bgm", "loop": True, "sideDuck": True},
        ],
        "effects": [
            {"name": "equalizer",
             "params": {"bands": [
                 {"freq_hz": 300.0, "gain_db": 2.0, "q": 1.0}]}},
            {"name": "limiter", "params": {"threshold_db": -3.0}},
        ],
    }
    s = Session(config, frame_ms=20,
                sources={"voice": (voice, sr), "bgm": (bgm, sr)},
                prefetch_depth=2,        # frames dispatched and their
                device=device)           # copies started ahead of read()
    s.seek(1500.0)                       # sample-accurate, state re-primed
    frame = s.read()                     # one 20 ms int16 frame
    group = s.read_many(25)              # 500 ms in ONE dispatch
    print(f"frame {frame.shape}, group {group.shape}, "
          f"peak {np.abs(group).max()}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
