"""Mix two tracks and master to -16 LUFS (ITU-R BS.1770 gated
loudness) on the GPU (counterpart of ``lufs_mastering.py``).

    python examples/torch_lufs_mastering.py [--device cpu]
"""

import argparse

import numpy as np

from xmtpu_torch import api
from xmtpu_torch.ops.loudness import measure_lufs_np


def main(device=None) -> None:
    sr = 48000
    rng = np.random.default_rng(1)
    n = sr * 5
    voice = (0.2 * rng.standard_normal(n)).astype(np.float32)
    music = (0.1 * np.sin(2 * np.pi * 220 * np.arange(n) / sr)).astype(
        np.float32)
    out = api.mix(
        [
            {"pcm": voice, "sr": sr, "fade_in_ms": 250},
            {"pcm": music, "sr": sr, "gain_db": -6.0, "loop": True},
        ],
        sr,
        normalize="lufs",
        target_db=-16.0,
        device=device,
    )
    x = out[:, None] if out.ndim == 1 else out
    print(f"mixed {out.shape}, integrated loudness "
          f"{measure_lufs_np(x.T, sr):.2f} LUFS")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
