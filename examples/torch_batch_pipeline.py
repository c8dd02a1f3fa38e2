"""Batch-process a manifest of clips through the full chain on the GPU
(the PyTorch port's counterpart of ``batch_pipeline.py``).

Builds a few synthetic clips, writes a manifest, and runs the bucketed
ragged batch runner (decode thread -> SPSC ring -> the step on the card
-> writer thread) with resume markers and per-clip failure isolation:

    python examples/torch_batch_pipeline.py [outdir] [--device cpu]

(a temporary directory when no ``outdir`` is given).
"""

import argparse
import json
import os
import tempfile

import numpy as np

from xmtpu_torch.io import write_wav
from xmtpu_torch.runner import run_batch


def main(outdir: str, device=None) -> None:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(7)
    jobs = []
    for i, seconds in enumerate((3.0, 5.0, 2.2)):
        n = int(44100 * seconds)
        t = np.arange(n) / 44100.0
        tone = np.sin(2 * np.pi * (220 * (i + 1)) * t)
        voice = ((tone + 0.05 * rng.standard_normal(n)) * 12000).astype(
            np.int16)
        src = os.path.join(outdir, f"voice_{i}.wav")
        write_wav(src, voice, 44100)
        jobs.append({"voice": src,
                     "out": os.path.join(outdir, f"out_{i}.wav")})
    # write and reload a manifest file: the flow of
    # `python -m xmtpu_torch.cli batch manifest.json`
    mpath = os.path.join(outdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(jobs, f, indent=1)
    with open(mpath) as f:
        manifest = json.load(f)
    rep = run_batch(manifest, sr_in=44100, sr_bus=16000, batch_size=4,
                    pipeline=True, device=device)
    print(rep.to_json())


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("outdir", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    a = p.parse_args()
    if a.outdir:
        main(a.outdir, a.device)
    else:
        with tempfile.TemporaryDirectory() as d:
            main(d, a.device)
