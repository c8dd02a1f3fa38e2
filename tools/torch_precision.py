#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 31 alone on the card: the matmul precision
rungs (the default step's ``mixfirst`` front as a probe, the resample
ops, K7, the matmul DFTs), K1's ``trim=False`` and ``gp``, and the
``mixfirst_pad`` step, each with its gates.

    python3 tools/torch_precision.py
    python3 tools/torch_precision.py --device cpu   # a small rehearsal

Run it from the repo root. It imports neither ``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import argparse
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        chip_smoke.precision_phase(chip_smoke.card_helpers())
        return
    import torch

    h = types.SimpleNamespace(card="cpu", dev=torch.device("cpu"))
    chip_smoke.precision_phase(h, n_clips=2, seconds=1.0, long_rows=2,
                               long_n=20000, ops_rows=2, ops_n=8820)


if __name__ == "__main__":
    main()
