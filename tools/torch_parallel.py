#!/usr/bin/env python3
"""``chip_smoke.py``'s parallel phases alone on the card(s): the hour-long
clip time-sharded (27), the sharded step, pool and server and the dryrun
twin (28) on 4 virtual shards of ``cuda:0``, and the same legs on the
host's real cards (29), each with its gates; then the kernels' JSON line.

    python3 tools/torch_parallel.py                 # phases 27-29
    python3 tools/torch_parallel.py --phases 29     # a host of several cards

Run it from the repo root on a machine with a card (phase 29 needs
several cards of one host). It imports neither ``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="27,28,29",
                    help="comma-separated subset of 27,28,29")
    args = ap.parse_args(argv)
    h = chip_smoke.card_helpers()
    chip_smoke.parallel_phases(
        h, phases=tuple(int(p) for p in args.phases.split(",")))
    print(chip_smoke.kernels_line(h.kernels))


if __name__ == "__main__":
    main()
