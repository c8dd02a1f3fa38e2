"""The controls of the comparison that decides ``correct``: each is a
whole run of the cell (``harness.run_cell``) at the cell's own size,
with a short window and something else in the program's place, and has
to come out ``correct`` false. The benchmark's runs never run this.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--window 2]

For each seed it prints one JSON line with each control's compared
number and ``correct``:

- ``tf32_reference``: the reference put in the program's place and
  computed in TF32, the precision below the configurations' (float32
  with TF32 off): the operands of the products the program computes
  (the rate converter's filter and signal; the folded EQ+reverb FIR's
  taps and signal) rounded to TF32, each product accumulated exactly
  (``reference/dsp.py``). It runs on the host once for each batch of
  the ring and hands back the program's type and layout on the device;
- ``program_bf16_front`` (cells whose entry is the flagship step): the
  program itself with its own lower-precision path switched on, the
  front's matmuls at the ``"default"`` rung (one bf16 pass).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

from perfbench import harness


def reference_in_place(config: dict, precision: str):
    """A ``wrap`` for ``run_cell``: the reference at ``precision`` in
    the program's place, computed once for each batch of the ring."""
    import torch

    ref = harness.load_module("reference", config["reference"])

    def wrap(entry):
        done: dict = {}

        def call(batch):
            key = id(batch)
            if key not in done:
                like = entry(batch)  # the program's type, layout, device
                y = harness.reference_rows(
                    ref, config, {k: v.cpu().numpy() for k, v in batch.items()},
                    precision)
                if tuple(y.shape) != tuple(like.shape):
                    raise ValueError(f"reference {y.shape} vs program "
                                     f"{tuple(like.shape)}")
                done[key] = torch.from_numpy(y).to(like.device, like.dtype)
            return done[key]
        return call
    return wrap


def _reading(r: dict) -> dict:
    v = r["checks"]["worst_row_db"]["value"]
    return {"worst_row_db": float("inf") if v is None else v,
            "correct": r["correct"]}


def tf32_reading(name: str, seed: int, seconds: float, device=None,
                 overrides=None) -> dict:
    cell = harness.Cell(name, overrides=overrides)
    return _reading(harness.run_cell(
        name, seed, seconds, False, device=device, overrides=overrides,
        wrap=reference_in_place(cell.config, "tf32"), log=lambda m: None))


def bf16_front_reading(name: str, seed: int, seconds: float, device=None,
                       overrides=None) -> dict:
    from xmtpu_torch.ops import resample as tres

    real = tres.apply_aligned
    tres.apply_aligned = functools.partial(real, precision="default")
    try:
        r = harness.run_cell(name, seed, seconds, False, device=device,
                             overrides=overrides, log=lambda m: None)
    finally:
        tres.apply_aligned = real
    return _reading(r)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--window", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = {"workload": args.workload, "seed": seed,
               "limit_db": cell.config["limit_db"],
               "tf32_reference": tf32_reading(args.workload, seed,
                                              args.window)}
        if cell.config["entry"] == "flagship_step":
            row["program_bf16_front"] = bf16_front_reading(
                args.workload, seed, args.window)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
