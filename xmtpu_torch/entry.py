"""The flagship step and its example arguments for a one-device check
(the counterpart of the JAX package's ``__graft_entry__.entry()``).

    python -m xmtpu_torch.entry [--device D]

runs ``fn(*args)`` once and prints the output's shape and dtype. The
two 1 s clips are fewer than the 128 rows at which the step takes its
fused branch, so on a card they run the small-batch branch: the EQ on
the IIR kernel (``kernels.iir.sosfilt``) with its float64 state chain,
the reverb on the fftconv kernel (``ops.reverb.reverb``) and the
limiter's envelope on the envelope kernel (``ops.limiter.limiter``
through ``kernels.envelope.envelope``), its curve in torch. The
multi-device twin is :mod:`xmtpu_torch.parallel.dryrun`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from xmtpu_torch.batch import make_flagship_step
from xmtpu_torch.utils.device import resolve_device


def example_batch(batch: int, n: int):
    """(voice, bgm): ``batch`` int16 clips of ``n`` samples, the JAX
    entry's example inputs (voice ``default_rng(0)`` noise x 9000, bgm a
    sine x 12000 in every row)."""
    rng = np.random.default_rng(0)
    voice = (rng.standard_normal((batch, n)) * 9000).astype(np.int16)
    bgm = (np.sin(np.arange(n) / 50.0)[None].repeat(batch, 0) * 12000
           ).astype(np.int16)
    return voice, bgm


def entry(device=None):
    """-> ``(fn, (voice, bgm))``: the flagship step at 44.1 kHz in and a
    16 kHz bus on the kernels, and two int16 clips of 1 s on the step's
    device (``cuda`` unless ``device`` names another;
    :class:`~xmtpu_torch.utils.errors.DeviceError` without a card)."""
    dev = resolve_device(device)
    fn = make_flagship_step(sr_in=44100, sr_bus=16000, iir_backend="pallas",
                            device=dev)
    voice, bgm = example_batch(batch=2, n=44100)
    return fn, (torch.from_numpy(voice).to(dev), torch.from_numpy(bgm).to(dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m xmtpu_torch.entry",
        description="Run the flagship step once on its example clips.")
    ap.add_argument("--device", default=None,
                    help="where to run (cpu, cuda:0); default: cuda")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example).cpu().numpy()
    print("entry(): OK,", out.shape, out.dtype)


if __name__ == "__main__":
    main()
