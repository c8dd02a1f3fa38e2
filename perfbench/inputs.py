"""The one traffic generator: a ring of distinct batches made on the
device from ``--seed``, as a traffic file under ``perfbench/traffic/``
describes them.

A traffic file gives ``clips_per_batch``, ``clip_seconds``,
``sample_rate``, ``channels`` (default 1), ``ring`` (distinct batches,
cycled), ``in_flight`` (batches the caller keeps queued), and
``signals``: one entry per input of the entry, by name, each with

- ``layout``: ``"clips,samples"`` or ``"clips,samples,channels"``;
- ``dtype``: ``"int16"`` (values clipped to the int16 range, then
  truncated toward zero) or ``"float32"``;
- ``kind``: ``"gaussian"`` (``scale`` times standard normal noise) or
  ``"tone"`` (``scale`` times a sine whose frequency, uniform in
  ``freq_hz`` = [lo, hi], and phase are drawn per clip).

Every seed makes batches of the same sizes; only their content differs.
The draws come from one ``torch.Generator`` on the device, slot by slot
and signal by signal in the file's order, in a few large calls.
"""

from __future__ import annotations

import math


def batch_shape(traffic: dict, layout: str) -> tuple[int, ...]:
    dims = {"clips": int(traffic["clips_per_batch"]),
            "samples": int(round(traffic["clip_seconds"] * traffic["sample_rate"])),
            "channels": int(traffic.get("channels", 1))}
    return tuple(dims[d] for d in layout.split(","))


def audio_seconds(traffic: dict) -> float:
    """Audio seconds of one batch: clips times their length (channels
    of one clip count once)."""
    return int(traffic["clips_per_batch"]) * float(traffic["clip_seconds"])


def _signal(spec: dict, traffic: dict, gen, device):
    import torch

    shape = batch_shape(traffic, spec["layout"])
    kind, scale = spec["kind"], float(spec["scale"])
    if kind == "gaussian":
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale
    elif kind == "tone":
        lo, hi = map(float, spec["freq_hz"])
        clips = shape[0]
        f = lo + (hi - lo) * torch.rand(clips, generator=gen, device=device,
                                        dtype=torch.float64)
        phi = 2.0 * math.pi * torch.rand(clips, generator=gen, device=device,
                                         dtype=torch.float64)
        t = torch.arange(shape[1], device=device, dtype=torch.float64) / float(
            traffic["sample_rate"])
        x = torch.sin(2.0 * math.pi * f[:, None] * t[None, :] + phi[:, None])
        x = (x * scale).to(torch.float32)
        if len(shape) == 3:
            x = x[:, :, None].expand(shape).contiguous()
    else:
        raise ValueError(f"unknown signal kind {kind!r}")
    if spec["dtype"] == "int16":
        return torch.trunc(x.clamp_(-32768.0, 32767.0)).to(torch.int16)
    if spec["dtype"] == "float32":
        return x
    raise ValueError(f"unknown dtype {spec['dtype']!r}")


def make_ring(traffic: dict, seed: int, device) -> list[dict]:
    """``ring`` batches, each a dict of tensors on ``device``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return [{name: _signal(spec, traffic, gen, device)
             for name, spec in traffic["signals"].items()}
            for _ in range(int(traffic["ring"]))]
