#!/usr/bin/env python3
"""Count the torch operations of one streaming frame of BASELINE config 5
(``xmtpu_torch.bench.config5_config``) on the CPU, per effect engine.

    python3 tools/torch_stream_ops.py

A 4-slot ``SessionPool`` dispatches 4 frames under a
``TorchDispatchMode`` that counts every aten operation except views
(which launch nothing on a card); a ``StreamSession`` dispatches one.
On the kernel engine the twins' time loops are replaced by one
allocation each, so each kernel counts as the one launch it is on a
card. A count, not a time: what a card's host must launch per frame.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from xmtpu_torch import bench  # noqa: E402
from xmtpu_torch.graph.pool import SessionPool  # noqa: E402
from xmtpu_torch.graph.streaming import StreamSession  # noqa: E402
from xmtpu_torch.kernels import envelope, iir  # noqa: E402

VIEWS = {"view", "reshape", "_reshape_alias", "slice", "select", "expand",
         "permute", "t", "unsqueeze", "squeeze", "as_strided", "alias",
         "transpose", "unfold", "narrow", "detach", "_unsafe_view", "split",
         "unbind", "movedim", "diagonal", "lift_fresh", "view_as_real",
         "view_as_complex", "real", "imag", "_conj",
         "_record_function_enter_new", "_record_function_exit"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main() -> None:
    iir.sosfilt_plain = lambda x, sos, zi: (torch.empty_like(x),
                                            torch.empty_like(zi))
    envelope.envelope_plain = lambda d, k, c, init, *a, **kw: (
        torch.empty_like(d), torch.empty_like(init))
    cfg = bench.config5_config()
    src, pool_srcs = bench.config5_sources(1.0, 4, 1.0)
    for engine in ("scan", "pallas"):
        p = SessionPool(cfg, 4, sources=pool_srcs, effects_backend=engine,
                        device="cpu")
        p.read(2)
        with Count() as c:
            p._dispatch(4)
        top = sorted(c.ops.items(), key=lambda kv: -kv[1])[:6]
        print(f"pool, {engine}: {sum(c.ops.values()) / 4:.0f} operations a "
              f"frame; most: {top} (4 frames)")
    s = StreamSession(cfg, sources=src, device="cpu")
    s.read()
    with Count() as c:
        s._dispatch(3, s.fx_state)
    print(f"session, scan: {sum(c.ops.values())} operations a frame")


if __name__ == "__main__":
    main()
