"""Tracing and per-stage annotation (counterpart of
``xmtpu.utils.profiling``).

:func:`trace` profiles a block with ``torch.profiler`` (the CPU and,
where a card is present, its CUDA activity) and writes a Chrome trace
into a directory; the CLI's ``bench --profile DIR`` goes through it.
Each stage of a step runs inside :func:`stage`, a
``torch.profiler.record_function`` range, so a trace groups its CPU ops
and their CUDA kernels under ``xmtpu_torch.<stage>``. Outside a
profiler the range costs one no-op context manager per stage.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from xmtpu_torch.utils.logging import get_logger

log = get_logger("xmtpu_torch.profile")


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Profile the enclosed block into ``trace_dir`` as a Chrome trace
    (``trace.<pid>.json``, opened by Perfetto or ``chrome://tracing``);
    a no-op when ``trace_dir`` is None or empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    t0 = time.perf_counter()
    prof = profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        path = os.path.join(trace_dir, f"trace.{os.getpid()}.json")
        prof.export_chrome_trace(path)
        log.info("profile trace written to %s (%.2fs)", path,
                 time.perf_counter() - t0)


def stage(name: str):
    """Named profiler range around one pipeline stage."""
    return torch.profiler.record_function(f"xmtpu_torch.{name}")
