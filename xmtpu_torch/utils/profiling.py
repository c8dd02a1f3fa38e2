"""Per-stage trace annotation (counterpart of
``xmtpu.utils.profiling.stage``).

Each stage of the step runs inside ``torch.profiler.record_function``,
so a ``torch.profiler.profile`` trace groups its CPU ops and their CUDA
kernels under ``xmtpu_torch.<stage>``. Outside a profiler the range
costs one no-op context manager per stage.
"""

from __future__ import annotations

import torch


def stage(name: str):
    """Named profiler range around one pipeline stage."""
    return torch.profiler.record_function(f"xmtpu_torch.{name}")
