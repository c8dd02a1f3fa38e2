"""Polyphase resample of float32 rows as a direct banded FIR
(counterpart of ``xmtpu.kernels.resample.resample_pallas``).

Output sample ``j = c*L + r`` is the ``K2``-tap dot

    out[j] = sum_k hsel[r, k] * x[c*M + s[r] + k]     (x = 0 outside [0, n))

with ``s[r] = col_start[r] + base - pad_left``: the same plan and the
same function as ``ops.resample.polyphase_resample``, computed by the
hand-written kernel ``csrc/resample.cu`` (shared with the fused int16
front through ``csrc/polyphase.cuh``) on CUDA, at any row length.

:func:`resample` is a drop-in for ``polyphase_resample``: it passes
float32 through at ``L == M`` and refuses a band wider than ``2*M``
with ``polyphase_resample``'s :class:`NotPortedError`, as the twin
does. ``resample_pallas`` also leaves ``M < 64`` to XLA, a limit of its
TPU tiling; the direct FIR has no such limit and runs there too. On a
CPU tensor it runs ``polyphase_resample``, the kernel's plain twin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels._seg import on_device
from xmtpu_torch.ops import resample as _ops

# Launches of the CUDA kernel in this process (this module's and the
# fused front's wrappers count separately); callers may reset it.
launches = 0

# input elements per track a block stages (the window of its frame tile)
_WINDOW = 6144
_MAX_ROW_BLOCKS = 65535  # grid.y, kRowsPerBlock = 8 rows each
_ROWS_PER_BLOCK = 8


def poly_tables(plan: _ops.ResamplePlan) -> dict:
    """The kernel's host tables: ``hsel`` (L, K2) float32 taps and
    ``soff`` (L,) int32 window starts relative to ``c*M``."""
    soff = plan.col_start + (plan.base - plan.pad_left)
    return {"hsel": np.ascontiguousarray(plan.hsel, np.float32),
            "soff": soff.astype(np.int32)}


def frames_per_block(plan: _ops.ResamplePlan, nj: int) -> tuple[int, int]:
    """(output frames per block, window elements per track): the frame
    tile whose input window, (tc-1)*M + width, stays within _WINDOW."""
    tc = max(1, min(nj, (_WINDOW - plan.width) // plan.M + 1))
    return tc, (tc - 1) * plan.M + plan.width


def check_rows(R: int) -> None:
    if R > _MAX_ROW_BLOCKS * _ROWS_PER_BLOCK:
        raise ValueError(f"{R} rows: the kernel takes at most "
                         f"{_MAX_ROW_BLOCKS * _ROWS_PER_BLOCK}")


def device_tables(plan: _ops.ResamplePlan, device) -> dict:
    key = ("polyphase", plan.L, plan.M, plan.K2, plan.taps.tobytes())
    return on_device(key, device, lambda: poly_tables(plan))


def resample_pass(x2d: torch.Tensor, plan: _ops.ResamplePlan,
                  out_len: int) -> torch.Tensor:
    """The kernel over contiguous float32 CUDA rows (R, n) -> (R,
    out_len)."""
    global launches
    R, n = x2d.shape
    check_rows(R)
    tabs = device_tables(plan, x2d.device)
    tc, win = frames_per_block(plan, -(-out_len // plan.L))
    y = torch.empty((R, out_len), dtype=torch.float32, device=x2d.device)
    lib = _build.load()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.xm_resample_f32(
            x2d.data_ptr(), tabs["hsel"].data_ptr(), tabs["soff"].data_ptr(),
            y.data_ptr(), R, n, out_len, plan.L, plan.M, plan.K2, tc, win,
            stream)
    _build.check(rc, "resample")
    launches += 1
    return y


def resample(x: torch.Tensor, sr_in: int, sr_out: int,
             taps_per_phase: int = 24, beta: float = 9.0) -> torch.Tensor:
    """Resample the last axis of ``x`` (..., n) -> (..., ceil(n*L/M))
    float32: the kernel on CUDA, ``polyphase_resample`` on the CPU
    (module docstring)."""
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    x = x.to(torch.float32)
    if L == M:
        return x
    plan = _ops.make_plan(L, M, taps_per_phase, beta)
    if plan.width > 2 * M or x.device.type == "cpu":
        # the twin (it raises NotPortedError for the wide band)
        return _ops.polyphase_resample(x, sr_in, sr_out, taps_per_phase,
                                       beta)
    if x.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {x.device}")
    batch, n = x.shape[:-1], x.shape[-1]
    if n < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")
    R = int(np.prod(batch)) if batch else 1
    out_len = _ops.resample_output_len(n, L, M)
    y = resample_pass(x.reshape(R, n).contiguous(), plan, out_len)
    return y.reshape(*batch, out_len)
