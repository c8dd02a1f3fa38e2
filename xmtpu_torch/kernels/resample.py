"""Polyphase resample of float32 rows as a direct banded FIR
(counterpart of ``xmtpu.kernels.resample.resample_pallas``).

Output sample ``j = c*L + r`` is the ``K2``-tap dot

    out[j] = sum_k hsel[r, k] * x[c*M + s[r] + k]     (x = 0 outside [0, n))

with ``s[r] = col_start[r] + base - pad_left``: the same plan and the
same function as ``ops.resample.polyphase_resample``, computed by the
hand-written kernel ``csrc/resample.cu`` (shared with the fused int16
front through ``csrc/polyphase.cuh``) on CUDA, at any row length.

:func:`resample` is a drop-in for ``polyphase_resample``: it passes
float32 through at ``L == M`` and leaves a band wider than ``2*M`` to
the twin's strided convolution, as ``resample_pallas`` leaves it to
XLA's. ``resample_pallas`` also leaves ``M < 64`` to XLA, a limit of
its TPU tiling; the direct FIR has no such limit and runs there too. On
a CPU tensor it runs ``polyphase_resample``, the kernel's plain twin.

``precision=`` takes the rungs of ``ops.precision`` (the JAX
``resample_pallas(precision=)``, which sets the rung of K7's own dots).
HIGHEST (the default) is the kernel as it is. DEFAULT runs it on
operands rounded to bf16: the host taps rounded once
(:func:`poly_tables` ``part="hi"``), the input by one elementwise pass;
the kernel's float32 products of bf16 values are exact, so that is one
bf16 pass with float32 sums. HIGH is the three-term split by linearity,
three launches: K7(x_hi, h_lo) + K7(x_lo, h_hi) + K7(x_hi, h_hi), the
twin's order. The twin splits the same way (``ops.precision``).

Non-finite input: an output is non-finite exactly where the twin's is.
The twin multiplies whole frames by the band, so a NaN or inf reaches
every output of a frame whose band holds it: in the twin's aligned
branch (``n % M == 0``, ``n >= 2M``, whole output frames) the frame's
own M samples poison all its outputs, the previous frame's last
``|lo|`` samples its phases ``r < r0`` and the next frame's first
``hi`` its phases ``r >= r2``; in its windowed branch the frame's whole
band ``x[c*M + lo : c*M + M + hi]`` poisons all its outputs. The kernel
flags such frames and a second launch writes NaN there
(``csrc/polyphase.cuh``). One finer mapping differs: where the twin
meets an inf it gives ±inf or NaN depending on what else the band holds;
the kernel's non-finite outputs are NaN.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from xmtpu_torch.kernels import _build, _seg
from xmtpu_torch.kernels._seg import on_device
from xmtpu_torch.ops import precision as _prec
from xmtpu_torch.ops import resample as _ops
from xmtpu_torch.utils.device import check_interpret

# Launches of the CUDA kernel in this process (this module's and the
# fused front's wrappers count separately); callers may reset it.
launches = 0

# shared bytes a block may take on an H100 (one block a SM)
BLOCK_BYTES = 232448
# csrc/polyphase.cuh: the default filter's instance (K2 = 25) takes phases
# in pairs whose windows start at most PAIR_SKEW apart
DEFAULT_K2, PAIR_SKEW = 25, 3


@dataclass(frozen=True)
class PolyGeometry:
    """The kernel's tiling of one plan: ``groups`` phase groups of ``G``
    (one per block), work items of ``frames`` = 32 F output frames (F a
    lane), ``tiles`` of them a row, the window's and the output tile's
    row pitches ``pitch`` and ``tile_pitch`` (32-bit words, odd), a
    block's shared ``smem`` bytes, and ``pair_skew``, the most two paired
    phases' windows start apart (:func:`pair_skew`)."""
    G: int
    groups: int
    frames: int
    tiles: int
    pitch: int
    tile_pitch: int
    smem: int
    pair_skew: int

    @property
    def paired(self) -> bool:
        """Whether the kernel takes this plan's phases in pairs."""
        return self.pair_skew <= PAIR_SKEW


def poly_tables(plan: _ops.ResamplePlan, part: str | None = None) -> dict:
    """The kernel's host tables: ``hsel`` (L, K2p) float32 taps, K2p =
    K2 rounded up to a multiple of 4 (zeros past K2, so a phase's taps
    load 16 bytes at a time), and ``soff`` (L,) int32 window starts
    relative to ``c*M``. ``part``: None (the float32 taps), ``"hi"`` or
    ``"lo"``, the bf16 head or tail of the float32 taps
    (``ops.precision.split``), held as float32."""
    K2p = -(-plan.K2 // 4) * 4
    hsel = np.zeros((plan.L, K2p), np.float32)
    hsel[:, :plan.K2] = plan.hsel
    if part is not None:
        parts = _prec.split(torch.from_numpy(hsel))
        hsel = parts[("hi", "lo").index(part)].float().numpy()
    soff = plan.col_start + (plan.base - plan.pad_left)
    return {"hsel": hsel, "soff": soff.astype(np.int32)}


def poly_smem(G: int, F: int, pitch: int, tile_pitch: int, K2: int,
              tracks: int) -> int:
    """csrc/polyphase.cuh ``poly_smem_bytes``: the group's taps ((G + 1)
    x K2p), the window stages (K7 three, K8 two) of 32 F rows and 4
    words, each rounded to 16 bytes, the output tile and, for K8's two
    int16 tracks, their raw sample pairs."""
    ring, raw = (3, 0) if tracks == 1 else (2, 2 * ((pitch + 1) // 2))
    stage = (32 * F * pitch + 7) // 4 * 4
    return 4 * ((G + 1) * -(-K2 // 4) * 4 + ring * stage
                + 32 * F * (tile_pitch + raw))


def _pitch(W: int, M: int, tracks: int) -> int:
    """The window rows' pitch for a window of W samples: odd (the 32
    lanes' banks distinct), past W + PAIR_SKEW (the paired phases' reads)
    and K8's whole sample pairs staged up to a sample early (+ 4); for
    K7 at odd M also = M (mod 4), with room for 3 samples each side (+
    6), so that rows copied as 16-byte chunks land aligned."""
    if tracks == 1 and M % 2:
        P = W + PAIR_SKEW + 6
        return P + (M - P) % 4
    return (W + PAIR_SKEW + 4) | 1


# frames a lane per item, in order of preference: K7's consumers reuse a
# phase pair's taps over two frame pairs at F = 4; K8, with its raw pair
# area, runs best at F = 2 with larger groups (tools/torch_poly_tiling.py)
F_PREFERENCE = {1: (4, 2, 1), 2: (2, 1)}


@functools.lru_cache(maxsize=128)
def _tiling(plan: _ops.ResamplePlan, tracks: int) -> tuple:
    """(G, F, pitch, tile pitch, shared bytes): for F in the kernel's
    order of preference, the largest group G = ceil(L / ng) (the fewest
    groups: the least window staged twice) whose block fits
    BLOCK_BYTES; the window pitch from the group's widest window
    (:func:`_pitch`)."""
    s = plan.col_start
    L, K2 = plan.L, plan.K2
    for F in F_PREFERENCE[tracks]:
        for ng in range(1, L + 1):
            G = -(-L // ng)
            r0 = np.arange(0, L, G)
            r1 = np.minimum(r0 + G, L) - 1
            P = _pitch(int((s[r1] - s[r0]).max()) + K2, plan.M, tracks)
            TP = G | 1
            smem = poly_smem(G, F, P, TP, K2, tracks)
            if smem <= BLOCK_BYTES:
                return G, F, P, TP, smem
    raise ValueError(f"no polyphase tiling fits {BLOCK_BYTES} bytes "
                     f"(L={L}, K2={K2})")


def pair_skew(plan: _ops.ResamplePlan, G: int) -> int:
    """The most two paired phases' windows start apart (pairs r0 + 2q,
    r0 + 2q + 1 inside each group of G from r0), or a value past
    PAIR_SKEW when the default filter's paired instance does not apply
    (another K2)."""
    if plan.K2 != DEFAULT_K2:
        return PAIR_SKEW + 1
    s = plan.col_start
    r = np.arange(plan.L - 1)
    first = (r % G) % 2 == 0
    second = (r + 1) % G != 0
    d = (s[r + 1] - s[r])[first & second]
    return int(d.max()) if d.size else 0


def poly_geometry(plan: _ops.ResamplePlan, nj: int,
                  tracks: int = 1) -> PolyGeometry:
    """The kernel's tiling of ``plan`` over rows of ``nj`` output frames:
    K7's (``tracks=1``) or K8's (``tracks=2``). The wrappers launch with
    it; the tests model the kernel on it."""
    G, F, P, TP, smem = _tiling(plan, tracks)
    return PolyGeometry(G=G, groups=-(-plan.L // G), frames=32 * F,
                        tiles=-(-nj // (32 * F)), pitch=P, tile_pitch=TP,
                        smem=smem, pair_skew=pair_skew(plan, G))


def device_tables(plan: _ops.ResamplePlan, device,
                  part: str | None = None) -> dict:
    key = ("polyphase", plan.L, plan.M, plan.K2, plan.taps.tobytes(), part)
    return on_device(key, device, lambda: poly_tables(plan, part))


def persistent_blocks(query: str, geo: PolyGeometry, R: int,
                      device: torch.device) -> int:
    """The persistent grid: the kernel's resident blocks per SM (the
    occupancy ``query`` at ``geo.smem``) on every SM, rounded down to a
    multiple of the group count (a block keeps one group), at least one
    block per group and at most one per work item."""
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = _seg.card_slots(query, index, geo.smem)
    per_group = min(R * geo.tiles, max(1, sms * per_sm // geo.groups))
    return per_group * geo.groups


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, whose data starts 16-byte aligned: the
    kernels read rows as aligned 16-byte chunks (K7) or 4-byte sample
    pairs (K8)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def twin_branch(plan: _ops.ResamplePlan, n: int,
                out_len: int) -> tuple[bool, int, int]:
    """(aligned, r0, r2): which branch ``polyphase_resample`` takes at
    row length n, and the aligned branch's edge phases (the windowed
    branch: False, 0, L); the kernel's non-finite mask follows it."""
    nj = -(-out_len // plan.L)
    if n % plan.M == 0 and n >= 2 * plan.M and nj * plan.L == out_len:
        t = _ops.aligned_tables(plan)
        return True, t.r0, t.r2
    return False, 0, plan.L


def resample_pass(x2d: torch.Tensor, plan: _ops.ResamplePlan,
                  out_len: int, part: str | None = None) -> torch.Tensor:
    """The kernel over contiguous float32 CUDA rows (R, n) -> (R,
    out_len), with the taps :func:`poly_tables` gives for ``part``,
    then the launch that writes NaN where the twin's would be (module
    docstring; a no-op for finite input)."""
    global launches
    R, n = x2d.shape
    x2d = aligned16(x2d)
    tabs = device_tables(plan, x2d.device, part)
    nj = -(-out_len // plan.L)
    geo = poly_geometry(plan, nj)
    y = torch.empty((R, out_len), dtype=torch.float32, device=x2d.device)
    flags = torch.zeros(1 + R * nj, dtype=torch.int32, device=x2d.device)
    aligned, r0, r2 = twin_branch(plan, n, out_len)
    lib = _build.load()
    with torch.cuda.device(x2d.device):
        blocks = persistent_blocks("xm_resample_blocks_per_sm", geo, R,
                                   x2d.device)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.xm_resample_f32(
            x2d.data_ptr(), tabs["hsel"].data_ptr(), tabs["soff"].data_ptr(),
            y.data_ptr(), R, n, out_len, plan.L, plan.M, plan.K2, geo.G,
            geo.frames // 32, geo.pitch, geo.tile_pitch, geo.pair_skew,
            blocks, flags.data_ptr(), stream)
        _build.check(rc, "resample")
        rc = lib.xm_resample_nan_fixup(flags.data_ptr(), y.data_ptr(), R,
                                       out_len, plan.L, r0, r2, int(aligned),
                                       stream)
    _build.check(rc, "resample NaN fixup")
    launches += 1
    return y


def resample(x: torch.Tensor, sr_in: int, sr_out: int,
             taps_per_phase: int = 24, beta: float = 9.0,
             interpret: bool | None = None, precision=None) -> torch.Tensor:
    """Resample the last axis of ``x`` (..., n) -> (..., ceil(n*L/M))
    float32: the kernel on CUDA, ``polyphase_resample`` on the CPU, at
    ``precision`` (module docstring). ``interpret=True`` means the twin
    and needs x on the CPU (``utils.device.check_interpret``)."""
    check_interpret(interpret, x.device)
    rung = _prec.resolve(precision)
    g = math.gcd(int(sr_in), int(sr_out))
    L, M = sr_out // g, sr_in // g
    x = x.to(torch.float32)
    if L == M:
        return x
    plan = _ops.make_plan(L, M, taps_per_phase, beta)
    if plan.width > 2 * M or x.device.type == "cpu":
        # the twin (the strided conv for the wide band)
        return _ops.polyphase_resample(x, sr_in, sr_out, taps_per_phase,
                                       beta, precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"no resample kernel for device {x.device}")
    batch, n = x.shape[:-1], x.shape[-1]
    if n < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")
    R = int(np.prod(batch)) if batch else 1
    out_len = _ops.resample_output_len(n, L, M)
    x2d = x.reshape(R, n).contiguous()
    if rung == _prec.HIGHEST:
        y = resample_pass(x2d, plan, out_len)
    elif rung == _prec.DEFAULT:  # the head alone: one rounding pass
        y = resample_pass(x2d.to(torch.bfloat16).float(), plan, out_len,
                          "hi")
    else:
        x_hi, x_lo = (p.float() for p in _prec.split(x2d))
        y = resample_pass(x_hi, plan, out_len, "lo")
        y += resample_pass(x_lo, plan, out_len, "hi")
        y += resample_pass(x_hi, plan, out_len, "hi")
    return y.reshape(*batch, out_len)
