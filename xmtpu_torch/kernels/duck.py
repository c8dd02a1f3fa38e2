"""The mixer's side-chain duck (``ops.mix.duck_gain_block`` and
``ops.mix.duck_apply``) over (..., n) float32 side chains ``s``:

    env[t] = max(|s[t]|, k env[t-1]);  e2[t] = (1 - c) e2[t-1] + c env[t]
    x = clamp((20 log10(max(e2, 1e-12)) - threshold_db)/knee_db + 0.5, 0, 1)
    g = 10^(-depth_db x / 20)

all in float64, from a state (env[-1], e2[-1]) a row, zeros when None.
Two forms: :func:`gain` returns g (float64) and the final state;
:func:`apply` returns ``s + bed * g.to(float32)``, a float32 ducked bus,
and never stores g. On a CUDA tensor both launch the hand-written kernel
``csrc/duck.cu`` (or raise); on any other device :func:`gain` runs the
plain twin :func:`gain_plain`, the float64 scans of ``ops.limiter``
(``decaying_max_scan``, ``onepole_scan``) and the knee in torch, which
the CPU tests and the JAX comparison use, and :func:`apply` raises
(``ops.mix.duck_apply`` keeps the CPU's expression). No TPU kernel is
ported: the JAX package runs the duck as XLA's associative scans.

The kernel's split (``csrc/duck.cu``'s header): a row in tiles of
:data:`TILE` samples, one block a tile; a tile in :data:`THREADS`
segments of :data:`SEG` samples, one thread a segment; the exact carries
of both recurrences composed across segments by a block scan and across
tiles by a small chain launch. Its rule for the tile count is its own:
S = ceil(n / TILE) a row, so the blocks follow the length (2 x 7,032 at
the mix cell's 2 x 28.8 M) and a frame of a few hundred samples runs at
S = 1, in one launch (pass C alone, from the given state); longer rows
take five (passes A, B and C and the two chains).

Outside the knee's band (:func:`knee_bounds`) x clamps to exactly 0 or
1, and the kernel takes g there without the log and the power: bit for
bit what the band's path gives.
"""

from __future__ import annotations

import math

import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.ops import limiter as _lim

# Launches of the CUDA kernel's passes in this process (5 a call, 1 at
# S = 1); callers may reset it.
launches = 0

# csrc/duck.cu kThreads, kSeg and kTile: segments a block, samples a
# segment, samples a tile
THREADS = 256
SEG = 16
TILE = THREADS * SEG
# The margin of knee_bounds: x clamps past the bounds by at least
# 20 log10(1 + 1e-9) = 8.7e-9 dB, against rounding of about 1e-12 dB in
# the level and the knee's arithmetic.
_MARGIN = 1e-9


def tiles(n: int) -> int:
    """Tiles a row of ``n`` samples takes on the kernel (its S)."""
    return max(1, -(-n // TILE))


def knee(e2: torch.Tensor, threshold_db: float, depth_db: float,
         knee_db: float) -> torch.Tensor:
    """The gate's gain of a float64 e2 (the twin's knee)."""
    env_db = 20.0 * torch.log10(torch.clamp_min(e2, 1e-12))
    x = torch.clamp((env_db - threshold_db) / knee_db + 0.5, 0.0, 1.0)
    return torch.pow(10.0, -depth_db * x / 20.0)


def knee_bounds(threshold_db: float, knee_db: float) -> tuple[float, float]:
    """(e_lo, e_hi): x is exactly 0 for e2 <= e_lo and exactly 1 for e2
    >= e_hi, with a margin of :data:`_MARGIN` of e2 past the knee's ends
    (thr -/+ knee/2 dB); NaN for a bound the margin cannot prove (a knee
    outside (0, 1e4] dB, a threshold past 1e4 dB, e_lo below the level
    meter's 1e-12 floor), so the kernel evaluates the knee there."""
    thr, kn = float(threshold_db), float(knee_db)
    if not (0.0 < kn <= 1e4 and abs(thr) <= 1e4):
        return math.nan, math.nan
    e_lo = 10.0 ** ((thr - kn / 2.0) / 20.0) * (1.0 - _MARGIN)
    e_hi = 10.0 ** ((thr + kn / 2.0) / 20.0) * (1.0 + _MARGIN)
    return (e_lo if e_lo >= 1e-12 else math.nan), e_hi


def gain_plain(s: torch.Tensor, k_rel: float, c_att: float,
               threshold_db: float, depth_db: float, knee_db: float,
               state=None):
    """Plain twin of the gain form: (g float64 of s's shape, (env_last,
    e2_last)) from the float64 scans and :func:`knee`. ``state``:
    (env, e2) shaped (...,) or broadcastable, or None for zeros."""
    d = s.to(torch.float64).abs()
    if state is None:
        z = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
        state = (z, z)
    env, env_last = _lim.decaying_max_scan(d, k_rel, state[0])
    e2, sm_last = _lim.onepole_scan(env, c_att, state[1])
    return knee(e2, threshold_db, depth_db, knee_db), (env_last, sm_last)


def _rows(s: torch.Tensor, what: str) -> torch.Tensor:
    if s.dtype != torch.float32 or s.dim() < 1 or not s.numel():
        raise ValueError(f"{what} must be a non-empty float32 tensor "
                         "(..., n)")
    return s.reshape(-1, s.shape[-1]).contiguous()


def _state_rows(x, lead, device) -> torch.Tensor:
    """A carried state (tensor, array or float) broadcast to the leading
    shape ``lead``, as a contiguous float64 row vector on ``device``."""
    t = torch.as_tensor(x, dtype=torch.float64, device=device)
    return t.expand(lead).reshape(-1).contiguous()


def _launch(s, lead, bed, out, g, state, env_last, e2_last, k_rel, c_att,
            threshold_db, depth_db, knee_db) -> None:
    """One call of the kernel over (R, n) rows ``s``, the side chain's
    leading shape ``lead`` flattened (module docstring)."""
    global launches
    R, n = s.shape
    if R > 65535:
        raise ValueError(f"{R} rows: the kernel takes at most 65,535")
    S = tiles(n)
    env0 = e20 = None
    if state is not None:
        env0, e20 = (_state_rows(x, lead, s.device) for x in state)
    scratch = (torch.empty(4 * R * S, dtype=torch.float64, device=s.device)
               if S > 1 else None)
    c = float(c_att)
    e_lo, e_hi = knee_bounds(threshold_db, knee_db)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = lib.xm_duck_f32(
            s.data_ptr(), ptr(bed), ptr(out), ptr(g), ptr(env0), ptr(e20),
            ptr(env_last), ptr(e2_last), ptr(scratch), R, n, S,
            float(k_rel), 1.0 - c, c, int(c >= 1.0), float(threshold_db),
            float(knee_db), -float(depth_db), e_lo, e_hi, stream)
    _build.check(rc, "duck")
    launches += 5 if S > 1 else 1


def gain(s: torch.Tensor, k_rel: float, c_att: float, threshold_db: float,
         depth_db: float, knee_db: float, state=None):
    """The gain form: (g float64 of s's shape, (env_last, e2_last) shaped
    s.shape[:-1]) for the side chain ``s`` (..., n), from ``state`` (the
    carried (env, e2), or None for zeros). The kernel on CUDA (``s``
    float32), :func:`gain_plain` elsewhere."""
    if s.device.type != "cuda":
        return gain_plain(s, k_rel, c_att, threshold_db, depth_db, knee_db,
                          state)
    x = _rows(s, "the side chain")
    g = torch.empty(x.shape, dtype=torch.float64, device=s.device)
    env_last = torch.empty(x.shape[0], dtype=torch.float64, device=s.device)
    e2_last = torch.empty_like(env_last)
    lead = s.shape[:-1]
    _launch(x, lead, None, None, g, state, env_last, e2_last, k_rel, c_att,
            threshold_db, depth_db, knee_db)
    return g.reshape(s.shape), (env_last.reshape(lead),
                                e2_last.reshape(lead))


def apply(s: torch.Tensor, bed: torch.Tensor, k_rel: float, c_att: float,
          threshold_db: float, depth_db: float, knee_db: float, state=None,
          overwrite: bool = False) -> torch.Tensor:
    """The mix form: ``s + bed * g.to(float32)`` with g the gain form's,
    as float32 of s's shape; ``bed`` float32 of s's shape. With
    ``overwrite`` the result may be written over ``s`` (the caller owns
    it). The kernel; ``s`` on a CUDA device, or it raises."""
    if s.device.type != "cuda":
        raise ValueError(f"the duck's mix form runs on a CUDA device, not "
                         f"{s.device}")
    if (not torch.is_tensor(bed) or bed.shape != s.shape
            or bed.device != s.device):
        raise ValueError(f"bed must be a tensor of the side chain's shape "
                         f"{tuple(s.shape)} on {s.device}")
    x = _rows(s, "the side chain")
    b = _rows(bed, "bed")
    out = x if overwrite else torch.empty_like(x)
    _launch(x, s.shape[:-1], b, out, None, state, None, None, k_rel, c_att,
            threshold_db, depth_db, knee_db)
    return out.reshape(s.shape)
