"""The noise suppressor's PSD smoothing and Wiener gain over the spectra
(``ops.ns`` items 3 and 4 and the product X*G), for a noise estimate
fixed per row and bin (the frozen median or a caller's ``noise_psd``):

    P[t] = a P[t-1] + (1-a) |X[t]|^2;   snr = max(P / noise - 1, 0)
    Y[t] = X[t] * max(snr / (1 + snr), floor)

along the frames of each (row, bin). On a CUDA tensor :func:`wiener`
launches the hand-written kernel ``csrc/ns_wiener.cu``, which writes Y
over X; on a CPU tensor it runs :func:`wiener_plain`, the suppressor's
torch steps (the log-depth scan :func:`onepole_frames`, then
:func:`wiener_gain`), which the CPU tests and the on-card comparison
use. No TPU kernel is ported: the JAX package runs these steps in XLA.

The kernel splits the frames into S segments of L = ceil(T / S) frames
(:func:`seg_plan`; the last one shorter) so that R*F*S threads fill the
card (:func:`wiener_segments`): pass A smooths each segment from zero
and keeps its final P, pass B enters segment s with the exact carry
``carry[s] = a^L carry[s-1] + fin[s-1]`` and writes Y. With S = 1 pass A
is skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels import _build, _seg
from xmtpu_torch.ops._scan import associative_scan

# Launches of the CUDA kernel's passes in this process (2 a call, 1 at
# S = 1); callers may reset it.
launches = 0

BLOCK = 128  # chains (row, bin) a block: csrc/ns_wiener.cu kThreads
# Waves of blocks the segments make on a card: at the voice cell's shape
# on an H100 the kernel took 0.89 ms in one wave (S = 10) and 0.82 in
# four (S = 40; no faster at 96).
WAVES = 4
# Frames a segment holds at least: below that a thread's carry over the
# finals before it (S - 1 steps) costs as much as its segment.
MIN_SEGLEN = 64
_MAX_GRID_Y = 65535


def _onepole_combine(lhs, rhs):
    lv, lp = lhs
    rv, rp = rhs
    return rp * lv + rv, lp * rp


def onepole_frames(psd: torch.Tensor, a: float) -> torch.Tensor:
    """P[t] = a P[t-1] + (1-a) psd[t] over axis -2 (frames), as one
    associative scan."""
    v = psd.movedim(-2, -1)
    a_t = torch.tensor(a, dtype=psd.dtype)
    out, _ = associative_scan(_onepole_combine,
                              ((1 - a_t) * v, torch.full_like(v, a)))
    return out.movedim(-1, -2)


def wiener_gain(P: torch.Tensor, noise: torch.Tensor,
                floor: float) -> torch.Tensor:
    """G = max(snr / (1 + snr), floor), snr = max(P / max(noise, 1e-20)
    - 1, 0); ``noise`` broadcasts against ``P``."""
    snr = torch.clamp_min(P / torch.clamp_min(noise, 1e-20) - 1.0, 0.0)
    return torch.clamp_min(snr / (1.0 + snr), float(floor))


def wiener_plain(X: torch.Tensor, noise: torch.Tensor, smooth: float,
                 floor: float) -> torch.Tensor:
    """Plain twin of the kernel: X (..., T, F) complex64, noise (..., F)
    -> X * G, a new tensor."""
    P = onepole_frames(torch.square(torch.abs(X)), float(smooth))
    return X * wiener_gain(P, noise[..., None, :], floor)


def seg_plan(T: int, S: int) -> tuple[int, int]:
    """(S, L) for at most ``S`` segments of T frames: L = ceil(T / S),
    then as many segments of L as T needs, so every segment holds a
    frame and the last one T - (S - 1) L of them."""
    S = max(1, min(int(S), T, _MAX_GRID_Y))
    L = -(-T // S)
    return -(-T // L), L


def segment_count(R: int, T: int, F: int, sms: int, per_sm: int) -> int:
    """The segments that fill a card of ``sms`` SMs holding ``per_sm``
    of pass B's blocks each :data:`WAVES` times over, with ceil(R*F /
    BLOCK) blocks a segment, in segments of at least :data:`MIN_SEGLEN`
    frames (1 below that)."""
    cols = -(-R * F // BLOCK)
    return max(1, min(WAVES * sms * per_sm // cols, T // MIN_SEGLEN))


def wiener_segments(R: int, T: int, F: int, device) -> int:
    """S of :func:`wiener` on ``device``: :func:`segment_count` over the
    card's SMs and pass B's resident blocks (``_seg.card_slots``); 1 off
    a card, where the plain twin runs unsegmented."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = _seg.card_slots("xm_ns_wiener_blocks_per_sm", index)
    return seg_plan(T, segment_count(R, T, F, sms, per_sm))[0]


def _check(X, noise) -> None:
    if (not torch.is_tensor(X) or X.dtype != torch.complex64
            or X.dim() < 2 or not X.is_contiguous()):
        raise ValueError("X must be a contiguous complex64 tensor "
                         "(..., T, F)")
    if (not torch.is_tensor(noise) or noise.dtype != torch.float32
            or noise.device != X.device):
        raise ValueError(f"noise must be a float32 tensor on {X.device}")
    T, F = X.shape[-2:]
    if T * F >= 2**31:
        raise ValueError(f"{T} frames of {F} bins: the kernel indexes a "
                         "row's spectra with 32-bit offsets")


def wiener(X: torch.Tensor, noise: torch.Tensor, smooth: float,
           floor: float, segments: int | None = None) -> torch.Tensor:
    """Y = X * G (module docstring) for X (..., T, F) complex64 and the
    noise estimate (..., F) float32, broadcast to X's leading dims. On
    CUDA the kernel writes Y over X and returns X, in ``segments``
    segments (None: :func:`wiener_segments`); on the CPU the twin
    returns a new tensor."""
    global launches
    _check(X, noise)
    if X.device.type == "cpu":
        return wiener_plain(X, noise, smooth, floor)
    if X.device.type != "cuda":
        raise ValueError(f"no Wiener kernel for device {X.device}")
    *lead, T, F = X.shape
    R = int(np.prod(lead, dtype=np.int64))
    nz = torch.broadcast_to(noise, (*lead, F)).reshape(R, F).contiguous()
    if R == 0 or T == 0 or F == 0:
        return X
    S, L = seg_plan(T, wiener_segments(R, T, F, X.device)
                    if segments is None else segments)
    fin = torch.empty((S - 1, R * F), dtype=torch.float32, device=X.device)
    a = np.float32(smooth)
    b = np.float32(1.0) - a
    aL = float(np.float64(a) ** L)  # a^L of the float32 a, rounded once
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.xm_ns_wiener_f32(X.data_ptr(), X.data_ptr(), nz.data_ptr(),
                                  fin.data_ptr(), R, T, F, S, L, float(a),
                                  float(b), aL, float(np.float32(floor)),
                                  stream)
    _build.check(rc, "ns_wiener")
    launches += 2 if S > 1 else 1
    return X
