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

For the adaptive estimate (``ops.ns`` item 2: a per-frame nonlinear
recursion seeded by the lead-in median) :func:`track` runs the tracker,
the smoothing and the gain in float64 over float64 spectra and writes Y
as complex64: on a CUDA tensor the hand-written kernel
``csrc/ns_track.cu``, on a CPU tensor its plain twin :func:`track_plain`,
a loop over frames that rounds every operation as the kernel does, so
the two give the same Y bit for bit on the same spectra. The float64 is
there for the branch decisions, which must be the float64 definition's
(``csrc/ns_track.cu``'s header). The recursion has no closed-form carry
along frames, so the kernel splits the frames (:func:`track_plan`, S
from :func:`track_segments`) by replay: pass A walks each chain through the
first S - 1 segments and keeps the state (estimate, P) at each
segment's start; pass B replays each segment from its state and writes
Y. With S = 1 pass A is skipped.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels import _build, _seg
from xmtpu_torch.ops._scan import associative_scan

# Launches of the CUDA kernel's passes in this process (2 a call, 1 at
# S = 1); callers may reset it.
launches = 0
# Launches of the adaptive tracker's kernel passes (2 a call, 1 at S = 1);
# callers may reset it.
track_launches = 0

# chains (row, bin) a block: csrc/ns_wiener.cu kThreads and
# csrc/ns_track.cu kThreadsB
BLOCK = 128
# Waves of blocks the segments make on a card: at the voice cell's shape
# on an H100 the kernel took 0.89 ms in one wave (S = 10) and 0.82 in
# four (S = 40; no faster at 96).
WAVES = 4
# Frames a segment holds at least: below that a thread's carry over the
# finals before it (S - 1 steps) costs as much as its segment.
MIN_SEGLEN = 64
# Frames pass A of the tracker kernel takes at once: its segments hold a
# multiple of them (csrc/ns_track.cu kGroupA).
TRACK_GROUP = 8
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


def track_plan(T: int, S: int) -> tuple[int, int]:
    """(S, L) of the tracker kernel for at most ``S`` segments of T
    frames: :func:`seg_plan`'s L rounded up to a multiple of
    :data:`TRACK_GROUP`, then as many segments of L as T needs."""
    L = seg_plan(T, S)[1]
    L = -(-L // TRACK_GROUP) * TRACK_GROUP
    return -(-T // L), L


def track_segments(R: int, T: int, F: int, device) -> int:
    """S of :func:`track` on ``device``: :func:`segment_count` over the
    card's SMs and pass B's resident blocks; 1 off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = _seg.card_slots("xm_ns_track_blocks_per_sm", index)
    return track_plan(T, segment_count(R, T, F, sms, per_sm))[0]


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


def adaptive_noise_step(noise, psd_t, a_n: float, thresh: float,
                        up_leak: float):
    """One frame of the pinned adaptive noise recursion (``ops.ns`` item
    2; the offline loop, the streaming step and :func:`track_plain` run
    it)."""
    ratio = psd_t / torch.clamp_min(noise, 1e-20)
    upd = a_n * noise + (1.0 - a_n) * psd_t
    return torch.where(ratio < thresh, upd, noise * up_leak)


def track_plain(X: torch.Tensor, seed: torch.Tensor, smooth: float,
                floor: float, noise_frames: int, noise_smooth: float,
                presence_thresh: float, up_leak: float,
                noise_out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the tracker kernel: X (..., T, F) complex128, the
    seed (..., F) float64 -> Y = X * G as a new complex64 tensor; each
    frame's estimate into ``noise_out`` (float64, X's shape) when given.
    The estimate holds the seed for the first ``noise_frames`` frames."""
    re, im = X.real, X.imag
    psd = re * re + im * im
    a = float(smooth)
    nz = torch.broadcast_to(seed, psd.shape[:-2] + psd.shape[-1:])
    P = torch.zeros_like(nz)
    Y = torch.empty(X.shape, dtype=torch.complex64, device=X.device)
    for t in range(X.shape[-2]):
        p = psd[..., t, :]
        if t >= noise_frames:
            nz = adaptive_noise_step(nz, p, float(noise_smooth),
                                     float(presence_thresh), float(up_leak))
        P = a * P + (1.0 - a) * p
        snr = torch.clamp_min(P / torch.clamp_min(nz, 1e-20) - 1.0, 0.0)
        g = torch.clamp_min(snr / (1.0 + snr), float(floor))
        Y[..., t, :] = torch.complex(re[..., t, :] * g, im[..., t, :] * g)
        if noise_out is not None:
            noise_out[..., t, :] = nz
    return Y


def _check_track(X, seed, noise_out) -> None:
    if (not torch.is_tensor(X) or X.dtype != torch.complex128
            or X.dim() < 2 or not X.is_contiguous()):
        raise ValueError("X must be a contiguous complex128 tensor "
                         "(..., T, F)")
    if (not torch.is_tensor(seed) or seed.dtype != torch.float64
            or seed.device != X.device):
        raise ValueError(f"seed must be a float64 tensor on {X.device}")
    if noise_out is not None and (
            not torch.is_tensor(noise_out) or noise_out.dtype != torch.float64
            or noise_out.shape != X.shape or noise_out.device != X.device
            or not noise_out.is_contiguous()):
        raise ValueError("noise_out must be a contiguous float64 tensor "
                         f"of X's shape {tuple(X.shape)} on {X.device}")
    T, F = X.shape[-2:]
    if T * F >= 2**31:
        raise ValueError(f"{T} frames of {F} bins: the kernel indexes a "
                         "row's spectra with 32-bit offsets")


def _fast_bounds(thresh: float) -> tuple[float, float]:
    """(tlo, thi) of the kernel's decision without a division
    (``csrc/ns_track.cu``'s header): thresh * (1 -/+ 2^-40) where
    thresh lies in (2^-900, 2^900), else (-inf, inf), so the division
    always decides."""
    if not 2.0**-900 < thresh < 2.0**900:
        return -math.inf, math.inf
    return thresh * (1.0 - 2.0**-40), thresh * (1.0 + 2.0**-40)


def track(X: torch.Tensor, seed: torch.Tensor, smooth: float, floor: float,
          noise_frames: int, noise_smooth: float, presence_thresh: float,
          up_leak: float, noise_out: torch.Tensor | None = None,
          segments: int | None = None) -> torch.Tensor:
    """Y = X * G with the adaptive estimate (module docstring) for X
    (..., T, F) complex128 and the seed (..., F) float64, broadcast to
    X's leading dims -> a new complex64 tensor: the kernel on CUDA, in
    ``segments`` segments (None: :func:`track_segments`), the twin on the
    CPU. ``noise_out`` (float64, X's shape) receives each frame's
    estimate when given."""
    global track_launches
    _check_track(X, seed, noise_out)
    args = (float(smooth), float(floor), int(noise_frames),
            float(noise_smooth), float(presence_thresh), float(up_leak))
    if X.device.type == "cpu":
        return track_plain(X, seed, *args, noise_out=noise_out)
    if X.device.type != "cuda":
        raise ValueError(f"no tracker kernel for device {X.device}")
    *lead, T, F = X.shape
    R = int(np.prod(lead, dtype=np.int64))
    sd = torch.broadcast_to(seed, (*lead, F)).reshape(R, F).contiguous()
    Y = torch.empty(X.shape, dtype=torch.complex64, device=X.device)
    if R == 0 or T == 0 or F == 0:
        return Y
    a, gfloor, lead_frames, an, thresh, leak = args
    S, L = track_plan(T, track_segments(R, T, F, X.device)
                      if segments is None else segments)
    ck = torch.empty((2 * (S - 1), R * F), dtype=torch.float64,
                     device=X.device)
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = lib.xm_ns_track_f64(
            X.data_ptr(), Y.data_ptr(), sd.data_ptr(),
            None if noise_out is None else noise_out.data_ptr(),
            ck.data_ptr(), R, T, F, S, L, lead_frames, a, 1.0 - a, an,
            1.0 - an, thresh, *_fast_bounds(thresh), leak, gfloor, stream)
    _build.check(rc, "ns_track")
    track_launches += 2 if S > 1 else 1
    return Y
