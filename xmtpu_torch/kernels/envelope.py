"""Fused soft-knee limiter of signed rows (counterpart of
``xmtpu.kernels.envelope.limiter_pallas`` on its unsegmented path).

Detector ``|x|``, the envelope recurrences

    env[t] = max(|x[t]|, k_rel * env[t-1])
    e2[t]  = (1 - c_att) * e2[t-1] + c_att * env[t]

from ``init`` = (env, e2), the soft-knee gain evaluated exactly as the
JAX kernel's ``_curve_gain`` (exp/log in float32) and the ceiling clamp.

On a CUDA tensor :func:`limiter` launches the hand-written kernel
``csrc/envelope.cu``. On a CPU tensor it runs :func:`limiter_plain`, a
torch loop over time on (R,) vectors with the same curve, which the CPU
tests and the on-card comparison use.

The JAX package's time-segmented path (taken for small batches) is not
ported, and this limiter has no ``segments=`` knob: it always runs the
unsegmented recurrence.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.ops.limiter import _EPS, _knee_slope

# Launches of the CUDA kernel in this process; callers may reset it.
launches = 0

_LN10 = math.log(10.0)


def curve_of(threshold_db: float, knee_db: float = 6.0,
             ceiling_db: float = 0.0, ratio: float = float("inf"),
             makeup_db: float = 0.0) -> tuple[float, ...]:
    """The curve 5-tuple (threshold_db, knee_db, ceiling_db, slope,
    makeup_db) of the JAX kernel's ``curve=`` argument."""
    return (float(threshold_db), float(knee_db), float(ceiling_db),
            _knee_slope(ratio), float(makeup_db))


def curve_consts(curve) -> tuple[float, ...]:
    """The curve's constants in the kernel's argument order: (20/ln10,
    eps, threshold, W/2, 2W, slope, makeup, ln10/20, ceiling amp)."""
    threshold_db, knee_db, ceiling_db, slope, makeup_db = map(float, curve)
    w = max(knee_db, 1e-6)
    return (20.0 / _LN10, _EPS, threshold_db, 0.5 * w, 2.0 * w, slope,
            makeup_db, _LN10 / 20.0, 10.0 ** (ceiling_db / 20.0))


def curve_apply(x: torch.Tensor, e2: torch.Tensor,
                consts: tuple[float, ...]) -> torch.Tensor:
    """Soft-knee gain from ``e2`` applied to ``x``, clamped (float32)."""
    lvl, eps, thr, half_w, two_w, slope, makeup, exp_s, ceil_amp = consts
    level = lvl * torch.log(torch.clamp_min(e2, eps))
    over = level - thr
    in_knee = slope * (over + half_w) ** 2 / two_w
    red = torch.where(over <= -half_w, 0.0,
                      torch.where(over >= half_w, slope * over, in_knee))
    g = torch.exp((makeup - red) * exp_s)
    return torch.clamp(x * g, -ceil_amp, ceil_amp)


def _check_x(x) -> None:
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor (rows, n)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")


def _check_init(init, x) -> None:
    R = x.shape[0]
    if (not torch.is_tensor(init) or init.dtype != torch.float32
            or tuple(init.shape) != (2, R) or not init.is_contiguous()
            or init.device != x.device):
        raise ValueError(
            f"init must be a contiguous float32 (2, {R}) tensor on "
            f"{x.device}")


def limiter_plain(x: torch.Tensor, k_rel: float, c_att: float,
                  consts: tuple[float, ...], init: torch.Tensor):
    """Plain twin: the recurrences as a torch loop over time, float32
    coefficients as the kernel receives them, then the curve."""
    k = float(np.float32(k_rel))
    c = float(np.float32(c_att))
    a = float(np.float32(1.0) - np.float32(c_att))
    d = x.abs().T.contiguous()  # (n, R): one contiguous row per step
    env = init[0].clone()
    e2 = init[1].clone()
    e2_t = torch.empty_like(d)
    for t in range(d.shape[0]):
        env = torch.maximum(d[t], k * env)
        e2 = a * e2 + c * env
        e2_t[t] = e2
    return curve_apply(x, e2_t.T, consts), torch.stack([env, e2])


def limiter(x: torch.Tensor, k_rel: float, c_att: float, curve,
            init: torch.Tensor | None = None):
    """x (R, n) contiguous float32 -> (y (R, n), zf (2, R) = (env, e2)).
    ``curve``: the 5-tuple of :func:`curve_of`. ``init``: (2, R)
    float32 starting state, None = zeros."""
    global launches
    consts = curve_consts(curve)
    _check_x(x)
    if init is None:
        init = torch.zeros((2, x.shape[0]), dtype=torch.float32,
                           device=x.device)
    _check_init(init, x)
    if x.device.type == "cpu":
        return limiter_plain(x, k_rel, c_att, consts, init)
    if x.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {x.device}")
    R, n = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    zf = torch.empty_like(init)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xm_limiter_f32(
            x.data_ptr(), init.data_ptr(), y.data_ptr(), zf.data_ptr(),
            R, n, k_rel, c_att, *consts, stream)
    _build.check(rc, "envelope")
    launches += 1
    return y, zf
