"""Soft-knee limiter math (counterpart of ``xmtpu.ops.limiter``).

Pinned semantics, mirrored exactly by :func:`limiter_np`:

1. detector ``d[n] = max_ch |x[n]|`` (channels linked);
2. peak envelope ``env[n] = max(d[n], k_rel * env[n-1])``,
   ``k_rel = exp(-1/(release_ms * sr / 1000))``;
3. attack smoothing ``e2[n] = (1-c) e2[n-1] + c env[n]``;
4. soft-knee static curve in dB: reduction 0 below ``T - W/2``,
   ``(over + W/2)^2 / (2W)`` inside the knee, ``over`` above;
5. safety clamp at ``ceiling_db``.

:func:`limiter` is the JAX package's ``limiter`` on either engine. On
its kernel backend (``"pallas"``, the port's default) steps 1-3 run in
the envelope kernels (``xmtpu_torch.kernels.envelope``): the detector,
the time-segmented envelope kernel, then the elementwise curve in torch;
with ``linked_fuse=True`` the curve runs in the kernel's gain form,
``kernels.envelope.linked_limiter``. On ``"scan"`` the whole limiter
runs in float64, steps 2-3 as log-depth associative scans
(:func:`decaying_max_scan`, :func:`onepole_scan`). The flagship chain's
fused branch runs steps 1-5 in one kernel instead. This module also
holds the coefficient helpers and the float64 oracle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels.envelope import (_EPS, _knee_slope, envelope,
                                          linked_limiter)
from xmtpu_torch.ops._scan import associative_scan
from xmtpu_torch.utils.errors import ConfigError
from xmtpu_torch.utils.profiling import stage


def _release_coeff(release_ms: float, sr: int) -> float:
    if release_ms <= 0:
        return 0.0
    return math.exp(-1.0 / (release_ms * sr / 1000.0))


def _attack_coeff(attack_ms: float, sr: int) -> float:
    if attack_ms <= 0:
        return 1.0  # identity smoothing
    return 1.0 - math.exp(-1.0 / (attack_ms * sr / 1000.0))


def _decay_max_combine(lhs, rhs):
    lv, lp = lhs
    rv, rp = rhs
    return torch.maximum(rv, rp * lv), lp * rp


def _init_of(init, like: torch.Tensor) -> torch.Tensor:
    """A carried state (tensor, array or plain float) as a tensor of
    ``like``'s dtype and device, shaped like ``like`` without its last
    axis."""
    t = torch.as_tensor(init, dtype=like.dtype, device=like.device)
    return t.expand(like.shape[:-1])


def decaying_max_scan(d: torch.Tensor, k: float, init):
    """env[n] = max(d[n], k*env[n-1]) over the last axis; ``init`` =
    env[-1]. Returns (env, env_last). The initial state folds in closed
    form: env[n] = max(v[n], k^(n+1) * init) (k = 0: no carry)."""
    init = _init_of(init, d)
    p = torch.full_like(d, k)
    v, _ = associative_scan(_decay_max_combine, (d, p))
    npts = d.shape[-1]
    if k > 0:
        expo = torch.arange(1, npts + 1, dtype=d.dtype, device=d.device)
        decay = torch.exp(expo * math.log(k))
    else:
        decay = torch.zeros(npts, dtype=d.dtype, device=d.device)
    env = torch.maximum(v, decay * init[..., None])
    return env, env[..., -1]


def _onepole_combine(lhs, rhs):
    lv, lp = lhs
    rv, rp = rhs
    return rp * lv + rv, lp * rp


def onepole_scan(u: torch.Tensor, c: float, init):
    """e[n] = (1-c) e[n-1] + c u[n] over the last axis; ``init`` =
    e[-1]. Returns (e, e_last); ``c >= 1`` is the identity."""
    init = _init_of(init, u)
    if c >= 1.0:
        return u, u[..., -1]
    a = 1.0 - c
    v, _ = associative_scan(_onepole_combine, (c * u, torch.full_like(u, a)))
    npts = u.shape[-1]
    expo = torch.arange(1, npts + 1, dtype=u.dtype, device=u.device)
    e = v + torch.exp(expo * math.log(a)) * init[..., None]
    return e, e[..., -1]


def check_envelope_block(envelope_block) -> int | None:
    """The JAX package's validation of ``envelope_block``: None or a
    power of two >= 1. The port's kernels step per sample, the same
    function in exact arithmetic as any block lookahead, so every valid
    value runs the same path."""
    if envelope_block is None:
        return None
    eb = int(envelope_block)
    if eb < 1 or eb & (eb - 1):
        raise ConfigError(
            f"envelope_block={eb} must be a power of two "
            "(1 = explicit per-sample recurrence)")
    return eb


def soft_knee_gain_db(level_db: torch.Tensor, threshold_db: float,
                      knee_db: float, ratio: float = float("inf")):
    """Gain (<= 0 dB) from the soft-knee static curve. Elementwise."""
    slope = _knee_slope(ratio)
    over = level_db - threshold_db
    w = max(float(knee_db), 1e-6)
    in_knee = slope * (over + 0.5 * w) ** 2 / (2.0 * w)
    red = torch.where(
        over <= -0.5 * w, 0.0,
        torch.where(over >= 0.5 * w, slope * over, in_knee))
    return -red


def apply_gain_curve(x: torch.Tensor, e2: torch.Tensor, threshold_db: float,
                     knee_db: float = 6.0, ceiling_db: float = 0.0,
                     ratio: float = float("inf"), makeup_db: float = 0.0):
    """Steps 4-5: soft-knee curve on the smoothed envelope ``e2``
    (..., n), gain applied to ``x`` (..., ch, n), safety clamp."""
    level_db = 20.0 * torch.log10(torch.clamp_min(e2, _EPS))
    g = torch.pow(
        10.0,
        (soft_knee_gain_db(level_db, threshold_db, knee_db, ratio) + makeup_db)
        / 20.0,
    )
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    return torch.clamp(x * g[..., None, :], -ceil_amp, ceil_amp)


def _check_n_valid(x: torch.Tensor, n_valid) -> torch.Tensor:
    """x's first n_valid samples (the JAX validation: 1 <= n_valid <=
    x.shape[-1])."""
    if n_valid is None:
        return x
    nv = int(n_valid)
    if not 1 <= nv <= x.shape[-1]:
        raise ValueError(f"n_valid={nv} outside [1, {x.shape[-1]}]")
    return x[..., :nv]


LIMITER_BACKENDS = ("pallas", "scan")


def limiter(x: torch.Tensor, sr: int, threshold_db: float = -3.0,
            knee_db: float = 6.0, attack_ms: float = 1.0,
            release_ms: float = 100.0, ceiling_db: float = 0.0, state=None,
            ratio: float = float("inf"), makeup_db: float = 0.0,
            envelope_block: int | None = None, n_valid: int | None = None,
            linked_fuse: bool = False, backend: str = "pallas"):
    """Soft-knee limit ``x`` (..., channels, n) -> (y (..., channels,
    n_valid or n) in x's dtype, (env_last, e2_last) each (...,)).

    Channels (axis -2) are linked; leading axes are independent rows.
    ``state``: (env, e2) carried from a previous block, or None.
    ``n_valid``: only the first n_valid samples of x are signal.

    ``backend="pallas"`` (the port's default; x float32): the envelope
    runs on the envelope kernel (time-segmented for small batches, as
    the JAX package's Pallas backend picks it), the curve in torch;
    ``linked_fuse=True`` runs the curve in the kernel's gain form
    instead (the JAX ``linked_limiter_pallas``). ``backend="scan"``: the
    JAX package's float64 engine, the whole limiter in float64 and the
    state float64; ``linked_fuse`` has no scan form there and raises
    :class:`ConfigError` (the JAX package ignores it). ``envelope_block``:
    None or a power of two (else :class:`ConfigError`); the kernels step
    per sample whatever its value, and the scans ignore it."""
    check_envelope_block(envelope_block)
    if backend not in LIMITER_BACKENDS:
        raise ValueError(f"unknown limiter backend {backend!r}; accepted: "
                         + ", ".join(LIMITER_BACKENDS))
    k_rel = _release_coeff(release_ms, sr)
    c_att = _attack_coeff(attack_ms, sr)
    if backend == "scan":
        if linked_fuse:
            raise ConfigError("linked_fuse=True runs the envelope kernel's "
                              "gain form; the scan backend has no such form")
        if not torch.is_tensor(x) or x.dim() < 2:
            raise ValueError("x must be a tensor (..., channels, n)")
        in_dtype = x.dtype
        xf = _check_n_valid(x.to(torch.float64), n_valid)
        with stage("envelope"):
            d = torch.amax(xf.abs(), dim=-2)  # linked channels: (..., n)
            if state is None:
                state = (0.0, 0.0)
            env, env_last = decaying_max_scan(d, k_rel, state[0])
            e2, sm_last = onepole_scan(env, c_att, state[1])
        with stage("curve"):
            y = apply_gain_curve(xf, e2, threshold_db, knee_db, ceiling_db,
                                 ratio, makeup_db)
        return y.to(in_dtype), (env_last, sm_last)
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() < 2:
        raise ValueError("x must be a float32 tensor (..., channels, n)")
    if linked_fuse:
        with stage("linked limiter"):
            return linked_limiter(x, k_rel, c_att, threshold_db,
                                  knee_db=knee_db, ceiling_db=ceiling_db,
                                  ratio=ratio, makeup_db=makeup_db,
                                  init=state, n_valid=n_valid)
    x = _check_n_valid(x, n_valid)
    with stage("envelope"):
        d = torch.amax(x.abs(), dim=-2)  # linked channels: (..., n)
        e2, st = envelope(d, k_rel, c_att, init=state)
    with stage("curve"):
        y = apply_gain_curve(x, e2, threshold_db, knee_db, ceiling_db, ratio,
                             makeup_db)
    return y, st


def limiter_np(
    x,
    sr,
    threshold_db=-3.0,
    knee_db=6.0,
    attack_ms=1.0,
    release_ms=100.0,
    ceiling_db=0.0,
    state=(0.0, 0.0),
    ratio=float("inf"),
    makeup_db=0.0,
):
    """Float64 sequential oracle of steps 1-5 for ``x`` (..., ch, n).
    Returns (y, (env_last, e2_last))."""
    x = np.asarray(x, np.float64)
    k_rel = _release_coeff(release_ms, sr)
    c_att = _attack_coeff(attack_ms, sr)
    d = np.max(np.abs(x), axis=-2)  # (..., n): channels linked, batch free
    env_prev = np.broadcast_to(np.asarray(state[0], np.float64), d.shape[:-1]).copy()
    sm_prev = np.broadcast_to(np.asarray(state[1], np.float64), d.shape[:-1]).copy()
    n = d.shape[-1]
    env = np.empty_like(d)
    e2 = np.empty_like(d)
    for i in range(n):
        env_prev = np.maximum(d[..., i], k_rel * env_prev)
        env[..., i] = env_prev
        sm_prev = (1.0 - c_att) * sm_prev + c_att * env_prev if c_att < 1.0 else env_prev
        e2[..., i] = sm_prev
    level_db = 20.0 * np.log10(np.maximum(e2, _EPS))
    slope = _knee_slope(ratio)
    over = level_db - threshold_db
    w = max(float(knee_db), 1e-6)
    red = np.where(
        over <= -0.5 * w, 0.0,
        np.where(over >= 0.5 * w, slope * over,
                 slope * (over + 0.5 * w) ** 2 / (2 * w))
    )
    g = 10.0 ** ((-red + makeup_db) / 20.0)
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    y = np.clip(x * g[..., None, :], -ceil_amp, ceil_amp)
    return y, (env_prev, sm_prev)
