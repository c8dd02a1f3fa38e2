"""Biquad EQ (counterpart of ``xmtpu.ops.biquad``): the RBJ host design
(bit-exact with the JAX package's), the float64 scan engine's cascade
(:func:`sosfilt_scan`) and the float64 sequential oracle.

On the flagship path the EQ cascade never runs as an IIR on the device:
it is LTI, so its truncated impulse response (:func:`sos_impulse_np`)
folds into the reverb IR on the host (``batch._combined_ir``); the
kernel engine's cascade is ``kernels.iir.sosfilt``. :func:`sosfilt_scan`
is the JAX package's float64 associative-scan form, in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.ops._scan import associative_scan

_RBJ_KINDS = (
    "peaking",
    "lowshelf",
    "highshelf",
    "lowpass",
    "highpass",
    "bandpass",
    "notch",
)


def rbj_coeffs(
    kind: str, freq_hz: float, sr: int, q: float = 0.7071, gain_db: float = 0.0
) -> np.ndarray:
    """One RBJ biquad section -> sos row [b0, b1, b2, 1, a1, a2] (float64).

    Formulas follow the RBJ Audio EQ Cookbook exactly; ``gain_db`` is
    meaningful for peaking/shelf kinds only.
    """
    if kind not in _RBJ_KINDS:
        raise ValueError(f"unknown biquad kind {kind!r}; known: {_RBJ_KINDS}")
    if not (0.0 < freq_hz < sr / 2.0):
        raise ValueError(f"freq_hz must be in (0, sr/2), got {freq_hz} at sr={sr}")
    if not q > 0.0:
        # q <= 0 flips alpha's sign and pushes the poles outside the
        # unit circle: a silently diverging filter
        raise ValueError(f"q must be > 0, got {q}")
    if not math.isfinite(gain_db):
        raise ValueError(f"gain_db must be finite, got {gain_db}")
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * freq_hz / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)

    if kind == "peaking":
        b = [1 + alpha * A, -2 * cw, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cw, 1 - alpha / A]
    elif kind == "lowshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = [
            A * ((A + 1) - (A - 1) * cw + sq),
            2 * A * ((A - 1) - (A + 1) * cw),
            A * ((A + 1) - (A - 1) * cw - sq),
        ]
        a = [
            (A + 1) + (A - 1) * cw + sq,
            -2 * ((A - 1) + (A + 1) * cw),
            (A + 1) + (A - 1) * cw - sq,
        ]
    elif kind == "highshelf":
        sq = 2.0 * math.sqrt(A) * alpha
        b = [
            A * ((A + 1) + (A - 1) * cw + sq),
            -2 * A * ((A - 1) + (A + 1) * cw),
            A * ((A + 1) + (A - 1) * cw - sq),
        ]
        a = [
            (A + 1) - (A - 1) * cw + sq,
            2 * ((A - 1) - (A + 1) * cw),
            (A + 1) - (A - 1) * cw - sq,
        ]
    elif kind == "lowpass":
        b = [(1 - cw) / 2, 1 - cw, (1 - cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cw) / 2, -(1 + cw), (1 + cw) / 2]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    elif kind == "bandpass":  # constant 0 dB peak gain
        b = [alpha, 0.0, -alpha]
        a = [1 + alpha, -2 * cw, 1 - alpha]
    else:  # notch
        b = [1.0, -2 * cw, 1.0]
        a = [1 + alpha, -2 * cw, 1 - alpha]

    a0 = a[0]
    return np.array(
        [b[0] / a0, b[1] / a0, b[2] / a0, 1.0, a[1] / a0, a[2] / a0], np.float64
    )


def eq_sos(bands, sr: int) -> np.ndarray:
    """Build an [S, 6] sos cascade from EQ band dicts.

    Each band: {"freq_hz": f, "gain_db": g, "q": q, "kind": "peaking"}
    (kind optional; the default 5-band EQ is all-peaking).
    """
    keys = {"freq_hz", "gain_db", "q", "kind"}
    rows = []
    for b in bands:
        if not isinstance(b, dict) or "freq_hz" not in b:
            raise ValueError(
                f"EQ band needs 'freq_hz' (and optional gain_db/q/kind),"
                f" got {b!r}")
        unknown = set(b) - keys
        if unknown:
            raise ValueError(
                f"EQ band has unknown key(s) {sorted(unknown)}: {b!r}")
        rows.append(rbj_coeffs(
            b.get("kind", "peaking"),
            float(b["freq_hz"]),
            sr,
            q=float(b.get("q", 0.7071)),
            gain_db=float(b.get("gain_db", 0.0)),
        ))
    return np.stack(rows) if rows else np.zeros((0, 6), np.float64)


def _affine_combine(lhs, rhs):
    """Compose affine maps z -> M z + v: rhs after lhs (elementwise)."""
    lm11, lm12, lm21, lm22, lv1, lv2 = lhs
    rm11, rm12, rm21, rm22, rv1, rv2 = rhs
    return (
        rm11 * lm11 + rm12 * lm21,
        rm11 * lm12 + rm12 * lm22,
        rm21 * lm11 + rm22 * lm21,
        rm21 * lm12 + rm22 * lm22,
        rm11 * lv1 + rm12 * lv2 + rv1,
        rm21 * lv1 + rm22 * lv2 + rv2,
    )


def section_cums(x: torch.Tensor, b0, b1, b2, a1, a2) -> tuple:
    """Cumulative affine maps of one section: z[n] = M[n] z[-1] + v[n].
    Returns (m11, m12, m21, m22, v1, v2), each shaped like ``x``."""
    g1 = b1 - a1 * b0
    g2 = b2 - a2 * b0
    ones = torch.ones_like(x)
    elems = ((-a1) * ones, ones, (-a2) * ones, torch.zeros_like(x),
             g1 * x, g2 * x)
    return associative_scan(_affine_combine, elems)


def _section_scan(x, b0, b1, b2, a1, a2, zi):
    """One biquad section over the last axis of ``x`` (..., n) from the
    DF2T state ``zi`` (..., 2) -> (y, zf)."""
    m11, m12, m21, m22, v1, v2 = section_cums(x, b0, b1, b2, a1, a2)
    zi1 = zi[..., 0:1]
    zi2 = zi[..., 1:2]
    z1 = m11 * zi1 + m12 * zi2 + v1
    z2 = m21 * zi1 + m22 * zi2 + v2
    # y[n] = b0 x[n] + z1[n-1], with z1[-1] = zi1
    z1_prev = torch.cat([zi1, z1[..., :-1]], dim=-1)
    y = b0 * x + z1_prev
    zf = torch.cat([z1[..., -1:], z2[..., -1:]], dim=-1)
    return y, zf


def sosfilt_scan(sos, x: torch.Tensor, zi=None,
                 state_dtype=torch.float64):
    """Cascaded-biquad filter over the last axis of ``x`` (..., n), each
    section a log-depth associative scan in ``state_dtype`` (float64 by
    default); the output in x's dtype.

    ``sos``: [S, 6] (scipy layout, a0 == 1). ``zi``: [S, ..., 2] initial
    DF2T state or None for zeros. Returns (y, zf) with zf (S, ..., 2) in
    ``state_dtype``. An empty cascade is the identity."""
    dev = x.device
    sos = torch.as_tensor(np.asarray(sos, np.float64), dtype=state_dtype,
                          device=dev) if not torch.is_tensor(sos) else \
        sos.to(state_dtype)
    S = sos.shape[0]
    in_dtype = x.dtype
    if S == 0:
        return x, torch.zeros((0,) + tuple(x.shape[:-1]) + (2,),
                              dtype=state_dtype, device=dev)
    y = x.to(state_dtype)
    if zi is None:
        zi = torch.zeros((S,) + tuple(x.shape[:-1]) + (2,),
                         dtype=state_dtype, device=dev)
    else:
        zi = torch.as_tensor(zi, device=dev).to(state_dtype)
    zfs = []
    for s in range(S):  # a short cascade: one scan per section
        y, zf = _section_scan(y, sos[s, 0], sos[s, 1], sos[s, 2],
                              sos[s, 4], sos[s, 5], zi[s])
        zfs.append(zf)
    return y.to(in_dtype), torch.stack(zfs)


def sosfilt_np(sos: np.ndarray, x: np.ndarray, zi=None):
    """Sequential float64 DF2T cascade (scipy's state layout). Returns
    (y, zf)."""
    sos = np.asarray(sos, np.float64)
    x = np.asarray(x, np.float64)
    S = sos.shape[0]
    if zi is None:
        zi = np.zeros((S,) + x.shape[:-1] + (2,))
    z = np.array(zi, np.float64, copy=True)
    y = x.copy()
    for s in range(S):
        b0, b1, b2, _, a1, a2 = sos[s]
        z1 = z[s, ..., 0].copy()
        z2 = z[s, ..., 1].copy()
        out = np.empty_like(y)
        for n in range(y.shape[-1]):
            xn = y[..., n]
            yn = b0 * xn + z1
            z1_new = b1 * xn - a1 * yn + z2
            z2 = b2 * xn - a2 * yn
            z1 = z1_new
            out[..., n] = yn
        y = out
        z[s, ..., 0] = z1
        z[s, ..., 1] = z2
    return y, z


def sos_impulse_np(sos, tol: float = 1e-6, max_len: int = 1 << 21):
    """Truncated impulse response of the cascade (float64, host).

    The cascade is LTI, so at an l1-tail tolerance its action equals a
    finite FIR: the truncation error of ``conv(x, h)`` against the exact
    IIR is at most ``||x||_inf * sum(|h[cut:]|) <= tol * sum(|h|)``; the
    default 1e-6 is a -120 dB budget, far under the chain's -80 dB gate.

    The window doubles until the cut converges. Returns None if the
    response has not decayed within ``max_len`` samples; callers must
    then keep the exact IIR path.
    """
    from scipy import signal as sps

    sos = np.asarray(sos, np.float64)
    if sos.shape[0] == 0:
        return np.ones(1, np.float64)
    n = 4096
    while True:
        x = np.zeros(n, np.float64)
        x[0] = 1.0
        h = sps.sosfilt(sos, x)
        if not np.all(np.isfinite(h)):
            return None
        tail = np.cumsum(np.abs(h[::-1]))[::-1]  # tail[i] = sum_{t>=i} |h|
        total = tail[0]
        if total == 0.0:
            return h[:1]
        over = np.nonzero(tail > tol * total)[0]
        cut = int(over[-1]) + 1 if over.size else 1
        if cut < n:  # the discarded tail is below the tolerance
            return np.ascontiguousarray(h[:cut])
        if n >= max_len:
            return None
        n *= 2
