"""Biquad EQ host design (counterpart of the host part of
``xmtpu.ops.biquad``; bit-exact with it).

On the flagship path the EQ cascade never runs as an IIR on the device:
it is LTI, so its truncated impulse response (:func:`sos_impulse_np`)
folds into the reverb IR on the host (``batch._combined_ir``). What
ships here is the RBJ coefficient design and the float64 sequential
oracle.
"""

from __future__ import annotations

import math

import numpy as np

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
