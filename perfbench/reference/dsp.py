"""Float64 host arithmetic of the two chains, written from their
definitions. It imports nothing of the program: the resample filter, the
EQ sections, the synthetic impulse responses, the limiter and the int16
rule are worked out here again from the published formulas (the RBJ
cookbook, a Kaiser-window lowpass, BS-style soft-knee limiting).

``precision="tf32"`` is the control: the operands of the products that
the program computes on the device are rounded to TF32 (1 sign, 8
exponent and 10 mantissa bits), and each product is accumulated in
float64: a tensor-core product of TF32 operands with an exact
accumulation, the most favourable TF32 there is. Those operands are the
rate converter's filter and signal, and the EQ and reverb folded into
one FIR (as the program folds them) with its signal. Elementwise stages
(mix, fades, normalize, limiter, int16) are not products and are not
rounded; the EQ's recursive sections are not rounded either, since the
program never runs them as such.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import fft as sfft
from scipy import signal as sps

PRECISIONS = ("float64", "tf32")


def tf32(a: np.ndarray) -> np.ndarray:
    """Round to TF32's 11 significant bits (round to nearest even)."""
    m, e = np.frexp(np.asarray(a, np.float64))
    return np.ldexp(np.round(m * 2048.0) / 2048.0, e)


def rounder(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return tf32 if precision == "tf32" else _float64


def _float64(a) -> np.ndarray:
    return np.asarray(a, np.float64)


# --- rate conversion ------------------------------------------------------

def ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def lowpass(L: int, M: int, taps_per_phase: int = 24,
            beta: float = 9.0) -> np.ndarray:
    """Odd-length Kaiser lowpass for L/M conversion: cutoff
    min(pi/L, pi/M) of the L-upsampled rate, gain L."""
    nt = taps_per_phase * L
    nt += 1 - nt % 2
    return L * sps.firwin(nt, 1.0 / max(L, M), window=("kaiser", beta))


def resample(x: np.ndarray, sr_in: int, sr_out: int, rnd=np.asarray,
             taps_per_phase: int = 24, beta: float = 9.0) -> np.ndarray:
    """Polyphase conversion of the last axis: output j is the upsampled
    convolution at t = j*M + (ntaps-1)//2; ceil(n*L/M) samples."""
    L, M = ratio(sr_in, sr_out)
    h = rnd(lowpass(L, M, taps_per_phase, beta))
    offset = (len(h) - 1) // 2
    n_out = -(-x.shape[-1] * L // M)
    s = (-offset) % M
    d = (offset + s) // M
    z = sps.upfirdn(np.concatenate([np.zeros(s), h]), rnd(x), up=L,
                    down=M, axis=-1)
    y = z[..., d:d + n_out]
    if y.shape[-1] < n_out:
        y = np.concatenate(
            [y, np.zeros(y.shape[:-1] + (n_out - y.shape[-1],))], -1)
    return y


# --- gains ------------------------------------------------------------------

def db_to_amp(db: float) -> float:
    return 10.0 ** (db / 20.0)


def fade_ramp(n: int, fade_in: int, fade_out: int) -> np.ndarray:
    """Linear fade in over ``fade_in`` samples and out over ``fade_out``
    of an n-sample track: g[i] = min((i+1)/in, 1) * clip((n-i)/out, 0, 1)."""
    i = np.arange(n, dtype=np.float64)
    g = np.ones(n)
    if fade_in > 0:
        g *= np.minimum((i + 1.0) / fade_in, 1.0)
    if fade_out > 0:
        g *= np.clip((n - i) / fade_out, 0.0, 1.0)
    return g


def peak_normalize(x: np.ndarray, target_db: float) -> np.ndarray:
    peak = np.max(np.abs(x), axis=-1, keepdims=True)
    return x * np.where(peak > 0, db_to_amp(target_db) / np.maximum(peak, 1e-30),
                        1.0)


# --- EQ -----------------------------------------------------------------------

def peaking(freq_hz: float, sr: int, q: float, gain_db: float) -> np.ndarray:
    """RBJ cookbook peaking section -> [b0, b1, b2, 1, a1, a2]."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * math.pi * freq_hz / sr
    alpha = math.sin(w0) / (2.0 * q)
    c = math.cos(w0)
    b = np.array([1 + alpha * A, -2 * c, 1 - alpha * A])
    a = np.array([1 + alpha / A, -2 * c, 1 - alpha / A])
    return np.concatenate([b / a[0], [1.0], a[1:] / a[0]])


def eq_sos(bands, sr: int) -> np.ndarray:
    for b in bands:
        if b.get("kind", "peaking") != "peaking":
            raise ValueError(f"only peaking bands are defined here: {b}")
    return np.stack([peaking(float(b["freq_hz"]), sr, float(b.get("q", 0.7071)),
                             float(b.get("gain_db", 0.0))) for b in bands])


def sosfilt(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The exact IIR cascade over the last axis, zero initial state."""
    return sps.sosfilt(sos, x, axis=-1)


def sos_impulse(sos: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """The cascade's impulse response cut where its remaining l1 mass
    falls under ``tol`` of the total (-120 dB)."""
    n = 4096
    while True:
        x = np.zeros(n)
        x[0] = 1.0
        h = sps.sosfilt(sos, x)
        cut = trim_length(h, tol)
        if cut < n:
            return h[:cut]
        n *= 2


def trim_length(h: np.ndarray, rel: float = 1e-6) -> int:
    """Taps through the last index whose remaining l1 mass exceeds
    ``rel`` of the total."""
    tail = np.cumsum(np.abs(h[::-1]))[::-1]
    over = np.nonzero(tail > rel * tail[0])[0]
    return int(over[-1]) + 1 if over.size else 1


# --- reverb -------------------------------------------------------------------

def synthetic_ir(seconds: float, sr: int, rt60: float | None = None,
                 seed: int = 7) -> np.ndarray:
    """Exponentially decaying white noise (numpy ``default_rng(seed)``),
    -60 dB at rt60 (default: the IR's length), a unit first tap, then
    scaled to unit energy."""
    n = max(1, int(round(seconds * sr)))
    rt60 = seconds if rt60 is None else rt60
    t = np.arange(n) / sr
    ir = np.random.default_rng(seed).standard_normal(n) * 10.0 ** (
        -3.0 * t / max(rt60, 1e-6))
    ir[0] = 1.0
    return ir / np.sqrt(np.sum(ir ** 2))


def fir(x: np.ndarray, h: np.ndarray, workers: int = 1) -> np.ndarray:
    """Causal same-length convolution of the last axis with ``h`` by one
    float64 FFT per row."""
    n = x.shape[-1]
    N = sfft.next_fast_len(n + len(h) - 1, real=True)
    X = sfft.rfft(x, N, axis=-1, workers=workers)
    X *= sfft.rfft(h, N, workers=workers)
    return sfft.irfft(X, N, axis=-1, workers=workers)[..., :n]


def reverb(x: np.ndarray, ir: np.ndarray, wet: float, dry: float) -> np.ndarray:
    return dry * x + wet * fir(x, ir)


def folded_ir(sos: np.ndarray, ir: np.ndarray, wet: float,
              dry: float) -> np.ndarray:
    """EQ then reverb as one FIR, ``dry*h_eq + wet*h_eq*ir``, trimmed at
    -120 dB."""
    h_eq = sos_impulse(sos)
    c = wet * np.convolve(h_eq, ir)
    c[:len(h_eq)] += dry * h_eq
    return c[:trim_length(c)]


def folded_taps(sos: np.ndarray, ir: np.ndarray, wet: float,
                dry: float) -> int:
    """The taps a folded EQ+reverb stage reads."""
    return len(folded_ir(sos, ir, wet, dry))


def eq_reverb(x: np.ndarray, sos: np.ndarray, ir: np.ndarray, wet: float,
              dry: float, precision: str = "float64") -> np.ndarray:
    """The EQ (the exact IIR) then the reverb (dry/wet) over the last
    axis; at ``"tf32"`` the folded FIR, its signal and taps rounded."""
    if rounder(precision) is tf32:
        return fir(tf32(x), tf32(folded_ir(sos, ir, wet, dry)))
    return reverb(sosfilt(sos, x), ir, wet, dry)


# --- limiter ------------------------------------------------------------------

def release_coeff(release_ms: float, sr: int) -> float:
    return 0.0 if release_ms <= 0 else math.exp(-1.0 / (release_ms * sr / 1000.0))


def attack_coeff(attack_ms: float, sr: int) -> float:
    return 1.0 if attack_ms <= 0 else 1.0 - math.exp(-1.0 / (attack_ms * sr / 1000.0))


def decaying_max(d: np.ndarray, k: float) -> np.ndarray:
    """env[t] = max(d[t], k * env[t-1]), env[-1] = 0, over the last axis,
    in closed form: env[t] = k^t * max_{s<=t} d[s] k^-s, taken in logs
    (the running maximum of log d[s] - s log k)."""
    if k <= 0.0:
        return d.copy()
    lk = math.log(k)
    t = np.arange(d.shape[-1], dtype=np.float64)
    with np.errstate(divide="ignore"):
        v = np.log(d) - t * lk
    return np.exp(np.maximum.accumulate(v, axis=-1) + t * lk)


def decaying_max_loop(d: np.ndarray, k: float) -> np.ndarray:
    """The recurrence itself, one sample at a time (tests hold the
    closed form to it)."""
    env = np.empty_like(d)
    prev = np.zeros(d.shape[:-1])
    for i in range(d.shape[-1]):
        prev = np.maximum(d[..., i], k * prev)
        env[..., i] = prev
    return env


def limiter(x: np.ndarray, sr: int, threshold_db: float = -3.0,
            knee_db: float = 6.0, attack_ms: float = 1.0,
            release_ms: float = 100.0, ceiling_db: float = 0.0,
            loop: bool = False) -> np.ndarray:
    """Soft-knee limiter of ``x`` (..., channels, n), channels linked:
    detector max_ch |x|; peak envelope with release; one-pole attack
    smoothing e2[t] = (1-c) e2[t-1] + c env[t]; gain reduction 0 below
    T - W/2, (over + W/2)^2 / 2W inside the knee, over above; the
    result clipped at the ceiling."""
    k, c = release_coeff(release_ms, sr), attack_coeff(attack_ms, sr)
    d = np.max(np.abs(x), axis=-2)
    env = decaying_max_loop(d, k) if loop else decaying_max(d, k)
    e2 = env if c >= 1.0 else sps.lfilter([c], [1.0, c - 1.0], env, axis=-1)
    over = 20.0 * np.log10(np.maximum(e2, 1e-12)) - threshold_db
    w = max(float(knee_db), 1e-6)
    red = np.where(over <= -0.5 * w, 0.0,
                   np.where(over >= 0.5 * w, over, (over + 0.5 * w) ** 2 / (2 * w)))
    g = 10.0 ** (-red / 20.0)
    ceil = db_to_amp(ceiling_db)
    return np.clip(x * g[..., None, :], -ceil, ceil)


# --- int16 ------------------------------------------------------------------------

def to_pcm16(x: np.ndarray) -> np.ndarray:
    """x * 32768, rounded half away from zero, clipped to int16."""
    s = np.asarray(x, np.float64) * 32768.0
    return np.clip(np.sign(s) * np.floor(np.abs(s) + 0.5), -32768, 32767
                   ).astype(np.int16)
