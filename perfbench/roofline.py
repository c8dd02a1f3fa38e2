"""The yardstick of the roofline metrics: the card's published peaks and
the bytes and operations each stage needs, counted from its shapes
whatever kernel does the work.

A stage's least time is the larger of its bytes over the memory
bandwidth and its operations over the float32 peak. Bytes: each input
byte read once, each output byte written once, coefficients once.
"""

from __future__ import annotations

import math

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3 bytes/s,
# float32 operations/s outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12},
}


def peaks_for(kind: str) -> dict | None:
    return PEAKS.get(kind)


def least_seconds(n_bytes: float, n_ops: float, peaks: dict) -> float:
    return max(n_bytes / peaks["bytes_per_s"], n_ops / peaks["f32_ops_per_s"])


def fir_fft_ops(rows: int, n: int, taps: int) -> float:
    """The least float32 operations of a same-length causal FIR of
    ``taps`` taps over ``rows`` rows of n samples by FFT: the cheaper,
    over power-of-two transform sizes N, of overlap-save with the whole
    IR (one transform pair per frame, hop N - taps + 1, 6 per bin for the
    spectral product) and of a frequency-domain delay line (one transform
    pair per frame, hop N/2, the IR in ceil(taps / (N/2)) partitions, 8
    per bin and partition for the multiply-add). Two real rows share one
    complex transform of 5 N log2 N operations."""
    pairs, best = -(-rows // 2), math.inf
    for lg in range(4, max(n + taps, 16).bit_length() + 1):
        N = 1 << lg
        fft_pair = 2 * 5 * N * lg
        if N >= taps:
            best = min(best, -(-n // (N - taps + 1)) * (fft_pair + 6 * N))
        parts = -(-taps // (N // 2))
        best = min(best, -(-n // (N // 2)) * (fft_pair + 8 * N * parts))
    return pairs * best


def fir_stage(rows: int, n: int, taps: int) -> tuple[float, float]:
    """(bytes, operations) of a FIR over float32 rows with a gain per row
    and per sample applied on load (the folded EQ+reverb stage)."""
    return 4.0 * (2 * rows * n + taps + rows + n), fir_fft_ops(rows, n, taps)


def limiter_stage(rows: int, channels: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of a linked limiter over float32 (rows,
    channels, n): the signal in and out, four floats of state a row;
    18 operations a sample (detector, envelope, smoothing, curve, gain,
    clamp)."""
    return (4.0 * (2 * rows * channels * n + 4 * rows),
            18.0 * rows * channels * n)
