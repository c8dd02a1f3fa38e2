"""The adaptive noise suppressor's tracker stage over the spectra (the
estimate, the smoothing, the gain and X*G): its bytes and operations,
counted from its shapes whatever kernel does the work, for
``roofline.least_seconds``.

Bytes: the complex64 spectra read once and Y written once, 16 bytes a
bin and frame, whatever precision a program computes in (its float64
spectra are its choice). Operations, 21 a bin and frame: |X|^2 (3), the
tracker (7: the ratio and its compare, a_n noise + (1 - a_n) psd, the
leak's product, the select), the smoothing (3), snr (3), G (3), X*G on
the complex bin (2).

T = ceil(n / hop) + 1 frames (hop = nfft/2) of nfft/2 + 1 bins a row. At
``voice44k_adaptive.voice32x60s``'s 32 x 10,337 x 257 the bytes bind:
1.36 GB at 3.35 TB/s is 0.406 ms, against 0.027 ms of operations at 67
TFLOP/s."""

from __future__ import annotations


def track_stage(rows: int, n: int, nfft: int) -> tuple[float, float]:
    """(bytes, operations) of the tracker stage over the spectra of
    float32 (rows, n)."""
    bins = rows * (-(-n // (nfft // 2)) + 1) * (nfft // 2 + 1)
    return 16.0 * bins, 21.0 * bins
