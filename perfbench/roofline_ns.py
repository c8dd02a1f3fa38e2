"""The noise-suppression stage's bytes and operations, counted from its
shapes whatever kernels do the work, for ``roofline.least_seconds``.

Bytes: the float32 signal read once and written once, and the window
(``nfft`` floats); the frames, spectra and gains are intermediates a
single pass could keep on chip.

Operations, for each of T = ceil(n / hop) + 1 frames (hop = nfft/2) of
each row: a forward and an inverse real transform of nfft points at
2.5 nfft log2 nfft each (half a complex transform's 5 N log2 N); 14 a
bin (nfft/2 + 1 bins): |X|^2 (3), the smoothing a P + (1-a) |X|^2 (3),
snr = max(P / noise - 1, 0) (3), G = max(snr / (1 + snr), floor) (3),
X*G on the complex bin (2); 3 a sample: the analysis and synthesis
windows and the overlap-add. The median of the lead-in frames is left
out (8 frames of T). At the voice cell's shapes the bytes bind: 677 MB
at 3.35 TB/s is 0.202 ms, the 9.3 GFLOP at 67 TFLOP/s 0.139 ms."""

from __future__ import annotations

import math


def ns_stage(rows: int, n: int, nfft: int) -> tuple[float, float]:
    """(bytes, operations) of STFT Wiener suppression over float32
    (rows, n)."""
    frames = -(-n // (nfft // 2)) + 1
    per_frame = (2 * 2.5 * nfft * math.log2(nfft) + 14 * (nfft // 2 + 1)
                 + 3 * nfft)
    return 4.0 * (2 * rows * n + nfft), rows * frames * per_frame
