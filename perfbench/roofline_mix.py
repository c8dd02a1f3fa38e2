"""The mixer's ducking and loudness stages: their bytes and operations,
counted from their shapes whatever kernels do the work, for
``roofline.least_seconds``.

Ducking (``duck_stage``): the side-chain bus and the ducked bus, float32
(channels, n), read once and their ducked sum written once; the gain is
an intermediate a single pass could keep on chip, never stored. 12 bytes
a sample and channel. Operations, 14 a sample and channel: the detector
|s| and the decaying maximum (3), the one-pole smoothing (3), the level
in dB (1), the knee (4), the gain 10^(...) (1), the product with the bed
and the sum (2).

Loudness (``lufs_stage``): the float32 bus (channels, n) read to measure
it, then read again and written to apply the gain (one measurement must
finish before the gain is known). 12 bytes a sample and channel.
Operations, 21 a sample and channel: the K-weighting's two biquads (9
each: five products, four sums), the square and its running sum (2), the
gain's product (1); the block powers' gather and the gates (a few per
400 ms block) are left out.

At ``mix48k.episode600s``'s 2 x 28,800,000 the bytes bind both: 691.2 MB
at 3.35 TB/s is 0.206 ms, against 0.012 and 0.018 ms of operations at
67 TFLOP/s."""

from __future__ import annotations


def duck_stage(channels: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of side-chain ducking over float32
    (channels, n)."""
    return 12.0 * channels * n, 14.0 * channels * n


def lufs_stage(channels: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of BS.1770 loudness normalization over
    float32 (channels, n)."""
    return 12.0 * channels * n, 21.0 * channels * n
