"""The port tests' float64 references: the dB gate, the direct
convolution oracle, BS.1770's block powers summed block by block and two
signals to take them of, and a side chain of speech and pauses.

Imports neither JAX nor the reference package, so the card tests
(``tests/test_torch_gpu.py``, run with ``--noconftest`` on a machine
without JAX) use it too.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def db(got, ref) -> float:
    """RMS of ``got - ref`` in dB relative to the RMS of ``ref``, in
    float64; ``-inf`` when they are equal (the accuracy metric of
    BASELINE.json, ``tests/conftest.py``'s ``rms_db``). Numpy arrays or
    torch tensors on any device, int16 samples as they are: the ratio
    does not depend on their full scale."""
    g, r = _f64(got), _f64(ref)
    p_err = np.mean((g - r) ** 2)
    if p_err == 0:
        return -np.inf
    return float(10.0 * np.log10(p_err / np.mean(r**2)))


def direct_conv(x, h, n: int | None = None) -> np.ndarray:
    """The float64 direct convolution of each row of ``x`` (any leading
    shape) with ``h``: its first ``n`` outputs, or all of them.

    ``np.convolve`` takes one BLAS dot product an output, and numpy's
    OpenBLAS spreads every dot longer than 10,000 over all its threads;
    beside other busy processes that stalls for minutes. So the sums run
    on one BLAS thread."""
    from threadpoolctl import threadpool_limits

    x = np.asarray(x, np.float64)
    h = np.asarray(h, np.float64)
    with threadpool_limits(1, user_api="blas"):
        y = np.stack([np.convolve(r, h)[:n]
                      for r in x.reshape(-1, x.shape[-1])])
    return y.reshape(x.shape[:-1] + y.shape[-1:])


def block_powers(x, block: int, hop: int, nblk: int) -> np.ndarray:
    """BS.1770's block powers of ``x`` (ch, n) summed directly in
    float64, block by block, as ``ops.loudness.measure_lufs_np`` sums
    them: the mean square of samples [j * hop, j * hop + block) of each
    channel, summed over the channels, for j = 0 .. nblk-1."""
    x = _f64(x)
    return np.array([np.sum(np.mean(x[:, j * hop: j * hop + block] ** 2,
                                    axis=-1)) for j in range(nblk)])


def loud_stretch(ch: int, n: int, seed: int) -> np.ndarray:
    """(ch, n) float32 noise at 0.003 with samples [n // 5, n // 2) 40 dB
    louder, so quiet blocks of BS.1770 follow loud ones."""
    rng = np.random.default_rng(seed)
    x = 0.003 * rng.standard_normal((ch, n))
    x[:, n // 5: n // 2] *= 100.0
    return x.astype(np.float32)


def quiet_then_loud(sr: int, seconds: float, t: int, bad) -> np.ndarray:
    """(3, seconds * sr) float32 noise, 20 dB louder from sample ``t``
    on, where a ``bad`` sample sits in channel 1."""
    rng = np.random.default_rng(sr)
    x = 0.01 * rng.standard_normal((3, int(seconds * sr)))
    x[:, t:] *= 10.0
    x[1, t] = bad
    return x.astype(np.float32)


def speech_with_pauses(seconds: float, sr: int, seed: int) -> np.ndarray:
    """(2, n) float64 side chain: stretches of noise at -10 dB (1-3 s)
    between pauses at -70 dB (1-4 s), so a side-chain duck releases
    through its knee (about a second after the voice stops, at a 300 ms
    release) and attacks again at every turn."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    level = np.empty(n)
    t, talk = 0, True
    while t < n:
        d = int(sr * (rng.uniform(1.0, 3.0) if talk
                      else rng.uniform(1.0, 4.0)))
        level[t:t + d] = 10.0 ** ((-10.0 if talk else -70.0) / 20.0)
        t, talk = t + d, not talk
    return level * rng.standard_normal((2, n))
