"""Float64 reference of the voice-effects chain on (B, n, 1) float32
tracks: noise suppression, then the EQ, the reverb and the volume, then
the limiter (``precision``: see ``dsp``).

The noise suppressor is written here from its definition, in plain
``torch`` and numpy at float64 on the host (it imports nothing of the
program):

1. frames of ``nfft`` samples at a hop of nfft/2, the track zero-padded
   by a hop in front and to whole frames at the end (T = ceil(n / hop) +
   1 frames), each times the sqrt of the periodic Hann window, then
   ``torch.fft.rfft``;
2. the noise PSD: the median over the first ``noise_frames`` frames of
   |X|^2, bin by bin, an even count giving the mean of the two middle
   values; then held fixed (``noise_update`` "frozen", the only mode
   here);
3. the smoothed PSD ``P[t] = a P[t-1] + (1-a) |X[t]|^2``, ``P[-1] = 0``,
   one frame after another;
4. the Wiener gain ``G = max(snr / (1 + snr), floor)`` with ``snr =
   max(P / max(noise, 1e-20) - 1, 0)``, applied to the complex spectrum;
5. ``torch.fft.irfft``, the same window again, and the overlap-add of
   the frames, cut back to the track's n samples.

Departures from the program, none in the arithmetic: the smoothing is
the recursion itself where the program runs an associative scan, the
overlap-add adds frame by frame where the program adds two interleaved
framings, and everything is float64.

At ``precision="tf32"`` only the folded FIR's operands are rounded, as
in the other chains: the transforms of the suppressor are not products
the program computes on the tensor cores, so they stay float64. The
volume is folded into the FIR as the program folds it (``wet`` and
``dry`` scaled by its gain, so the IR's taps are the program's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import dsp


def sqrt_hann(nfft: int) -> torch.Tensor:
    i = torch.arange(nfft, dtype=torch.float64)
    return torch.sqrt(0.5 - 0.5 * torch.cos(2.0 * math.pi * i / nfft))


def frame_count(n: int, nfft: int) -> int:
    return -(-n // (nfft // 2)) + 1


def lead_median(psd: np.ndarray, k: int) -> np.ndarray:
    """Median over the first k frames (axis -2) of psd, bin by bin; an
    even k gives the mean of the two middle values."""
    s = np.sort(psd[..., :k, :], axis=-2)
    if k % 2:
        return s[..., k // 2, :]
    return 0.5 * (s[..., k // 2 - 1, :] + s[..., k // 2, :])


def suppress(x: np.ndarray, nfft: int = 512, noise_frames: int = 8,
             smooth: float = 0.7, floor: float = 0.1,
             noise_update: str = "frozen") -> np.ndarray:
    """Noise suppression of float64 (..., n) -> (..., n). The transforms
    are ``torch.fft``'s; the two loops over frames step numpy arrays,
    which hold the interpreter's lock through each step (torch's small
    operations release and retake it, and the reference runs in
    threads)."""
    if noise_update != "frozen":
        raise ValueError(f"only the frozen estimate is defined here, got "
                         f"{noise_update!r}")
    hop = nfft // 2
    n = x.shape[-1]
    T = frame_count(n, nfft)
    w = sqrt_hann(nfft)
    xp = torch.nn.functional.pad(torch.as_tensor(x, dtype=torch.float64),
                                 (hop, (T - 1) * hop + nfft - (n + hop)))
    X = torch.fft.rfft(xp.unfold(-1, nfft, hop) * w, dim=-1)  # (..., T, F)
    psd = (X.real ** 2 + X.imag ** 2).numpy()
    noise = np.maximum(lead_median(psd, noise_frames), 1e-20)
    P = np.empty_like(psd)
    acc = np.zeros_like(psd[..., 0, :])
    for t in range(T):
        acc = smooth * acc + (1.0 - smooth) * psd[..., t, :]
        P[..., t, :] = acc
    snr = np.maximum(P / noise[..., None, :] - 1.0, 0.0)
    G = torch.from_numpy(np.maximum(snr / (1.0 + snr), floor))
    frames = (torch.fft.irfft(X * G, n=nfft, dim=-1) * w).numpy()
    out = np.zeros(x.shape[:-1] + ((T - 1) * hop + nfft,))
    for t in range(T):
        out[..., t * hop:t * hop + nfft] += frames[..., t, :]
    return out[..., hop:hop + n]


def run(config: dict, inputs: dict, precision: str = "float64") -> np.ndarray:
    c = config["chain"]
    sr = int(c["sample_rate"])
    dsp.rounder(precision)
    x = np.moveaxis(np.asarray(inputs["pcm"], np.float64), 1, -1)  # (B, ch, n)
    x = suppress(x, **c["ns"])
    g = dsp.db_to_amp(float(c["volume_db"]))
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    y = dsp.eq_reverb(x, dsp.eq_sos(c["bands"], sr), ir, g * c["wet"],
                      g * c["dry"], precision)
    y = dsp.limiter(y, sr, **c["limiter"])
    return np.moveaxis(y, -1, 1)


def stages(config: dict, traffic: dict) -> dict:
    c = config["chain"]
    sr = int(c["sample_rate"])
    B, ch = int(traffic["clips_per_batch"]), int(traffic["channels"])
    n = int(round(traffic["clip_seconds"] * sr))
    sos = dsp.eq_sos(c["bands"], sr)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    g = dsp.db_to_amp(float(c["volume_db"]))
    return {"ns": {"rows": B * ch, "n": n, "nfft": int(c["ns"]["nfft"])},
            "eq_reverb": {"rows": B * ch, "n": n,
                          "taps": dsp.folded_taps(sos, ir, g * c["wet"],
                                                  g * c["dry"])},
            "limiter": {"rows": B, "channels": ch, "n": n}}
