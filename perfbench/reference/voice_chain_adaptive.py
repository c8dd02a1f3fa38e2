"""Float64 reference of the voice-effects chain with the adaptive noise
estimate on (B, n, 1) float32 tracks: noise suppression whose noise
estimate is updated every frame, then the EQ, the reverb and the volume,
then the limiter (``precision``: see ``dsp``).

The suppressor is ``voice_chain``'s (its frames, window, transforms,
lead-in median, smoothing, gain and overlap-add), with the estimate of
item 2 written here from its definition, frame after frame, bin by bin:

    noise[t] = seed                                   for t < noise_frames
    noise[t] = a_n noise[t-1] + (1 - a_n) psd[t]      where psd[t] / max(
               noise[t-1], 1e-20) < presence_thresh
    noise[t] = noise[t-1] up_leak                     elsewhere

with the seed the median over the first ``noise_frames`` frames of psd =
|X|^2, an even count giving the mean of the two middle values; the gain
of frame t divides by max(noise[t], 1e-20). Everything is float64 on the
host, in numpy and ``torch.fft``; it imports nothing of the program.
The rest of the chain, and the TF32 control, are ``voice_chain``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import dsp, voice_chain


def suppress(x: np.ndarray, nfft: int = 512, noise_frames: int = 8,
             smooth: float = 0.7, floor: float = 0.1,
             noise_update: str = "adaptive", noise_smooth: float = 0.95,
             presence_thresh: float = 4.0,
             up_leak: float = 1.02) -> np.ndarray:
    """Noise suppression of float64 (..., n) -> (..., n) with the
    adaptive estimate. The transforms are ``torch.fft``'s; the loop over
    frames steps numpy arrays (see ``voice_chain.suppress``)."""
    if noise_update != "adaptive":
        raise ValueError(f"only the adaptive estimate is defined here, got "
                         f"{noise_update!r}")
    hop = nfft // 2
    n = x.shape[-1]
    T = voice_chain.frame_count(n, nfft)
    w = voice_chain.sqrt_hann(nfft)
    xp = torch.nn.functional.pad(torch.as_tensor(x, dtype=torch.float64),
                                 (hop, (T - 1) * hop + nfft - (n + hop)))
    X = torch.fft.rfft(xp.unfold(-1, nfft, hop) * w, dim=-1)  # (..., T, F)
    psd = (X.real ** 2 + X.imag ** 2).numpy()
    noise = voice_chain.lead_median(psd, noise_frames)
    G = np.empty_like(psd)
    acc = np.zeros_like(psd[..., 0, :])
    for t in range(T):
        p = psd[..., t, :]
        if t >= noise_frames:
            ratio = p / np.maximum(noise, 1e-20)
            noise = np.where(ratio < presence_thresh,
                             noise_smooth * noise + (1.0 - noise_smooth) * p,
                             noise * up_leak)
        acc = smooth * acc + (1.0 - smooth) * p
        snr = np.maximum(acc / np.maximum(noise, 1e-20) - 1.0, 0.0)
        G[..., t, :] = np.maximum(snr / (1.0 + snr), floor)
    frames = (torch.fft.irfft(X * torch.from_numpy(G), n=nfft, dim=-1)
              * w).numpy()
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
    """``voice_chain``'s stages, and the tracker's spectra: ``ns_track``
    (rows, samples, nfft)."""
    st = voice_chain.stages(config, traffic)
    return {**st, "ns_track": dict(st["ns"])}
