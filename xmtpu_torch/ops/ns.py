"""Noise suppression: STFT Wiener gain (counterpart of
``xmtpu.ops.ns``; the same pinned semantics, mirrored by
:func:`suppress_np`, the float64 oracle).

1. STFT: sqrt-Hann window (analysis and synthesis, so their product is
   Hann and overlap-adds to exactly 1 at 50% hop), ``nfft`` (default
   512); frames zero-padded at the clip edges, so the output length is
   the input's and reconstruction is exact everywhere.
2. Noise PSD, by ``noise_update``: ``"frozen"`` (default), the median
   of the first ``noise_frames`` frame PSDs, then fixed (or the caller's
   ``noise_psd``); ``"adaptive"``, seeded by the same median, then per
   frame and bin ``noise = a_n noise + (1 - a_n) psd`` where the bin's
   PSD is within ``presence_thresh`` of the estimate, else ``noise *
   up_leak``.
3. PSD smoothing over frames: ``P[t] = a P[t-1] + (1-a) |X[t]|^2``.
4. Wiener gain with floor: ``snr = max(P/noise - 1, 0)``; ``G =
   max(snr / (1 + snr), floor)``.
5. iSTFT: overlap-add with the same window (the gain scales the complex
   spectrum; phase untouched).

The transforms are ``torch.fft.rfft``/``irfft``: the JAX package runs
them in XLA, outside any Pallas kernel. Items 3 and 4 and the product
X*G split by what the call can observe. On a CUDA tensor with the noise
fixed per row and bin (``"frozen"`` or a caller's ``noise_psd``) they
are one hand-written kernel over the spectra (``kernels.ns.wiener``,
``csrc/ns_wiener.cu``), which writes Y over X; on a CPU tensor (the
kernel's plain twin and the CPU tests' path) the smoothing is the port's
log-depth associative scan and the gain elementwise torch.

``"adaptive"`` analyses in float64 and runs items 2 to 4 and X*G in
float64 over the float64 spectra, on any device: one hand-written kernel
on a CUDA tensor (``kernels.ns.track``, ``csrc/ns_track.cu``), its plain
twin, a loop over frames, on a CPU tensor; Y comes back as complex64 for
the float32 synthesis. The tracker's branch decisions jump (its two
branches differ by about 12% at the threshold), so they have to be the
float64 definition's: from float32 spectra, two of three batches of 32
minute-long tracks (H100) held a track that flipped one and read -67 to
-69 dB against :func:`suppress_np`. The JAX package analyses in float32.

The median of an even count is the mean of the two middle values, as
``jnp.median`` and ``np.median`` give it (``torch.median`` would give
the lower one; the default ``noise_frames=8`` is even).

Under a profiler :func:`suppress` opens one range for each part
(``utils.profiling.stage``): ``ns_stft`` (item 1's analysis), ``ns_psd``
(|X|^2 and item 3), ``ns_noise`` (item 2), ``ns_gain`` (item 4 and X*G)
and ``ns_istft`` (item 5); on the Wiener kernel's path ``ns_stft``,
``ns_noise`` (the lead-in frames' |X|^2 and their median),
``ns_wiener`` (the kernel) and ``ns_istft``; with ``"adaptive"``
``ns_stft``, ``ns_noise`` (the median, the tracker's seed), ``ns_track``
(the kernel or its twin) and ``ns_istft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xmtpu_torch.kernels import ns as _kns
from xmtpu_torch.kernels.ns import adaptive_noise_step as _adaptive_noise_step
from xmtpu_torch.kernels.ns import onepole_frames as _onepole_frames
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.utils.device import to_device
from xmtpu_torch.utils.profiling import stage

_DEF_NFFT = 512
_DEF_FLOOR = 0.1


def _win(nfft: int, dtype=np.float64) -> np.ndarray:
    # sqrt of periodic Hann: w^2 (analysis*synthesis) COLA-sums to 1 at 50%
    h = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nfft) / nfft)
    return np.sqrt(h).astype(dtype)


def _win_t(nfft: int, like: torch.Tensor) -> torch.Tensor:
    return _win_on(nfft, like.dtype, str(like.device))


@functools.lru_cache(maxsize=16)
def _win_on(nfft: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """The window on ``device``, copied once: streaming suppression asks
    for it every frame, and a copy from pageable host memory would
    synchronise the stream."""
    return torch.as_tensor(_win(nfft), dtype=dtype, device=device)


def _frame_count(n: int, nfft: int) -> int:
    hop = nfft // 2
    return -(-n // hop) + 1  # cover the tail, plus one lead frame of pad


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median over ``dim``; an even count gives the mean of the two
    middle values (``np.median``'s rule)."""
    s = torch.sort(x, dim=dim).values
    k = x.shape[dim]
    hi = s.narrow(dim, k // 2, 1)
    if k % 2:
        return hi.squeeze(dim)
    lo = s.narrow(dim, k // 2 - 1, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


def stft(x: torch.Tensor, nfft: int = _DEF_NFFT) -> torch.Tensor:
    """(..., n) -> complex frames (..., T, nfft//2+1); sqrt-Hann, 50%
    hop, half-window zero padding on both edges."""
    hop = nfft // 2
    n = x.shape[-1]
    T = _frame_count(n, nfft)
    xp = torch.nn.functional.pad(x, (hop, (T - 1) * hop + nfft - (n + hop)))
    frames = xp.unfold(-1, nfft, hop)  # (..., T, nfft), a strided view
    return torch.fft.rfft(frames * _win_t(nfft, x), dim=-1)


def istft(F: torch.Tensor, n: int, nfft: int = _DEF_NFFT) -> torch.Tensor:
    """Inverse of :func:`stft` (sqrt-Hann synthesis, exact COLA)."""
    hop = nfft // 2
    frames = torch.fft.irfft(F, n=nfft, dim=-1)
    frames = frames * _win_t(nfft, frames)  # w^2 sums to 1 at 50% hop
    T = frames.shape[-2]
    batch = frames.shape[:-2]
    out = frames.new_zeros(batch + ((T - 1) * hop + nfft,))
    # overlap-add the two interleaved framings (each non-overlapping)
    even = frames[..., 0::2, :].reshape(*batch, -1)
    out[..., :even.shape[-1]] += even
    odd = frames[..., 1::2, :].reshape(*batch, -1)
    out[..., hop:hop + odd.shape[-1]] += odd
    return out[..., hop:hop + n]


def _adaptive_noise_track(psd: torch.Tensor, noise_frames: int, a_n: float,
                          thresh: float, up_leak: float) -> torch.Tensor:
    """Per-frame noise estimates (..., T, F): seeded by the lead-in
    median; the recursion starts at frame ``noise_frames`` (lead frames
    hold the seed), so a streaming session runs the same state sequence
    from there. A loop over frames, as the JAX package's ``lax.scan``:
    the definition's state sequence, to which the tests hold the
    tracker (``kernels.ns.track``)."""
    noise = median(psd[..., :noise_frames, :], dim=-2)
    out = torch.empty_like(psd)
    for t in range(psd.shape[-2]):
        if t >= noise_frames:
            noise = _adaptive_noise_step(noise, psd[..., t, :], a_n, thresh,
                                         up_leak)
        out[..., t, :] = noise
    return out


def _given_noise(noise_psd, X: torch.Tensor) -> torch.Tensor:
    """A caller's noise estimate (..., F) as float32 on X's device."""
    return torch.as_tensor(noise_psd, dtype=torch.float32, device=X.device)


def _check_mode(noise_update: str) -> None:
    if noise_update not in ("frozen", "adaptive"):
        raise ValueError(
            f"noise_update must be 'frozen' or 'adaptive', got "
            f"{noise_update!r}")


def suppress(x, nfft: int = _DEF_NFFT, noise_frames: int = 8,
             smooth: float = 0.7, floor: float = _DEF_FLOOR, noise_psd=None,
             noise_update: str = "frozen", noise_smooth: float = 0.95,
             presence_thresh: float = 4.0, up_leak: float = 1.02,
             device=None) -> torch.Tensor:
    """Suppress stationary noise in (..., n) PCM (an array or a tensor;
    int16 through the pinned conversion) -> a tensor on the device in the
    input's dtype. ``noise_update="adaptive"`` tracks a drifting noise
    floor (module docstring item 2). Runs on ``cuda`` unless ``device``
    names another device."""
    x = to_device(x, device)
    in_dtype = x.dtype
    was_i16 = in_dtype == torch.int16
    _check_mode(noise_update)
    if noise_psd is not None and noise_update == "adaptive":
        raise ValueError("noise_psd pins the estimate; it cannot be "
                         "combined with noise_update='adaptive'")
    adaptive = noise_update == "adaptive"
    # each device operation lies in one of the ranges: the int16
    # conversions go with the transforms beside them
    with stage("ns_stft"):
        if adaptive:  # float64 analysis (module docstring)
            xf = (_convert.pcm16_to_f32(x) if was_i16 else x).to(
                torch.float64)
        else:
            xf = _convert.pcm16_to_f32(x) if was_i16 else x.to(torch.float32)
        X = stft(xf, nfft)
    if adaptive:
        with stage("ns_noise"):
            lead = X[..., :noise_frames, :]
            seed = median(lead.real * lead.real + lead.imag * lead.imag,
                          dim=-2)
        with stage("ns_track"):
            Y = _kns.track(X, seed, float(smooth), float(floor),
                           int(noise_frames), float(noise_smooth),
                           float(presence_thresh), float(up_leak))
    elif X.device.type == "cuda":
        with stage("ns_noise"):
            if noise_psd is not None:
                noise = _given_noise(noise_psd, X)
            else:
                lead = torch.square(torch.abs(X[..., :noise_frames, :]))
                noise = median(lead, dim=-2)
        with stage("ns_wiener"):
            Y = _kns.wiener(X, noise, float(smooth), float(floor))
    else:
        with stage("ns_psd"):
            psd = torch.square(torch.abs(X))
            P = _onepole_frames(psd, float(smooth))
        with stage("ns_noise"):
            if noise_psd is not None:
                noise = _given_noise(noise_psd, X)[..., None, :]
            else:
                noise = median(psd[..., :noise_frames, :],
                               dim=-2)[..., None, :]
        with stage("ns_gain"):
            Y = X * _kns.wiener_gain(P, noise, floor)
    with stage("ns_istft"):
        y = istft(Y, x.shape[-1], nfft)
        return _convert.f32_to_pcm16(y) if was_i16 else y.to(in_dtype)


# ---------------------------------------------------------------------------
# Streaming (causal) suppression with carried state.
# ---------------------------------------------------------------------------


def stream_init(batch_shape, nfft: int = _DEF_NFFT, noise_frames: int = 8,
                device="cpu") -> dict:
    """Initial streaming state: ``batch_shape`` is the block's leading
    dims, an int ``nch`` or a tuple such as ``(B, ch)``. Fields: the
    input carry (last nfft-hop samples), the output overlap-add tail,
    the lead-in PSD buffer (its median is the frozen estimate, as
    offline), the PSD smoother, the running estimate and per-item frame
    counters (shaped ``batch_shape``: resetting one item's slices, its
    counter too, re-runs that item's lead-in)."""
    bs = ((int(batch_shape),) if isinstance(batch_shape, (int, np.integer))
          else tuple(int(b) for b in batch_shape))
    hop = nfft // 2
    F = nfft // 2 + 1
    z = dict(dtype=torch.float32, device=device)
    return {
        "carry": torch.zeros(bs + (nfft - hop,), **z),
        "ola": torch.zeros(bs + (nfft - hop,), **z),
        "lead": torch.zeros((noise_frames,) + bs + (F,), **z),
        "psd_s": torch.zeros(bs + (F,), **z),
        "noise": torch.zeros(bs + (F,), **z),  # running estimate
        "count": torch.zeros(bs, dtype=torch.int32, device=device),
    }


def stream_suppress(x: torch.Tensor, state: dict, nfft: int = _DEF_NFFT,
                    noise_frames: int = 8, smooth: float = 0.7,
                    floor: float = _DEF_FLOOR, noise_update: str = "frozen",
                    noise_smooth: float = 0.95, presence_thresh: float = 4.0,
                    up_leak: float = 1.02):
    """Causal streaming twin of :func:`suppress` for (..., n) blocks
    (a tensor; the state from :func:`stream_init` for the same leading
    dims, on its device). Returns (y (..., n), new_state).

    The output is delayed by nfft-hop samples (the overlap-add latency);
    frames of the ``noise_frames`` lead-in pass at unity gain while
    their PSDs build the median estimate, the offline one, so after the
    lead-in the gains are the offline gains. Counters are per item;
    a legacy state with one scalar counter is broadcast. ``n`` must be a
    multiple of hop (nfft/2)."""
    _check_mode(noise_update)
    if state["lead"].shape[0] != noise_frames:
        # frames past a smaller lead buffer would overwrite its last row
        # and the median would cover the wrong window
        raise ValueError(
            f"noise_frames={noise_frames} does not match the state's "
            f"lead buffer ({state['lead'].shape[0]} frames from "
            "stream_init); pass the same value to both")
    hop = nfft // 2
    n = x.shape[-1]
    if n % hop:
        raise ValueError(f"stream_suppress needs n % {hop} == 0, got {n}")
    bs = tuple(x.shape[:-1])
    if tuple(state["carry"].shape[:-1]) != bs:
        raise ValueError(
            f"state batch shape {tuple(state['carry'].shape[:-1])} does not "
            f"match input batch shape {bs}; stream_init(batch_shape) "
            "must be built for the same leading dims")
    st = {k: v for k, v in state.items() if k != "carry"}
    if st["count"].dim() == 0 and bs:
        st["count"] = st["count"].to(torch.int32).expand(bs)
    was_i16 = x.dtype == torch.int16
    xf = _convert.pcm16_to_f32(x) if was_i16 else x.to(torch.float32)
    w = _win_t(nfft, xf)
    buf = torch.cat([state["carry"], xf], dim=-1)
    iota = torch.arange(noise_frames, device=xf.device).reshape(
        (noise_frames,) + (1,) * len(bs))
    outs = []
    for j in range(n // hop):
        X = torch.fft.rfft(buf[..., j * hop: j * hop + nfft] * w, dim=-1)
        psd = torch.square(torch.abs(X))
        psd_s = smooth * st["psd_s"] + (1.0 - smooth) * psd
        cnt = st["count"]
        in_lead = cnt < noise_frames
        # per-item lead-buffer update: a one-hot mask over the lead axis
        idx = torch.clamp_max(cnt, noise_frames - 1)
        sel = (iota == idx[None]) & in_lead[None]
        lead = torch.where(sel[..., None], psd[None], st["lead"])
        if noise_update == "adaptive":
            noise = torch.where(
                in_lead[..., None], median(lead, dim=0),
                _adaptive_noise_step(st["noise"], psd, float(noise_smooth),
                                     float(presence_thresh),
                                     float(up_leak)))
        else:
            noise = median(lead, dim=0)  # frozen once the lead-in ends
        snr = torch.clamp_min(psd_s / torch.clamp_min(noise, 1e-20) - 1.0,
                              0.0)
        G = torch.clamp_min(snr / (1.0 + snr), float(floor))
        G = torch.where(in_lead[..., None], 1.0, G)  # unity in the lead-in
        yf = torch.fft.irfft(X * G, n=nfft, dim=-1) * w
        outs.append(yf[..., :hop] + st["ola"])  # at 50% hop, ola is hop wide
        st = {"psd_s": psd_s, "lead": lead, "noise": noise,
              "count": cnt + 1, "ola": yf[..., hop:]}
    y = torch.cat(outs, dim=-1)
    st["carry"] = buf[..., -(nfft - hop):]
    if was_i16:
        return _convert.f32_to_pcm16(y), st
    return y.to(x.dtype), st


# ---------------------------------------------------------------------------
# Numpy oracle (float64): mirrors the pinned math exactly.
# ---------------------------------------------------------------------------


def suppress_np(x, nfft=_DEF_NFFT, noise_frames=8, smooth=0.7,
                floor=_DEF_FLOOR, noise_psd=None, noise_update="frozen",
                noise_smooth=0.95, presence_thresh=4.0, up_leak=1.02):
    x = np.asarray(x, np.float64)
    hop = nfft // 2
    n = x.shape[-1]
    T = _frame_count(n, nfft)
    pad = [(0, 0)] * (x.ndim - 1) + [(hop, (T - 1) * hop + nfft - (n + hop))]
    xp = np.pad(x, pad)
    w = _win(nfft)
    frames = np.stack([xp[..., t * hop: t * hop + nfft] for t in range(T)],
                      axis=-2)
    X = np.fft.rfft(frames * w, axis=-1)
    psd = np.abs(X) ** 2
    P = np.empty_like(psd)
    acc = np.zeros_like(psd[..., 0, :])
    for t in range(T):
        acc = smooth * acc + (1 - smooth) * psd[..., t, :]
        P[..., t, :] = acc
    if noise_psd is not None:
        noise = np.asarray(noise_psd)[..., None, :]
    elif noise_update == "adaptive":
        nz = np.median(psd[..., :noise_frames, :], axis=-2)
        noise = np.empty_like(psd)
        for t in range(T):
            if t >= noise_frames:  # pinned: recursion starts post-lead
                pt = psd[..., t, :]
                ratio = pt / np.maximum(nz, 1e-20)
                upd = noise_smooth * nz + (1 - noise_smooth) * pt
                nz = np.where(ratio < presence_thresh, upd, nz * up_leak)
            noise[..., t, :] = nz
    else:
        noise = np.median(psd[..., :noise_frames, :], axis=-2, keepdims=True)
    snr = np.maximum(P / np.maximum(noise, 1e-20) - 1.0, 0.0)
    G = np.maximum(snr / (1.0 + snr), floor)
    yf = np.fft.irfft(X * G, n=nfft, axis=-1) * w
    total = (T - 1) * hop + nfft
    out = np.zeros(x.shape[:-1] + (total,))
    for t in range(T):
        out[..., t * hop: t * hop + nfft] += yf[..., t, :]
    return out[..., hop: hop + n]
