"""Public API (counterpart of ``xmtpu.api``): :func:`resample`, the
rate conversion of BASELINE config 1; :func:`mix`, the multi-track
mixer; :func:`effects`, the EQ -> reverb -> limiter chain of config 3;
and :func:`process_file`, the one-shot generator (tracks + config ->
mixed file); :class:`Session`, the streaming frame reads of config 5,
and :class:`SessionPool`, many such sessions in one batched step.

Accepts int16 or float32 PCM shaped ``(n,)``, ``(n, channels)`` (and,
for :func:`effects`, a batched ``(B, n, channels)`` stack), as a numpy
array or a tensor, and returns the same format. The device layout is
time-last, as the JAX package's: ``(channels, n)`` or ``(B, channels,
n)``. Every entry runs on ``cuda`` unless ``device=`` names another
device, and raises :class:`~xmtpu_torch.utils.errors.DeviceError`
without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.config.schema import (EffectConfig,  # noqa: F401
                                       PipelineConfig, TrackConfig)
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.utils.device import resolve_device, to_device
from xmtpu_torch.utils.profiling import stage


def _to_f32_device(pcm, device) -> tuple[torch.Tensor, bool, bool]:
    """-> (contiguous float32 time-last tensor on ``device``, was_int16,
    was_1d). The upload is ``utils.device.to_device``'s blocking copy."""
    arr = to_device(pcm, device)
    was_1d = arr.dim() == 1
    if was_1d:
        arr = arr[:, None]
    if arr.dim() == 2:
        arr = arr.T  # -> (channels, n), time-last for device ops
    elif arr.dim() == 3:  # batched clips (B, n, ch) -> (B, ch, n)
        arr = arr.transpose(-1, -2)
    else:
        raise ValueError(
            f"PCM must be (n,), (n, channels) or (B, n, channels), "
            f"got {tuple(arr.shape)}")
    with stage("layout"):
        if arr.dtype == torch.int16:
            return _convert.pcm16_to_f32(arr).contiguous(), True, was_1d
        return arr.to(torch.float32).contiguous(), False, was_1d


def _from_f32_device(y: torch.Tensor, was_int16: bool, was_1d: bool,
                     to_host: bool = True):
    """Back to the caller's format and time-first layout: a numpy array
    (``to_host``) or a contiguous tensor on the device."""
    out = _convert.f32_to_pcm16(y) if was_int16 else y
    out = out.transpose(-1, -2)  # back to (..., n, channels)
    if was_1d:
        out = out[..., 0]
    with stage("layout"):
        out = out.contiguous()
    return out.cpu().numpy() if to_host else out


def resample(pcm, sr_in: int, sr_out: int, taps_per_phase: int = 24,
             beta: float = 9.0, device=None):
    """Sample-rate-convert PCM (int16 or float32, ``(n,)`` or ``(n,
    ch)``): int16 in gives int16 out, float32 gives float32; the output
    length is ``ceil(n * sr_out / sr_in)`` after gcd reduction. The rates
    pass ``ops.resample.check_rates`` first (a :class:`ConfigError`
    otherwise). Runs on ``cuda`` unless ``device=`` is given: there on
    the resample kernel (``kernels.resample.resample``) for bands up to
    2M and the strided convolution above; on the CPU the kernel's plain
    twin (``ops.resample.polyphase_resample``)."""
    from xmtpu_torch.kernels import resample as _kres
    from xmtpu_torch.ops import resample as _res

    _res.check_rates(sr_in, sr_out)
    dev = resolve_device(device)
    ndim = pcm.dim() if torch.is_tensor(pcm) else np.ndim(pcm)
    if ndim > 2:
        raise ValueError(f"PCM must be (n,) or (n, channels), got shape "
                         f"{tuple(pcm.shape)}")
    x, was_i16, was_1d = _to_f32_device(pcm, dev)
    y = _kres.resample(x, sr_in, sr_out, taps_per_phase=taps_per_phase,
                       beta=beta)
    return _from_f32_device(y, was_i16, was_1d)


def mix(tracks, sample_rate: int, normalize: str | None = "peak", **kw):
    """Multi-track mix onto a common bus.

    ``tracks``: track specs, each a ``(pcm, sr)`` pair, a dict
    (``{"pcm", "sr", "gain"/"gain_db", "start_ms", "fade_in_ms",
    "fade_out_ms", "loop", "kind", "side_duck"}``) or a
    :class:`xmtpu_torch.graph.mixer.MixTrack`. Tracks are resampled to
    ``sample_rate``, placed, faded, looped, optionally ducked under the
    voice bus, summed and normalized (``"peak"``, ``"rms"``,
    ``"lufs"`` or None). The output dtype follows the first track
    (int16 in, int16 out). Other keywords: ``target_db``,
    ``duration_ms``, ``duck_params``, ``voice_effects``, ``device``
    (``cuda`` unless given), ``device_out`` (return the bus as a tensor
    on the device, in the same layout and dtype, instead of a numpy
    array). See :func:`xmtpu_torch.graph.mixer.mix`."""
    from xmtpu_torch.graph import mixer

    return mixer.mix(tracks, sample_rate, normalize=normalize, **kw)


def effects(pcm, sample_rate: int, chain, **kw):
    """Effect chain (config 3), on ``cuda`` unless ``device=`` names
    another device. With no ``backend`` (or ``"auto"``) the engine
    follows the device, as the JAX package's follows its platform: the
    port's kernels on ``cuda``, the float64 scan engine on the CPU
    (``backend="pallas"`` there runs the kernels' plain twins); a
    limiter with ``linked_fuse`` runs the kernel's gain form (its twin on
    the CPU) under ``auto``, the computation asked for. Other keywords:
    ``block_size`` (fixed blocks with carried state), ``backend`` (the
    default engine of effects that name none: ``auto``, ``pallas``,
    ``scan``/``oracle``/``xla``), ``device_out`` (return the tensor on
    the device instead of a numpy array). See
    :func:`xmtpu_torch.graph.fx.apply_chain`."""
    from xmtpu_torch.graph import fx

    return fx.apply_chain(pcm, sample_rate, chain, **kw)


def process_file(inputs, config: PipelineConfig, out_path, progress=None,
                 device=None):
    """One-shot generator: input file(s) + config -> mixed output file
    (decode, mix with the voice effects and normalization, the master
    chain, encode by the extension). ``inputs``: None, or a dict url ->
    pcm or (pcm, sr) overriding the config's urls. ``progress``: called
    with 0, 10, 80, 95 and 100 as the stages end. Runs on ``cuda``
    unless ``device`` names another device. See
    :func:`xmtpu_torch.graph.pipeline.process_file`."""
    from xmtpu_torch.graph import pipeline

    return pipeline.process_file(inputs, config, out_path,
                                 progress=progress, device=device)


class Session:
    """Streaming session: seek and frame reads with carried DSP state
    (the reference's mixer handle API). Wraps
    :class:`xmtpu_torch.graph.streaming.StreamSession`: ``read()`` returns
    one (frame, ch) frame (``prefetch_depth`` frames dispatched ahead),
    ``read_many(k)`` k frames with one fetch; the state is a tree of
    tensors (``state``/``load_state``) or an npz file in the JAX
    package's layout (``save_state``/``load_state_file``). Runs on
    ``cuda`` unless ``device=`` names another device. Not thread-safe:
    one Session per thread; :class:`SessionPool` serves many streams in
    one process behind a lock."""

    def __init__(self, *a, **kw):
        from xmtpu_torch.graph.streaming import StreamSession

        self._impl = StreamSession(*a, **kw)

    def seek(self, ms: float):
        return self._impl.seek(ms)

    def read(self):
        return self._impl.read()

    @property
    def state(self):
        return self._impl.state

    def load_state(self, st):
        return self._impl.load_state(st)

    def save_state(self, path):
        return self._impl.save_state(path)

    def load_state_file(self, path):
        return self._impl.load_state_file(path)

    def read_many(self, k: int):
        return self._impl.read_many(k)


class SessionPool:
    """Serving mode: K concurrent streaming sessions of one config
    advanced by one batched device step (the reference's many handles
    in one process). ``join(slot, sources)``, ``leave(slot)`` and
    ``seek(slot, ms)`` manage users; ``read(k)`` advances every active
    slot k frames with one fetch -> (K, k*frame, ch) PCM. Runs on
    ``cuda`` unless ``device=`` names another device. See
    :class:`xmtpu_torch.graph.pool.SessionPool`."""

    def __init__(self, *a, **kw):
        from xmtpu_torch.graph.pool import SessionPool as _Pool

        self._impl = _Pool(*a, **kw)

    @property
    def n_slots(self):
        return self._impl.n_slots

    @property
    def frame_out(self):
        return self._impl.frame_out

    @property
    def sr(self):
        return self._impl.sr

    def join(self, slot: int, sources):
        return self._impl.join(slot, sources)

    def leave(self, slot: int):
        return self._impl.leave(slot)

    def seek(self, slot: int, ms: float):
        return self._impl.seek(slot, ms)

    def active(self):
        return self._impl.active()

    def read(self, k: int = 1):
        return self._impl.read(k)

    def save_state(self, path):
        """Snapshot every slot's DSP state and clock (serving failover);
        restore with :meth:`load_state_file` after joining the same
        sources."""
        return self._impl.save_state(path)

    def load_state_file(self, path):
        return self._impl.load_state_file(path)
