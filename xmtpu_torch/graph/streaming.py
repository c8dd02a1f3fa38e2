"""Streaming session (counterpart of ``xmtpu.graph.streaming``): seek
and frame-by-frame reads with carried DSP state, the interactive mixer
handle of BASELINE config 5.

One step definition serves every frame (and, batched over slots, the
pool of ``graph.pool``): each track's host window for the frame goes to
the device, is resampled by ``ops.resample.resample_window`` (the
offline path's frame matrix, so streaming equals offline), placed,
gained and faded on float64 sample indices, summed on three buses (the
voice bus through ``config.effects``, side-ducked tracks, the rest),
ducked, and run through ``config.master_effects``. All DSP state is a
tree of tensors carried from frame to frame.

Geometry, as the JAX package's: ``frame_out`` bus samples a frame, a
multiple of every track's polyphase L; a track placed at ``start_bus``
has the constant block phase ``r0 = (-start_bus) mod L``, so each frame
needs ``nj`` whole L-blocks from the block clock ``c0 = (t0 - r0) / L``
and the slice ``[r0 : r0 + frame_out]``.

There is nothing to compile: the step is an eager sequence of torch
operations, so the JAX package's jitted step and ``read_many``'s
per-k ``lax.scan`` have no counterpart here. What ``jit`` hid is the
host side: no operation of the step waits for the device (the device
tables are copied once; ``_upload`` and ``_fetch_start`` use pinned
staging with ``non_blocking`` copies), so ``prefetch_depth`` frames are
in flight at once. A pinned staging block is not reused until the copy
that reads or fills it has passed (torch's caching host allocator
records an event for each such copy), and a fetched frame is read only
after the event recorded behind its copy.

State files keep the JAX package's layout: npz keys ``leaf_i`` in its
tree-flatten order (tuples in order, dict keys sorted, ``()`` and None
give no leaves), so a snapshot from either package restores in the
other (:func:`state_to_jax_leaves`, :func:`state_leaves_from_jax`).
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from xmtpu_torch.config.schema import PipelineConfig, config_from_dict
from xmtpu_torch.graph import fx as _fx
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.ops import mix as _mix
from xmtpu_torch.ops import resample as _resample
from xmtpu_torch.utils.device import check_interpret, resolve_device
from xmtpu_torch.utils.errors import ConfigError

NS_COUNTER = "count"  # the noise-suppression state's lead-in counter


# ---------------------------------------------------------------- state trees


def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic))


def state_paths(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in the JAX package's flatten order: tuples and
    lists in order, dict keys sorted, ``()`` and None contribute no
    leaves. A path is the tuple of indices and keys down to the leaf."""
    if _is_leaf(tree):
        return [(path, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in state_paths(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, t in enumerate(tree)
                for pl in state_paths(t, path + (i,))]
    raise ConfigError(f"state node of type {type(tree).__name__} at "
                      f"{_path_str(path)}")


def _skeleton(tree):
    """A hashable description of the tree's structure (leaves as '*')."""
    if _is_leaf(tree):
        return "*"
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _skeleton(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return ("seq",) + tuple(_skeleton(t) for t in tree)
    raise ConfigError(f"state node of type {type(tree).__name__}")


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if _is_leaf(template):
        return next(leaves)
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    return tuple(_rebuild(t, leaves) for t in template)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path) or "<root>"


def coerce_legacy_state_leaf(v, template: torch.Tensor, path: tuple):
    """A saved state leaf ``v`` (tensor or array) in the template's shape.

    An exact shape passes through unchanged. The one sanctioned widening
    is the noise-suppression lead-in counter: a leaf whose path ends in
    the NS state's ``"count"`` key, integer on both sides, whose shape
    is a leading prefix of the template's, broadcasts over the missing
    dims (older snapshots carried one counter per session, ``()``, or
    per slot, ``(K,)``, where the state now holds one per item, ``(ch,)``
    or ``(K, ch)``; the broadcast is what the shared counter meant).
    Every other mismatch raises :class:`ConfigError`. The JAX package
    widens any integer leaf whose shape is a prefix; the port does not
    copy that."""
    want = tuple(template.shape)
    shape = tuple(v.shape)
    if shape == want:
        return v
    a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    tdt = template.dtype
    if (path[-1:] == (NS_COUNTER,) and not tdt.is_floating_point
            and not tdt.is_complex and tdt != torch.bool
            and np.issubdtype(a.dtype, np.integer)
            and len(shape) < len(want) and shape == want[:len(shape)]):
        return np.broadcast_to(
            a.reshape(shape + (1,) * (len(want) - len(shape))), want).copy()
    raise ConfigError(
        f"state leaf {_path_str(path)} shape {shape} != {want}: the state "
        "does not match this effects chain (another chain, channel count "
        "or slot count)")


def state_to_jax_leaves(state, slot_axes=None) -> list:
    """The state's leaves as numpy arrays in the JAX package's layout and
    flatten order. ``slot_axes``: for a pool, each leaf's slot axis,
    moved to the front (JAX vmaps the single-session step, so every pool
    leaf has the slot axis first)."""
    leaves = [v for _, v in state_paths(state)]
    if slot_axes is not None:
        leaves = [v.movedim(ax, 0) for v, ax in zip(leaves, slot_axes)]
    return [v.detach().cpu().numpy() for v in leaves]


def state_leaves_from_jax(arrays, template, slot_axes=None):
    """The inverse of :func:`state_to_jax_leaves`: ``arrays`` (numpy or
    tensors, the JAX layout and order) -> a state shaped like
    ``template``, on its device and in its dtypes. Each leaf passes
    :func:`coerce_legacy_state_leaf`; a wrong count of leaves raises
    :class:`ConfigError`."""
    paths = state_paths(template)
    arrays = list(arrays)
    if len(arrays) != len(paths):
        raise ConfigError(
            f"state has {len(arrays)} leaves, this effects chain builds "
            f"{len(paths)}")
    axes = slot_axes if slot_axes is not None else [None] * len(paths)
    out = []
    for (path, t), a, ax in zip(paths, arrays, axes):
        tj = t if ax is None else t.movedim(ax, 0)
        c = torch.as_tensor(coerce_legacy_state_leaf(a, tj, path),
                            dtype=t.dtype, device=t.device)
        out.append(c if ax is None else c.movedim(0, ax).contiguous())
    return _rebuild(template, iter(out))


# ------------------------------------------------------------ host <-> device


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the stream: on a
    card through pinned staging and a ``non_blocking`` copy (the staging
    block stays out of reuse until the copy has passed); on the CPU the
    array itself, which every caller hands over freshly made."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch_start(out: torch.Tensor):
    """Start copying ``out`` to the host (the counterpart of
    ``copy_to_host_async``) -> a handle for :func:`_fetch`."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return host, ev


def _fetch(handle) -> np.ndarray:
    """The host array of a :func:`_fetch_start` handle, once its copy
    has landed."""
    host, ev = handle
    if ev is not None:
        ev.synchronize()
    return host.numpy()


# -------------------------------------------------------------- geometry


class _TrackStream:
    """Host-side per-track source geometry and window extraction."""

    def __init__(self, track, pcm, sr_native: int, sr_bus: int,
                 frame_out: int):
        self.cfg = track
        self.sr_bus = sr_bus
        self.frame_out = frame_out
        g = math.gcd(sr_native, sr_bus)
        self.L, self.M = sr_bus // g, sr_native // g
        if frame_out % self.L:
            raise ConfigError(
                f"frame_out {frame_out} not a multiple of track L={self.L}")
        self.plan = (_resample.make_plan(self.L, self.M, 24, 9.0)
                     if self.L != self.M else None)
        pcm = pcm.cpu().numpy() if torch.is_tensor(pcm) else np.asarray(pcm)
        if pcm.dtype == np.int16:
            pcm = _convert.pcm16_to_f32_np(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if track.end_time_ms is not None:
            # trim the source to end - start ms, as the offline pipeline:
            # a looped track then wraps the trimmed clip in both modes
            keep_ms = max(0.0, track.end_time_ms - track.start_time_ms)
            keep_n = int(round(keep_ms * sr_native / 1000.0))
            if keep_n < pcm.shape[0]:
                pcm = pcm[:keep_n]
        self.pcm = np.ascontiguousarray(pcm.T, np.float32)  # (ch, n)
        self.nch = self.pcm.shape[0]
        self.n_native = self.pcm.shape[1]

        self.start_bus = int(round(track.start_time_ms * sr_bus / 1000.0))
        n_out = _resample.resample_output_len(self.n_native, self.L, self.M)
        if track.end_time_ms is not None:
            n_out = min(n_out, int(round(track.end_time_ms * sr_bus / 1000.0))
                        - self.start_bus)
        self.n_out = max(n_out, 0)  # track length at the bus rate
        # the constant block phase: t0 mod L for every frame
        self.r0 = (-self.start_bus) % self.L
        self.nj = frame_out // self.L + (1 if self.r0 else 0)
        self.need = (frame_out if self.plan is None
                     else _resample.plan_rows(self.plan, self.nj) * self.M)

    def window_always(self, frame_idx: int):
        """(host window (ch, need), track-local offset t0) of this frame.
        Never None: outside the track the window is zeros, so every frame
        has the same step shape."""
        t0 = frame_idx * self.frame_out - self.start_bus
        if self.plan is None:
            return self._gather(np.arange(t0, t0 + self.frame_out)), t0
        p = self.plan
        c0 = (t0 - self.r0) // self.L
        lo = c0 * p.M + p.base - p.pad_left
        return self._gather(np.arange(lo, lo + self.need)), t0

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """pcm[:, idx], zeros outside [0, n_native); a loop wraps the
        non-negative indices."""
        if self.cfg.loop and self.n_native > 0:
            w = self.pcm[:, np.mod(idx, self.n_native)]
            w[:, idx < 0] = 0.0
            return w
        valid = (idx >= 0) & (idx < self.n_native)
        w = np.zeros((self.nch, len(idx)), np.float32)
        w[:, valid] = self.pcm[:, idx[valid]]
        return w

    def windows_block(self, frame_idx: int, k: int):
        """:meth:`window_always` for k consecutive frames -> (W (k, ch,
        need), t0s (k,) float64): consecutive windows advance by a
        constant stride, so one gather of the union serves all k."""
        t0s = (np.arange(frame_idx, frame_idx + k, dtype=np.float64)
               * self.frame_out - self.start_bus)
        t0_0 = frame_idx * self.frame_out - self.start_bus
        if self.plan is None:
            u = self._gather(np.arange(t0_0, t0_0 + k * self.frame_out))
            return (np.ascontiguousarray(
                u.reshape(self.nch, k, self.frame_out).swapaxes(0, 1)), t0s)
        p = self.plan
        step = (self.frame_out // self.L) * p.M  # source stride a frame
        lo0 = (t0_0 - self.r0) // self.L * p.M + p.base - p.pad_left
        u = self._gather(np.arange(lo0, lo0 + (k - 1) * step + self.need))
        w = np.empty((k, self.nch, self.need), np.float32)
        for f in range(k):
            w[f] = u[:, f * step: f * step + self.need]
        return w, t0s


# ------------------------------------------------------------------ the step


def _session_state0(voice_effects, master_effects, batch_shape: tuple,
                    has_duck: bool, device):
    """The state tree (voice fx, master fx, duck envelope) for blocks of
    leading shape ``batch_shape`` (``(nch,)`` a session, ``(K, nch)`` a
    pool): one definition for both, so the pool's state cannot drift
    from the session's."""
    vfx = _fx.chain_init_state(voice_effects, batch_shape, device)
    mfx = _fx.chain_init_state(master_effects, batch_shape, device)
    if not has_duck:
        return (vfx, mfx, ())
    z = torch.zeros(batch_shape, dtype=torch.float64, device=device)
    return (vfx, mfx, (z, z.clone()))


def _session_step_fn(tracks, voice_effects, master_effects, nch: int,
                     frame_out: int, has_duck: bool, duck_params, sr: int,
                     batch: tuple = (), device="cpu"):
    """The per-frame step shared by :class:`StreamSession` (``batch``
    ``()``) and ``graph.pool.SessionPool`` (``batch`` ``(K,)``):
    ``step(windows, offsets, state, n_outs=None) -> (out (*batch, nch,
    frame_out) float32, state)``. ``windows``: each track's (*batch, ch,
    need) tensor; ``offsets``: each track-local frame offset t0, a float
    or a float64 (*batch) tensor; ``n_outs``: None (each track's own
    length) or a float64 (*batch) tensor a track (pool slots differ)."""
    shape = tuple(batch) + (nch, frame_out)

    def step(windows, offsets, state, n_outs=None):
        vfx_state, mfx_state, duck_state = state
        # three buses: voice-kind tracks (config.effects, and they drive
        # the duck envelope), side-ducked tracks, everything else
        voice = torch.zeros(shape, dtype=torch.float32, device=device)
        ducked = torch.zeros_like(voice)
        other = torch.zeros_like(voice)
        for k, (ts, w, off) in enumerate(zip(tracks, windows, offsets)):
            if ts.plan is None:
                y = w
            else:
                y = _resample.resample_window(w, ts.plan, ts.nj)
                y = y[..., ts.r0: ts.r0 + frame_out]
            y = _track_env(y, ts, off,
                           n_out=None if n_outs is None else n_outs[k])
            if y.shape[-2] == 1 and nch > 1:
                y = y.expand(shape)
            if ts.cfg.side_duck:
                ducked = ducked + y
            elif ts.cfg.kind == "voice":
                voice = voice + y
            else:
                other = other + y
        voice, vfx_state = _fx.chain_apply(voice_effects, voice, vfx_state)
        if has_duck:
            # the envelope keys off all non-ducked tracks, as offline
            g, duck_state = _mix.duck_gain_block(voice + other, sr,
                                                 duck_state, **duck_params)
            acc = voice + other + ducked * g.to(torch.float32)
        else:
            acc = voice + other
        out, mfx_state = _fx.chain_apply(master_effects, acc, mfx_state)
        return out, (vfx_state, mfx_state, duck_state)

    return step


def _track_env(y: torch.Tensor, ts: _TrackStream, off, n_out=None):
    """Gain, fades and the placement mask at track-local offset ``off``
    (a float, or a float64 tensor of the leading dims). ``n_out``: the
    track length as a float64 tensor of the leading dims (pool slots),
    or None for the track's own. Sample indices are float64: float32
    loses integers past 2^24 samples, which would step the ramps and
    shift the mask."""
    t = ts.cfg
    n = y.shape[-1]
    sr = ts.sr_bus
    if torch.is_tensor(off):
        off = off[..., None]
    n_out = float(ts.n_out) if n_out is None else n_out[..., None]
    i = torch.arange(n, dtype=torch.float64, device=y.device) + off
    g = torch.full((n,), float(t.volume), dtype=torch.float64,
                   device=y.device)
    fade_in = int(round(t.fade_in_ms * sr / 1000.0))
    fade_out = int(round(t.fade_out_ms * sr / 1000.0))
    if fade_in > 0:
        g = g * torch.clamp((i + 1.0) / float(fade_in), max=1.0)
    if fade_out > 0 and not t.loop:
        g = g * torch.clamp((n_out - i) / float(fade_out), 0.0, 1.0)
    if t.loop:
        g = torch.where(i >= 0, g, 0.0)
    else:
        g = torch.where((i >= 0) & (i < n_out), g, 0.0)
    return y * g[..., None, :].to(y.dtype)


def frame_geometry(config: PipelineConfig, frame_ms: float,
                   native_rates) -> int:
    """``frame_out``: ``frame_ms`` at the bus rate, rounded up to a
    multiple of every track's polyphase L."""
    sr = config.sample_rate
    base = max(1, int(round(frame_ms * sr / 1000.0)))
    lcm = 1
    for sr_nat in native_rates:
        L = sr // math.gcd(int(sr_nat), sr)
        lcm = lcm * L // math.gcd(lcm, L)
    return -(-base // lcm) * lcm


# ---------------------------------------------------------------- the session


class StreamSession:
    """Streaming mixer and effects session (the reference's handle API).

    ``read()`` returns the next (frame_out, ch) frame; ``prefetch_depth``
    frames past it are dispatched ahead, each with its device-to-host
    copy started, and a seek discards them. ``read_many(k)`` runs k
    frames and fetches them at once. The effects run the float64 scan
    engine unless an effect names ``backend``; int16 output is converted
    on the device. Runs on ``cuda`` unless ``device`` names another
    device (:class:`DeviceError` without a card). Not thread-safe: one
    session per thread.
    """

    def __init__(self, config, frame_ms: float = 20.0, sources=None,
                 output_dtype=np.int16, duck_params: dict | None = None,
                 prefetch_depth: int = 1, device=None):
        from xmtpu_torch.graph.pipeline import resolve_source

        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        self.device = resolve_device(device)
        self.config = config
        self.sr = config.sample_rate
        self.output_dtype = output_dtype

        resolved = [(t,) + tuple(resolve_source(t, sources, self.sr, i))
                    for i, t in enumerate(config.tracks)]
        self.frame_out = frame_geometry(config, frame_ms,
                                        [sr for _, _, sr in resolved])
        self.tracks = [_TrackStream(t, pcm, int(sr), self.sr, self.frame_out)
                       for t, pcm, sr in resolved]
        self.nch = max((ts.nch for ts in self.tracks),
                       default=config.channels)
        # config.effects run on the summed voice bus at the bus rate
        # before the mix, master_effects after it, as offline
        self.voice_effects = _fx.build_chain(
            self.sr, list(config.effects), default_backend="scan",
            device_type=self.device.type)
        self.master_effects = _fx.build_chain(
            self.sr, list(config.master_effects), default_backend="scan",
            device_type=self.device.type)
        check_interpret(any(getattr(fx, "interpret", False) for fx in
                            self.voice_effects + self.master_effects),
                        self.device)
        for e in self.voice_effects + self.master_effects:
            if hasattr(e, "set_streaming"):  # needs the frame geometry
                e.set_streaming(self.frame_out)
        # looped tracks never fade out in a session (no known end), and
        # loop seams are resampled as a continuous stream
        self.has_duck = any(ts.cfg.side_duck for ts in self.tracks)
        self.duck_params = dict(duck_params or {})
        if int(prefetch_depth) < 1:
            raise ConfigError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.prefetch_depth = int(prefetch_depth)
        self._step = _session_step_fn(
            self.tracks, self.voice_effects, self.master_effects, self.nch,
            self.frame_out, self.has_duck, self.duck_params, self.sr,
            device=self.device)
        self.fx_state = self._init_state()
        self.frame_idx = 0
        self._queue = deque()  # dispatched ahead: (frame_idx, fetch, state)

    def _init_state(self):
        return _session_state0(self.voice_effects, self.master_effects,
                               (self.nch,), self.has_duck, self.device)

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """int16 output converted on the device (half the fetch)."""
        return _convert.f32_to_pcm16(out) if self.output_dtype == np.int16 \
            else out

    # -- public API ----------------------------------------------------------

    def seek(self, ms: float) -> None:
        """Reposition the output clock (frame-aligned) and reset the
        filter state; frames dispatched ahead are dropped."""
        sample = int(round(ms * self.sr / 1000.0))
        self.frame_idx = sample // self.frame_out
        self.fx_state = self._init_state()
        self._queue.clear()

    def _dispatch(self, frame_idx: int, fx_state):
        """Enqueue one frame's step and start its fetch; nothing here
        waits for the device."""
        windows, offsets = [], []
        for ts in self.tracks:
            w, t0 = ts.window_always(frame_idx)
            windows.append(_upload(w, self.device))
            offsets.append(float(t0))
        out, state = self._step(windows, offsets, fx_state)
        return (frame_idx, _fetch_start(self._finish(out)), state)

    def _fill_queue(self) -> None:
        """Top the queue up to ``prefetch_depth`` frames past the last
        queued (or consumed) frame, chaining states on the device."""
        while len(self._queue) < self.prefetch_depth:
            if self._queue:
                tail_idx, _, tail_state = self._queue[-1]
            else:
                tail_idx, tail_state = self.frame_idx - 1, self.fx_state
            self._queue.append(self._dispatch(tail_idx + 1, tail_state))

    def read(self) -> np.ndarray:
        """The next (frame_out, ch) frame."""
        if not self._queue or self._queue[0][0] != self.frame_idx:
            self._queue.clear()
        self._fill_queue()
        idx, handle, state = self._queue.popleft()
        self.fx_state = state
        self.frame_idx = idx + 1
        self._fill_queue()  # the next frames compute while this one lands
        return _fetch(handle).T

    def read_many(self, k: int) -> np.ndarray:
        """k frames -> (k*frame_out, ch): one upload of each track's k
        windows, k steps, one fetch. The frames equal k reads."""
        if k < 1:
            raise ConfigError("read_many(k) needs k >= 1")
        blocks = [ts.windows_block(self.frame_idx, k) for ts in self.tracks]
        ws = [_upload(w, self.device) for w, _ in blocks]
        state, outs = self.fx_state, []
        for f in range(k):
            out, state = self._step([w[f] for w in ws],
                                    [float(t0s[f]) for _, t0s in blocks],
                                    state)
            outs.append(out)
        out = torch.cat(outs, dim=-1)
        self.fx_state = state
        self.frame_idx += k
        self._queue.clear()
        return _fetch(_fetch_start(self._finish(out))).T

    @property
    def state(self):
        """The session state (pause/resume): the frame clock, the DSP
        state tree and the frame size."""
        return {"frame_idx": self.frame_idx, "fx_state": self.fx_state,
                "frame_out": self.frame_out}

    def load_state(self, st) -> None:
        """Install a :attr:`state`. A state of another effects chain,
        channel count or frame size raises :class:`ConfigError` here,
        not at the next read."""
        if st["frame_out"] != self.frame_out:
            raise ConfigError("state frame size mismatch")
        template = self._init_state()
        if _skeleton(st["fx_state"]) != _skeleton(template):
            raise ConfigError(
                "state does not match this session's effects chain "
                f"(expected {len(state_paths(template))} leaves of the "
                "config's structure)")
        leaves = []
        for (path, t), (_, v) in zip(state_paths(template),
                                     state_paths(st["fx_state"])):
            leaves.append(torch.as_tensor(
                coerce_legacy_state_leaf(v, t, path), dtype=t.dtype,
                device=self.device))
        self.frame_idx = int(st["frame_idx"])
        self.fx_state = _rebuild(template, iter(leaves))
        self._queue.clear()

    def save_state(self, path) -> None:
        """Persist the state (npz: ``frame_idx``, ``frame_out`` and the
        leaves ``leaf_i`` in the JAX package's order and layout; the
        structure is rebuilt from the config on load)."""
        leaves = state_to_jax_leaves(self.fx_state)
        np.savez(path, frame_idx=self.frame_idx, frame_out=self.frame_out,
                 **{f"leaf_{i}": v for i, v in enumerate(leaves)})

    def load_state_file(self, path) -> None:
        """Restore a :meth:`save_state` file (this package's or the JAX
        package's); a file of another chain raises :class:`ConfigError`."""
        with np.load(path) as z:
            if int(z["frame_out"]) != self.frame_out:
                raise ConfigError("state frame size mismatch")
            n = sum(1 for k in z.files if k.startswith("leaf_"))
            state = state_leaves_from_jax(
                [z[f"leaf_{i}"] for i in range(n)], self._init_state())
            frame_idx = int(z["frame_idx"])
        self.fx_state = state
        self.frame_idx = frame_idx
        self._queue.clear()
