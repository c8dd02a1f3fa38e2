"""Pooled serving (counterpart of ``xmtpu.graph.pool``): K concurrent
streaming sessions of one config advanced by one batched step.

The deployment shape of the reference library is many independent
mixer handles in one process. :class:`SessionPool` stacks K same-config
sessions: every tensor of the step carries the slot axis, so K slots
cost one sequence of launches a frame instead of K.

* **Sources live on the device.** Each user's PCM goes up once, at
  :meth:`SessionPool.join`, into a per-track ``(K, ch, need + lmax +
  need)`` buffer, written in place (O(row)); the buffer's ``need`` zeros
  on both ends make partial and out-of-range windows exact zeros. Each
  frame's windows are one batched gather over ``(K, need)``: a clipped
  start for ordinary tracks, a floor modulo of the clip length for
  looped ones. Per group only the clocks, lengths and the active mask
  go up, as one pinned ``non_blocking`` copy of a host snapshot, so
  ``join``/``leave``/``seek`` may change the host arrays right after a
  dispatch.
* **The step is the session's** (``streaming._session_step_fn``) with
  the leading shape ``(K,)``. The JAX package vmaps its single-session
  step, so its pool state has the slot axis first in every leaf; here
  the state is built for the batch shape ``(K, nch)``, which puts the
  slot axis at 1 in the EQ's ``(sections, K, ch, 2)`` and the noise
  suppressor's ``(noise_frames, K, ch, F)`` lead buffer. Each leaf's
  slot axis is found once (:func:`_slot_axes`); slot resets address it,
  and snapshots move it to the front, the JAX layout.
* ``read(k)`` runs k frames, converts int16 on the device, starts the
  fetch, dispatches the next group speculatively and only then waits
  for this group's bytes. There is no compile cache: the JAX package's
  per-k jitted scans (and their LRU) exist only because ``jit``
  compiles.
* **``mesh=``** shards the slot axis over a mesh axis (``mesh_axis``,
  ``"dp"``): slot ``s`` lives on the device of shard ``s // (K/n)``
  with its source buffers, its state and its clocks' upload, and the
  session's step runs once per shard at the leading shape ``(K/n,)``.
  Every shard's group is dispatched before any fetch is waited for; the
  shards' frames land in one host array in slot order. One process
  drives every shard (the JAX package's pool is one SPMD program, and
  its host calls act on global slots), and devices may repeat: virtual
  shards on one device. Snapshots keep the unsharded layout, so a file
  loads into a sharded or an unsharded pool alike. On a card a sharded
  pool can differ from the unsharded one by 1 LSB: each frame's resample
  (``ops.resample.resample_window``) is a ``torch.matmul`` whose cuBLAS
  kernel, and so its rounding, depends on the row count (K/n slots
  against K); the EQ and limiter kernels give every row bit for bit. On
  the CPU the two are bit for bit.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from xmtpu_torch.config.schema import PipelineConfig, config_from_dict
from xmtpu_torch.graph import fx as _fx
from xmtpu_torch.graph.streaming import (_rebuild, _TrackStream, _fetch,
                                         _fetch_start, _session_state0,
                                         _session_step_fn, _upload,
                                         frame_geometry,
                                         state_leaves_from_jax,
                                         state_paths, state_to_jax_leaves)
from xmtpu_torch.ops import convert as _convert
from xmtpu_torch.utils.device import check_interpret, resolve_device
from xmtpu_torch.utils.errors import ConfigError

EFFECTS_BACKENDS = ("scan", "pallas", "pallas_interpret")


def _locked(method):
    """Serialize a public method on the pool's lock (an RLock: locked
    methods call each other, e.g. the constructor's joins)."""
    @functools.wraps(method)
    def wrapper(self, *a, **kw):
        with self._lock:
            return method(self, *a, **kw)
    return wrapper


def mesh_devices(mesh, mesh_axis: str, n_slots: int, device) -> list:
    """The device of each slot shard: ``[resolve_device(device)]``
    without a mesh; with one, the devices along ``mesh_axis`` (the other
    axes at index 0). A mesh without that axis, ``n_slots`` that does not
    divide evenly over it, devices of more than one type, or a
    ``device`` that is not the mesh's raise :class:`ConfigError`."""
    if mesh is None:
        return [resolve_device(device)]
    if mesh_axis not in mesh.axis_names:
        raise ConfigError(f"mesh has no axis {mesh_axis!r} (axes: "
                          f"{mesh.axis_names})")
    n = mesh.shape[mesh_axis]
    if n_slots % n:
        raise ConfigError(f"n_slots={n_slots} must divide evenly over mesh "
                          f"axis {mesh_axis!r} (size {n})")
    devs = mesh.axis_devices(mesh_axis)
    if len({d.type for d in devs}) > 1:
        raise ConfigError(f"the mesh mixes device types: {devs}")
    if device is not None:
        want = torch.device(device)
        if any(d.type != want.type or (want.index is not None
                                       and d.index != want.index)
               for d in devs):
            raise ConfigError(f"device={str(want)!r} disagrees with the "
                              f"mesh's devices {[str(d) for d in devs]}")
    return devs


def _fetch_start_rows(outs: list):
    """Start copying each shard's output into its rows of one host
    array, in slot order -> a handle for ``streaming._fetch``."""
    if len(outs) == 1:
        return _fetch_start(outs[0])
    on_card = [o.device.type == "cuda" for o in outs]
    host = torch.empty((sum(o.shape[0] for o in outs),) + outs[0].shape[1:],
                       dtype=outs[0].dtype, pin_memory=any(on_card))
    events, lo = [], 0
    for o, card in zip(outs, on_card):
        host[lo:lo + o.shape[0]].copy_(o, non_blocking=card)
        lo += o.shape[0]
        if card:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(o.device))
            events.append(ev)
    return host, (_Events(events) if events else None)


class _Events(list):
    """The shards' copy events, waited for together."""

    def synchronize(self) -> None:
        for ev in self:
            ev.synchronize()


class _Shard:
    """Slots [lo, hi) of a pool on one device: their source buffers,
    state and step (set up by the pool)."""

    def __init__(self, device: torch.device, lo: int, hi: int):
        self.device, self.lo, self.hi = device, lo, hi
        self.srcbuf = self.states = self.state0 = self.step = None


def _slot_axes(init_state) -> list:
    """Each state leaf's slot axis: the one axis where the states built
    for 2 and for 3 slots differ."""
    axes = []
    for (_, a), (_, b) in zip(state_paths(init_state(2)),
                              state_paths(init_state(3))):
        diff = [i for i, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]
        if len(diff) != 1 or a.dim() != b.dim():
            raise ConfigError(f"state leaf of shape {tuple(a.shape)} has no "
                              "single slot axis")
        axes.append(diff[0])
    return axes


class SessionPool:
    """K concurrent streaming sessions batched into one device step.

    ``config``: the shared pipeline config (dict or PipelineConfig).
    ``n_slots``: the capacity K. ``sources``: per-slot source dicts
    (name -> pcm | (pcm, sr), as :class:`StreamSession`); slot 0's are
    required (its native rates fix the frame geometry), missing or None
    entries start empty. ``max_seconds``: the guaranteed capacity of the
    per-slot source buffers (they hold the longer of this and the
    longest source given at construction; a later :meth:`join` past it
    raises). ``effects_backend``: the engine of effects that name none:
    ``"scan"`` (the float64 scans, equal to a :class:`StreamSession`),
    ``"pallas"`` (the kernels on a card, their twins on the CPU) or
    ``"pallas_interpret"`` (the twins; the CPU only). ``device``: where
    the pool runs, ``cuda`` unless given. ``mesh``/``mesh_axis``: a
    :class:`~xmtpu_torch.parallel.Mesh` whose axis ``mesh_axis`` the
    slots shard over (``n_slots`` must divide evenly; the module
    docstring); ``device``, if given too, must be the mesh's.

    THREAD SAFETY: every public method holds one internal lock, so a
    serving loop may :meth:`read` on one thread while handlers
    ``join``/``leave``/``seek`` other slots.
    """

    def __init__(self, config, n_slots: int, frame_ms: float = 20.0,
                 sources=None, output_dtype=np.int16,
                 duck_params: dict | None = None,
                 max_seconds: float | None = None,
                 mesh=None, mesh_axis: str = "dp",
                 effects_backend: str = "scan", device=None):
        self._lock = threading.RLock()
        if effects_backend not in EFFECTS_BACKENDS:
            raise ConfigError(
                f"effects_backend must be scan|pallas|pallas_interpret, "
                f"got {effects_backend!r}")
        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        if n_slots < 1:
            raise ConfigError("n_slots must be >= 1")
        self.n_slots = K = int(n_slots)
        devices = mesh_devices(mesh, mesh_axis, K, device)
        self.device = devices[0]
        per = K // len(devices)
        self._shards = [_Shard(d, i * per, (i + 1) * per)
                        for i, d in enumerate(devices)]
        self.config = config
        self.sr = config.sample_rate
        self.output_dtype = output_dtype
        self.frame_ms = float(frame_ms)
        self.effects_backend = effects_backend

        sources = list(sources or [])
        if len(sources) > K:
            raise ConfigError(f"{len(sources)} source sets for {K} slots")
        if not sources or sources[0] is None:
            raise ConfigError(
                "SessionPool needs sources for slot 0 at construction: "
                "track native rates fix the pool's frame geometry")

        # decode each given source once: slot 0's native rates fix the
        # geometry, and the joins below reuse the built tracks
        self._slot_tracks: list = [None] * K
        self._frame_idx = np.zeros(K, np.int64)
        resolved = {i: self._resolve(s) for i, s in enumerate(sources)
                    if s is not None}
        self.frame_out = frame_geometry(config, self.frame_ms,
                                        [sr for _, sr in resolved[0]])
        built = {i: self._build_tracks(resolved=r)
                 for i, r in resolved.items()}
        geom = self._geom = built[0]
        self.nch = max((ts.nch for ts in geom), default=config.channels)

        # device-resident source buffers, one per track
        self._need = [ts.need for ts in geom]
        self._lmax = []
        for j, gs in enumerate(geom):
            lm = max(tr[j].n_native for tr in built.values())
            if max_seconds is not None:
                lm = max(lm, int(math.ceil(max_seconds
                                           * (self.sr * gs.M // gs.L))))
            self._lmax.append(lm)
        self._n_nat = [np.zeros(K, np.int64) for _ in geom]
        self._n_out = [np.zeros(K, np.float64) for _ in geom]

        self.voice_effects = _fx.build_chain(
            self.sr, list(config.effects), default_backend=effects_backend,
            device_type=self.device.type)
        self.master_effects = _fx.build_chain(
            self.sr, list(config.master_effects),
            default_backend=effects_backend, device_type=self.device.type)
        check_interpret(any(getattr(fx, "interpret", False) for fx in
                            self.voice_effects + self.master_effects),
                        self.device)
        for e in self.voice_effects + self.master_effects:
            if hasattr(e, "set_streaming"):
                e.set_streaming(self.frame_out)
        self.has_duck = any(ts.cfg.side_duck for ts in geom)
        self.duck_params = dict(duck_params or {})
        self._slot_axes = _slot_axes(lambda k: self._init_state(
            (k, self.nch), self.device))
        for sh in self._shards:
            n = sh.hi - sh.lo
            sh.srcbuf = [
                torch.zeros((n, gs.nch, 2 * self._need[j] + self._lmax[j]),
                            dtype=torch.float32, device=sh.device)
                for j, gs in enumerate(geom)]
            sh.state0 = self._init_state((self.nch,), sh.device)
            sh.states = self._init_state((n, self.nch), sh.device)
            sh.step = _session_step_fn(
                geom, self.voice_effects, self.master_effects, self.nch,
                self.frame_out, self.has_duck, self.duck_params, self.sr,
                batch=(n,), device=sh.device)
        self._pending = None  # the speculative next group

        for i, src in enumerate(sources):
            if src is not None:
                self.join(i, src, _tracks=built[i])

    def _init_state(self, batch_shape: tuple, device):
        return _session_state0(self.voice_effects, self.master_effects,
                               batch_shape, self.has_duck, device)

    def _shard_of(self, slot: int):
        """(the shard holding ``slot``, its index there)."""
        sh = self._shards[slot // (self._shards[0].hi - self._shards[0].lo)]
        return sh, slot - sh.lo

    @property
    def states(self):
        """The state tree of every slot: the shard's own with one shard,
        else the shards' leaves concatenated along their slot axes on
        the first shard's device (a copy)."""
        if len(self._shards) == 1:
            return self._shards[0].states
        per_shard = [[v for _, v in state_paths(sh.states)]
                     for sh in self._shards]
        leaves = [torch.cat([v.to(self.device) for v in vs], dim=ax)
                  for vs, ax in zip(zip(*per_shard), self._slot_axes)]
        return _rebuild(self._shards[0].states, iter(leaves))

    # -- slot lifecycle ------------------------------------------------------

    def _resolve(self, src) -> list:
        """Each track's (pcm, native_sr), decoded once."""
        from xmtpu_torch.graph.pipeline import resolve_source

        return [resolve_source(t, src, self.sr, i)
                for i, t in enumerate(self.config.tracks)]

    def _build_tracks(self, src=None, resolved=None) -> list:
        if resolved is None:
            resolved = self._resolve(src)
        return [_TrackStream(t, pcm, int(sr_nat), self.sr, self.frame_out)
                for t, (pcm, sr_nat) in zip(self.config.tracks, resolved)]

    @_locked
    def join(self, slot: int, sources, _tracks: list | None = None) -> None:
        """Attach a user's sources to ``slot`` (its state and clock
        reset; one in-place upload per track). The slot's native rates
        and channel counts must match the pool's geometry, and each
        source must fit the buffers; checked before anything changes."""
        self._check_slot(slot)
        tracks = _tracks if _tracks is not None else self._build_tracks(sources)
        for j, (ts, gs) in enumerate(zip(tracks, self._geom)):
            if (ts.L, ts.M) != (gs.L, gs.M):
                raise ConfigError(
                    f"slot {slot} track {j}: native rate gives polyphase "
                    f"L/M {ts.L}/{ts.M}, pool geometry is {gs.L}/{gs.M}")
            if ts.nch != gs.nch:
                raise ConfigError(
                    f"slot {slot} track {j}: {ts.nch} channels, pool "
                    f"geometry has {gs.nch}")
            if ts.n_native > self._lmax[j]:
                raise ConfigError(
                    f"slot {slot} track {j}: {ts.n_native} samples exceed "
                    f"the pool source buffer ({self._lmax[j]}); construct "
                    "the pool with a larger max_seconds")
        self._slot_tracks[slot] = tracks
        sh, i = self._shard_of(slot)
        for j, ts in enumerate(tracks):
            need, row = self._need[j], sh.srcbuf[j][i]
            row.zero_()
            if ts.n_native:
                row[:, need: need + ts.n_native].copy_(
                    _upload(ts.pcm, sh.device))
            self._n_nat[j][slot] = ts.n_native
            self._n_out[j][slot] = float(ts.n_out)
        for ts in tracks:
            ts.pcm = None  # the audio lives on the device from here
        self._frame_idx[slot] = 0
        self._pending = None  # stale windows and state
        self._reset_state(slot)

    @_locked
    def leave(self, slot: int) -> None:
        """Detach ``slot``: it outputs exact silence until the next
        :meth:`join` (zero length and a state reset, so a departed
        user's filter tails do not ring into the freed slot)."""
        self._check_slot(slot)
        self._slot_tracks[slot] = None
        for j in range(len(self._geom)):
            self._n_nat[j][slot] = 0
            self._n_out[j][slot] = 0.0
        self._pending = None
        self._reset_state(slot)

    @_locked
    def seek(self, slot: int, ms: float) -> None:
        """Frame-aligned reposition of one slot and a state reset."""
        self._check_slot(slot)
        sample = int(round(ms * self.sr / 1000.0))
        self._frame_idx[slot] = sample // self.frame_out
        self._pending = None
        self._reset_state(slot)

    @_locked
    def active(self) -> list[int]:
        return [i for i, t in enumerate(self._slot_tracks) if t is not None]

    @_locked
    def at_end(self, slot: int) -> bool:
        """True once every non-loop track of ``slot`` has been produced
        at its current clock (loop-only slots never end; empty slots
        have)."""
        self._check_slot(slot)
        tracks = self._slot_tracks[slot]
        if tracks is None:
            return True
        finite = [ts for ts in tracks if not ts.cfg.loop]
        if not finite:
            return False
        fi = int(self._frame_idx[slot])
        return all((fi * self.frame_out - ts.start_bus) >= ts.n_out
                   for ts in finite)

    @_locked
    def frames_remaining(self, slot: int) -> int | None:
        """Frames until :meth:`at_end`: None for loop-only slots, 0 for
        empty or ended ones. The last frame may be partial; its rest is
        exact silence."""
        self._check_slot(slot)
        tracks = self._slot_tracks[slot]
        if tracks is None:
            return 0
        finite = [ts for ts in tracks if not ts.cfg.loop]
        if not finite:
            return None
        end = max(ts.start_bus + ts.n_out for ts in finite)
        return max(0, -(-end // self.frame_out) - int(self._frame_idx[slot]))

    def _check_slot(self, slot: int) -> None:
        if not (0 <= slot < self.n_slots):
            raise ConfigError(f"slot {slot} out of range [0, {self.n_slots})")

    def _reset_state(self, slot: int) -> None:
        """The slot's slice of every state leaf back to the initial
        state, in place, along that leaf's own slot axis."""
        sh, i = self._shard_of(slot)
        for (_, S), (_, s0), ax in zip(state_paths(sh.states),
                                       state_paths(sh.state0),
                                       self._slot_axes):
            S.select(ax, i).copy_(s0)

    # -- checkpoint and restore ---------------------------------------------

    @_locked
    def save_state(self, path) -> None:
        """Snapshot every slot's DSP state and clock to ``path`` (npz, the
        JAX package's keys and layouts: a snapshot of either package
        restores in the other). Sources are not saved: restore after
        joining the same sources in the same slots."""
        leaves = [np.concatenate(vs) for vs in zip(*(
            state_to_jax_leaves(sh.states, self._slot_axes)
            for sh in self._shards))]
        np.savez(
            path, frame_out=self.frame_out, n_slots=self.n_slots,
            frame_idx=self._frame_idx,
            n_nat=np.stack(self._n_nat) if self._n_nat else np.zeros((0, 0)),
            active=np.array([t is not None for t in self._slot_tracks], bool),
            **{f"leaf_{i}": v for i, v in enumerate(leaves)})

    @_locked
    def load_state_file(self, path) -> None:
        """Restore a :meth:`save_state` snapshot. The pool must have the
        same geometry and the same sources joined in the same slots
        (checked: the slot mask and each track's source lengths); a
        snapshot of another effects chain raises :class:`ConfigError`."""
        with np.load(path) as z:
            if (int(z["frame_out"]) != self.frame_out
                    or int(z["n_slots"]) != self.n_slots):
                raise ConfigError(
                    "pool snapshot geometry mismatch: saved frame/slot "
                    f"shape ({int(z['frame_out'])}, {int(z['n_slots'])}) vs "
                    f"this pool's ({self.frame_out}, {self.n_slots})")
            active_now = np.array([t is not None for t in self._slot_tracks],
                                  bool)
            if not np.array_equal(active_now, z["active"]):
                raise ConfigError(
                    "pool snapshot active-slot mask mismatch: join the same "
                    "slots before restoring")
            want = (len(self._geom), self.n_slots)
            if z["n_nat"].shape != want:
                raise ConfigError(
                    f"pool snapshot track table shape {z['n_nat'].shape} != "
                    f"{want} (different track count in config?)")
            for j in range(len(self._geom)):
                if not np.array_equal(self._n_nat[j], z["n_nat"][j]):
                    raise ConfigError(
                        f"track {j} source lengths differ from the "
                        "snapshot: rejoin the same sources before restoring")
            n_saved = sum(1 for k in z.files if k.startswith("leaf_"))
            n_want = len(self._slot_axes)
            if n_saved != n_want:
                raise ConfigError(
                    f"pool snapshot has {n_saved} state leaves, this pool's "
                    f"config builds {n_want} (different effects chain?)")
            # the whole pool's tree on the host, then each shard's slots
            full = state_leaves_from_jax(
                [z[f"leaf_{i}"] for i in range(n_saved)],
                self._init_state((self.n_slots, self.nch), "cpu"),
                self._slot_axes)
            frame_idx = z["frame_idx"].copy()
        for sh in self._shards:
            sh.states = _rebuild(sh.states, iter(
                v.narrow(ax, sh.lo, sh.hi - sh.lo).to(sh.device).contiguous()
                for (_, v), ax in zip(state_paths(full), self._slot_axes)))
        self._frame_idx[:] = frame_idx
        self._pending = None

    # -- the device step -----------------------------------------------------

    def _windows(self, sh, fi: torch.Tensor, n_nats, active: torch.Tensor):
        """Each slot of shard ``sh``: its window of every track at frame
        clocks ``fi`` (the shard's slots) int64, one batched gather per
        track."""
        windows, offsets = [], []
        for j, gs in enumerate(self._geom):
            t0 = fi * self.frame_out - gs.start_bus
            if gs.plan is None:
                lo = t0
            else:
                c0 = torch.div(t0 - gs.r0, gs.L, rounding_mode="floor")
                lo = c0 * gs.M + (gs.plan.base - gs.plan.pad_left)
            windows.append(self._extract(sh.srcbuf[j], j, lo, n_nats[j],
                                         active, bool(gs.cfg.loop)))
            offsets.append(t0.to(torch.float64))
        return windows, offsets

    def _extract(self, src, j: int, lo, n_nat, active, loop: bool):
        """Track j's (K, ch, need) windows of its source buffer ``src``
        (a shard's K slots) starting at source index ``lo`` (K,).
        Ordinary tracks: a clipped start into the zero-padded buffer. Loops: the index modulo the clip length (a
        floor modulo, non-negative for a negative ``lo``), zeros before
        the clip's start. Empty slots read zeros (``active``)."""
        need = self._need[j]
        K, ch, length = src.shape
        ar = torch.arange(need, device=src.device)
        if loop:
            pos = lo[:, None] + ar
            idx = torch.remainder(pos, torch.clamp_min(n_nat, 1)[:, None])
            w = torch.gather(src, 2, (idx + need)[:, None, :].expand(
                K, ch, need))
            w = torch.where((pos >= 0)[:, None, :], w, 0.0)
        else:
            start = torch.clamp(lo + need, 0, length - need)
            w = torch.gather(src, 2, (start[:, None] + ar)[:, None, :].expand(
                K, ch, need))
        return w * active[:, None, None]

    def _dispatch(self, k: int):
        """Enqueue one K x k group for the current clocks, shard after
        shard, and start its fetch; nothing waits for a device. One
        upload a shard: its slots' columns of a snapshot of the clocks,
        the active mask and the per-slot lengths (float64 holds every
        integer a clip can reach exactly), each a fresh pinned copy."""
        T = len(self._geom)
        host = np.empty((2 + 2 * T, self.n_slots), np.float64)
        host[0] = self._frame_idx
        host[1] = [t is not None for t in self._slot_tracks]
        for j in range(T):
            host[2 + j] = self._n_nat[j]
            host[2 + T + j] = self._n_out[j]
        outs, shard_states = [], []
        for sh in self._shards:
            dev = _upload(host[:, sh.lo:sh.hi], sh.device)
            fi0 = dev[0].to(torch.int64)
            active = dev[1].to(torch.float32)
            n_nats = dev[2:2 + T].to(torch.int64)
            n_outs = list(dev[2 + T:])
            states, frames = sh.states, []
            for f in range(k):
                windows, offsets = self._windows(sh, fi0 + f, n_nats, active)
                out, states = sh.step(windows, offsets, states, n_outs)
                frames.append(out)
            # (K, ch, k, frame) -> (K, ch, k*frame)
            out = torch.stack(frames, dim=2).reshape(
                sh.hi - sh.lo, self.nch, k * self.frame_out)
            if self.output_dtype == np.int16:  # on the device: half the fetch
                out = _convert.f32_to_pcm16(out)
            outs.append(out)
            shard_states.append(states)
        return (k, self._frame_idx.copy(), _fetch_start_rows(outs),
                shard_states)

    # -- reading -------------------------------------------------------------

    def _pending_for(self, k: int):
        pend = self._pending
        if (pend is None or pend[0] != k
                or not np.array_equal(pend[1], self._frame_idx)):
            return None
        return pend

    @_locked
    def prime(self, k: int = 1) -> None:
        """Dispatch a K x k group for the current clocks unless one is
        pending (no clock advance); the next :meth:`read` of the same k
        takes it. ``PoolServer.pump`` primes every pool before fetching
        any, so their device work overlaps."""
        if k < 1:
            raise ConfigError("prime(k) needs k >= 1")
        if self._pending_for(k) is None:
            self._pending = self._dispatch(k)

    @_locked
    def read(self, k: int = 1) -> np.ndarray:
        """Advance every active slot by k frames -> (K, k*frame, ch) PCM
        (empty slots: silence). The next group is dispatched before this
        group's bytes are waited for; ``join``/``leave``/``seek`` drop
        it."""
        if k < 1:
            raise ConfigError("read(k) needs k >= 1")
        pend = self._pending_for(k) or self._dispatch(k)
        self._pending = None
        _, _, handle, shard_states = pend
        for sh, states in zip(self._shards, shard_states):
            sh.states = states
        for i in range(self.n_slots):
            if self._slot_tracks[i] is not None:
                self._frame_idx[i] += k
        self._pending = self._dispatch(k)  # the next group computes
        return np.moveaxis(_fetch(handle), 1, 2)
