"""Serving front end over :class:`~xmtpu_torch.graph.pool.SessionPool`
for sessions of many configs (counterpart of ``xmtpu.graph.serve``).

A process of the reference library holds many independent mixer
handles, one per client, each with its own JSON config.
:class:`PoolServer` buckets sessions by what their step computes (the
config's content and the frame geometry), backs every bucket with one
or more pools, and hands clients session ids for
``read``/``seek``/``close``.

A pool advances all of its slots together (one step a frame for all of
them), so a session's ``read`` buffers: a read that needs frames pumps
the owning pool once and queues the co-resident sessions' frames for
their own readers. A synchronous serving loop can call :meth:`pump`
once a period instead and fan the frames out. A session that stops
reading would buffer without bound: past ``max_buffer_frames`` the
server refuses to advance its pool (:meth:`PoolServer.read` raises,
naming the laggard; :meth:`PoolServer.pump` skips that pool and keeps
the others going). Sessions past their end buffer nothing, and a pool
whose sessions have all ended costs no device work.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from xmtpu_torch.config.schema import PipelineConfig, config_from_dict
from xmtpu_torch.graph.pool import mesh_devices
from xmtpu_torch.utils.errors import ConfigError, XmtpuError


def _bucket_key(cfg: PipelineConfig, frame_ms: float, geom) -> tuple:
    """The pool-compatibility key: two sessions may share a pool if
    their configs build the same step and their tracks' native rates
    and channel counts (``geom``) match (``join`` checks the latter for
    real). Effects key by content (an IR file by path, size and mtime).
    Track urls key by their aliasing pattern (which positions share a
    url), not their values: the step never reads a url, so clients with
    the same pipeline and each their own file share a pool, and
    positions that share a url stay shared when :meth:`PoolServer.open`
    re-keys a joiner's audio by the pool's own urls."""
    from xmtpu_torch.graph import fx as _fx

    alias: dict = {}
    tracks = tuple(
        (alias.setdefault(t.url, i), t.kind, t.volume, t.start_time_ms,
         t.end_time_ms, t.fade_in_ms, t.fade_out_ms, t.loop, t.side_duck)
        for i, t in enumerate(cfg.tracks))
    return (cfg.sample_rate, cfg.channels, cfg.normalize,
            cfg.normalize_target_db, float(frame_ms), tracks,
            _fx._chain_key(cfg.sample_rate, list(cfg.effects)),
            _fx._chain_key(cfg.sample_rate, list(cfg.master_effects)),
            tuple(geom))


@dataclasses.dataclass
class _Served:
    pool: object
    slot: int
    key: tuple
    frames: list  # buffered (frame_out, ch) arrays, oldest first


class PoolServer:
    """Many concurrent sessions of many configs in one process.

    ``n_slots``: the capacity of each pool (a bucket grows by whole
    pools). ``max_seconds``: the floor of every pool's source capacity
    (a pool holds at least the longer of this and its first session's
    sources). ``max_buffer_frames``: the unread-frame cap a session (see
    the module docstring). ``duck_params`` and ``output_dtype`` apply to
    every pool. ``device``: where the pools run, ``cuda`` unless given
    (:class:`DeviceError` without a card). ``mesh``/``mesh_axis``: every
    pool shards its slots over the mesh's axis ``mesh_axis``
    (``n_slots`` must divide evenly; checked here, not at the first
    :meth:`open`; see :class:`~xmtpu_torch.graph.pool.SessionPool`).

    THREAD SAFETY: every public method holds one internal lock, as
    :class:`SessionPool`'s do; a pool's source upload in :meth:`open`
    runs outside it.
    """

    def __init__(self, n_slots: int = 32, frame_ms: float = 20.0,
                 max_seconds: float | None = None,
                 output_dtype=np.int16, duck_params: dict | None = None,
                 max_buffer_frames: int = 1024,
                 mesh=None, mesh_axis: str = "dp", device=None):
        if n_slots < 1:
            raise ConfigError("n_slots must be >= 1")
        if max_buffer_frames < 1:
            raise ConfigError("max_buffer_frames must be >= 1")
        # fail here, not at the first open(), where every open would
        # found yet another bad pool
        self.device = mesh_devices(mesh, mesh_axis, int(n_slots), device)[0]
        # what every pool is given: the mesh names the devices when set
        self._pool_kw = dict(mesh=mesh, mesh_axis=mesh_axis,
                             device=self.device if mesh is None else device)
        self.n_slots = int(n_slots)
        self.frame_ms = float(frame_ms)
        self.max_seconds = max_seconds
        self.output_dtype = output_dtype
        self.duck_params = duck_params
        self.max_buffer_frames = int(max_buffer_frames)
        self._lock = threading.RLock()
        self._buckets: dict[tuple, list] = {}  # key -> [SessionPool, ...]
        # id(pool) -> {slot: sid}; sid None = reserved by an open() in
        # flight. Also the pool -> sessions index of pump.
        self._alloc: dict[int, dict[int, int | None]] = {}
        self._sessions: dict[int, _Served] = {}
        self._next_sid = 0

    # -- session lifecycle ---------------------------------------------------

    def open(self, config, sources=None) -> int:
        """Start a session -> its id. ``config``: dict or
        :class:`PipelineConfig` (each session brings its own).
        ``sources``: name -> pcm | (pcm, sr) overriding track urls. Each
        distinct url is decoded once; the audio lives on the device for
        the life of the session."""
        from xmtpu_torch.graph import pool as _pool
        from xmtpu_torch.graph.pipeline import resolve_source

        if isinstance(config, dict):
            config = config_from_dict(config)
        if not isinstance(config, PipelineConfig):
            raise ConfigError("config must be PipelineConfig or dict")
        if not config.tracks:
            raise ConfigError("config has no tracks to serve")
        by_url: dict = {}
        resolved = []
        for i, t in enumerate(config.tracks):
            if t.url not in by_url:
                by_url[t.url] = resolve_source(t, sources,
                                               config.sample_rate, i)
            resolved.append(by_url[t.url])
        geom = tuple((int(sr), 1 if np.ndim(pcm) == 1
                      else int(np.shape(pcm)[1])) for pcm, sr in resolved)
        key = _bucket_key(config, self.frame_ms, geom)

        # The upload (a join, or a new pool) runs outside the server
        # lock, so reads of other pools never wait for an open(): the
        # slot is reserved (sid None) under the lock, the upload holds
        # the pool's own lock, and the session registers (or the
        # reservation rolls back) under the lock.
        tried: set[int] = set()
        while True:
            with self._lock:
                cand = None
                for p in self._buckets.get(key, ()):
                    if id(p) in tried:
                        continue
                    occupied = self._alloc[id(p)]
                    free = [i for i in range(p.n_slots) if i not in occupied]
                    if free:
                        occupied[free[0]] = None  # reserve
                        cand = (p, free[0])
                        break
            if cand is None:
                break
            p, slot = cand
            # the pool resolves joins by its own first config's urls:
            # re-key this session's decoded audio by position
            srcdict = {pt.url: (pcm, int(sr))
                       for pt, (pcm, sr) in zip(p.config.tracks, resolved)}
            try:
                p.join(slot, srcdict)
            except ConfigError:
                # refused before any change (geometry, or a clip past
                # this pool's capacity): try the next pool or a new one
                with self._lock:
                    self._alloc[id(p)].pop(slot, None)
                tried.add(id(p))
                continue
            except BaseException:
                # no reservation may outlive a failed upload
                with self._lock:
                    self._alloc[id(p)].pop(slot, None)
                raise
            with self._lock:
                # a pump may have advanced the pool between the join and
                # here: the client starts at 0
                p.seek(slot, 0.0)
                return self._register(p, slot, key)
        # no pool to join: a new one, registered only once it exists
        srcdict = {t.url: (pcm, int(sr))
                   for t, (pcm, sr) in zip(config.tracks, resolved)}
        pool = _pool.SessionPool(
            config, self.n_slots, frame_ms=self.frame_ms, sources=[srcdict],
            output_dtype=self.output_dtype, duck_params=self.duck_params,
            max_seconds=self.max_seconds, **self._pool_kw)
        with self._lock:
            self._buckets.setdefault(key, []).append(pool)
            self._alloc[id(pool)] = {}
            return self._register(pool, 0, key)

    def _register(self, pool, slot: int, key: tuple) -> int:
        """Bind a joined slot to a fresh session id (lock held)."""
        sid = self._next_sid
        self._next_sid += 1
        self._alloc[id(pool)][slot] = sid
        self._sessions[sid] = _Served(pool, slot, key, [])
        return sid

    def close(self, sid: int) -> None:
        """End a session: its slot outputs silence and is free for the
        next :meth:`open`; buffered frames are dropped."""
        with self._lock:
            s = self._sessions.pop(self._check(sid))
            s.pool.leave(s.slot)
            self._alloc[id(s.pool)].pop(s.slot, None)

    def seek(self, sid: int, ms: float) -> None:
        """Reposition one session (frame-aligned, state reset); frames
        buffered before the seek are dropped."""
        with self._lock:
            s = self._sessions[self._check(sid)]
            s.pool.seek(s.slot, float(ms))
            s.frames.clear()

    def _check(self, sid: int) -> int:
        if sid not in self._sessions:
            raise XmtpuError(f"unknown session id {sid}")
        return sid

    # -- reading -------------------------------------------------------------

    def _plan_pool(self, pool, k: int) -> list:
        """[(session, frames to keep)] for advancing ``pool`` k frames
        (frames past a session's end are not its stream). Raises the
        laggard refusal, naming the session, before any device work."""
        plan = []
        for sid in self._alloc[id(pool)].values():
            if sid is None:  # reserved by an open() in flight
                continue
            s = self._sessions[sid]
            rem = pool.frames_remaining(s.slot)
            take = k if rem is None else min(k, rem)
            if take == 0:
                continue
            if len(s.frames) + take > self.max_buffer_frames:
                raise XmtpuError(
                    f"cannot advance pool: co-resident session {sid} "
                    f"has {len(s.frames)} unread frames "
                    f"(max_buffer_frames={self.max_buffer_frames}) — "
                    f"read or close it first")
            plan.append((s, take))
        return plan

    def _pump_pool(self, pool, k: int, plan: list) -> None:
        """Advance ``pool`` k frames and buffer per ``plan``; nothing
        (no dispatch, no fetch) when nothing would buffer."""
        if not plan:
            return
        out = pool.read(k)  # (K, k*frame, ch)
        f = pool.frame_out
        for s, take in plan:
            # a copy of the session's row: views into ``out`` would keep
            # the whole group alive while one laggard holds one frame
            row = np.array(out[s.slot])
            s.frames.extend(row[i * f:(i + 1) * f] for i in range(take))

    def read(self, sid: int, k: int = 1) -> np.ndarray | None:
        """The next ``k`` frames of one session as (<= k*frame, ch) PCM:
        fewer only at the end of the stream, None once it has ended.
        Needing frames pumps the owning pool for all its sessions, by
        group sizes that are powers of two (the floor of the shortfall),
        the JAX package's ladder: at most log2(k) + 1 dispatches a
        read."""
        if k < 1:
            raise ConfigError("read(sid, k) needs k >= 1")
        if k > self.max_buffer_frames:
            raise ConfigError(
                f"read(sid, k={k}) exceeds max_buffer_frames="
                f"{self.max_buffer_frames} (the requester's own frames "
                "must fit the buffer); raise it at construction")
        with self._lock:
            s = self._sessions[self._check(sid)]
            while len(s.frames) < k:
                rem = s.pool.frames_remaining(s.slot)
                if rem == 0:
                    break  # the end: return the short tail, or None
                need = k - len(s.frames)
                if rem is not None:
                    need = min(need, rem)
                step = 1 << (need.bit_length() - 1)  # power-of-two floor
                self._pump_pool(s.pool, step, self._plan_pool(s.pool, step))
            if not s.frames:
                return None
            take, s.frames = s.frames[:k], s.frames[k:]
            return np.concatenate(take, axis=0)

    def pump(self, k: int = 1) -> dict[int, np.ndarray]:
        """Advance every pool k frames, then drain: {sid: every buffered
        frame} for each session with audio ready. A pool whose advance
        would overflow a laggard's buffer is skipped this call (its
        backlog still drains, which unblocks it); every pool is primed
        before any is fetched, so their device work overlaps."""
        if k < 1:
            raise ConfigError("pump(k) needs k >= 1")
        if k > self.max_buffer_frames:
            raise ConfigError(
                f"pump(k={k}) exceeds max_buffer_frames="
                f"{self.max_buffer_frames}; raise it at construction")
        with self._lock:
            plans = []
            for pools in self._buckets.values():
                for pool in pools:
                    try:
                        plan = self._plan_pool(pool, k)
                    except XmtpuError:
                        continue  # a laggard: skip this pool only
                    if plan:
                        plans.append((pool, plan))
            for pool, _ in plans:
                pool.prime(k)
            for pool, plan in plans:
                self._pump_pool(pool, k, plan)
            out = {}
            for sid, s in self._sessions.items():
                if s.frames:
                    out[sid] = np.concatenate(s.frames, axis=0)
                    s.frames = []
            return out

    # -- introspection and maintenance ---------------------------------------

    def at_end(self, sid: int) -> bool:
        """True once ``sid`` has no frames left, buffered or to come."""
        with self._lock:
            s = self._sessions[self._check(sid)]
            return not s.frames and s.pool.at_end(s.slot)

    def stats(self) -> dict:
        """Bucket, pool, slot and session counts, and each session's
        unread frames."""
        with self._lock:
            return {
                "buckets": len(self._buckets),
                "pools": sum(len(v) for v in self._buckets.values()),
                "slots": sum(p.n_slots for v in self._buckets.values()
                             for p in v),
                "sessions": len(self._sessions),
                "buffered_frames": {sid: len(s.frames)
                                    for sid, s in self._sessions.items()},
            }

    def release_idle_pools(self) -> int:
        """Drop pools with no open session (freeing their device
        buffers) -> how many."""
        with self._lock:
            n = 0
            for key, pools in list(self._buckets.items()):
                keep = []
                for p in pools:
                    if self._alloc[id(p)]:
                        keep.append(p)
                    else:
                        del self._alloc[id(p)]
                        n += 1
                if keep:
                    self._buckets[key] = keep
                else:
                    del self._buckets[key]
            return n
