"""File-batch runner: many clips through the ragged flagship step on one
GPU (counterpart of ``xmtpu.runner``; BASELINE config 4's "256 podcast
clips").

* **bucketing by (native rate, length)**: clips group by their native
  sample rate and pad to geometric length edges (ratio 1.25), so a step
  serves one rate and a chunk holds clips of similar length;
* **failure isolation**: a clip that fails to decode, or an output that
  fails to write, is reported alone; a chunk whose step fails fails its
  own clips. A broken kernel build or a missing card
  (:class:`KernelBuildError`, :class:`DeviceError`) fails the run
  instead: it is not a fault of the clips;
* **resume**: a done-marker (``<out>.done``) is written per clip, and a
  re-run skips clips already marked;
* **metrics**: clips, audio-seconds, wall seconds, realtime factor and
  the card's peak memory, in :class:`BatchReport` (JSON-dumpable).

The step is ``xmtpu_torch.batch.make_batch_step`` on the run's device:
``cuda`` unless ``device=`` names another, ``device="cpu"`` running the
kernels' plain twins. Steps are cached per (rate, bus rate, step
keywords, device) for the process.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from xmtpu_torch.io import open_audio
from xmtpu_torch.io.wav import write_wav
from xmtpu_torch.utils.device import check_interpret, resolve_device
from xmtpu_torch.utils.errors import (ConfigError, DeviceError,
                                      KernelBuildError, XmtpuError)

log = logging.getLogger("xmtpu_torch.runner")

_BUCKET_RATIO = 1.25
# errors that are the run's, not a clip's: they propagate
_FATAL = (KernelBuildError, DeviceError)


@dataclass
class ClipJob:
    """One clip: voice (path or (pcm, sr)), optional bgm, output path."""

    voice: object
    out: str
    bgm: object = None


@dataclass
class BatchReport:
    total: int = 0
    done: int = 0
    skipped_resume: int = 0
    failed: list = field(default_factory=list)  # (out_path, error str)
    audio_sec: float = 0.0
    wall_sec: float = 0.0
    buckets: int = 0
    peak_hbm_bytes: int | None = None  # the card's peak allocated bytes
    # in the run (its HBM3); None on the CPU

    @property
    def realtime_factor(self) -> float:
        return self.audio_sec / self.wall_sec if self.wall_sec > 0 else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "total": self.total,
                "done": self.done,
                "skipped_resume": self.skipped_resume,
                "failed": self.failed,
                "audio_sec": round(self.audio_sec, 3),
                "wall_sec": round(self.wall_sec, 3),
                "realtime_factor": round(self.realtime_factor, 1),
                "buckets": self.buckets,
                "peak_hbm_bytes": self.peak_hbm_bytes,
            }
        )


def _bucket_edge(n: int, base: int = 16384) -> int:
    """Smallest geometric bucket edge >= n (ratio 1.25, floor ``base``)."""
    e = base
    while e < n:
        e = int(math.ceil(e * _BUCKET_RATIO))
    return e


def _load_mono_i16(src, sr_default: int):
    """Decode to mono int16 on the host -> (pcm, native_rate). Every
    sample format downmixes by the channel mean."""
    if isinstance(src, tuple):
        pcm, sr = src
    elif isinstance(src, np.ndarray):
        pcm, sr = src, sr_default
    else:
        with open_audio(src) as d:
            pcm, sr = d.read_all(), d.sample_rate
    pcm = np.asarray(pcm)
    if pcm.ndim > 1:
        if pcm.dtype == np.int16:
            pcm = np.round(pcm.astype(np.float64).mean(axis=1)).astype(
                np.int16)
        else:
            pcm = pcm.mean(axis=1)
    if pcm.dtype != np.int16:
        from xmtpu_torch.ops.convert import f32_to_pcm16_np

        pcm = f32_to_pcm16_np(pcm.astype(np.float32))
    return pcm, int(sr)


def _decode_job(job: ClipJob, sr_in: int, sr_bus: int):
    """Decode and validate one job -> (voice_i16, bgm_i16 or None, rate).
    Raises on any per-clip failure (the caller isolates it)."""
    from xmtpu_torch.ops.convert import f32_to_pcm16_np, pcm16_to_f32_np
    from xmtpu_torch.ops.resample import check_rates, resample_oracle_np

    v, v_sr = _load_mono_i16(job.voice, sr_in)
    b = None
    if job.bgm is not None:
        b, b_sr = _load_mono_i16(job.bgm, sr_in)
        if b_sr != v_sr:  # align the bgm to the voice's rate on the host
            b = f32_to_pcm16_np(resample_oracle_np(
                pcm16_to_f32_np(b).astype(np.float64), b_sr, v_sr
            ).astype(np.float32))
    if len(v) == 0:
        raise XmtpuError("empty clip")
    check_rates(v_sr, sr_bus)  # per clip: a weird header fails one clip
    return v, b, v_sr


def _check_jobs(jobs, resume: bool, report: BatchReport) -> list:
    """The manifest as ClipJobs, the resumed ones counted and dropped.
    A malformed manifest fails the run with :class:`ConfigError`."""
    todo = []
    for job in jobs:
        if not isinstance(job, ClipJob):
            if not isinstance(job, dict) or not {"voice", "out"} <= set(job):
                raise ConfigError(
                    f"manifest entry needs 'voice' and 'out' (and "
                    f"optional 'bgm'): {job!r}")
            unknown = set(job) - {"voice", "bgm", "out"}
            if unknown:
                raise ConfigError(
                    f"manifest entry has unknown key(s) {sorted(unknown)}: "
                    f"{job!r}")
            job = ClipJob(**job)
        if not isinstance(job.out, (str, os.PathLike)):
            raise ConfigError(
                f"manifest 'out' must be a path, got "
                f"{type(job.out).__name__}: {job!r}")
        if not isinstance(job.out, str):
            job = dataclasses.replace(job, out=os.fspath(job.out))
        if resume and os.path.exists(job.out + ".done"):
            report.skipped_resume += 1
            continue
        todo.append(job)
    return todo


def run_batch(
    jobs,
    sr_in: int = 44100,
    sr_bus: int = 16000,
    batch_size: int = 64,
    resume: bool = True,
    step_kw: dict | None = None,
    write_done_markers: bool = True,
    pipeline: bool = True,
    decode_threads: int = 1,
    device=None,
) -> BatchReport:
    """Run clips through the ragged flagship step on ``device`` (None =
    ``cuda``; :class:`DeviceError` without a card, raised before any
    decode; ``device="cpu"`` runs the kernels' plain twins).

    Clips bucket by (native rate, length edge); mixed-rate manifests
    are fine. ``sr_in`` is only the assumed rate of bare-array inputs
    (files carry their own). A clip whose rate gives an unreasonable
    polyphase ratio fails alone, and a chunk whose step fails fails its
    own clips. ``step_kw`` goes to ``make_batch_step``; its
    ``interpret=True`` (the JAX package's Pallas interpret mode) means
    the twins and is refused with :class:`ConfigError` off the CPU.

    ``pipeline=True`` (default) runs three host stages at once: a
    decode thread streams clips through the native SPSC ring
    (:class:`xmtpu_torch.native.PcmChannel`) while the calling thread
    packs chunks and launches steps (asynchronously on the card), and a
    writer thread fetches results and writes WAVs. ``pipeline=False``
    keeps the serial decode-all -> step -> write order (same bytes).

    ``decode_threads`` (pipelined only): decode up to N clips at once;
    results enter the ring in manifest order whichever thread finishes
    first, so chunks, and the output bytes, are those of 1.
    """
    if decode_threads < 1:
        raise ConfigError(f"decode_threads must be >= 1, got {decode_threads}")
    from xmtpu_torch.ops.resample import check_rates

    # whole-run rates fail the run, typed, before any decode
    check_rates(sr_in, sr_bus)
    dev = resolve_device(device)
    step_kw = dict(step_kw or {})
    check_interpret(step_kw.get("interpret"), dev)
    if isinstance(jobs, (str, bytes, dict)):
        raise ConfigError(
            f"jobs must be a list of {{voice, bgm?, out}} entries, got "
            f"{type(jobs).__name__}")
    jobs = list(jobs)  # any iterable (generator, deque, ...)
    report = BatchReport(total=len(jobs))
    t_start = time.perf_counter()
    todo = _check_jobs(jobs, resume, report)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    disp = _Dispatcher(sr_bus, step_kw, dev)
    if pipeline:
        _run_batch_pipelined(todo, report, sr_in, sr_bus, batch_size, disp,
                             write_done_markers, decode_threads)
    else:
        _run_batch_serial(todo, report, sr_in, sr_bus, batch_size, disp,
                          write_done_markers)
    missing = report.total - (report.done + len(report.failed)
                              + report.skipped_resume)
    if missing > 0:
        # every job ends done, failed or skipped: a stage crash that
        # dropped jobs must not read as success
        report.failed.append((
            "<unaccounted>",
            f"{missing} job(s) were dropped by a pipeline-stage failure"))
    report.wall_sec = time.perf_counter() - t_start
    if dev.type == "cuda":
        report.peak_hbm_bytes = int(torch.cuda.max_memory_allocated(dev))
    log.info("batch: %s", report.to_json())
    return report


def _freeze_kw(kw) -> tuple:
    """Hashable cache key of step keywords (lists of band dicts are
    legal values)."""
    def fz(v):
        if isinstance(v, dict):
            return tuple(sorted((k, fz(x)) for k, x in v.items()))
        if isinstance(v, (list, tuple)):
            return tuple(fz(x) for x in v)
        return v
    return fz(dict(kw))


_STEP_CACHE: dict = {}  # repeat run_batch calls (a service processing
# manifests) reuse built steps and their device tables


class _Dispatcher:
    """The device side: the per-rate step cache and chunk dispatch."""

    def __init__(self, sr_bus: int, step_kw: dict, device: torch.device):
        self.sr_bus = sr_bus
        self.step_kw = step_kw
        self.device = device

    def step_for(self, rate: int):
        from xmtpu_torch import batch as tbatch

        key = (rate, self.sr_bus, _freeze_kw(self.step_kw), str(self.device))
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = tbatch.make_batch_step(
                sr_in=rate, sr_bus=self.sr_bus, device=self.device,
                **self.step_kw)
        return _STEP_CACHE[key]

    def dispatch(self, rate: int, edge: int, chunk):
        """Pack one chunk into fresh host arrays, upload them (pinned,
        ``non_blocking`` on a card) and launch the step without waiting
        for it. ``chunk``: a list of (job, voice, bgm). -> (lengths,
        the output on the device)."""
        from xmtpu_torch.graph.streaming import _upload

        B = len(chunk)
        voice = np.zeros((B, edge), np.int16)
        bgm = np.zeros((B, edge), np.int16)
        lengths = np.zeros((B,), np.int32)
        for r, (job, v, b) in enumerate(chunk):
            voice[r, : len(v)] = v
            lengths[r] = len(v)
            if b is not None and len(b) > 0:
                reps = -(-len(v) // len(b))
                bgm[r, : len(v)] = np.tile(b, reps)[: len(v)]
        step = self.step_for(rate)
        out_dev = step(_upload(voice, self.device), _upload(bgm, self.device),
                       _upload(lengths, self.device))
        return lengths, out_dev


def _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                 write_done_markers):
    """Write one finished chunk's WAVs and done markers (host side),
    isolating each job's failure: one bad output path must not abort the
    chunk or kill the writer thread."""
    g = math.gcd(rate, sr_bus)
    L, M = sr_bus // g, rate // g
    for r, (job, v, b) in enumerate(chunk):
        try:
            m = -(-(int(lengths[r]) * L) // M)
            write_wav(job.out, out[r, :m], sr_bus)
            if write_done_markers:
                with open(job.out + ".done", "w") as f:
                    f.write("ok\n")
        except Exception as e:
            log.warning("write failed for %s: %s", job.out, e)
            report.failed.append((job.out, f"write failed: {e}"))
            continue
        report.done += 1
        report.audio_sec += int(lengths[r]) / rate


def _fail_chunk(report, chunk, what: str, e) -> None:
    for (job, _, _) in chunk:
        report.failed.append((job.out, f"{what}: {e}"))


def _run_batch_serial(todo, report, sr_in, sr_bus, batch_size, disp,
                      write_done_markers):
    """Decode every clip, then step each chunk of each bucket and write."""
    pending = []
    for job in todo:
        try:
            v, b, rate = _decode_job(job, sr_in, sr_bus)
        except Exception as e:  # per-clip decode isolation
            log.warning("clip %s failed to decode: %s", job.out, e)
            report.failed.append((job.out, str(e)))
            continue
        pending.append((job, v, b, (rate, _bucket_edge(len(v)))))

    buckets: dict[tuple, list] = {}
    for (job, v, b, key) in pending:
        buckets.setdefault(key, []).append((job, v, b))
    report.buckets = len(buckets)

    for (rate, edge), items in sorted(buckets.items()):
        for i in range(0, len(items), batch_size):
            chunk = items[i: i + batch_size]
            try:
                lengths, out_dev = disp.dispatch(rate, edge, chunk)
                out = out_dev.cpu().numpy()
            except _FATAL:
                raise
            except Exception as e:
                log.warning("bucket (%s Hz, %s) chunk failed: %s",
                            rate, edge, e)
                _fail_chunk(report, chunk, "device step failed", e)
                continue
            _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                         write_done_markers)


def _run_batch_pipelined(todo, report, sr_in, sr_bus, batch_size, disp,
                         write_done_markers, decode_threads: int = 1):
    """Three concurrent host stages:

    decode thread --PcmChannel (SPSC ring)--> caller (pack + launch)
                                               --Queue--> writer thread

    The card runs chunk k while the decode thread prepares k+1 and the
    writer drains k-1: a step's launch returns before the card finishes,
    and the writer's ``.cpu()`` is the only blocking fetch. Buckets fill
    greedily and dispatch as soon as ``batch_size`` clips of one (rate,
    edge) arrive; stragglers flush at the end of the stream. Decode
    errors are caught in the decode thread, step errors at the launch or
    at the writer's fetch.
    """
    import queue as _queue
    import threading

    from xmtpu_torch.native import PcmChannel

    chan = PcmChannel()
    write_q: _queue.Queue = _queue.Queue(maxsize=4)  # bounds in-flight

    handled = [0]  # the prefix of `todo` that reached an outcome in
    # _emit: jobs are emitted strictly in manifest order

    def _emit(job, result):
        """Publish one decode result (a thunk) or a per-clip failure."""
        try:
            v, b, rate = result()
        except Exception as e:
            log.warning("clip %s failed to decode: %s", job.out, e)
            report.failed.append((job.out, str(e)))
            handled[0] += 1
            return
        chan.put([v, b], (job, rate))  # counted only after the publish:
        # a put failure leaves this job to the sweep below
        handled[0] += 1

    def producer():
        try:
            if decode_threads <= 1:
                for job in todo:
                    _emit(job, lambda j=job: _decode_job(j, sr_in, sr_bus))
                return
            # N decode workers, ONE publisher (this thread): results are
            # drained in submission order through a window of ~2N, so
            # the ring keeps a single producer and chunks match
            # decode_threads=1; the blocking put bounds the rest
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            pending: deque = deque()
            with ThreadPoolExecutor(
                    decode_threads,
                    thread_name_prefix="xmtpu_torch-decode") as ex:
                for job in todo:
                    pending.append(
                        (job, ex.submit(_decode_job, job, sr_in, sr_bus)))
                    if len(pending) > 2 * decode_threads:
                        j, fut = pending.popleft()
                        _emit(j, fut.result)
                while pending:
                    j, fut = pending.popleft()
                    _emit(j, fut.result)
        except Exception as e:  # a crash of the stage itself: every job
            # not yet handled is failed, never silently dropped
            log.warning("decode stage failed: %s", e)
            for job in todo[handled[0]:]:
                report.failed.append((job.out, f"decode stage failed: {e}"))
        finally:
            chan.close()

    def writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            chunk, lengths, out_dev, rate, edge = item
            try:
                out = out_dev.cpu().numpy()  # waits for the card
            except Exception as e:
                log.warning("bucket (%s Hz, %s) chunk failed: %s",
                            rate, edge, e)
                _fail_chunk(report, chunk, "device step failed", e)
                continue
            del out_dev  # the card's copy is free before the writes
            try:
                _write_chunk(report, chunk, lengths, out, rate, sr_bus,
                             write_done_markers)
            except Exception as e:
                # outside _write_chunk's per-job isolation: the writer
                # must not die and leave the caller blocked on the queue
                log.warning("bucket (%s Hz, %s) write stage failed: %s",
                            rate, edge, e)
                _fail_chunk(report, chunk, "write stage failed", e)

    # daemon threads: an exception escaping the orchestration below
    # (KeyboardInterrupt, a fatal error) never leaves a blocked helper
    # holding the interpreter open
    t_prod = threading.Thread(target=producer, name="xmtpu_torch-decode",
                              daemon=True)
    t_write = threading.Thread(target=writer, name="xmtpu_torch-write",
                               daemon=True)
    t_prod.start()
    t_write.start()

    buckets: dict[tuple, list] = {}
    seen_buckets: set = set()

    def flush(key, items):
        rate, edge = key
        try:
            lengths, out_dev = disp.dispatch(rate, edge, items)
        except _FATAL:
            raise
        except Exception as e:  # pack / build / launch error: fail chunk
            log.warning("bucket (%s Hz, %s) dispatch failed: %s",
                        rate, edge, e)
            _fail_chunk(report, items, "device step failed", e)
            return
        payload = (items, lengths, out_dev, rate, edge)
        while True:  # never block forever on a dead writer
            try:
                write_q.put(payload, timeout=1.0)
                return
            except _queue.Full:
                if not t_write.is_alive():
                    for (job, _, _) in items:
                        report.failed.append((job.out, "writer thread died"))
                    return

    ok = False
    try:
        while (item := chan.get()) is not None:
            (v, b), (job, rate) = item
            key = (rate, _bucket_edge(len(v)))
            seen_buckets.add(key)
            buckets.setdefault(key, []).append((job, v, b))
            if len(buckets[key]) >= batch_size:
                flush(key, buckets.pop(key))
        for key in sorted(buckets):  # end-of-stream stragglers
            flush(key, buckets[key])
        report.buckets = len(seen_buckets)
        t_prod.join()
        ok = True
    finally:
        if not ok:
            chan.close()  # a producer blocked on a full ring stops
        # always unblock the writer, without blocking forever on a
        # writer that died with the queue full
        while True:
            try:
                write_q.put(None, timeout=1.0)
                break
            except _queue.Full:
                if not t_write.is_alive():
                    break
        # success: wait for every chunk to land on disk; failure: a
        # bounded wait (the daemon flag guarantees exit)
        t_write.join(None if ok else 10.0)
