"""One run of one cell: set-up, the measured window, the traced slice,
the correctness check, and the result line.

Everything is found by name from ``BENCHMARK.json``: the workload names
its configuration (``perfbench/configs/<config>.json``, whose ``entry``
and ``reference`` name ``perfbench/entries/<entry>.py`` and
``perfbench/reference/<reference>.py``) and its traffic
(``perfbench/traffic/<traffic>.json``); each end-to-end metric is
``perfbench/end_to_end/<name>.py`` and each per-layer metric
``perfbench/layer_metrics/<name>.py``. A cell, a mix or a metric is
added by adding files and entries; nothing here lists them.

The window is a closed loop of one caller: the entry is called for
batch i+1 before the host waits on batch i's completion event, so
``in_flight`` batches are queued on the device; the inputs cycle through
a ring of distinct batches made on the device from the seed. Issuing
stops when ``seconds`` have passed; the window ends when the last
issued batch is seen complete, and every issued batch counts.

The check: for each slot of the ring, one of its batches in the window
is drawn from the seed, and ``check_rows_per_slot`` of its rows (see
``check_rows``) are recomputed by the float64 reference once the window
has closed and the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from perfbench import compare
from perfbench import inputs as gen

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "xmtpu")
CACHE = PKG / ".cache"


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"perfbench.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``xmtpu_torch`` is not ``xmtpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, name: str, spec: dict | None = None,
                 overrides: dict | None = None):
        spec = spec if spec is not None else json.loads(
            (ROOT / "BENCHMARK.json").read_text())
        wl = {w["name"]: w for w in spec["workloads"]}
        if name not in wl:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(wl)}")
        self.name = name
        self.workload = wl[name]
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        over = overrides or {}
        self.config = _merge(json.loads((ROOT / cfg["file"]).read_text()),
                             over.get("config", {}))
        self.traffic = _merge(json.loads(
            (PKG / "traffic" / f"{self.workload['traffic']}.json").read_text()),
            over.get("traffic", {}))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]


class SlotSample:
    """One output for each slot of the ring, drawn uniformly from that
    slot's batches of the window (a reservoir of one a slot, seeded)."""

    def __init__(self, ring: int, seed: int):
        self.rngs = [random.Random(f"{seed}:{s}") for s in range(ring)]
        self.seen = [0] * ring
        self.kept = [None] * ring

    def offer(self, item) -> None:
        s = item[0]
        self.seen[s] += 1
        if self.rngs[s].randrange(self.seen[s]) == 0:
            self.kept[s] = item

    @property
    def items(self) -> list:
        return [it for it in self.kept if it is not None]


def check_rows(traffic: dict, seed: int) -> list:
    """For each slot of the ring, the rows (clips) of its sampled batch
    that the reference recomputes: ``check_rows_per_slot`` of them. The
    slots take consecutive runs of one permutation of the rows, drawn
    from the seed, so where ring x rows reaches the batch every row
    index is checked in some slot."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    B = int(traffic["clips_per_batch"])
    k = min(B, int(traffic["check_rows_per_slot"]))
    perm = rng.permutation(B)
    return [np.sort(perm[(np.arange(k) + s * k) % B])
            for s in range(int(traffic["ring"]))]


@dataclass
class Window:
    seconds: float = 0.0
    batches: int = 0
    latencies_s: list = field(default_factory=list)
    audio_s_per_batch: float = 0.0
    setup_s: float = 0.0


def _range(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def closed_loop(entry, ring: list, in_flight: int, *, seconds=None,
                batches=None, sample: SlotSample | None = None,
                marks: bool = False) -> Window:
    """Call ``entry`` on the ring's batches, ``in_flight`` queued, until
    ``seconds`` have passed or ``batches`` were issued; wait for all."""
    import torch

    cuda = next(iter(ring[0].values())).is_cuda
    w = Window()
    q: deque = deque()

    def retire():
        t_call, ev, out, slot = q.popleft()
        if ev is not None:
            with _range("perfbench.wait", marks):
                ev.synchronize()
        w.latencies_s.append(time.perf_counter() - t_call)
        if sample is not None:
            sample.offer((slot, out))

    i = 0
    t0 = time.perf_counter()
    stop = None if seconds is None else t0 + seconds
    while ((batches is None or i < batches)
           and (stop is None or time.perf_counter() < stop)):
        slot = i % len(ring)
        t_call = time.perf_counter()
        with _range("perfbench.batch", marks):
            out = entry(ring[slot])
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        q.append((t_call, ev, out, slot))
        i += 1
        while len(q) >= in_flight:
            retire()
    while q:
        retire()
    w.seconds = time.perf_counter() - t0
    w.batches = i
    return w


def _traced_slice(entry, ring, in_flight: int, batches: int, workdir: str):
    """A short closed loop under ``torch.profiler``; -> TraceView."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import WINDOW, TraceView

    acts = [ProfilerActivity.CPU]
    if next(iter(ring[0].values())).is_cuda:
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(workdir, "trace.json")
    with profile(activities=acts) as prof:
        closed_loop(entry, ring, in_flight, batches=in_flight + 2, marks=True)
        with torch.profiler.record_function(WINDOW):
            closed_loop(entry, ring, in_flight, batches=batches, marks=True)
    prof.export_chrome_trace(path)
    view = TraceView.from_file(path)
    os.remove(path)
    return view


@dataclass
class LayerContext:
    """What a per-layer reader gets: the traced window, the batches in
    it, the stages' shapes (from the reference), the card's peaks."""
    trace: object
    batches: int
    stages: dict
    peaks: dict | None


def _power_limit_w():
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             start: float | None = None, device=None,
             overrides: dict | None = None, wrap=None, log=None) -> dict:
    """One run of cell ``name``; -> the result dict with ``checks`` last.
    ``device``: where the program runs (None = the card). ``wrap``: a
    function applied to the entry (tests plant faults with it)."""
    start = time.perf_counter() if start is None else start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = Cell(name, overrides=overrides)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    phases = [("start", start)]

    def mark(what):
        phases.append((what, time.perf_counter()))

    import torch

    mark("interpreter and imports")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    if cuda:
        from xmtpu_torch.kernels import _build

        torch.cuda.init()
        mark("CUDA context")
        _build.load()
        mark(f"kernels ({_build.library_path().parent.name})")
    traffic, config = cell.traffic, cell.config
    entry = load_module("entries", config["entry"]).build(config, traffic, dev)
    if wrap is not None:
        entry = wrap(entry)
    mark("entry")
    ring = gen.make_ring(traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    mark("ring")
    in_flight = int(traffic["in_flight"])
    closed_loop(entry, ring, in_flight, batches=int(traffic["warmup_batches"]))
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    mark("warm-up")
    setup_s = time.perf_counter() - start
    log("perfbench: set-up " + ", ".join(
        f"{what} {t - t_prev:.3f} s" for (_, t_prev), (what, t)
        in zip(phases, phases[1:])))
    sample = SlotSample(len(ring), seed)
    win = closed_loop(entry, ring, in_flight, seconds=seconds, sample=sample)
    win.setup_s = setup_s
    win.audio_s_per_batch = gen.audio_seconds(traffic)
    used = [i for i in range(torch.cuda.device_count())
            if torch.cuda.max_memory_allocated(i) > 0] if cuda else []
    peak = max((int(torch.cuda.max_memory_allocated(i)) for i in used),
               default=0)
    kind = torch.cuda.get_device_name(dev) if cuda else str(dev)
    reference = load_module("reference", config["reference"])
    metrics: dict = {}
    traced: dict = {}
    device_info = {"platform": "gpu" if cuda else dev.type, "kind": kind,
                   "count": len(used) if cuda else 1,
                   "memory_peak_bytes": peak}
    if trace:
        from perfbench import roofline

        workdir = tempfile.mkdtemp(prefix="perfbench_")
        try:
            view = _traced_slice(entry, ring, in_flight,
                                 int(traffic["trace_batches"]), workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        ctx = LayerContext(view, int(traffic["trace_batches"]),
                           reference.stages(config, traffic),
                           roofline.peaks_for(kind))
        for m in cell.per_layer:
            v = load_module("layer_metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        traced["breakdown"] = view.breakdown()
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
    else:
        for m in cell.end_to_end:
            v = load_module("end_to_end", m["name"]).value(win)
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the sampled rows of the program's outputs and of the inputs they
    # came from, to the host; then the program's state goes before the
    # reference runs
    rows = check_rows(traffic, seed)
    checked, host_in = [], {}
    for slot, out in sample.items:
        idx = torch.as_tensor(rows[slot], device=out.device)
        checked.append((slot, out.index_select(0, idx).cpu().numpy()))
        host_in[slot] = {k: v.index_select(0, idx.to(v.device)).cpu().numpy()
                         for k, v in ring[slot].items()}
    del entry, ring, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    limit = float(config["limit_db"])
    dbs = [compare.worst_row_db(out, reference_rows(reference, config,
                                                    host_in[s]))
           for s, out in checked]
    worst = max(dbs)
    log(f"perfbench: reference over {sum(len(o) for _, o in checked)} rows "
        f"of {len(checked)} batch(es) in {time.perf_counter() - t:.2f} s")
    if cuda:
        device_info["power_limit_w"] = _power_limit_w()
    return {"correct": bool(np.isfinite(worst) and worst <= limit),
            "attempted": win.batches, "failed": sum(d > limit for d in dbs),
            "metrics": metrics, "device": device_info, **traced,
            "checks": {"worst_row_db": {
                "value": max(worst, compare.FLOOR_DB) if np.isfinite(worst)
                else None, "limit": limit}}}


def reference_rows(reference, config: dict, inputs: dict,
                   precision: str = "float64") -> np.ndarray:
    """The reference over a batch, its clips split into blocks that run
    on the host's cores at once (every stage is row by row; numpy and
    scipy release the interpreter's lock inside them)."""
    from concurrent.futures import ThreadPoolExecutor

    rows = len(next(iter(inputs.values())))
    n = max(1, min(8, os.cpu_count() or 1, rows))
    cuts = np.linspace(0, rows, n + 1).astype(int)
    parts = [{k: v[a:b] for k, v in inputs.items()}
             for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    with ThreadPoolExecutor(len(parts)) as pool:
        outs = list(pool.map(lambda x: reference.run(config, x, precision),
                             parts))
    return np.concatenate(outs, axis=0)


def check_lines(result: dict) -> list:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in result["checks"].items()]


def cli(args, start: float) -> int:
    import torch

    cell = Cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this host has {have}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      start=start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
