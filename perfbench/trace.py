"""Reading a ``torch.profiler`` Chrome trace of the traced window.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. Each is tied by its ``correlation`` id to the
runtime or driver call that launched it, and so to the
``record_function`` ranges (``user_annotation`` events) open on that
host thread at the launch: the program's ``xmtpu_torch.<stage>`` ranges
and the harness's ``perfbench.*`` ones. The window is the harness's
``perfbench.traced_window`` range, which ends after the last batch's
completion was seen on the host.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass

WINDOW = "perfbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"
NAMED = ("xmtpu_torch.", "perfbench.")


@dataclass(frozen=True)
class DeviceOp:
    name: str
    cat: str
    ts: float  # us, device start
    dur: float  # us
    stack: tuple  # range names open at the launch, outermost first

    def under(self, *names: str) -> bool:
        return any(n in self.stack for n in names)


class _Ranges:
    """The ranges of one host thread, for containment queries."""

    def __init__(self, ranges):
        self.r = sorted(ranges, key=lambda e: (e[0], -e[1]))
        self.starts = [s for s, _, _ in self.r]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.r):
            while stack and self.r[stack[-1]][1] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, ts: float) -> int:
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            s, e, _ = self.r[i]
            if s <= ts <= e:
                return i
            i = self.parent[i]
        return -1

    def stack(self, ts: float) -> tuple:
        names, i = [], self.innermost(ts)
        while i >= 0:
            names.append(self.r[i][2])
            i = self.parent[i]
        return tuple(reversed(names))


class TraceView:
    def __init__(self, events: list):
        by_thread: dict = {}
        launches: dict = {}
        device = []
        window = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            key = (ev.get("pid"), ev.get("tid"))
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            if cat == RANGE_CAT:
                by_thread.setdefault(key, []).append((ts, ts + dur, ev["name"]))
                if ev["name"] == WINDOW:
                    window = (ts, ts + dur, key)
            elif cat in LAUNCH_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, key)
            elif cat in DEVICE_CATS:
                device.append(ev)
        if window is None:
            raise ValueError(f"the trace has no {WINDOW} range")
        self.t0, self.t1, self.host = window
        self.window_s = (self.t1 - self.t0) / 1e6
        self._threads = {k: _Ranges(v) for k, v in by_thread.items()}
        self.ops = []
        for ev in device:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            launch = launches.get((ev.get("args") or {}).get("correlation"))
            if launch is not None:
                lts, key = launch
                inside = self.t0 <= lts <= self.t1
                ranges = self._threads.get(key)
                stack = ranges.stack(lts) if ranges else ()
            else:
                inside = self.t0 <= ts <= self.t1
                stack = ()
            if inside:
                self.ops.append(DeviceOp(ev.get("name", "?"), ev["cat"], ts,
                                         dur, stack))
        self.ops.sort(key=lambda o: o.ts)

    @classmethod
    def from_file(cls, path) -> "TraceView":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def busy_intervals(self) -> list:
        """Union of the device operations' intervals, clipped to the
        window (us)."""
        merged = []
        for o in self.ops:
            s, e = max(o.ts, self.t0), min(o.ts + o.dur, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        """Idle intervals of the device inside the window (us)."""
        out, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_range_at(self, ts: float) -> str:
        """The innermost program or harness range open on the window's
        host thread at ``ts``."""
        ranges = self._threads.get(self.host)
        for name in reversed(ranges.stack(ts) if ranges else ()):
            if name.startswith(NAMED):
                return name
        return "(no range)"

    def device_time_s(self, ops) -> float:
        return sum(o.dur for o in ops) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = {}
        for o in self.ops:
            by_op[o.name] = by_op.get(o.name, 0.0) + o.dur / 1e6
        by_gap: dict = {}
        for s, e in self.gaps():
            name = self.host_range_at(s)
            by_gap[name] = by_gap.get(name, 0.0) + (e - s) / 1e6
        return {k: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
                for k, d in (("device_ops", by_op), ("idle_gaps", by_gap))}
