"""The roofline counts against the bounds the kernel table records
(roofline ms: bytes over 3.35 TB/s or operations over 67 TFLOP/s), and
the trace readers on a synthetic trace."""

import pytest

from perfbench import roofline
from perfbench.harness import LayerContext, load_module
from perfbench.trace import TraceView

H100 = roofline.peaks_for("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("counts,ms", [
    (roofline.fir_stage(256, 160000, 4093), 0.098),  # K1, podcast step
    (roofline.fir_stage(32, 480000, 24082), 0.0373),  # K1 long, config 3
    (roofline.limiter_stage(256, 1, 160000), 0.098),  # K2
])
def test_stage_bounds_match_the_kernel_table(counts, ms):
    t = 1e3 * roofline.least_seconds(*counts, H100)
    assert round(t, 4 if ms < 0.05 else 3) == ms
    n_bytes, n_ops = counts
    assert n_bytes / H100["bytes_per_s"] > n_ops / H100["f32_ops_per_s"]


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7, "args": args}


def _gpu(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 3, "args": {"correlation": corr}}


def synthetic():
    """Two batches of: a front kernel, a fused conv, a limiter kernel, a
    conversion outside every program range; device time 1 + 2 + 1 + 0.5
    per batch, idle 3 us between the two batches."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100)]
    corr = 0
    t_dev = 10.0
    for b in range(2):
        base = b * 40
        ev.append(_x("perfbench.batch", "user_annotation", base + 1, 30))
        for name, rng, dur in (("front", "xmtpu_torch.mixfirst", 1.0),
                               ("conv", "xmtpu_torch.eq+reverb", 2.0),
                               ("lim", "xmtpu_torch.limiter", 1.0),
                               ("cvt", None, 0.5)):
            corr += 1
            t = base + 2 + corr % 4 * 5
            if rng:
                ev.append(_x(rng, "user_annotation", t, 3))
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + 1, 1,
                         correlation=corr))
            ev.append(_gpu(name, t_dev, dur, corr))
            t_dev += dur
        ev.append(_x("perfbench.wait", "user_annotation", base + 32, 8))
        t_dev += 3.0
    ev.append(_gpu("outside", 200, 5, 999))  # launched after the window
    ev.append(_x("cudaLaunchKernel", "cuda_runtime", 150, 1, correlation=999))
    return TraceView(ev)


def test_trace_view_attributes_and_unions():
    t = synthetic()
    assert len(t.ops) == 8
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(9e-6)
    conv = [o for o in t.ops if o.name == "conv"]
    assert all(o.stack == ("perfbench.traced_window", "perfbench.batch",
                           "xmtpu_torch.eq+reverb") for o in conv)
    cvt = [o for o in t.ops if o.name == "cvt"]
    assert all(not any(r.startswith("xmtpu_torch.") for r in o.stack)
               for o in cvt)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "conv"
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(91e-6)


def test_readers_on_the_synthetic_trace():
    t = synthetic()
    stages = {"eq_reverb": {"rows": 1, "n": 1000, "taps": 10},
              "limiter": {"rows": 1, "channels": 1, "n": 1000}}
    ctx = LayerContext(t, 2, stages, H100)
    read = {n: load_module("layer_metrics", n).read(ctx) for n in (
        "device_idle_pct", "launches_per_batch", "front_ms",
        "eq_reverb_roofline", "limiter_roofline")}
    assert read["device_idle_pct"] == pytest.approx(91.0)
    assert read["launches_per_batch"] == 4
    assert read["front_ms"] == pytest.approx(1e-3)
    least = roofline.least_seconds(*roofline.fir_stage(1, 1000, 10), H100)
    assert read["eq_reverb_roofline"] == pytest.approx(100 * least / 2e-6)
    least = roofline.least_seconds(*roofline.limiter_stage(1, 1, 1000), H100)
    assert read["limiter_roofline"] == pytest.approx(100 * least / 1e-6)


def test_readers_find_nothing_and_say_nothing():
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100)]
    ctx = LayerContext(TraceView(ev), 2, {}, H100)
    for n in ("device_idle_pct", "launches_per_batch", "front_ms",
              "eq_reverb_roofline", "limiter_roofline"):
        assert load_module("layer_metrics", n).read(ctx) is None


def test_eq_reverb_falls_back_to_unranged_ops_without_the_range():
    """effects(): no eq+reverb range; the call's operations outside every
    program range are the stage (the convolution and the layout copies)."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("xmtpu_torch.envelope", "user_annotation", 20, 5)]
    for corr, (ts, dur) in enumerate([(5, 2.0), (10, 3.0), (21, 4.0)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 60 + corr * 5, dur, corr))
    ctx = LayerContext(TraceView(ev), 1, {"eq_reverb": {"rows": 1, "n": 100,
                                                       "taps": 4}}, H100)
    least = roofline.least_seconds(*roofline.fir_stage(1, 100, 4), H100)
    got = load_module("layer_metrics", "eq_reverb_roofline").read(ctx)
    assert got == pytest.approx(100 * least / 5e-6)
