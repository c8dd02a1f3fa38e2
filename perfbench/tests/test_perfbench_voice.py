"""The voice cell (``voice44k.mono32x60s``): a whole run on the CPU's
twins at a tiny size reads ``correct`` true; with a fault planted in
the noise suppressor, or the reference's TF32 control in the program's
place, false. The suppressor's counts and readers on a synthetic trace,
and (marked ``gpu``) the cell on the card at full size, traced."""

import json
import subprocess

import numpy as np
import pytest
import torch

from perfbench import control, harness, roofline, roofline_ns
from perfbench.harness import LayerContext, load_module
from perfbench.tests.test_perfbench_roofline import H100, _gpu, _x
from perfbench.trace import TraceView

W = "voice44k.mono32x60s"
SEED = 2**31 + 12345
# two tracks of 0.5 s (86 frames of the suppressor, 8 of them lead-in);
# on the CPU "auto" is the float64 scan engine, "pallas" the kernels'
# twins, the card's path
TINY = {"traffic": {"clips_per_batch": 2, "clip_seconds": 0.5, "ring": 2,
                    "warmup_batches": 2, "trace_batches": 3},
        "config": {"call": {"backend": "pallas"}}}
NS_METRICS = ("ns_ms", "ns_roofline", "ns_launches")


def _run(**kw):
    return harness.run_cell(W, SEED, 0.2, False, device="cpu",
                            overrides=TINY, log=lambda m: None, **kw)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    # the twins read about -114 dB
    assert r["checks"]["worst_row_db"]["value"] < -100.0


def _bf16_smoothing(real):
    def smooth(psd, a):
        return real(psd.to(torch.bfloat16), a).to(psd.dtype)
    return smooth


def _lower_median(real):
    def median(x, dim):
        return torch.median(x, dim=dim).values
    return median


@pytest.mark.parametrize("name,fault", [("_onepole_frames", _bf16_smoothing),
                                        ("median", _lower_median)])
def test_a_planted_ns_fault_is_not_correct(monkeypatch, name, fault):
    """The PSD smoothing in bfloat16, or the lower of the two middle
    values as the lead-in's median (``torch.median``): each fails the
    -80 dB check by a wide margin."""
    from xmtpu_torch.ops import ns

    monkeypatch.setattr(ns, name, fault(getattr(ns, name)))
    r = _run()
    v = r["checks"]["worst_row_db"]["value"]
    assert not r["correct"]
    assert v is None or v > r["checks"]["worst_row_db"]["limit"] + 5.0


def test_tf32_reference_fails_the_limit():
    r = control.tf32_reading(W, SEED, 0.2, device="cpu", overrides=TINY)
    assert not r["correct"]
    assert r["worst_row_db"] > harness.Cell(W).config["limit_db"] + 5.0


def test_ns_counts_at_the_cell_s_shapes():
    """32 x 2,646,000 at nfft 512: 10,337 frames a track; the bytes
    bind (0.202 ms against 0.139 ms of operations)."""
    st = harness.load_module("reference", "voice_chain").stages(
        harness.Cell(W).config, harness.Cell(W).traffic)["ns"]
    n_bytes, n_ops = roofline_ns.ns_stage(**st)
    assert n_bytes == 4 * (2 * 32 * 2646000 + 512)
    assert n_ops == 32 * 10337 * (2 * 2.5 * 512 * 9 + 14 * 257 + 3 * 512)
    t = roofline.least_seconds(n_bytes, n_ops, H100)
    assert round(1e3 * t, 4) == 0.2022
    assert n_bytes / H100["bytes_per_s"] > n_ops / H100["f32_ops_per_s"]


def _trace(ns_range: bool):
    """One batch: two operations under ``xmtpu_torch.ns`` (nested in a
    sub-range; 2 + 3 us), one under the limiter (4 us); without
    ``ns_range``, the parent's trace with no such range."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("xmtpu_torch.effects", "user_annotation", 2, 40)]
    if ns_range:
        ev += [_x("xmtpu_torch.ns", "user_annotation", 3, 10),
               _x("xmtpu_torch.ns_stft", "user_annotation", 4, 3)]
    ev.append(_x("xmtpu_torch.limiter", "user_annotation", 20, 5))
    for corr, (ts, dur) in enumerate([(5, 2.0), (10, 3.0), (21, 4.0)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 60 + corr * 6, dur, corr))
    return TraceView(ev)


def test_ns_readers_on_a_synthetic_trace():
    st = {"ns": {"rows": 2, "n": 1000, "nfft": 64}}
    ctx = LayerContext(_trace(True), 1, st, H100)
    read = {n: load_module("layer_metrics", n).read(ctx) for n in NS_METRICS}
    assert read["ns_ms"] == pytest.approx(5e-3)
    assert read["ns_launches"] == 2
    least = roofline.least_seconds(*roofline_ns.ns_stage(2, 1000, 64), H100)
    assert read["ns_roofline"] == pytest.approx(100 * least / 5e-6)


def test_ns_readers_find_nothing_and_say_nothing():
    ctx = LayerContext(_trace(False), 1, {"ns": {"rows": 2, "n": 1000,
                                                 "nfft": 64}}, H100)
    for n in NS_METRICS:
        assert load_module("layer_metrics", n).read(ctx) is None
    ctx = LayerContext(_trace(True), 1, {}, H100)
    assert load_module("layer_metrics", "ns_roofline").read(ctx) is None


@pytest.mark.gpu
def test_the_cell_on_the_card_traced():
    """Full size, traced: ``correct``, and every metric the cell lists."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*spec["command"], "--workload", W, "--seed", str(2**31 + 91),
         "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert set(r["metrics"]) == {m["name"] for m in harness.Cell(W).per_layer}
    assert set(NS_METRICS) <= set(r["metrics"])
    assert 0 < r["metrics"]["ns_roofline"]["value"] <= 100
    assert np.isfinite(r["metrics"]["ns_ms"]["value"])
