"""The adaptive voice cell (``voice44k_adaptive.voice32x60s``): a whole
run on the CPU's twins at a tiny size reads ``correct`` true; its
controls read false: the reference's TF32 control in the program's
place, the program with the frozen estimate, the program with ``up_leak``
1.0; a program without the float64 tracker is refused at set-up. The
tracker's counts and the cell's three readers on a synthetic
trace, and what they read on a program without the tracker's range; and
(marked ``gpu``) the cell on the card at full size, traced."""

import json
import subprocess

import numpy as np
import pytest
import torch

from perfbench import control, harness, roofline, roofline_ns_track
from perfbench.harness import LayerContext, load_module
from perfbench.tests.test_perfbench_roofline import H100, _gpu, _x
from perfbench.trace import TraceView

W = "voice44k_adaptive.voice32x60s"
SEED = 2**31 + 12345
# two tracks of 0.5 s (88 frames of the suppressor, 8 of them lead-in);
# "pallas" is the kernels' twins, the card's path
TINY = {"traffic": {"clips_per_batch": 2, "clip_seconds": 0.5, "ring": 2,
                    "warmup_batches": 2, "trace_batches": 3},
        "config": {"call": {"backend": "pallas"}}}
METRICS = ("ns_adaptive_ms", "ns_adaptive_launches", "ns_track_roofline")


def _run(**kw):
    return harness.run_cell(W, SEED, 0.2, False, device="cpu",
                            overrides=TINY, log=lambda m: None, **kw)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    # the twins read about -121 dB
    assert r["checks"]["worst_row_db"]["value"] < -100.0


@pytest.mark.parametrize("control_kw", [{"noise_update": "frozen"},
                                        {"up_leak": 1.0}])
def test_a_program_control_is_not_correct(monkeypatch, control_kw):
    """The frozen estimate (about -9 dB) or no upward leak (about -23
    dB) in the program's suppressor, the reference unchanged."""
    from xmtpu_torch.ops import ns

    real = ns.suppress
    monkeypatch.setattr(ns, "suppress",
                        lambda x, **kw: real(x, **{**kw, **control_kw}))
    r = _run()
    v = r["checks"]["worst_row_db"]["value"]
    assert not r["correct"]
    assert v is None or v > r["checks"]["worst_row_db"]["limit"] + 20.0


def test_tf32_reference_fails_the_limit():
    r = control.tf32_reading(W, SEED, 0.2, device="cpu", overrides=TINY)
    assert not r["correct"]
    assert r["worst_row_db"] > harness.Cell(W).config["limit_db"] + 5.0


def test_a_program_without_the_float64_tracker_is_refused_at_set_up(
        monkeypatch):
    """A program whose adaptive suppressor has no ``kernels.ns.track``
    (its decisions float32, its frames stepped from the host) is refused
    by the cell's entry before the ring is made: the run ends in an error
    and gives no result line."""
    from xmtpu_torch.kernels import ns

    monkeypatch.delattr(ns, "track")
    made = []
    monkeypatch.setattr(harness.gen, "make_ring",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="no float64 tracker"):
        _run()
    assert not made


def test_track_counts_at_the_cell_s_shapes():
    """32 x 2,646,000 at nfft 512: 10,337 frames of 257 bins a track,
    16 bytes a bin and frame: 1.36 GB, 0.406 ms; the bytes bind."""
    st = harness.load_module("reference", "voice_chain_adaptive").stages(
        harness.Cell(W).config, harness.Cell(W).traffic)
    assert st["ns_track"] == {"rows": 32, "n": 2646000, "nfft": 512}
    n_bytes, n_ops = roofline_ns_track.track_stage(**st["ns_track"])
    assert n_bytes == 16 * 32 * 10337 * 257
    assert n_ops == 21 * 32 * 10337 * 257
    t = roofline.least_seconds(n_bytes, n_ops, H100)
    assert round(1e3 * t, 3) == 0.406
    assert n_bytes / H100["bytes_per_s"] > n_ops / H100["f32_ops_per_s"]


def _trace(track_range: bool):
    """One batch: two operations under ``xmtpu_torch.ns`` (2 + 3 us), the
    second under ``ns_track`` when ``track_range``, one under the limiter
    (4 us)."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("xmtpu_torch.effects", "user_annotation", 2, 40),
          _x("xmtpu_torch.ns", "user_annotation", 3, 10),
          _x("xmtpu_torch.ns_stft", "user_annotation", 4, 3)]
    if track_range:
        ev.append(_x("xmtpu_torch.ns_track", "user_annotation", 8, 4))
    ev.append(_x("xmtpu_torch.limiter", "user_annotation", 20, 5))
    for corr, (ts, dur) in enumerate([(5, 2.0), (10, 3.0), (21, 4.0)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 60 + corr * 6, dur, corr))
    return TraceView(ev)


def test_readers_on_a_synthetic_trace():
    st = {"ns_track": {"rows": 2, "n": 1000, "nfft": 64}}
    ctx = LayerContext(_trace(True), 1, st, H100)
    read = {n: load_module("layer_metrics", n).read(ctx) for n in METRICS}
    assert read["ns_adaptive_ms"] == pytest.approx(5e-3)
    assert read["ns_adaptive_launches"] == 2
    least = roofline.least_seconds(
        *roofline_ns_track.track_stage(2, 1000, 64), H100)
    assert read["ns_track_roofline"] == pytest.approx(100 * least / 3e-6)


def test_the_tracker_s_reader_finds_nothing_without_its_range():
    """A program without the ``ns_track`` range (its tracker a loop over
    frames) reads the stage's time and launches, and no roofline share;
    nor does a trace without the stage's shapes."""
    st = {"ns_track": {"rows": 2, "n": 1000, "nfft": 64}}
    ctx = LayerContext(_trace(False), 1, st, H100)
    assert load_module("layer_metrics", "ns_track_roofline").read(ctx) is None
    assert load_module("layer_metrics", "ns_adaptive_launches").read(ctx) == 2
    ctx = LayerContext(_trace(True), 1, {}, H100)
    assert load_module("layer_metrics", "ns_track_roofline").read(ctx) is None


@pytest.mark.gpu
def test_the_cell_on_the_card_traced():
    """Full size, traced: ``correct``, and every metric the cell lists."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*spec["command"], "--workload", W, "--seed", str(2**31 + 92),
         "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert set(r["metrics"]) == {m["name"] for m in harness.Cell(W).per_layer}
    assert set(METRICS) <= set(r["metrics"])
    assert 0 < r["metrics"]["ns_track_roofline"]["value"] <= 100
    assert np.isfinite(r["metrics"]["ns_adaptive_ms"]["value"])
