"""The mix cell (``mix48k.episode600s``): a whole run on the CPU's twins
at a tiny size reads ``correct`` true; with a fault planted in the
loudness stage or the duck, or the reference's TF32 control in the
program's place, false; what a fault in the duck's recurrences reads. The mixer's stage counts and readers on a
synthetic trace, and (marked ``gpu``) the cell on the card at full size,
traced."""

import json
import subprocess

import numpy as np
import pytest
import torch

from perfbench import control, harness, roofline, roofline_mix
from perfbench.harness import LayerContext, load_module
from perfbench.tests.test_perfbench_roofline import H100, _gpu, _x
from perfbench.trace import TraceView

W = "mix48k.episode600s"
SEED = 2**31 + 12345
# a 2 s voice over a 0.5 s bed looped four times; on the CPU "auto" is
# the float64 scan engine, "pallas" the kernels' twins, the card's path
TINY = {"traffic": {"clip_seconds": 2.0, "ring": 2, "warmup_batches": 2,
                    "trace_batches": 3},
        "config": {"bgm_seconds": 0.5, "chain": {"backend": "pallas"}}}
MIX_METRICS = ("duck_ms", "duck_launches", "duck_roofline", "lufs_ms",
               "lufs_roofline", "place_ms")


def _run(**kw):
    return harness.run_cell(W, SEED, 0.2, False, device="cpu",
                            overrides=TINY, log=lambda m: None, **kw)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    # the twins read about -92 dB: int16 steps where float32 rounding
    # crosses a half step
    assert r["checks"]["worst_row_db"]["value"] < -85.0


def _no_shelf(real):
    def sos(sr):
        return real(sr)[1:]
    return sos


def _unducked(real):
    def gain(bus, sr, **kw):
        return torch.ones_like(bus, dtype=torch.float64)
    return gain


@pytest.mark.parametrize("module,name,fault", [
    ("loudness", "k_weighting_sos", _no_shelf),
    ("mix", "duck_gain", _unducked)])
def test_a_planted_mix_fault_is_not_correct(monkeypatch, module, name,
                                            fault):
    """The K-weighting without its shelf stage, or the bed left
    unducked: each fails the -80 dB check by a wide margin."""
    import importlib

    mod = importlib.import_module(f"xmtpu_torch.ops.{module}")
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = _run()
    v = r["checks"]["worst_row_db"]["value"]
    assert not r["correct"]
    assert v is None or v > r["checks"]["worst_row_db"]["limit"] + 20.0


# the faults of ``tests/test_torch_episode_mix.py``, planted while the
# duck runs (the voice chain's limiter is left alone), and whether the
# tiny cell tells each
TOLD = {"decaying_max_as_abs": True, "onepole_as_identity": True,
        "release_x10": False}


@pytest.mark.parametrize("fault", TOLD)
def test_a_fault_in_the_duck_s_recurrences(monkeypatch, fault):
    """What the cell's check tells of the duck's recurrences: little.
    The Gaussian voice never pauses, so past its first milliseconds the
    side chain sits above the knee and the gain at the depth, whatever
    the scans do. At this 2 s size the fade-in's share lets the check see
    a missing decaying maximum or one-pole (about -72 and -75 dB); a
    release ten times too long reads as the sound run. At the cell's
    600 s all three read ``correct`` (PERF.md §6). The recurrences are
    checked on a side chain with pauses instead
    (``tests/test_torch_episode_mix.py``)."""
    from unittest import mock

    from tests.test_torch_episode_mix import DUCK_FAULTS
    from xmtpu_torch.ops import limiter
    from xmtpu_torch.ops import mix as mixops

    name, make = DUCK_FAULTS[fault]
    told = TOLD[fault]
    real = mixops.duck_gain

    def duck_gain(*a, **kw):
        with mock.patch.object(limiter, name, make(getattr(limiter, name))):
            return real(*a, **kw)

    sound = _run()["checks"]["worst_row_db"]["value"]
    monkeypatch.setattr(mixops, "duck_gain", duck_gain)
    r = _run()
    v = r["checks"]["worst_row_db"]["value"]
    assert r["correct"] is not told
    if told:
        assert v > r["checks"]["worst_row_db"]["limit"]
    else:
        assert abs(v - sound) < 0.5


def test_tf32_reference_fails_the_limit():
    r = control.tf32_reading(W, SEED, 0.2, device="cpu", overrides=TINY)
    assert not r["correct"]
    assert r["worst_row_db"] > harness.Cell(W).config["limit_db"] + 3.0


def test_mix_counts_at_the_cell_s_shapes():
    """2 x 28,800,000 (600 s of 44.1 kHz voice at 48 kHz): the bytes
    bind both stages, 0.206 ms each."""
    cell = harness.Cell(W)
    st = load_module("reference", "episode_mix").stages(cell.config,
                                                        cell.traffic)
    assert st["duck"] == st["lufs"] == {"channels": 2, "n": 28_800_000}
    assert st["ns"] == {"rows": 2, "n": 28_800_000, "nfft": 512}
    for stage in (roofline_mix.duck_stage, roofline_mix.lufs_stage):
        n_bytes, n_ops = stage(**st["duck"])
        assert n_bytes == 12 * 2 * 28_800_000
        assert n_bytes / H100["bytes_per_s"] > n_ops / H100["f32_ops_per_s"]
        t = roofline.least_seconds(n_bytes, n_ops, H100)
        assert round(1e3 * t, 3) == 0.206


def _trace(ranges: bool):
    """One batch: under ``xmtpu_torch.mix``, two operations under
    ``mix_place`` (one nested in ``mix_resample``; 1 + 2 us), two under
    ``duck`` (3 + 4 us), one under ``lufs`` inside ``lufs_gate`` (5 us);
    without ``ranges``, the parent's trace with none of them."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 90)]
    if ranges:
        ev += [_x("xmtpu_torch.mix", "user_annotation", 2, 80),
               _x("xmtpu_torch.mix_place", "user_annotation", 3, 10),
               _x("xmtpu_torch.mix_resample", "user_annotation", 8, 4),
               _x("xmtpu_torch.duck", "user_annotation", 20, 20),
               _x("xmtpu_torch.lufs", "user_annotation", 50, 20),
               _x("xmtpu_torch.lufs_gate", "user_annotation", 55, 10)]
    launches = [(4, 1.0), (9, 2.0), (22, 3.0), (30, 4.0), (57, 5.0)]
    for corr, (ts, dur) in enumerate(launches, 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 100 + corr * 6, dur, corr))
    return TraceView(ev)


def test_mix_readers_on_a_synthetic_trace():
    st = {"duck": {"channels": 2, "n": 1000},
          "lufs": {"channels": 2, "n": 1000}}
    ctx = LayerContext(_trace(True), 1, st, H100)
    read = {n: load_module("layer_metrics", n).read(ctx) for n in MIX_METRICS}
    assert read["place_ms"] == pytest.approx(3e-3)
    assert read["duck_ms"] == pytest.approx(7e-3)
    assert read["duck_launches"] == 2
    assert read["lufs_ms"] == pytest.approx(5e-3)
    least = roofline.least_seconds(*roofline_mix.duck_stage(2, 1000), H100)
    assert read["duck_roofline"] == pytest.approx(100 * least / 7e-6)
    least = roofline.least_seconds(*roofline_mix.lufs_stage(2, 1000), H100)
    assert read["lufs_roofline"] == pytest.approx(100 * least / 5e-6)


def test_mix_readers_find_nothing_and_say_nothing():
    st = {"duck": {"channels": 2, "n": 1000},
          "lufs": {"channels": 2, "n": 1000}}
    ctx = LayerContext(_trace(False), 1, st, H100)
    for n in MIX_METRICS:
        assert load_module("layer_metrics", n).read(ctx) is None
    ctx = LayerContext(_trace(True), 1, {}, H100)
    for n in ("duck_roofline", "lufs_roofline"):
        assert load_module("layer_metrics", n).read(ctx) is None


@pytest.mark.gpu
def test_the_cell_on_the_card_traced():
    """Full size, traced: ``correct``, and every metric the cell lists,
    each roofline share at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [*spec["command"], "--workload", W, "--seed", str(2**31 + 92),
         "--seconds", "2", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert set(r["metrics"]) == {m["name"] for m in harness.Cell(W).per_layer}
    assert set(MIX_METRICS) <= set(r["metrics"])
    for m in ("duck_roofline", "lufs_roofline"):
        assert 0 < r["metrics"][m]["value"] <= 100
    assert np.isfinite(r["metrics"]["lufs_ms"]["value"])
