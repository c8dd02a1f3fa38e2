"""The readers of the program's entry, conversion and layout ranges
(``to_pcm16_ms``, ``layout_ms``, ``dispatch_ms``) on a synthetic trace."""

import pytest

from perfbench.harness import LayerContext, load_module
from perfbench.tests.test_perfbench_roofline import H100, _gpu, _x
from perfbench.trace import TraceView

NEW = ("to_pcm16_ms", "layout_ms", "dispatch_ms")


def synthetic():
    """Two batches, each an entry range of 20 us on the host holding a
    layout copy (1 us on the device), a stage kernel (3 us) and the
    int16 conversion (0.5 us). The second entry runs 5 us past the
    window's end, and holds a nested ``effects`` range, counted once."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 55)]
    corr = 0
    for b in range(2):
        base = b * 40
        ev.append(_x("perfbench.batch", "user_annotation", base + 1, 22))
        ev.append(_x("xmtpu_torch.step", "user_annotation", base + 2, 20))
        if b:
            ev.append(_x("xmtpu_torch.effects", "user_annotation",
                         base + 3, 10))
        for k, (rng, dur) in enumerate((("xmtpu_torch.layout", 1.0),
                                        ("xmtpu_torch.limiter", 3.0),
                                        ("xmtpu_torch.to_pcm16", 0.5))):
            corr += 1
            t = base + 4 + 5 * k
            ev.append(_x(rng, "user_annotation", t, 3))
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", t + 1, 1,
                         correlation=corr))
            ev.append(_gpu(f"k{corr}", 100 + corr * 5, dur, corr))
    return TraceView(ev)


def test_new_readers_on_the_synthetic_trace():
    ctx = LayerContext(synthetic(), 2, {}, H100)
    read = {n: load_module("layer_metrics", n).read(ctx) for n in NEW}
    assert read["layout_ms"] == pytest.approx(1e-3)
    assert read["to_pcm16_ms"] == pytest.approx(0.5e-3)
    # 20 us, then 42..55 (the window's end) = 13 us, over 2 batches
    assert read["dispatch_ms"] == pytest.approx(16.5e-3)


def test_new_readers_find_nothing_and_say_nothing():
    """A program without the ranges (the parent of the change that adds
    them): every new reader returns None."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
          _gpu("k1", 60, 2.0, 1)]
    ctx = LayerContext(TraceView(ev), 1, {}, H100)
    for n in NEW:
        assert load_module("layer_metrics", n).read(ctx) is None


def test_eq_reverb_reads_the_range_where_effects_opens_it():
    """With the effect's own ``eq+reverb`` range, the roofline reads the
    convolution alone, not the layout copies beside it."""
    from perfbench import roofline

    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("xmtpu_torch.effects", "user_annotation", 2, 40),
          _x("xmtpu_torch.layout", "user_annotation", 3, 4),
          _x("xmtpu_torch.eq+reverb", "user_annotation", 10, 5),
          _x("xmtpu_torch.layout", "user_annotation", 20, 4)]
    for corr, (ts, dur) in enumerate([(4, 2.0), (11, 5.0), (21, 3.0)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 60 + corr * 6, dur, corr))
    ctx = LayerContext(TraceView(ev), 1, {"eq_reverb": {"rows": 1, "n": 100,
                                                       "taps": 4}}, H100)
    least = roofline.least_seconds(*roofline.fir_stage(1, 100, 4), H100)
    got = load_module("layer_metrics", "eq_reverb_roofline").read(ctx)
    assert got == pytest.approx(100 * least / 5e-6)
    assert load_module("layer_metrics", "layout_ms").read(ctx) == (
        pytest.approx(5e-3))
