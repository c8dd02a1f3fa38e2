"""The reader of the segmented envelope's two core launches
(``envelope_core_ms``) on a synthetic trace: it counts the operations
launched inside ``xmtpu_torch.envelope_pass_a`` and ``_pass_b``, not the
chains and the correction between them, and says nothing for a program
without those ranges."""

import pytest

from perfbench.harness import LayerContext, load_module
from perfbench.tests.test_perfbench_roofline import H100, _gpu, _x
from perfbench.trace import TraceView


def _trace(pass_ranges: bool):
    """One batch inside ``xmtpu_torch.envelope``: pass A (2 us), a chain
    (0.5 us), pass B (3 us); without ``pass_ranges`` the same launches
    under the envelope range alone."""
    ev = [_x("perfbench.traced_window", "user_annotation", 0, 100),
          _x("perfbench.batch", "user_annotation", 1, 50),
          _x("xmtpu_torch.envelope", "user_annotation", 2, 40)]
    if pass_ranges:
        ev += [_x("xmtpu_torch.envelope_pass_a", "user_annotation", 3, 4),
               _x("xmtpu_torch.envelope_pass_b", "user_annotation", 20, 4)]
    for corr, (ts, dur) in enumerate([(4, 2.0), (10, 0.5), (21, 3.0)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", ts, 1,
                     correlation=corr))
        ev.append(_gpu(f"k{corr}", 60 + corr * 6, dur, corr))
    return TraceView(ev)


def test_envelope_core_reads_the_two_launches():
    ctx = LayerContext(_trace(True), 1, {}, H100)
    got = load_module("layer_metrics", "envelope_core_ms").read(ctx)
    assert got == pytest.approx(5e-3)


def test_envelope_core_finds_nothing_and_says_nothing():
    ctx = LayerContext(_trace(False), 1, {}, H100)
    assert load_module("layer_metrics", "envelope_core_ms").read(ctx) is None
