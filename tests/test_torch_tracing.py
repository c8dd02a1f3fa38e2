"""The port's profiler ranges (``xmtpu_torch.utils.profiling.stage``),
on the CPU under a CPU-only ``torch.profiler``.

- Outside a profiler ``stage()`` is the shared no-op context; inside
  one its range reaches the exported Chrome trace as
  ``xmtpu_torch.<name>``.
- Coverage: in the tiny fused flagship step and in ``effects()`` on the
  config-3 chain (the kernels' plain twins, the branches the benchmark's
  cells take on the card), every aten op that computes or copies inside
  the entry's range (``xmtpu_torch.step``, ``xmtpu_torch.effects``) lies
  inside a stage range below it. Ops that only make views, allocate or
  dispatch to an op that does the work are exempt: the work shows as
  their children, which are checked too.
- The segmented fused limiter opens its three sub-ranges in order; the
  segmented envelope opens one range around each pass's launch, with
  its segment chains outside them.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmtpu_torch import batch as tb
from xmtpu_torch import effects
from xmtpu_torch.kernels import envelope
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff
from xmtpu_torch.ops.reverb import synthetic_ir
from xmtpu_torch.utils import profiling

# views, allocations, and wrappers whose work (a copy) is a child op
METADATA = {"aten::as_strided", "aten::transpose", "aten::t",
            "aten::reshape", "aten::expand", "aten::slice", "aten::select",
            "aten::detach", "aten::view", "aten::_unsafe_view",
            "aten::_reshape_alias", "aten::unsqueeze", "aten::squeeze",
            "aten::permute", "aten::alias", "aten::to",
            "aten::contiguous", "aten::lift_fresh", "aten::result_type"}

BANDS = [{"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
         {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
         {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
         {"freq_hz": 4000.0, "gain_db": -2.0, "q": 1.1},
         {"freq_hz": 7000.0, "gain_db": 3.0, "q": 0.8}]


def _ranges(prof) -> list:
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.name.startswith("xmtpu_torch.")]


def _unranged(prof, entry: str) -> list:
    """Aten ops inside ``entry``'s range with no other program range
    between them and it; the entry must hold some."""
    out, inside = [], 0
    for e in prof.events():
        if not e.name.startswith("aten::") or e.name in METADATA or (
                e.name.startswith("aten::empty")):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            up.append(p.name)
            p = p.cpu_parent
        if entry not in up:
            continue
        inside += 1
        if not any(n.startswith("xmtpu_torch.")
                   for n in up[:up.index(entry)]):
            out.append((e.name, up))
    assert inside, f"no op inside {entry}"
    return out


def test_stage_is_the_shared_noop_outside_a_profiler(tmp_path):
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.stage("probe")
    assert off is profiling.stage("other") is profiling._OFF
    with off as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("probe"):
            torch.ones(4).add_(1.0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert any(ev.get("name") == "xmtpu_torch.probe"
               and ev.get("cat") == "user_annotation" for ev in events)


def test_flagship_step_launches_only_under_stage_ranges():
    """The tiny fused step (as the benchmark's tiny podcast cell sets
    it): 4 clip pairs of 0.1 s at 44.1 kHz."""
    step = tb.make_flagship_step(device="cpu", fused=True)
    rng = np.random.default_rng(20)
    v, b = (torch.from_numpy(rng.integers(-9000, 9000, (4, 4410),
                                          dtype=np.int16)) for _ in "vb")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(v, b)
    assert _unranged(prof, "xmtpu_torch.step") == []
    names = set(_ranges(prof))
    assert {f"xmtpu_torch.{n}" for n in (
        "step", "mixfirst", "normalize", "eq+reverb", "limiter",
        "to_pcm16")} <= names


def test_effects_launches_only_under_stage_ranges():
    """config 3's chain (EQ and reverb folded, the limiter) on 2 stereo
    clips of 0.1 s at 48 kHz, kept on the device."""
    chain = [
        {"name": "equalizer", "params": {"bands": BANDS}},
        {"name": "reverb", "params": {
            "ir": synthetic_ir(0.5, 48000, seed=7).astype(np.float32),
            "wet": 0.3, "dry": 0.7}},
        {"name": "limiter", "params": {"threshold_db": -3.0}},
    ]
    x = torch.from_numpy(np.random.default_rng(20).normal(
        0.0, 0.3, (2, 4800, 2)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = effects(x, 48000, chain, device="cpu", backend="pallas",
                    device_out=True)
    assert y.shape == x.shape and y.is_contiguous()
    assert _unranged(prof, "xmtpu_torch.effects") == []
    names = _ranges(prof)
    assert names.count("xmtpu_torch.layout") == 2
    assert {f"xmtpu_torch.{n}" for n in (
        "effects", "eq+reverb", "limiter", "envelope", "curve")} <= set(names)


def test_segmented_limiter_opens_its_passes_in_order():
    sr = 16000
    x = torch.from_numpy(np.random.default_rng(20).normal(
        0.0, 0.5, (2, 8000)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        envelope.limiter(x, _release_coeff(100.0, sr), _attack_coeff(1.0, sr),
                         envelope.curve_of(-3.0), segments=2,
                         run=envelope.envelope_plain)
    assert _ranges(prof) == ["xmtpu_torch.limiter_pass_a",
                             "xmtpu_torch.limiter_carries",
                             "xmtpu_torch.limiter_pass_b"]


def test_segmented_envelope_ranges_hold_its_passes_alone():
    sr = 16000
    d = torch.from_numpy(np.abs(np.random.default_rng(21).normal(
        0.0, 0.5, (2, 8000))).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        envelope.envelope(d, _release_coeff(100.0, sr),
                          _attack_coeff(1.0, sr), segments=5,
                          run=envelope.envelope_plain)
    assert _ranges(prof) == ["xmtpu_torch.envelope_pass_a",
                             "xmtpu_torch.envelope_pass_b"]
    passes = [e.time_range for e in prof.events()
              if e.name.startswith("xmtpu_torch.")]
    chains = [e.time_range for e in prof.events()
              if e.name in ("aten::amax", "aten::sum")]
    assert chains and not any(p.start <= c.start <= p.end
                              for p in passes for c in chains)


@pytest.mark.parametrize("entry", ["step", "effects"])
def test_entries_open_no_range_without_a_profiler(entry, monkeypatch):
    """With no profiler the entries never build a ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if entry == "step":
        step = tb.make_flagship_step(device="cpu", fused=True)
        z = torch.zeros((2, 4410), dtype=torch.int16)
        assert step(z, z).shape == (2, 1600)
    else:
        chain = [{"name": "volume", "params": {"gain": 0.5}}]
        y = effects(np.ones((8, 2), np.float32), 48000, chain, device="cpu")
        assert np.array_equal(y, np.full((8, 2), 0.5, np.float32))
