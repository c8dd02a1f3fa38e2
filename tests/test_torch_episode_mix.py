"""The generator's mix (the benchmark's ``mix48k`` configuration: the
voice chain, a looped and side-ducked bed, BS.1770 loudness to -16
LUFS) against its float64 reference, ``perfbench/reference/
episode_mix.py``, on the CPU.

One size: a 2 s int16 voice at 44.1 kHz (Gaussian x 9000) over a 0.5 s
int16 stereo bed at 48 kHz (a 220 Hz tone x 12000) looped four times,
seeded.

- ``mix()`` at the configuration's settings with the voice chain on the
  kernels' CPU twins (``backend="pallas"``, the path the card's cell
  takes) against the reference: -80 dB a channel, the configuration's
  guarantee. The output is int16, so the error is the int16 steps that
  float32 rounding moves across a half step: about -92 dB measured. The
  reference's TF32 control reads about -67, the K-weighting without its
  shelf or the bed left unducked above -15
  (``perfbench/tests/test_perfbench_mix.py``).
- The reference's duck against the port's sequential float64 oracle
  ``ops.mix.duck_gain_np``, and its loudness against
  ``ops.loudness.measure_lufs_np`` and the port's
  ``k_weighting_sos(48000)``: the same arithmetic in float64 by other
  routes, held to 1e-12 relative, 1e-9 LU and 2e-12.
- The port's duck against the reference's on a side chain of speech and
  pauses that crosses the knee both ways, to 1e-12; a decaying maximum,
  a one-pole or a release planted wrong is off by more than 1e-3. The
  cell's check cannot see such faults: its voice never pauses.
- ``device_out=True`` returns, bit for bit, the tensor of the numpy
  result, in its layout and dtype.
- Under a CPU profiler every operation of ``mix`` lies under a program
  range below ``xmtpu_torch.mix``, and the mixer's ranges are there;
  without a profiler no ``record_function`` is opened.
- The reference imports nothing of the program and no JAX.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.entries import voice_effects
from perfbench.reference import episode_mix
from xmtpu_torch import mix
from xmtpu_torch.ops import limiter, loudness
from xmtpu_torch.ops import mix as mixops

from . import torch_refs as refs
from .test_torch_tracing import _ranges, _unranged

ROOT = Path(__file__).resolve().parents[1]
CONFIG_PATH = ROOT / "perfbench/configs/mix48k.json"
CONFIG = json.loads(CONFIG_PATH.read_text())
SR = 48000
VOICE_SR = 44100
BGM_S = 0.5
MIX_RANGES = {f"xmtpu_torch.{n}" for n in (
    "mix", "mix_place", "mix_resample", "voice_fx", "ns", "eq+reverb+volume",
    "limiter", "duck", "lufs", "lufs_kweight", "lufs_gate", "to_pcm16",
    "mix_out")}


@pytest.fixture(scope="module")
def inputs():
    """Batch rows as the traffic makes them: the voice (1, n) and the
    bed (1, n, 2), int16; the mix reads the bed's first 0.5 s."""
    rng = np.random.default_rng(26)
    v = np.clip(np.trunc(9000.0 * rng.standard_normal(2 * VOICE_SR)),
                -32768, 32767).astype(np.int16)
    t = np.arange(int(BGM_S * SR)) / SR
    b = np.trunc(12000.0 * np.sin(2 * np.pi * 220.0 * t)).astype(np.int16)
    return {"voice": v[None], "bgm": np.stack([b, b], -1)[None]}


def _config() -> dict:
    return {**CONFIG, "bgm_seconds": BGM_S}


def _mix(inputs, **kw):
    """``xmtpu_torch.mix`` as the cell's entry calls it, on the CPU with
    the voice chain on the kernels' twins."""
    effects = voice_effects.chain(CONFIG["chain"])
    for e in effects:
        if e["name"] in ("equalizer", "reverb", "limiter"):
            e["params"]["backend"] = "pallas"
    voice = dict(CONFIG["tracks"][0], pcm=inputs["voice"][0], sr=VOICE_SR)
    bed = dict(CONFIG["tracks"][1], pcm=inputs["bgm"][0], sr=SR)
    for t in (voice, bed):
        del t["signal"]
    return mix([voice, bed], SR, normalize="lufs", target_db=-16.0,
               duck_params=dict(CONFIG["duck"]), voice_effects=effects,
               device="cpu", **kw)


def _side_chain() -> np.ndarray:
    """(2, 96000) float64: noise whose level sweeps -80 to -6 dB, so the
    duck's knee and both loudness gates see every case."""
    rng = np.random.default_rng(27)
    level = 10.0 ** (np.linspace(-80.0, -6.0, 2 * SR) / 20.0)
    return level * rng.standard_normal((2, 2 * SR))


def test_mix_matches_the_reference(inputs):
    got = _mix(inputs)
    want = episode_mix.run(_config(), inputs)[0]
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == (2 * SR, 2)
    assert max(refs.db(got[:, c], want[:, c]) for c in range(2)) < -80.0


def test_device_out_is_the_host_result(inputs):
    host = _mix(inputs)
    dev = _mix(inputs, device_out=True)
    assert torch.is_tensor(dev) and dev.is_contiguous()
    assert dev.dtype == torch.int16
    assert np.array_equal(dev.numpy(), host)
    # a mono float program: (n,) float32, the same way
    x = np.random.default_rng(28).normal(0.0, 0.2, 1600).astype(np.float32)
    host = mix([(x, 16000)], 16000, device="cpu")
    dev = mix([(x, 16000)], 16000, device="cpu", device_out=True)
    assert dev.shape == host.shape == (1600,) and dev.dtype == torch.float32
    assert np.array_equal(dev.numpy(), host)


def test_reference_duck_matches_the_port_oracle():
    s = _side_chain()
    want = mixops.duck_gain_np(s, SR, **CONFIG["duck"])
    got = episode_mix.duck_gain(s, SR, **CONFIG["duck"])
    assert want.min() < 0.3 and want.max() == 1.0  # the knee is crossed
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


# a fault in one of the duck's recurrences, planted in the functions
# ``ops.mix.duck_gain_block`` calls: the decaying maximum left out (|s|
# itself), the one-pole left out, the release ten times too long
DUCK_FAULTS = {
    "decaying_max_as_abs": ("decaying_max_scan",
                            lambda real: lambda d, k, init: (d, d[..., -1])),
    "onepole_as_identity": ("onepole_scan",
                            lambda real: lambda u, c, init: (u, u[..., -1])),
    "release_x10": ("_release_coeff",
                    lambda real: lambda ms, sr: real(10.0 * ms, sr)),
}


@pytest.mark.parametrize("fault", [None, *DUCK_FAULTS])
def test_duck_on_a_side_chain_with_pauses(monkeypatch, fault):
    """The port's duck (the float64 scans) against the reference's on
    20 s of speech and pauses: 1e-12 sound, and each planted fault in a
    recurrence off by more than 1e-3 of the gain. The mix cell cannot
    tell these faults (its Gaussian voice never pauses, so the gain
    stays at the depth after the voice's first milliseconds: PERF.md
    §6); this is where the duck's recurrences are checked."""
    s = refs.speech_with_pauses(20.0, SR, 31)
    want = episode_mix.duck_gain(s, SR, **CONFIG["duck"])
    assert want.min() < 0.3 and want.max() == 1.0  # the knee is crossed
    assert np.mean((want > 0.26) & (want < 0.99)) > 0.01  # and inside it
    if fault:
        name, make = DUCK_FAULTS[fault]
        monkeypatch.setattr(limiter, name, make(getattr(limiter, name)))
    got = mixops.duck_gain(torch.from_numpy(s), SR, **CONFIG["duck"])
    err = np.max(np.abs(got.numpy() - want))
    if fault:
        assert err > 1e-3, err
    else:
        assert err < 1e-12 * np.max(want), err


def test_reference_loudness_matches_the_port_oracle():
    # the port designs the stages from the analog prototype: 1.04e-12
    # from the table's 14 decimals at most
    np.testing.assert_allclose(episode_mix.k_weighting_sos(),
                               loudness.k_weighting_sos(SR), rtol=0.0,
                               atol=2e-12)
    s = _side_chain()
    want = loudness.measure_lufs_np(s, SR)
    assert abs(episode_mix.integrated_loudness(s, SR) - want) < 1e-9
    # the relative gate drops blocks the absolute gate keeps
    p = episode_mix.block_powers(s, SR)
    lk = -0.691 + 10.0 * np.log10(p)
    assert np.sum(lk > -70.0) > np.sum(lk > want - 10.0)


def test_mix_launches_only_under_its_ranges(inputs, monkeypatch):
    """The recurrences segmented as on the card (whose rule takes S =
    1,024 for the K-weighting at the cell's length): 250 segments of 384
    samples keep the twins' per-sample loops, and the profile, short."""
    for mod, name in ((loudness, "sosfilt"), (limiter, "envelope")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         segments=250))
    _mix(inputs)  # the chain is built and cached outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _mix(inputs, device_out=True)
    assert _unranged(prof, "xmtpu_torch.mix") == []
    assert MIX_RANGES <= set(_ranges(prof))


def test_mix_opens_no_range_without_a_profiler(inputs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _mix(inputs, device_out=True).shape == (2 * SR, 2)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from perfbench.reference import episode_mix\n"
        f"cfg = json.load(open({str(CONFIG_PATH)!r}))\n"
        "cfg['bgm_seconds'] = 0.5\n"
        "x = {'voice': np.ones((1, 44100), np.int16),\n"
        "     'bgm': np.ones((1, 44100, 2), np.int16)}\n"
        "episode_mix.run(cfg, x)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "xmtpu", "xmtpu_torch"}
