"""The voice-effects chain (noise suppression -> EQ -> reverb -> volume
-> limiter, the benchmark's ``voice44k`` configuration) against its
float64 reference, ``perfbench/reference/voice_chain.py``, on the CPU.

One size: 2 mono tracks of 1 s at 44.1 kHz (Gaussian x 0.3, seeded).

- ``effects()`` on the kernels' CPU twins (``backend="pallas"``, the
  path the card's cell takes) against the reference: -80 dB a track,
  the configuration's guarantee. The twins read about -113 dB; the
  reference's TF32 control reads about -72, a stage left out or a
  wrong median far above.
- The reference's suppressor against the port's float64 oracle
  ``ops.ns.suppress_np`` (max abs 3.6e-16 measured: the same
  arithmetic, another FFT library), held to 1e-13; and against the
  port's ``suppress`` (float32 transforms and scan; about -135 dB
  measured), held to -120 dB: float32 rounding of a few operations a
  sample, where the lower median or a bfloat16 smoothing read above
  -60 dB.
- The reference imports nothing of the program and no JAX.
- Under a CPU profiler every operation of ``ns.suppress`` lies in one of
  its five ranges (the rest of the chain's stages are held to their
  ranges by ``test_torch_tracing.py``).
"""

from __future__ import annotations

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
from perfbench.reference import voice_chain
from xmtpu_torch import effects
from xmtpu_torch.graph import fx
from xmtpu_torch.ops import ns
from xmtpu_torch.utils import profiling

from . import torch_refs as refs
from .test_torch_tracing import _ranges, _unranged

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench/configs/voice44k.json").read_text())
SR = 44100
NS_RANGES = ["xmtpu_torch.ns_stft", "xmtpu_torch.ns_psd",
             "xmtpu_torch.ns_noise", "xmtpu_torch.ns_gain",
             "xmtpu_torch.ns_istft"]


@pytest.fixture(scope="module")
def tracks():
    """(2, n, 1) float32: two mono tracks of 1 s."""
    rng = np.random.default_rng(22)
    return (0.3 * rng.standard_normal((2, SR, 1))).astype(np.float32)


def _chain():
    return voice_effects.chain(CONFIG["chain"])


def _worst_db(got, ref) -> float:
    """The worst track's RMS error against the reference, in dB."""
    got = np.asarray(got, np.float64)
    return max(refs.db(g, r) for g, r in zip(got, ref))


def test_effects_voice_chain_matches_the_reference(tracks):
    y = effects(torch.from_numpy(tracks), SR, _chain(), device="cpu",
                backend="pallas", device_out=True)
    want = voice_chain.run(CONFIG, {"pcm": tracks})
    assert y.shape == want.shape == tracks.shape
    assert _worst_db(y.numpy()[..., 0], want[..., 0]) < -80.0


def test_the_chain_builds_as_on_the_card():
    """NS alone, then EQ+reverb+volume folded into one FIR feeding the
    limiter, with the reference's tap count (the roofline's stage)."""
    built = fx.build_chain(SR, _chain(), device_type="cuda")
    assert [type(e).__name__ for e in built] == ["NoiseSuppressFx",
                                                 "ConvLimiterFx"]
    conv = built[1].conv
    assert conv.stage_name == "eq+reverb+volume"
    traffic = {"clips_per_batch": 32, "channels": 1, "clip_seconds": 60.0}
    st = voice_chain.stages(CONFIG, traffic)
    assert st["eq_reverb"]["taps"] == len(conv.ir) == 22191
    assert st["ns"] == {"rows": 32, "n": 2646000, "nfft": 512}


def test_reference_ns_matches_the_port(tracks):
    x = tracks[..., 0]
    ref = voice_chain.suppress(x.astype(np.float64), **CONFIG["chain"]["ns"])
    oracle = ns.suppress_np(x.astype(np.float64))
    assert np.max(np.abs(oracle - ref)) < 1e-13
    got = ns.suppress(torch.from_numpy(x), device="cpu")
    assert got.dtype == torch.float32
    assert _worst_db(got.numpy(), ref) < -120.0


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from perfbench.reference import voice_chain\n"
        f"cfg = json.load(open({str(ROOT / 'perfbench/configs/voice44k.json')!r}))\n"
        "voice_chain.run(cfg, {'pcm': np.ones((1, 4410, 1), np.float32)})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "xmtpu", "xmtpu_torch"}
    assert "torch" in mods


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_suppress_launches_only_under_its_five_ranges(tracks, dtype):
    x = tracks[..., 0]
    if dtype == np.int16:
        x = np.round(x * 9000.0).astype(np.int16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("ns"):
            y = ns.suppress(torch.from_numpy(x), device="cpu")
    assert y.dtype == torch.from_numpy(x).dtype
    assert _unranged(prof, "xmtpu_torch.ns") == []
    # int16 out: the pinned conversion opens its own range inside the last
    tail = ["xmtpu_torch.to_pcm16"] if dtype == np.int16 else []
    assert _ranges(prof) == ["xmtpu_torch.ns"] + NS_RANGES + tail
