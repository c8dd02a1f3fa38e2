"""The voice-effects chain with the adaptive noise estimate (the
benchmark's ``voice44k_adaptive`` configuration) against its float64
reference, ``perfbench/reference/voice_chain_adaptive.py``, and the
tracker's plain twin (``kernels.ns.track_plain``, the CPU's path of
``kernels.ns.track``) against the definition, on the CPU.

One signal size: 2 mono tracks of 1 s at 44.1 kHz (Gaussian x 0.3,
seeded; 174 frames of the suppressor, 8 of them lead-in); the twin's
edge shapes run on random spectra.

- ``effects()`` on the kernels' CPU twins (``backend="pallas"``, the
  card's path) against the reference: -80 dB a track, the
  configuration's guarantee (about -115 dB measured).
- The reference's suppressor against the port's float64 oracle
  ``ops.ns.suppress_np(noise_update="adaptive")``: the same arithmetic
  through another FFT library, held to 1e-13 (as the frozen reference).
- The twin's estimate, frame by frame, equal to
  ``ops.ns._adaptive_noise_track`` (the definition's loop) on the same
  float64 PSD: both round every operation once in the same order, so
  bit for bit; and its branch decisions equal to the float64
  definition's from numpy's FFT (``torch_refs.adaptive_noise``), with
  the estimates within 1e-12: two FFT libraries differ by ~1e-16 and a
  flipped decision moves an estimate by about 12%.
- A float64 model of the kernel's frame split (pass A's states at the
  segments' starts, pass B's replays) equal to the sequential estimates
  bit for bit, at the segment counts the card's rule and the edges give.
- The reference imports nothing of the program and no JAX.
- Under a CPU profiler every operation of the adaptive ``suppress`` lies
  in one of its four ranges.
- A planted fault reads above -60 dB against the reference: ``up_leak``
  1.0, the seed held for the whole track, the update taken on the wrong
  side of the threshold.
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
from perfbench.reference import voice_chain_adaptive as reference
from xmtpu_torch import effects
from xmtpu_torch.kernels import ns as kns
from xmtpu_torch.ops import ns
from xmtpu_torch.utils import profiling

from . import torch_refs as refs
from .test_torch_tracing import _ranges, _unranged

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (ROOT / "perfbench/configs/voice44k_adaptive.json").read_text())
NS = CONFIG["chain"]["ns"]
SR = 44100
NS_RANGES = ["xmtpu_torch.ns_stft", "xmtpu_torch.ns_noise",
             "xmtpu_torch.ns_track", "xmtpu_torch.ns_istft"]
TRACK = dict(smooth=NS["smooth"], floor=NS["floor"],
             noise_frames=NS["noise_frames"], noise_smooth=NS["noise_smooth"],
             presence_thresh=NS["presence_thresh"], up_leak=NS["up_leak"])


@pytest.fixture(scope="module")
def tracks():
    """(2, n, 1) float32: two mono tracks of 1 s."""
    rng = np.random.default_rng(28)
    return (0.3 * rng.standard_normal((2, SR, 1))).astype(np.float32)


def _worst_db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    return max(refs.db(g, r) for g, r in zip(got, ref))


def _chain_db(tracks) -> float:
    y = effects(torch.from_numpy(tracks), SR,
                voice_effects.chain(CONFIG["chain"]), device="cpu",
                backend="pallas", device_out=True)
    want = reference.run(CONFIG, {"pcm": tracks})
    assert y.shape == want.shape == tracks.shape
    return _worst_db(y.numpy()[..., 0], want[..., 0])


def test_effects_adaptive_voice_chain_matches_the_reference(tracks):
    db = _chain_db(tracks)
    print(f"adaptive voice chain on the twins: {db:.1f} dB")
    assert db < -80.0


def test_reference_ns_matches_the_port_s_oracle(tracks):
    x = tracks[..., 0].astype(np.float64)
    ref = reference.suppress(x, **NS)
    oracle = ns.suppress_np(x, **NS)
    assert np.max(np.abs(oracle - ref)) < 1e-13


def _spectra(shape, seed):
    """Random complex128 spectra (R, T, F): a decade of levels a frame
    and a stretch 40 dB louder, so both branches of the tracker run."""
    R, T, F = shape
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-0.5, 0.5, (R, T, 1))
    scale[:, T // 3:T // 3 + 4] *= 100.0
    X = (rng.standard_normal((R, T, F))
         + 1j * rng.standard_normal((R, T, F))) * scale
    return torch.from_numpy(X)


@pytest.mark.parametrize("shape", [(2, 174, 257), (1, 97, 33), (3, 5, 9),
                                   (2, 8, 17), (1, 1, 257)])
def test_twin_runs_the_definition_s_state_sequence(shape):
    """At the tracks' shape, a prime T, T < and = ``noise_frames`` and
    one frame: each frame's estimate equals ``_adaptive_noise_track``'s
    bit for bit (the lead-in frames hold the seed), and ``track`` on the
    CPU is the twin."""
    X = _spectra(shape, sum(shape))
    psd = X.real * X.real + X.imag * X.imag
    seed = ns.median(psd[..., :NS["noise_frames"], :], dim=-2)
    got = torch.empty(X.shape, dtype=torch.float64)
    Y = kns.track(X, seed, **TRACK, noise_out=got)
    want = ns._adaptive_noise_track(psd, NS["noise_frames"],
                                    NS["noise_smooth"],
                                    NS["presence_thresh"], NS["up_leak"])
    assert torch.equal(got, want)
    assert Y.dtype == torch.complex64 and torch.equal(
        Y, kns.track_plain(X, seed, **TRACK))
    assert torch.equal(got[:, :NS["noise_frames"]],
                       seed[:, None].expand(-1, min(shape[1],
                                                    NS["noise_frames"]), -1))


def _replay(psd, nz, P, t0, t1, lead):
    """The tracker and the smoothing over frames [t0, t1) from the state
    (nz, P), as the kernel's passes run them -> (nz, P, estimates)."""
    out = []
    for t in range(t0, t1):
        p = psd[..., t, :]
        if t >= lead:
            nz = torch.where(
                p / torch.clamp_min(nz, 1e-20) < NS["presence_thresh"],
                NS["noise_smooth"] * nz + (1.0 - NS["noise_smooth"]) * p,
                nz * NS["up_leak"])
        P = NS["smooth"] * P + (1.0 - NS["smooth"]) * p
        out.append(nz)
    return nz, P, out


@pytest.mark.parametrize("T,S", [(174, 1), (174, 5), (97, 13), (5, 8),
                                 (20, 3), (30, 4), (1000, 10), (10337, 32)])
def test_the_kernel_s_frame_split_replays_the_sequence(T, S):
    """A float64 model of the kernel's two passes (``track_plan``'s S
    segments of L frames, L a multiple of pass A's group of 8; pass A:
    the state at each segment's start from one walk through the first S
    - 1 segments; pass B: each segment replayed from its state) gives the
    sequential estimates bit for bit, at T prime, T < S, a first segment
    that is all lead-in, the last segment whole or short, and the cell's
    10,337 frames."""
    X = _spectra((1, T, 3), T + S)
    psd = X.real * X.real + X.imag * X.imag
    lead = NS["noise_frames"]
    seed = ns.median(psd[..., :lead, :], dim=-2)
    want = torch.empty(X.shape, dtype=torch.float64)
    kns.track_plain(X, seed, **TRACK, noise_out=want)
    S, L = kns.track_plan(T, S)
    assert (S - 1) * L < T <= S * L and (S == 1 or L % kns.TRACK_GROUP == 0)
    nz, P = seed, torch.zeros_like(seed)
    states = [(nz, P)]
    for s in range(1, S):  # pass A
        nz, P, _ = _replay(psd, nz, P, (s - 1) * L, s * L, lead)
        states.append((nz, P))
    got = torch.cat([torch.stack(_replay(psd, *states[s], s * L,
                                         min((s + 1) * L, T), lead)[2],
                                 dim=-2) for s in range(S)], dim=-2)
    assert torch.equal(got, want)


def test_twin_makes_the_float64_definition_s_decisions(tracks):
    """Through ``suppress``'s float64 analysis: zero decisions apart from
    the definition on numpy's FFT, and -80 dB against ``suppress_np``."""
    x = tracks[..., 0]
    X = ns.stft(torch.from_numpy(x).double())
    psd = X.real * X.real + X.imag * X.imag
    seed = ns.median(psd[..., :NS["noise_frames"], :], dim=-2)
    got = torch.empty(X.shape, dtype=torch.float64)
    kns.track(X, seed, **TRACK, noise_out=got)
    want, upd = refs.adaptive_noise(x, NS["nfft"], NS["noise_frames"],
                                    NS["noise_smooth"],
                                    NS["presence_thresh"], NS["up_leak"])
    lead = NS["noise_frames"]
    leak = refs.leak_taken(got, lead, NS["up_leak"])[..., lead:, :]
    assert int(np.sum(leak == upd[..., lead:, :])) == 0
    assert 0.5 < upd[..., lead:, :].mean() < 0.99  # both branches run
    rel = np.max(np.abs(got.numpy() - want) / want)
    print(f"twin vs the float64 definition: max relative {rel:.2e}")
    assert rel < 1e-12
    y = ns.suppress(x, device="cpu", **{k: v for k, v in NS.items()})
    assert _worst_db(y.numpy(), ns.suppress_np(x.astype(np.float64),
                                               **NS)) < -80.0


def test_reference_imports_nothing_of_the_program():
    path = ROOT / "perfbench/configs/voice44k_adaptive.json"
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from perfbench.reference import voice_chain_adaptive as r\n"
        f"cfg = json.load(open({str(path)!r}))\n"
        "r.run(cfg, {'pcm': np.ones((1, 4410, 1), np.float32)})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "xmtpu", "xmtpu_torch"}
    assert "torch" in mods


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_adaptive_suppress_launches_only_under_its_four_ranges(tracks,
                                                               dtype):
    x = tracks[..., 0]
    if dtype == np.int16:
        x = np.round(x * 9000.0).astype(np.int16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("ns"):
            y = ns.suppress(torch.from_numpy(x), device="cpu", **NS)
    assert y.dtype == torch.from_numpy(x).dtype
    assert _unranged(prof, "xmtpu_torch.ns") == []
    tail = ["xmtpu_torch.to_pcm16"] if dtype == np.int16 else []
    assert _ranges(prof) == ["xmtpu_torch.ns"] + NS_RANGES + tail


def _wrong_side(X, seed, smooth, floor, noise_frames, noise_smooth,
                presence_thresh, up_leak, noise_out=None):
    """The twin with the update taken where the PSD is at or above the
    threshold and the leak below it."""
    re, im = X.real, X.imag
    psd = re * re + im * im
    nz = torch.broadcast_to(seed, psd.shape[:-2] + psd.shape[-1:])
    P = torch.zeros_like(nz)
    Y = torch.empty(X.shape, dtype=torch.complex64)
    for t in range(X.shape[-2]):
        p = psd[..., t, :]
        if t >= noise_frames:
            nz = torch.where(p / torch.clamp_min(nz, 1e-20) >= presence_thresh,
                             noise_smooth * nz + (1.0 - noise_smooth) * p,
                             nz * up_leak)
        P = smooth * P + (1.0 - smooth) * p
        snr = torch.clamp_min(P / torch.clamp_min(nz, 1e-20) - 1.0, 0.0)
        g = torch.clamp_min(snr / (1.0 + snr), floor)
        Y[..., t, :] = torch.complex(re[..., t, :] * g, im[..., t, :] * g)
    return Y


@pytest.mark.parametrize("fault", ["up_leak 1.0", "seed held", "wrong side"])
def test_a_planted_tracker_fault_reads_above_minus_60_db(tracks, monkeypatch,
                                                         fault):
    real = kns.track_plain

    def planted(*a, **kw):
        names = ("X", "seed", "smooth", "floor", "noise_frames",
                 "noise_smooth", "presence_thresh", "up_leak")
        kw.update(zip(names, a))
        if fault == "up_leak 1.0":
            kw["up_leak"] = 1.0
        elif fault == "seed held":  # no frame passes: the leak of 1 holds
            kw.update(presence_thresh=0.0, up_leak=1.0)
        else:
            return _wrong_side(**kw)
        return real(**kw)

    monkeypatch.setattr(kns, "track_plain", planted)
    db = _chain_db(tracks)
    print(f"{fault}: {db:.1f} dB")
    assert db > -60.0


@pytest.mark.parametrize("case", ["complex64", "seed float32", "noise_out"])
def test_track_refuses(case):
    X = _spectra((1, 9, 5), 1)
    seed = torch.ones(1, 5, dtype=torch.float64)
    kw = {}
    if case == "complex64":
        X = X.to(torch.complex64)
    elif case == "seed float32":
        seed = seed.float()
    else:
        kw["noise_out"] = torch.empty(1, 9, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        kns.track(X, seed, **TRACK, **kw)
