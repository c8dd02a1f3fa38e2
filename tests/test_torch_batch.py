"""Parity of the port's flagship step (``xmtpu_torch.batch``) with the
JAX package's (``xmtpu.batch``), on the CPU (``device="cpu"``: the
kernels' plain twins).

Two shapes, one per branch:
- fused: 2 clips of 22050 int16 samples (0.5 s at 44.1 kHz, 50 frames
  of 441) -> 8000 bus samples with ``fused=True``. At 2 rows x 8000
  samples ``pick_segments`` is 1, so the JAX chain runs the same
  kernels the port replaces: the fftconv convolution and the
  unsegmented fused limiter (Pallas in interpret mode);
- unfused (the auto rule below 128 rows): 2 clips of 88200 samples
  (2 s) -> 32000 bus samples, where both the IIR and the envelope
  split each row into 4 segments, as in the JAX chain.

Tolerances: the step's int16 output against the JAX step and against
both float64 oracles, -80 dB (the chain's accuracy gate; the margin is
printed). Host tables: bit-exact.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu.ops import limiter as xlimiter
from xmtpu.ops import resample as xresample
from xmtpu_torch import batch as tbatch
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR_IN, SR_BUS = 44100, 16000
B, N_IN = 2, 22050
N_IN_UNFUSED = 88200  # 2 s -> 32000 bus samples
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(20261016)
    v = (rng.standard_normal((B, N_IN)) * 8000).astype(np.int16)
    b = (rng.standard_normal((B, N_IN)) * 6000).astype(np.int16)
    return v, b


@pytest.fixture(scope="module")
def y_jax(clips):
    v, b = clips
    step = jax.jit(xbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                             interpret=True, fused=True))
    return np.asarray(step(jnp.asarray(v), jnp.asarray(b)))


@pytest.fixture(scope="module")
def y_port(clips):
    v, b = clips
    step = tbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS, fused=True,
                                     device="cpu")
    return step(torch.from_numpy(v), torch.from_numpy(b)).numpy()


@pytest.fixture(scope="module")
def y_jax_scan(clips):
    """The JAX step on its float64 scan backend (the unfused branch, as
    its auto rule picks for iir_backend="scan")."""
    v, b = clips
    step = jax.jit(xbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                             interpret=True,
                                             iir_backend="scan"))
    return np.asarray(step(jnp.asarray(v), jnp.asarray(b)))


@pytest.fixture(scope="module")
def clips_unfused():
    rng = np.random.default_rng(20261017)
    v = (rng.standard_normal((B, N_IN_UNFUSED)) * 8000).astype(np.int16)
    b = (np.sin(np.arange(N_IN_UNFUSED) / 40.0)[None].repeat(B, 0)
         * 9000).astype(np.int16)
    return v, b


def _jax_tables() -> dict:
    """The same host tables, built with the JAX package's code."""
    sos = xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR_BUS)
    ir = xbatch._reverb.synthetic_ir(0.25, SR_BUS).astype("float32")
    t = xresample.aligned_tables(xresample._make_plan(160, 441, 24, 9.0))
    return {
        "sos": sos, "ir": xbatch._combined_ir(sos, ir, 0.25, 0.75),
        "reverb_ir": ir, "wet": 0.25, "dry": 0.75,
        "H1": t.H1, "H0": t.H0, "H2": t.H2,
        "lo": t.lo, "hi": t.hi, "r0": t.r0, "r2": t.r2,
        "k_rel": xlimiter._release_coeff(xbatch.LIM_RELEASE_MS, SR_BUS),
        "c_att": xlimiter._attack_coeff(xbatch.LIM_ATTACK_MS, SR_BUS),
        # limiter_pallas's curve 5-tuple for the chain's threshold
        "curve": np.array([-3.0, 6.0, 0.0, xlimiter._knee_slope(
            float("inf")), 0.0]),
        "fade": int(round(250.0 * SR_BUS / 1000.0)),
        "sr_in": SR_IN, "sr_bus": SR_BUS, "bgm_gain": 0.4,
    }


def test_flagship_tables_bit_exact():
    ours, ref = tbatch.flagship_tables(SR_IN, SR_BUS), _jax_tables()
    assert set(ours) == set(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert tbatch.DEFAULT_BANDS == xbatch.DEFAULT_BANDS
    assert (tbatch.LIM_RELEASE_MS, tbatch.LIM_ATTACK_MS) == (
        xbatch.LIM_RELEASE_MS, xbatch.LIM_ATTACK_MS)


def test_step_vs_jax_step(y_port, y_jax):
    assert y_port.shape == y_jax.shape == (B, 8000)
    assert y_port.dtype == np.int16
    db = refs.db(y_port, y_jax)
    print(f"port step vs JAX step: {db:.1f} dB (gate -80, margin "
          f"{-80 - db:.1f} dB)")
    assert db <= -80.0


def test_step_vs_oracles(clips, y_port):
    """Against the port's own float64 oracle and the JAX package's,
    which are the same numpy computation (bit-equal)."""
    v, b = clips
    ref = tbatch.flagship_oracle_np(v, b, sr_in=SR_IN, sr_bus=SR_BUS)
    ref_j = xbatch.flagship_oracle_np(v, b, sr_in=SR_IN, sr_bus=SR_BUS)
    assert np.array_equal(ref, ref_j)
    for i in range(B):
        db = refs.db(y_port[i], ref[i])
        print(f"clip {i}: {db:.1f} dB vs float64 oracle (gate -80, "
              f"margin {-80 - db:.1f} dB)")
        assert db <= -80.0


def test_from_tables_matches_own_tables(clips, y_port):
    """A step built from the JAX package's tables computes the same
    output as the port's own make_flagship_step."""
    v, b = clips
    step = tbatch.FlagshipStep.from_tables(_jax_tables(), device="cpu",
                                           fused=True)
    y = step(torch.from_numpy(v), torch.from_numpy(b)).numpy()
    assert np.array_equal(y, y_port)
    assert step.ir.dtype == torch.float32 and step.ir.shape == (4093,)


def test_front_matches_jax_operation_order(clips):
    """The step mixes at integer scale and lets the resample tables
    carry pcm16_to_f32's 1/32768: bit for bit the JAX package's
    pcm16_to_f32(v3) + g * pcm16_to_f32(b3) through the unscaled
    banded resample."""
    from xmtpu_torch.ops import convert, resample

    v, b = (torch.from_numpy(a).reshape(B, N_IN // 441, 441) for a in clips)
    m_ref = resample.polyphase_resample_framed(
        convert.pcm16_to_f32(v) + 0.4 * convert.pcm16_to_f32(b),
        SR_IN, SR_BUS).reshape(B, -1)
    step = tbatch.make_flagship_step(fused=True, device="cpu")
    m, _, _ = step.front(*(torch.from_numpy(a) for a in clips))
    assert m.dtype == torch.float32 and torch.equal(m, m_ref)


@pytest.mark.parametrize("kw", [
    {"iir_backend": "scan"},
    {"resample_backend": "mixfirst_pad", "fused": True},
    {"iir_backend": "scan", "resample_backend": "pallas"},
    {"resample_backend": "mixfirst_pad"},
    {"iir_backend": "scan", "envelope_block": 2, "lti_fold": False},
    {"iir_backend": "scan", "fused": False},
    {"limiter_fuse": False, "envelope_block": 2, "iir_backend": "scan"},
    {"envelope_block": 8, "resample_backend": "mixfirst_pad"},
])
def test_unported_options_refused(kw, clips, y_jax_scan):
    """Nothing of these is refused any more (the name is kept from when
    the mixfirst_pad probe was). The mixfirst_pad front (the JAX
    package's lane-padding front: 441 -> 512 zero lanes and zero filter
    rows) runs with every other option: against the JAX step built with
    the same options (Pallas in interpret mode), 1 LSB and -80 dB, and
    against the port's own mixfirst step, 1 LSB. The scan IIR backend
    runs: with any valid envelope_block, lti_fold, limiter_fuse,
    fused=False or the "pallas" front it is the JAX scan step's unfused
    chain (nothing folds, the auto rule never fuses), to -80 dB and 1 LSB
    (the JAX step's front and reverb are its float32 kernels).
    lti_fold=False, the "pallas"/"rsmix" fronts and block lookahead run
    (tests/test_torch_fronts.py, tests/test_torch_unfolded.py,
    test_envelope_block_runs_per_sample)."""
    v, b = (torch.from_numpy(a) for a in clips)
    if kw.get("resample_backend") == "mixfirst_pad":
        y_j = np.asarray(jax.jit(xbatch.make_flagship_step(
            sr_in=SR_IN, sr_bus=SR_BUS, interpret=True, **kw))(
                jnp.asarray(clips[0]), jnp.asarray(clips[1])))
        step = tbatch.make_flagship_step(device="cpu", **kw)
        y = step(v, b).numpy()
        y_mf = tbatch.make_flagship_step(
            device="cpu", **{**kw, "resample_backend": "mixfirst"})(v, b)
        diff = np.abs(y.astype(np.int32) - y_j.astype(np.int32))
        db = refs.db(y, y_j)
        print(f"mixfirst_pad step {kw} vs JAX: {db:.1f} dB, {diff.max()} LSB")
        assert y.shape == y_j.shape and diff.max() <= 1 and db <= -80.0
        assert np.abs(y.astype(np.int32) - y_mf.numpy().astype(
            np.int32)).max() <= 1
        return
    step = tbatch.make_flagship_step(device="cpu", **kw)
    assert step.iir_backend == "scan" and not step.fold
    y = step(v, b).numpy()
    diff = np.abs(y.astype(np.int32) - y_jax_scan.astype(np.int32))
    db = refs.db(y, y_jax_scan)
    print(f"scan step {kw} vs JAX scan step: {db:.1f} dB, {diff.max()} LSB")
    assert diff.max() <= 1 and db <= -80.0


@pytest.mark.parametrize("block", [1, 2, 8])
def test_envelope_block_runs_per_sample(clips, block):
    """The step takes the limiter's envelope_block validation (None or a
    power of two >= 1) and steps per sample, the same function in exact
    arithmetic: the same output as None on both branches. Other values
    are a ConfigError, as in ops.limiter and LimiterFx."""
    v, b = (torch.from_numpy(a) for a in clips)
    for fused in (False, True):
        y = tbatch.make_flagship_step(fused=fused, device="cpu")(v, b)
        y_b = tbatch.make_flagship_step(fused=fused, envelope_block=block,
                                        device="cpu")(v, b)
        assert torch.equal(y, y_b)
    with pytest.raises(ConfigError, match="power of two"):
        tbatch.make_flagship_step(device="cpu", envelope_block=3 * block)


def test_unknown_resample_backend_is_a_config_error():
    """The JAX step runs any string other than its three named fronts
    as the two-track front; the port names the accepted values."""
    for bad in ("mixfrist", "xla", ""):
        with pytest.raises(ConfigError, match="'mixfirst', 'pallas', "
                                              "'rsmix'"):
            tbatch.make_flagship_step(device="cpu", resample_backend=bad)
        with pytest.raises(ConfigError):
            tbatch.FlagshipStep.from_tables(_jax_tables(), device="cpu",
                                            resample_backend=bad)


def test_auto_fused_small_batch_refused(clips):
    """fused=None follows the JAX auto rule: below 128 rows it runs the
    unfused chain, the same computation as fused=False, and not the
    fused one. A clip length that is not a multiple of 441 runs, as in
    the JAX step, through the general banded resample."""
    v, b = (torch.from_numpy(a) for a in clips)
    auto = tbatch.make_flagship_step(device="cpu")
    assert auto.fused is None
    y = auto(v, b)
    assert torch.equal(y, tbatch.make_flagship_step(fused=False,
                                                    device="cpu")(v, b))
    assert not torch.equal(y, tbatch.make_flagship_step(fused=True,
                                                        device="cpu")(v, b))
    y_odd = tbatch.make_flagship_step(fused=True, device="cpu")(
        v[:, :N_IN - 1], b[:, :N_IN - 1])
    assert y_odd.shape == (B, -(-(N_IN - 1) * 160 // 441))


def test_bench_takes_the_root_bench_keys(monkeypatch):
    """The port's bench accepts the root bench.py's keys; values the
    step refuses raise its typed error before the device check, and an
    unknown key exits naming the known ones."""
    from xmtpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(iir_backend="scan")  # runs: it reaches the device check
    with pytest.raises(ConfigError, match="iir_backend"):
        bench.main(iir_backend="xla")
    with pytest.raises(ConfigError, match="power of two"):
        bench.main(envelope_block=3)
    with pytest.raises(ConfigError, match="accepted"):
        bench.main(resample_backend="mixfrist")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(resample_backend="rsmix", limiter_fuse=0,
                   envelope_block=1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "xmtpu_torch.bench",
                          "--resample_backnd=rsmix"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "limiter_fuse" in out.stderr


def _recording_eq_env(monkeypatch) -> list:
    """Record the step's calls of the eq_env kernel's wrapper."""
    calls = []
    real = tbatch.eq_env

    def rec(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tbatch, "eq_env", rec)
    return calls


def test_lti_fold_off_refused_only_on_fused_branch(clips, monkeypatch):
    """As in the JAX step, lti_fold only changes the fused branch: with
    fused=False it runs the unfused chain; on the fused branch (fused=
    True, or fused=None from 128 rows up) it runs the unfolded chain on
    the eq_env kernel (K6), and no longer raises."""
    calls = _recording_eq_env(monkeypatch)
    v, b = (torch.from_numpy(a) for a in clips)
    y = tbatch.make_flagship_step(fused=False, lti_fold=False,
                                  device="cpu")(v, b)
    assert torch.equal(y, tbatch.make_flagship_step(fused=False,
                                                    device="cpu")(v, b))
    auto = tbatch.make_flagship_step(lti_fold=False, device="cpu")
    assert torch.equal(auto(v, b), y) and not calls
    wide = torch.zeros((128, 441), dtype=torch.int16)
    wide[:, ::3] = 1000
    assert auto(wide, wide).shape == (128, 160)
    assert calls == [(128, 160)]
    step = tbatch.FlagshipStep.from_tables(_jax_tables(), device="cpu",
                                           fused=True, lti_fold=False)
    y_k6 = step(v[:, :4410], b[:, :4410])
    assert calls[-1] == (B, 1600)
    assert torch.equal(y_k6, tbatch.make_flagship_step(
        fused=True, lti_fold=False, device="cpu")(v[:, :4410], b[:, :4410]))


def test_non_truncating_eq_runs_unfolded(clips, monkeypatch):
    """EQ bands whose impulse response does not truncate leave no
    combined IR: flagship_tables returns ir=None and the fused branch
    runs the unfolded chain on the eq_env kernel, the same computation
    as lti_fold=False. (RBJ bands that decay never fail the truncation
    test, so the test makes sos_impulse_np report it.)"""
    v, b = (torch.from_numpy(a[:, :4410].copy()) for a in clips)
    y_ref = tbatch.make_flagship_step(fused=True, lti_fold=False,
                                      device="cpu")(v, b)
    monkeypatch.setattr(tbatch._biquad, "sos_impulse_np",
                        lambda *a, **k: None)
    tables = tbatch.flagship_tables()
    assert tables["ir"] is None
    calls = _recording_eq_env(monkeypatch)
    step = tbatch.make_flagship_step(fused=True, device="cpu")
    assert step.ir is None and not step.fold
    assert torch.equal(step(v, b), y_ref)
    assert calls == [(B, 1600)]


def test_builds_on_cuda_unless_asked(monkeypatch):
    """Without a device argument the step builds on CUDA; with no CUDA
    device it raises the typed error naming device="cpu", never
    building silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match='device="cpu"'):
        tbatch.make_flagship_step()
    with pytest.raises(DeviceError, match='device="cpu"'):
        tbatch.FlagshipStep.from_tables(_jax_tables())
    step = tbatch.make_flagship_step(device="cpu")
    assert step.ir.device.type == "cpu"


def test_unfused_step_vs_jax_step(clips_unfused):
    """The small-batch branch (fused=None below 128 rows): the port's
    CPU step against the JAX step (Pallas interpret mode), both with
    4 IIR and 4 envelope segments per row, and each clip against the
    float64 oracle."""
    from xmtpu.kernels.iir import pick_segments

    v, b = clips_unfused
    assert pick_segments(B, 32000) == 4
    assert pick_segments(B, 32000, lanes=256) == 4
    step_j = jax.jit(xbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS,
                                               interpret=True))
    y_j = np.asarray(step_j(jnp.asarray(v), jnp.asarray(b)))
    y_t = tbatch.make_flagship_step(device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).numpy()
    assert y_t.shape == y_j.shape == (B, 32000) and y_t.dtype == np.int16
    db = refs.db(y_t, y_j)
    print(f"unfused port step vs JAX step: {db:.1f} dB (gate -80, margin "
          f"{-80 - db:.1f} dB)")
    assert db <= -80.0
    ref = tbatch.flagship_oracle_np(v, b, sr_in=SR_IN, sr_bus=SR_BUS)
    for i in range(B):
        dbi = refs.db(y_t[i], ref[i])
        print(f"unfused clip {i}: {dbi:.1f} dB vs float64 oracle")
        assert dbi <= -80.0


def test_unfused_limiter_on_fused_branch_vs_jax(clips):
    """fused=True, limiter_fuse=False: the envelope kernel plus the
    torch curve after the folded convolution."""
    v, b = clips
    step_j = jax.jit(xbatch.make_flagship_step(
        sr_in=SR_IN, sr_bus=SR_BUS, interpret=True, fused=True,
        limiter_fuse=False))
    y_j = np.asarray(step_j(jnp.asarray(v), jnp.asarray(b)))
    y_t = tbatch.make_flagship_step(fused=True, limiter_fuse=False,
                                    device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).numpy()
    db = refs.db(y_t, y_j)
    print(f"limiter_fuse=False step vs JAX step: {db:.1f} dB (gate -80)")
    assert db <= -80.0


def test_port_imports_no_jax():
    """A fresh interpreter imports the port and runs the CPU step (the
    default front, the "pallas" and "rsmix" fronts, the unfolded branch),
    the ragged step and the public effects chain (both limiter forms, an
    11,998-tap folded IR: the partitioned fftconv path on the card)
    without loading jax, jaxlib or the JAX package; so do the public
    resample (the kernel's twin and the strided conv), the mix ops and
    ducking, the matmul DFTs and the scan engine (the effects chain on
    its scan backend and under auto on the CPU, the scan step); so do
    loudness, noise suppression, the WAV codec, the config schema, the
    mixer and the file pipeline (process_file with an ir_wav reverb);
    so do a streaming Session, a SessionPool on both effect engines and
    a PoolServer, each reading a frame; so do the native host runtime
    (its ring), the file-batch runner (``run_batch``, pipelined), the
    command line (``resample``) and the compat handles (a mixer frame,
    the decoder); so do the parallel paths (``xmtpu_torch.parallel``
    with its dryrun: the SP chain on the kernel engine's twins, the
    sharded step); so do ``entry()``, a step built with
    ``interpret=True`` and, where the FFmpeg shim is expected to work, a
    FLAC round trip through ``xmtpu_torch.io``; so do the precision
    rungs (``ops.precision``: the resample ops, K7's twin, the matmul
    DFTs' variants and gauss form), bf16 resampling, the hop-padded
    ``reverb(trim=False, gp=)``, the ``mixfirst_pad`` step and
    ``pick_segments(aligned=True)``."""
    code = (
        "import sys, numpy as np, torch\n"
        "from xmtpu_torch import batch, bench\n"
        "import xmtpu_torch.kernels.envelope, xmtpu_torch.kernels.fftconv\n"
        "from xmtpu_torch.kernels import eq_env, resample, rsmix\n"
        "v = np.zeros((2, 22050), np.int16); v[:, ::7] = 3000\n"
        "y = batch.make_flagship_step(fused=True, device='cpu')("
        "torch.from_numpy(v), torch.from_numpy(v))\n"
        "assert y.shape == (2, 8000), y.shape\n"
        "s = torch.from_numpy(v[:, :4410].copy())\n"
        "for kw in ({'resample_backend': 'pallas'}, {'resample_backend': "
        "'rsmix'}, {'lti_fold': False}):\n"
        "    y = batch.make_flagship_step(fused=True, device='cpu', **kw)(s, s)\n"
        "    assert y.shape == (2, 1600), (kw, y.shape)\n"
        "y = batch.make_batch_step(device='cpu')(s, s, [4410, 3000])\n"
        "assert y.shape == (2, 1600) and not y[1, 1089:].any()\n"
        "import xmtpu_torch.api, xmtpu_torch.graph.fx\n"
        "x = np.zeros((2, 9600, 2), np.float32); x[:, ::5] = 0.9\n"
        "for lim in ({}, {'linked_fuse': True}):\n"
        "    y = xmtpu_torch.api.effects(x, 48000, [\n"
        "        {'name': 'equalizer', 'bands': [{'freq_hz': 1000.0}]},\n"
        "        {'name': 'reverb', 'ir_seconds': 0.25},\n"
        "        {'name': 'limiter', **lim}], device='cpu')\n"
        "    assert y.shape == x.shape, y.shape\n"
        "for be in ('scan', None):\n"
        "    y = xmtpu_torch.api.effects(x, 48000, [\n"
        "        {'name': 'equalizer', 'bands': [{'freq_hz': 1000.0}]},\n"
        "        {'name': 'reverb', 'ir_seconds': 0.05},\n"
        "        {'name': 'limiter'}], device='cpu', backend=be,\n"
        "        block_size=4000)\n"
        "    assert y.shape == x.shape, y.shape\n"
        "y = batch.make_flagship_step(iir_backend='scan', device='cpu')(s, s)\n"
        "assert y.shape == (2, 1600), y.shape\n"
        "import xmtpu_torch.ops.mix as mix, xmtpu_torch.ops.fftmm as fftmm\n"
        "y = xmtpu_torch.api.resample(v[0], 44100, 16000, device='cpu')\n"
        "assert y.shape == (8000,) and y.dtype == np.int16, y.shape\n"
        "y = xmtpu_torch.resample(x[0], 16000, 48000, device='cpu')\n"
        "assert y.shape == (28800, 2) and y.dtype == np.float32, y.shape\n"
        "g = mix.duck_gain(torch.from_numpy(x[0].T.copy()), 48000)\n"
        "assert g.shape == (2, 9600) and bool((g <= 1.0).all())\n"
        "m, _ = mix.peak_normalize(mix.mix_sum(torch.from_numpy(x)), 0.5)\n"
        "y = fftmm.fir_convolve_os_mxu(torch.from_numpy(x[0].T.copy()),\n"
        "    np.ones(64), 1024)\n"
        "assert y.shape == (2, 9600), y.shape\n"
        "import tempfile, os\n"
        "import xmtpu_torch.io, xmtpu_torch.config, xmtpu_torch.ops.ns\n"
        "import xmtpu_torch.ops.loudness, xmtpu_torch.graph.mixer\n"
        "import xmtpu_torch.graph.pipeline\n"
        "from xmtpu_torch.ops import loudness, ns\n"
        "l = loudness.measure_lufs(x[0].T, 48000, device='cpu')\n"
        "assert l.dim() == 0 and bool(torch.isfinite(l)), l\n"
        "y = ns.suppress(x[0].T, device='cpu')\n"
        "assert y.shape == (2, 9600), y.shape\n"
        "d = tempfile.mkdtemp()\n"
        "xmtpu_torch.io.write_wav(os.path.join(d, 'v.wav'), v[0], 44100)\n"
        "xmtpu_torch.io.write_wav(os.path.join(d, 'ir.wav'), v[0, :64], 44100)\n"
        "cfg = xmtpu_torch.config.config_from_dict({'sampleRate': 48000,\n"
        "    'normalize': 'lufs', 'normalizeTargetDb': -16.0,\n"
        "    'tracks': [{'url': os.path.join(d, 'v.wav')}],\n"
        "    'effects': [{'name': 'noise_suppression'}, {'name': 'reverb',\n"
        "        'ir_wav': os.path.join(d, 'ir.wav')}],\n"
        "    'masterEffects': [{'name': 'limiter'}], 'blockSize': 8192})\n"
        "xmtpu_torch.process_file(None, cfg, os.path.join(d, 'o.wav'),\n"
        "                         device='cpu')\n"
        "o, sr = xmtpu_torch.io.read_wav(os.path.join(d, 'o.wav'))\n"
        "assert sr == 48000 and o.shape == (24000, 1), o.shape\n"
        "scfg = xmtpu_torch.config.config_from_dict({'sampleRate': 16000,\n"
        "    'normalize': None, 'tracks': [{'url': 'v'}],\n"
        "    'effects': [{'name': 'noise_suppression'}],\n"
        "    'masterEffects': [{'name': 'limiter'}]})\n"
        "src = {'v': (v[0].copy(), 44100)}\n"
        "f = xmtpu_torch.Session(scfg, sources=src, device='cpu').read()\n"
        "assert f.shape == (320, 1) and f.dtype == np.int16, f.shape\n"
        "for be in ('scan', 'pallas'):\n"
        "    pool = xmtpu_torch.SessionPool(scfg, 2, sources=[src, src],\n"
        "                                   effects_backend=be, device='cpu')\n"
        "    assert pool.read(1).shape == (2, 320, 1)\n"
        "srv = xmtpu_torch.PoolServer(n_slots=2, device='cpu')\n"
        "sid = srv.open(scfg, src)\n"
        "assert srv.read(sid, 1).shape == (320, 1)\n"
        "from xmtpu_torch import cli, compat, native, runner\n"
        "f = native.Fifo(8); assert f.write(b'abc') == 3 and f.read(3) == b'abc'\n"
        "rep = runner.run_batch([{'voice': os.path.join(d, 'v.wav'),\n"
        "    'out': os.path.join(d, 'b.wav')}], device='cpu')\n"
        "assert rep.done == 1 and not rep.failed, rep\n"
        "assert cli.main(['resample', os.path.join(d, 'v.wav'),\n"
        "    os.path.join(d, 'r.wav'), '--rate', '16000', '--device',\n"
        "    'cpu']) == 0\n"
        "h = compat.XmAudioUtils(device='cpu')\n"
        "import json\n"
        "h.mixer_init(json.dumps({'sampleRate': 16000, 'tracks': [{'url':\n"
        "    os.path.join(d, 'r.wav')}]}))\n"
        "assert h.mixer_get_frame().shape == (320, 1)\n"
        "h.decoder_create(os.path.join(d, 'r.wav'))\n"
        "assert h.decoder_get_pcm(10).shape == (10, 1)\n"
        "import xmtpu_torch.parallel, xmtpu_torch.parallel.dryrun\n"
        "mesh = xmtpu_torch.parallel.Mesh(['cpu'] * 2, ('sp',))\n"
        "y = xmtpu_torch.parallel.sp_effects_chain(torch.from_numpy(\n"
        "    x[0].T.copy()), 48000, mesh, [{'freq_hz': 1000.0}],\n"
        "    np.ones(8, np.float32) / 8, engine='kernel')\n"
        "assert y.shape == (2, 9600), y.shape\n"
        "mesh, _ = batch.shard_over_batch(2, device='cpu')\n"
        "y = batch.flagship_step_sharded(mesh)(s, s)\n"
        "assert y.shape == (2, 1600), y.shape\n"
        "from xmtpu_torch import entry\n"
        "fn, ex = entry.entry(device='cpu')\n"
        "assert fn(*ex).shape == (2, 16000)\n"
        "y = batch.make_flagship_step(fused=True, interpret=True,\n"
        "                             device='cpu')(s, s)\n"
        "assert y.shape == (2, 1600), y.shape\n"
        "if xmtpu_torch.io.HAVE_FFMPEG:\n"
        "    xmtpu_torch.io.encode_audio(os.path.join(d, 'v.flac'), v[0],\n"
        "                                44100)\n"
        "    with xmtpu_torch.io.open_audio(os.path.join(d, 'v.flac')) as f:\n"
        "        assert np.array_equal(f.read_all()[:, 0], v[0])\n"
        "from xmtpu_torch.ops import precision, resample as ores\n"
        "from xmtpu_torch.ops import reverb as orv\n"
        "from xmtpu_torch.kernels import iir\n"
        "xr = torch.ones((2, 4410))\n"
        "for p in ('high', 'default', 'bfloat16_3x'):\n"
        "    assert ores.polyphase_resample(xr, 44100, 16000,\n"
        "        precision=p).shape == (2, 1600)\n"
        "    assert resample.resample(xr, 44100, 16000,\n"
        "        precision=p).shape == (2, 1600)\n"
        "assert ores.polyphase_resample(xr, 44100, 16000,\n"
        "    dtype=torch.bfloat16).dtype == torch.bfloat16\n"
        "y = fftmm.fir_convolve_os_mxu(torch.from_numpy(x[0].T.copy()),\n"
        "    np.ones(64), 1024, precision='high', variant='four_step',\n"
        "    gauss=True)\n"
        "assert y.shape == (2, 9600), y.shape\n"
        "y = orv.reverb(torch.from_numpy(x[0].T.copy()), np.ones(64),\n"
        "    dry=0.0, trim=False, gp=2, block=1024)\n"
        "assert y.shape == (2, 9984), y.shape\n"
        "y = batch.make_flagship_step(fused=True, device='cpu',\n"
        "    resample_backend='mixfirst_pad')(s, s)\n"
        "assert y.shape == (2, 1600), y.shape\n"
        "assert iir.pick_segments(16, 480000, lanes=256, aligned=True) == 15\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'xmtpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_unfused_step_imports_no_jax():
    """A fresh interpreter runs the segmented small-batch step on the
    CPU without loading jax, jaxlib or the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "from xmtpu_torch import batch\n"
        "from xmtpu_torch.kernels import envelope, iir\n"
        "v = np.zeros((2, 88200), np.int16); v[:, ::5] = 2000\n"
        "step = batch.make_flagship_step(device='cpu')\n"
        "y = step(torch.from_numpy(v), torch.from_numpy(v))\n"
        "assert y.shape == (2, 32000), y.shape\n"
        "assert iir.pick_segments(2, 32000) == 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'xmtpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
