"""Parity of the port's flagship step (``xmtpu_torch.batch``) with the
JAX package's (``xmtpu.batch``), on the CPU.

One shape: 2 clips of 22050 int16 samples (0.5 s at 44.1 kHz, 50
frames of 441) -> 8000 bus samples. At 2 rows x 8000 samples
``pick_segments`` is 1, so the JAX chain with ``fused=True`` runs the
same kernels the port replaces: the fftconv convolution and the
unsegmented fused limiter (Pallas in interpret mode).

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
from xmtpu_torch.utils.errors import NotPortedError

from .conftest import rms_db

SR_IN, SR_BUS = 44100, 16000
B, N_IN = 2, 22050
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
    step = tbatch.make_flagship_step(sr_in=SR_IN, sr_bus=SR_BUS, fused=True)
    return step(torch.from_numpy(v), torch.from_numpy(b)).numpy()


def _jax_tables() -> dict:
    """The same host tables, built with the JAX package's code."""
    sos = xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR_BUS)
    ir = xbatch._reverb.synthetic_ir(0.25, SR_BUS).astype("float32")
    t = xresample.aligned_tables(xresample._make_plan(160, 441, 24, 9.0))
    return {
        "sos": sos, "ir": xbatch._combined_ir(sos, ir, 0.25, 0.75),
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
    db = rms_db((y_port - y_jax.astype(np.float64)) / 32768.0,
                y_jax.astype(np.float64) / 32768.0)
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
        db = rms_db((y_port[i] - ref[i].astype(np.float64)) / 32768.0,
                    ref[i].astype(np.float64) / 32768.0)
        print(f"clip {i}: {db:.1f} dB vs float64 oracle (gate -80, "
              f"margin {-80 - db:.1f} dB)")
        assert db <= -80.0


def test_from_tables_matches_own_tables(clips, y_port):
    """A step built from the JAX package's tables computes the same
    output as the port's own make_flagship_step."""
    v, b = clips
    step = tbatch.FlagshipStep.from_tables(_jax_tables(), device="cpu")
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
    step = tbatch.make_flagship_step(fused=True)
    m, _, _ = step.front(*(torch.from_numpy(a) for a in clips))
    assert m.dtype == torch.float32 and torch.equal(m, m_ref)


@pytest.mark.parametrize("kw", [
    {"iir_backend": "scan"},
    {"resample_backend": "pallas"},
    {"resample_backend": "rsmix"},
    {"resample_backend": "mixfirst_pad"},
    {"fused": False},
    {"lti_fold": False},
    {"limiter_fuse": False},
    {"envelope_block": 8},
])
def test_unported_options_refused(kw):
    with pytest.raises(NotPortedError, match="ROADMAP"):
        tbatch.make_flagship_step(**kw)


def test_auto_fused_small_batch_refused(clips):
    """fused=None follows the JAX auto rule, which picks the unported
    unfused chain below 128 rows: refused, not silently fused."""
    v, b = clips
    step = tbatch.make_flagship_step()
    with pytest.raises(NotPortedError, match="128"):
        step(torch.from_numpy(v), torch.from_numpy(b))
    unaligned = torch.zeros((B, N_IN - 1), dtype=torch.int16)
    with pytest.raises(NotPortedError, match="multiple of 441"):
        tbatch.make_flagship_step(fused=True)(unaligned, unaligned)


def test_port_imports_no_jax():
    """A fresh interpreter imports the port and runs the CPU step
    without loading jax, jaxlib or the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "from xmtpu_torch import batch, bench\n"
        "import xmtpu_torch.kernels.envelope, xmtpu_torch.kernels.fftconv\n"
        "v = np.zeros((2, 22050), np.int16); v[:, ::7] = 3000\n"
        "y = batch.make_flagship_step(fused=True)(torch.from_numpy(v),"
        " torch.from_numpy(v))\n"
        "assert y.shape == (2, 8000), y.shape\n"
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
