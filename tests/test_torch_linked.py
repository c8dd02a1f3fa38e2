"""Parity of the port's channel-linked limiter
(``xmtpu_torch.kernels.envelope.linked_limiter``: pass A on the
envelope-only kernel, the decay-window dot and the (+, *) chain for the
exact per-segment init, pass B on the kernel's gain form) and of
``ops.limiter.limiter(linked_fuse=True)`` with the JAX package's
``linked_limiter_pallas`` / ``ops.limiter.limiter`` (Pallas in interpret
mode), on the CPU.

On a CPU tensor the wrappers run the kernel's plain torch twin; the CUDA
kernel itself is compared with the twin on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 2 stereo clips x 32768 samples at 48 kHz, where
``pick_segments(2, 32768, lanes=256)`` is 8 (16384-sample halves: 4),
with a hot burst that drives the knee and the ceiling clamp.

Tolerances:
- against the JAX kernels: -100 dB on y (float32 on both sides; the JAX
  default block-8 lookahead reassociates the recurrences, the decay
  window's dot and sum order differ, exp/log round differently), final
  states to rtol 1e-5;
- the two forms of the twin (the gain form and the envelope form plus
  ``curve_gain``): bit-exact;
- the limiter op against the float64 oracle: -80 dB (the chain gate).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels.envelope import linked_limiter_pallas
from xmtpu.ops import limiter as xlimiter
from xmtpu_torch.graph import fx as tfx
from xmtpu_torch.kernels import envelope
from xmtpu_torch.ops import limiter
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

B, CH, N, SR = 2, 2, 32768, 48000
K_REL = limiter._release_coeff(100.0, SR)
C_ATT = limiter._attack_coeff(1.0, SR)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(41)
    x = (0.5 * rng.standard_normal((B, CH, N))).astype(np.float32)
    x[0, :, 1000:1200] *= 6.0
    x[1, :, 20000:20300] *= 4.0  # a burst across a segment boundary
    return x


def _jax(x, **kw):
    y, st = linked_limiter_pallas(jnp.asarray(x), K_REL, C_ATT, -3.0,
                                  interpret=True, **kw)
    return np.asarray(y), tuple(np.asarray(s) for s in st)


def _check(y_t, st_t, y_j, st_j, what):
    db = refs.db(y_t, y_j)
    print(f"linked limiter twin vs Pallas ({what}): {db:.1f} dB (gate -100)")
    assert y_t.shape == y_j.shape and db <= -100.0
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5)


@pytest.mark.parametrize("segments", [None, 1])
def test_linked_twin_vs_pallas(x, segments):
    """Segmented (S = 8 by the JAX rule) and one gain-form pass."""
    if segments is None:
        assert envelope.pick_segments(B, N, lanes=256) == 8
    y_j, st_j = _jax(x, segments=segments)
    y_t, st_t = envelope.linked_limiter(torch.from_numpy(x), K_REL, C_ATT,
                                        -3.0, segments=segments)
    _check(y_t.numpy(), st_t, y_j, st_j, f"segments={segments}")
    assert np.abs(y_t.numpy()).max() <= 1.0


def test_linked_carried_state_over_halves(x):
    """Two halves (S = 4 each) with the first half's state carried into
    the second equal the whole clip through the JAX kernel."""
    y_j, st_j = _jax(x)
    xt = torch.from_numpy(x)
    y1, st = envelope.linked_limiter(xt[..., :N // 2].contiguous(), K_REL,
                                     C_ATT, -3.0)
    y2, st2 = envelope.linked_limiter(xt[..., N // 2:].contiguous(), K_REL,
                                      C_ATT, -3.0, init=st)
    _check(torch.cat([y1, y2], -1).numpy(), st2, y_j, st_j, "two halves")


def test_linked_n_valid_and_compressor_curve(x):
    """n_valid trims a padded tail before the detector (bit-equal to the
    unpadded clip); a finite ratio with makeup against the JAX kernel."""
    xt = torch.from_numpy(x)
    pad = torch.cat([xt, torch.full((B, CH, 512), 9.9)], -1)
    y_ref, st_ref = envelope.linked_limiter(xt, K_REL, C_ATT, -3.0)
    y_nv, st_nv = envelope.linked_limiter(pad, K_REL, C_ATT, -3.0, n_valid=N)
    assert torch.equal(y_nv, y_ref)
    assert all(torch.equal(a, b) for a, b in zip(st_nv, st_ref))
    kw = dict(knee_db=4.0, ratio=4.0, makeup_db=2.0, ceiling_db=-0.5)
    y_j, st_j = linked_limiter_pallas(jnp.asarray(x), K_REL, C_ATT, -10.0,
                                      interpret=True, **kw)
    y_t, st_t = envelope.linked_limiter(xt, K_REL, C_ATT, -10.0, **kw)
    _check(y_t.numpy(), st_t, np.asarray(y_j),
           tuple(np.asarray(s) for s in st_j), "compressor curve")
    with pytest.raises(ValueError, match="n_valid"):
        envelope.linked_limiter(xt, K_REL, C_ATT, -3.0, n_valid=N + 1)
    with pytest.raises(ValueError, match="does not divide"):
        envelope.linked_limiter(xt, K_REL, C_ATT, -3.0, segments=3)
    with pytest.raises(ValueError, match="ch, n"):
        envelope.linked_limiter(xt[0, 0], K_REL, C_ATT, -3.0)


def test_limiter_op_linked_fuse_vs_jax(x):
    """ops.limiter.limiter(linked_fuse=True) against the JAX op on its
    Pallas backend, and both against the float64 oracle."""
    y_j, st_j = xlimiter.limiter(jnp.asarray(x), SR, threshold_db=-3.0,
                                 backend="pallas_interpret",
                                 linked_fuse=True)
    y_t, st_t = limiter.limiter(torch.from_numpy(x), SR, threshold_db=-3.0,
                                linked_fuse=True)
    _check(y_t.numpy(), st_t, np.asarray(y_j),
           tuple(np.asarray(s) for s in st_j), "ops.limiter")
    ref, _ = limiter.limiter_np(x, SR, threshold_db=-3.0)
    db = refs.db(y_t.numpy(), ref)
    print(f"linked limiter op vs float64 oracle: {db:.1f} dB (gate -80)")
    assert db <= -80.0


def test_gain_form_twin_and_modes(x):
    """The gain form of the twin is the envelope form followed by
    curve_gain, bit for bit; every curve_mode outside the pass's two
    forms raises (the JAX "apply" form is limiter(), not a pass form),
    as do a mode without its curve and a curve without its mode."""
    d = torch.from_numpy(np.abs(x[0]).copy())
    init = torch.tensor([[0.2, 0.1], [0.3, 0.05]])
    ktab = torch.from_numpy(envelope.seg_ktab(K_REL, N))
    ecorr = torch.tensor([0.4, 0.9])
    curve = envelope.curve_of(-3.0)
    g, zf = envelope.envelope_pass(d, 0.0, C_ATT, init, ktab, ecorr,
                                   curve=curve, curve_mode="gain")
    e2, zf_e = envelope.envelope_pass(d, 0.0, C_ATT, init, ktab, ecorr)
    assert torch.equal(g, envelope.curve_gain(e2, envelope.curve_consts(
        curve))) and torch.equal(zf, zf_e)
    for bad in ("Gain", "apply", "applied", ""):
        with pytest.raises(ValueError, match="forms"):
            envelope.envelope_pass(d, K_REL, C_ATT, init, curve=curve,
                                   curve_mode=bad)
    with pytest.raises(ValueError, match="needs the curve"):
        envelope.envelope_pass(d, K_REL, C_ATT, init, curve_mode="gain")
    with pytest.raises(ValueError, match="takes no curve"):
        envelope.envelope_plain(d, K_REL, C_ATT, init, curve=curve)


@pytest.mark.parametrize("block", [1, 2, 8])
def test_envelope_block_runs_per_sample(x, block):
    """envelope_block takes the JAX validation (a power of two >= 1) and
    runs the per-sample kernels: the same output as None, both limiter
    forms; through the chain's LimiterFx too."""
    xt = torch.from_numpy(x)
    for linked in (False, True):
        y0, _ = limiter.limiter(xt, SR, linked_fuse=linked)
        y1, _ = limiter.limiter(xt, SR, envelope_block=block,
                                linked_fuse=linked)
        assert torch.equal(y0, y1)
    (lim,) = tfx.build_chain(SR, [{"name": "limiter", "params": {
        "envelope_block": block}}])
    assert lim.kw["envelope_block"] == block


@pytest.mark.parametrize("block", [3, 0, -4, 12])
def test_envelope_block_refuses_non_powers_of_two(x, block):
    with pytest.raises(ConfigError, match="power of two"):
        limiter.limiter(torch.from_numpy(x), SR, envelope_block=block)
    with pytest.raises(ConfigError, match="power of two"):
        tfx.build_chain(SR, [{"name": "limiter", "params": {
            "envelope_block": block}}])


@pytest.mark.parametrize("backend", ["scan", "oracle", "xla"])
def test_linked_fuse_on_a_scan_backend_is_a_config_error(backend):
    """The JAX chain silently ignores linked_fuse on its scan backend;
    the port refuses the combination (the scan engine runs without the
    flag, tests/test_torch_scan.py)."""
    with pytest.raises(ConfigError, match="linked_fuse"):
        tfx.build_chain(SR, [{"name": "limiter", "params": {
            "linked_fuse": True, "backend": backend}}])
    with pytest.raises(ConfigError, match="linked_fuse"):
        tfx.build_chain(SR, [{"name": "compressor", "params": {
            "linked_fuse": True}}], default_backend=backend)
