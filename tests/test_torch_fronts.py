"""Parity of the port's flagship step with the JAX package's on its
``resample_backend`` fronts, on the CPU (``device="cpu"``: the kernels'
plain twins; the JAX step in Pallas interpret mode):

- ``"pallas"``: both tracks through the resample kernel (K7), faded and
  mixed, on both branches, at an aligned and a non-aligned length;
- ``"rsmix"``: the fused int16 front (K8) on both branches, and at a
  length its gate refuses, where both packages fall back to the
  two-track front (the port's on K7, the JAX package's on XLA's banded
  resample);
- ``"mixfirst"`` at a non-aligned length (the general banded resample).

Shape: 2 clips of 0.5 s (22050 int16 samples at 44.1 kHz, 8000 at the
bus); the non-aligned length is 22000 (7982 bus samples). At 2 rows
the JAX auto rule would pick the unfused branch; each case names its
branch.

Tolerance: the int16 output against the JAX step and each clip against
the float64 oracle, -80 dB (the chain's gate; the margins are printed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu_torch import batch as tbatch

from . import torch_refs as refs

B, N_IN = 2, 22050


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(20261018)
    v = (rng.standard_normal((B, N_IN)) * 8000).astype(np.int16)
    b = (np.sin(np.arange(N_IN) / 30.0)[None].repeat(B, 0) * 7000
         + rng.standard_normal((B, N_IN)) * 500).astype(np.int16)
    return v, b


def _check_vs_jax_and_oracle(v, b, label, **kw):
    y_j = np.asarray(jax.jit(xbatch.make_flagship_step(interpret=True,
                                                       **kw))(
        jnp.asarray(v), jnp.asarray(b)))
    y_t = tbatch.make_flagship_step(device="cpu", **kw)(
        torch.from_numpy(v), torch.from_numpy(b)).numpy()
    assert y_t.shape == y_j.shape == (B, -(-v.shape[1] * 160 // 441))
    assert y_t.dtype == np.int16
    db = refs.db(y_t, y_j)
    ref = tbatch.flagship_oracle_np(v, b)
    dbo = [refs.db(y_t[i], ref[i]) for i in range(B)]
    print(f"{label}: {db:.1f} dB vs the JAX step, clips "
          + ", ".join(f"{d:.1f}" for d in dbo)
          + " dB vs float64 (gate -80)")
    assert db <= -80.0 and max(dbo) <= -80.0


@pytest.mark.parametrize("fused", [True, False])
def test_pallas_front(clips, fused):
    _check_vs_jax_and_oracle(*clips, f"pallas front, fused={fused}",
                             resample_backend="pallas", fused=fused)


def test_pallas_front_any_length(clips):
    v, b = (a[:, :22000].copy() for a in clips)
    _check_vs_jax_and_oracle(v, b, "pallas front, 22000 samples",
                             resample_backend="pallas", fused=True)


@pytest.mark.parametrize("fused", [True, False])
def test_rsmix_front(clips, fused):
    assert tbatch.resample_mix_supported(N_IN, B, 44100, 16000)
    _check_vs_jax_and_oracle(*clips, f"rsmix front, fused={fused}",
                             resample_backend="rsmix", fused=fused)


def test_rsmix_front_falls_back(clips, monkeypatch):
    """At a length the fused front's gate refuses, both packages run the
    two-track front; the port's resamples on K7's wrapper (as on the
    "pallas" front), and the fused front's wrapper is not called."""
    v, b = (a[:, :22000].copy() for a in clips)
    assert not tbatch.resample_mix_supported(22000, B, 44100, 16000)

    def refuse(*a, **k):
        raise AssertionError("resample_mix called past its gate")

    calls = []
    resample = tbatch.resample_kernel

    def record(x, *a, **k):
        calls.append(tuple(x.shape))
        return resample(x, *a, **k)

    monkeypatch.setattr(tbatch, "resample_mix", refuse)
    monkeypatch.setattr(tbatch, "resample_kernel", record)
    _check_vs_jax_and_oracle(v, b, "rsmix front fallback, 22000 samples",
                             resample_backend="rsmix", fused=True)
    assert calls == [(2 * B, 22000)]


def test_mixfirst_any_length(clips):
    v, b = (a[:, :22000].copy() for a in clips)
    _check_vs_jax_and_oracle(v, b, "mixfirst, 22000 samples", fused=True)


def test_two_track_front_returns_no_ramp(clips):
    """The two-track and fused fronts apply the fade themselves: no
    deferred ramp; the mixfirst front defers it."""
    v, b = (torch.from_numpy(a) for a in clips)
    for backend, deferred in (("pallas", False), ("rsmix", False),
                              ("mixfirst", True)):
        step = tbatch.make_flagship_step(device="cpu", fused=True,
                                         resample_backend=backend)
        m, scale, ramp = step.front(v, b)
        assert m.shape == (B, 8000) and scale.shape == (B,)
        assert (ramp is not None) == deferred
