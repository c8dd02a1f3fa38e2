"""Parity of the port's unfolded fused branch and ragged-length step
with the JAX package's, on the CPU (``device="cpu"``: the kernels'
plain twins; the JAX steps in Pallas interpret mode).

- ``make_flagship_step(fused=True, lti_fold=False)``: the reverb with
  its wet/dry mix on the fftconv kernel, then EQ + envelope on the
  eq_env kernel (K6) and the torch curve; 2 clips of 0.5 s (8000 bus
  samples), so that the twin's time loop stays at a few seconds;
- ``make_batch_step`` on ragged lengths (one full clip of 0.5 s, one of
  0.34 s zero-padded to it), with ``fused`` and ``lti_fold`` each True
  and False: the folded branch (fftconv + the envelope + torch curve),
  the unfolded one (K6) and the unfused one (IIR, fftconv, limiter).

Tolerances: against the JAX step and the float64 oracle, -80 dB (the
chain's gate), within each clip's output length; past it, every sample
exactly 0 on both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu_torch import batch as tbatch
from xmtpu_torch.utils.errors import DeviceError

from . import torch_refs as refs

B, N_IN = 2, 22050
LENGTHS = (22050, 15000)  # -> 8000 and 5443 bus samples


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(20261019)
    v = (rng.standard_normal((B, N_IN)) * 8000).astype(np.int16)
    b = (rng.standard_normal((B, N_IN)) * 6000).astype(np.int16)
    return v, b


def test_unfolded_fused_branch_vs_jax(clips):
    v, b = clips
    kw = dict(fused=True, lti_fold=False)
    y_j = np.asarray(jax.jit(xbatch.make_flagship_step(interpret=True,
                                                       **kw))(
        jnp.asarray(v), jnp.asarray(b)))
    y_t = tbatch.make_flagship_step(device="cpu", **kw)(
        torch.from_numpy(v), torch.from_numpy(b)).numpy()
    assert y_t.shape == y_j.shape == (B, 8000) and y_t.dtype == np.int16
    db = refs.db(y_t, y_j)
    ref = tbatch.flagship_oracle_np(v, b)
    dbo = [refs.db(y_t[i], ref[i]) for i in range(B)]
    print(f"unfolded fused branch: {db:.1f} dB vs the JAX step, clips "
          + ", ".join(f"{d:.1f}" for d in dbo) + " dB vs float64 (gate -80)")
    assert db <= -80.0 and max(dbo) <= -80.0


@pytest.mark.parametrize("fused,lti_fold", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_batch_step_vs_jax(clips, fused, lti_fold):
    v, b = (a.copy() for a in clips)
    for i, n in enumerate(LENGTHS):  # the runner zero-pads short clips
        v[i, n:] = 0
        b[i, n:] = 0
    lengths = np.asarray(LENGTHS)
    y_j = np.asarray(jax.jit(xbatch.make_batch_step(
        interpret=True, fused=fused, lti_fold=lti_fold))(
        jnp.asarray(v), jnp.asarray(b), jnp.asarray(lengths)))
    y_t = tbatch.make_batch_step(device="cpu", fused=fused,
                                 lti_fold=lti_fold)(
        torch.from_numpy(v), torch.from_numpy(b),
        torch.from_numpy(lengths)).numpy()
    assert y_t.shape == y_j.shape == (B, 8000) and y_t.dtype == np.int16
    dbs = []
    for i, n in enumerate(LENGTHS):
        m = -(-n * 160 // 441)
        assert not y_t[i, m:].any() and not y_j[i, m:].any()
        ref = tbatch.flagship_oracle_np(v[i, :n], b[i, :n])
        assert ref.shape == (m,)
        dbs.append((refs.db(y_t[i, :m], y_j[i, :m]),
                    refs.db(y_t[i, :m], ref)))
    print(f"batch step fused={fused} lti_fold={lti_fold}: clips "
          + ", ".join(f"{a:.1f} / {o:.1f}" for a, o in dbs)
          + " dB vs the JAX step / float64 (gate -80)")
    assert max(max(d) for d in dbs) <= -80.0


def test_batch_step_builds_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match='device="cpu"'):
        tbatch.make_batch_step()
    step = tbatch.make_batch_step(device="cpu")
    assert isinstance(step, torch.nn.Module) and step.fused is None
    assert step.reverb_ir.device.type == "cpu"
