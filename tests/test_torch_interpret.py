"""``interpret=`` on the port's step factories and on ``ops.reverb.reverb``
(the JAX package's Pallas interpret mode): None and False let the device
decide, True means the kernels' plain twins and runs on the CPU only.

One size: two int16 clips of 0.5 s at 44.1 kHz (a 16 kHz bus). On the
CPU the three values give the same output bit for bit; True anywhere
else raises ``ConfigError`` before a table is built or a sample moves;
the port's fused step with ``interpret=True`` against the JAX step built
the same way (jitted, interpret mode): -80 dB at the int16 output;
``run_batch(step_kw={"interpret": True})`` runs on the CPU and raises on
``cuda`` before it decodes a clip.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu_torch import batch as tbatch
from xmtpu_torch import runner
from xmtpu_torch.io import write_wav
from xmtpu_torch.ops import reverb as treverb
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

SR_IN, N = 44100, 22050


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(16)
    v = (rng.standard_normal((2, N)) * 9000).astype(np.int16)
    b = (np.sin(np.arange(N) / 50.0)[None].repeat(2, 0) * 12000
         ).astype(np.int16)
    return v, b


def _flagship(device, interpret, v, b):
    return tbatch.make_flagship_step(interpret=interpret, device=device)(v, b)


def _batch(device, interpret, v, b):
    return tbatch.make_batch_step(interpret=interpret, device=device)(
        v, b, [N, N - 5000])


def _sharded(device, interpret, v, b):
    if device == "cpu":
        mesh, _ = tbatch.shard_over_batch(2, device="cpu")
    else:  # the devices of a mesh of cards (None: no mesh of its own)
        mesh = types.SimpleNamespace(devices=np.array(
            [torch.device(device or "cuda")] * 2, dtype=object))
    return tbatch.flagship_step_sharded(mesh, interpret=interpret)(v, b)


def _reverb(device, interpret, v, b):
    x = v.to(torch.float32) / 32768.0
    if device != "cpu":  # a tensor that is not on the CPU
        x = torch.empty(x.shape, device="meta")
    return treverb.reverb(x, treverb.synthetic_ir(0.05, 16000), wet=0.3,
                          dry=0.7, interpret=interpret)


@pytest.mark.parametrize("fn", [_flagship, _batch, _sharded, _reverb],
                         ids=["make_flagship_step", "make_batch_step",
                              "flagship_step_sharded", "reverb"])
def test_interpret_rule(fn, clips, monkeypatch):
    v, b = (torch.from_numpy(a) for a in clips)
    outs = [fn("cpu", it, v, b) for it in (None, False, True)]
    assert outs[0].device.type == "cpu"
    assert all(torch.equal(o, outs[0]) for o in outs[1:])

    def built(*a, **k):
        raise AssertionError("built or launched before the refusal")

    monkeypatch.setattr(tbatch, "flagship_tables", built)
    monkeypatch.setattr(treverb, "fir_convolve", built)
    for device in ("cuda", None):
        with pytest.raises(ConfigError, match="CPU only"):
            fn(device, True, v, b)
    if fn is _reverb:
        with pytest.raises(ConfigError, match="backend='pallas' only"):
            treverb.reverb(v.float(), np.ones(4), interpret=True,
                           backend="xla")


def test_fused_interpret_step_vs_jax(clips):
    v, b = clips
    step_j = jax.jit(xbatch.make_flagship_step(sr_in=SR_IN, interpret=True,
                                               fused=True))
    y_j = np.asarray(step_j(jnp.asarray(v), jnp.asarray(b)))
    y_t = tbatch.make_flagship_step(sr_in=SR_IN, interpret=True, fused=True,
                                    device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).numpy()
    assert y_t.shape == y_j.shape == (2, 8000)
    db = refs.db(y_t, y_j)
    print(f"fused step, interpret=True: port vs JAX {db:.1f} dB")
    assert db <= -80.0


def test_run_batch_passes_interpret_through(clips, tmp_path, monkeypatch):
    v, _ = clips
    jobs = []
    for i in range(2):
        write_wav(tmp_path / f"in{i}.wav", v[i], SR_IN)
        jobs.append({"voice": str(tmp_path / f"in{i}.wav"),
                     "out": str(tmp_path / f"out{i}.wav")})
    seen = []
    make = tbatch.make_batch_step
    monkeypatch.setattr(runner, "_STEP_CACHE", {})
    monkeypatch.setattr(
        tbatch, "make_batch_step",
        lambda **kw: seen.append(kw["interpret"]) or make(**kw))
    rep = runner.run_batch(jobs, step_kw={"interpret": True}, resume=False,
                           device="cpu")
    assert rep.done == 2 and not rep.failed and seen == [True]

    def decoded(*a, **k):
        raise AssertionError("decoded before the refusal")

    monkeypatch.setattr(runner, "open_audio", decoded)
    with pytest.raises(ConfigError, match="CPU only"):
        runner.run_batch(jobs, step_kw={"interpret": True}, resume=False,
                         device="cuda")
