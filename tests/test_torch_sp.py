"""Parity of the port's sequence parallelism (``xmtpu_torch.parallel``)
with the JAX package's ``xmtpu.parallel`` on the CPU, over 4 shards.

The JAX package's SP functions need a mesh of 4 devices, which a JAX
process gets only from ``--xla_force_host_platform_device_count=4`` set
before JAX starts: they run in one child process (``_JAX_CHILD``,
started when the module's first test runs, so the port's own checks run
meanwhile), which writes every output into an ``.npz``. The port runs
the same seeded inputs on ``Mesh(["cpu"] * 4, ...)``: 4 virtual shards,
the kernels' plain twins on the kernel engine.

One signal length, 16,384 samples (4 shards of 4,096; the 2-D mesh 2 x
2); a 2-band EQ, a 480-tap FIR, a 960-tap reverb IR. Gates against the
JAX package: the FIR and the scan engine's biquad and envelope -100
dB; the chains -80 dB; the kernel engine -80 dB (the twins against
Pallas in interpret mode). The port's own checks, as
``tests/test_sp.py``'s: equality with its single-device ops, an impulse
ringing across a shard boundary, the halo longer than a shard, a mesh
without an ``"sp"`` axis, an uneven split.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from xmtpu_torch.batch import DEFAULT_BANDS
from xmtpu_torch.ops import biquad, limiter, reverb
from xmtpu_torch.parallel import (Mesh, sp_biquad, sp_effects_chain,
                                  sp_envelope, sp_fir)
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

SR = 48000
N = 16384
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_CHILD = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
import xmtpu  # noqa: F401
from xmtpu.parallel import sp_biquad, sp_effects_chain, sp_envelope, sp_fir

z = np.load(sys.argv[1])
devs = jax.devices()
assert len(devs) == 4, devs
mesh = jax.sharding.Mesh(np.array(devs), ("sp",))
mesh2 = jax.sharding.Mesh(np.array(devs).reshape(2, 2), ("dp", "sp"))
out = {"fir": sp_fir(jnp.asarray(z["x1"]), z["taps"], mesh)}
for eng in ("scan", "kernel"):
    d = z["d"] if eng == "scan" else z["d"].astype(np.float32)
    out["biquad_" + eng] = sp_biquad(z["sos"], jnp.asarray(z["x1"]), mesh,
                                     engine=eng)
    out["env_" + eng] = sp_envelope(jnp.asarray(d), 48000, mesh, engine=eng)
    out["chain_" + eng] = sp_effects_chain(
        jnp.asarray(z["x2"]), 48000, mesh, bands=z["sos"], ir=z["ir"],
        threshold_db=-6.0, engine=eng)
out["chain_2d"] = sp_effects_chain(
    jnp.asarray(z["xb"]), 48000, mesh2, bands=z["sos"], ir=z["ir"],
    threshold_db=-6.0, dp_axis="dp")
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs() -> dict:
    rng = np.random.default_rng(7)
    return dict(
        x1=(0.3 * rng.standard_normal(N)).astype(np.float32),
        taps=reverb.synthetic_ir(0.01, SR).astype(np.float32),
        sos=biquad.eq_sos(list(DEFAULT_BANDS[:2]), SR),
        d=np.abs(2.0 * rng.standard_normal(N)),
        x2=(0.5 * rng.standard_normal((2, N))).astype(np.float32),
        ir=reverb.synthetic_ir(0.02, SR).astype(np.float32),
        xb=(0.5 * rng.standard_normal((4, 2, N))).astype(np.float32))


class _JaxRun:
    """The JAX child, started at construction; :meth:`get` waits."""

    def __init__(self, z: dict):
        self._dir = tempfile.TemporaryDirectory()
        src = os.path.join(self._dir.name, "in.npz")
        self._out = os.path.join(self._dir.name, "out.npz")
        np.savez(src, **z)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_CHILD, src, self._out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._res = None

    def get(self) -> dict:
        if self._res is None:
            log, _ = self._proc.communicate(timeout=300)
            assert self._proc.returncode == 0, log[-4000:]
            with np.load(self._out) as f:
                self._res = dict(f)
        return self._res

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._dir.cleanup()


@pytest.fixture(scope="module")
def z():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(z):
    run = _JaxRun(z)
    yield run
    run.close()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * 4, ("sp",))


def _single_chain(x, sos, ir):
    """The port's single-device chain (float64 scans), as
    tests/test_sp.py builds its reference."""
    y, _ = biquad.sosfilt_scan(sos, x)
    y = reverb.reverb(y, ir, wet=0.3, dry=0.7, backend="xla")
    y, _ = limiter.limiter(y, SR, threshold_db=-6.0, backend="scan")
    return y


# -- the port's own checks (run while the JAX child computes) ---------------


def test_sp_fir_equals_local_and_halo_crosses(jax_out, z, mesh):
    x = torch.from_numpy(z["x1"])
    ref = reverb.fir_convolve_full(x, z["taps"])[:N]
    assert refs.db(sp_fir(x, z["taps"], mesh), ref) <= -100.0
    # an impulse at the end of shard 0 rings into shard 1
    x = torch.zeros(N)
    x[N // 4 - 1] = 1.0
    taps = np.zeros(64, np.float32)
    taps[10] = 1.0
    got = sp_fir(x, taps, mesh)
    assert float(got[N // 4 + 9]) == pytest.approx(1.0, abs=1e-4)
    assert float(got.abs().sum()) == pytest.approx(1.0, abs=1e-2)


@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_sp_biquad_and_envelope_equal_single_device(z, mesh, engine):
    x = torch.from_numpy(z["x1"])
    ref, _ = biquad.sosfilt_scan(z["sos"], x)
    gate = -100.0 if engine == "scan" else -80.0
    assert refs.db(sp_biquad(z["sos"], x, mesh, engine=engine), ref) <= gate
    d = torch.from_numpy(z["d"])
    k_rel = limiter._release_coeff(100.0, SR)
    c_att = limiter._attack_coeff(1.0, SR)
    env, _ = limiter.decaying_max_scan(d, k_rel, 0.0)
    e2, _ = limiter.onepole_scan(env, c_att, 0.0)
    dd = d if engine == "scan" else d.float()
    assert refs.db(sp_envelope(dd, SR, mesh, engine=engine), e2) <= gate


def test_sp_chain_equals_single_device_and_lands_on_input_device(z, mesh):
    x = torch.from_numpy(z["x2"])
    got = sp_effects_chain(x, SR, mesh, bands=z["sos"], ir=z["ir"],
                           threshold_db=-6.0)
    assert got.device == x.device and got.dtype == x.dtype
    assert refs.db(got, _single_chain(x, z["sos"], z["ir"])) <= -80.0


def test_sp_refusals(mesh):
    x = torch.zeros((1, 256))
    two = Mesh(["cpu"] * 2, ("sp",))
    with pytest.raises(ValueError, match="halo"):
        sp_fir(x, np.ones(200), two)  # halo 199 > shard length 128
    with pytest.raises(ValueError, match="no axis 'sp'"):
        sp_fir(x, np.ones(3), Mesh(["cpu"] * 2, ("dp",)))
    with pytest.raises(ValueError, match="divide evenly"):
        sp_fir(torch.zeros((1, 258)), np.ones(3), mesh)
    with pytest.raises(ConfigError, match="engine"):
        sp_biquad(np.zeros((1, 6)), x, two, engine="fast")


# -- against the JAX package ------------------------------------------------


def test_sp_fir_matches_jax(jax_out, z, mesh):
    got = sp_fir(torch.from_numpy(z["x1"]), z["taps"], mesh)
    assert refs.db(got, jax_out.get()["fir"]) <= -100.0


@pytest.mark.parametrize("engine,gate", [("scan", -100.0),
                                         ("kernel", -80.0)])
def test_sp_biquad_envelope_match_jax(jax_out, z, mesh, engine, gate):
    ref = jax_out.get()
    got = sp_biquad(z["sos"], torch.from_numpy(z["x1"]), mesh, engine=engine)
    db_b = refs.db(got, ref["biquad_" + engine])
    d = torch.from_numpy(z["d"])
    got = sp_envelope(d if engine == "scan" else d.float(), SR, mesh,
                      engine=engine)
    db_e = refs.db(got, ref["env_" + engine])
    print(f"{engine}: biquad {db_b:.1f} dB, envelope {db_e:.1f} dB vs JAX")
    assert db_b <= gate and db_e <= gate


@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_sp_chain_matches_jax(jax_out, z, mesh, engine):
    got = sp_effects_chain(torch.from_numpy(z["x2"]), SR, mesh,
                           bands=z["sos"], ir=z["ir"], threshold_db=-6.0,
                           engine=engine)
    db = refs.db(got, jax_out.get()["chain_" + engine])
    print(f"chain, {engine} engine: {db:.1f} dB vs JAX")
    assert db <= -80.0


def test_sp_2d_mesh_matches_jax_and_single_device(jax_out, z):
    mesh2 = Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                 ("dp", "sp"))
    xb = torch.from_numpy(z["xb"])
    got = sp_effects_chain(xb, SR, mesh2, bands=z["sos"], ir=z["ir"],
                           threshold_db=-6.0, dp_axis="dp")
    assert refs.db(got, _single_chain(xb, z["sos"], z["ir"])) <= -80.0
    assert refs.db(got, jax_out.get()["chain_2d"]) <= -80.0
