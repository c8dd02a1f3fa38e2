"""Parity of the port's float64 scan engine with the JAX package's, on
the CPU: ``ops.biquad.sosfilt_scan``, ``ops.limiter``'s envelope scans
and ``limiter(backend="scan")``, ``ops.reverb``'s XLA forms and
``reverb_block``, ``ops.fftmm.fir_convolve_os_mxu``, the effect chain on
its ``scan``/``oracle``/``xla`` backends and under ``auto`` on the CPU,
and ``make_flagship_step(iir_backend="scan")``.

One signal length: 8,820 samples (0.2 s at 44.1 kHz).

Tolerances (each test states its own):
- float64 in: <= -200 dB against the JAX scans (the same associative
  recursion in float64);
- float32 chains: <= -120 dB against the JAX scan chain (float32 FFTs,
  the float32 casts between effects);
- against the float64 oracles (``sosfilt_np``, ``limiter_np``,
  ``reverb_np``, ``flagship_oracle_np``): <= -100 dB, the JAX package's
  own (tests/test_effects.py:92);
- the scan step against the JAX scan step: -80 dB and 1 LSB (its front
  and reverb are the JAX package's float32 kernels, about -98 dB).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu import batch as xbatch
from xmtpu.graph import fx as xfx
from xmtpu.ops import biquad as xbiquad
from xmtpu.ops import fftmm as xfftmm
from xmtpu.ops import limiter as xlimiter
from xmtpu.ops import reverb as xreverb
from xmtpu_torch import batch as tbatch
from xmtpu_torch.graph import fx as tfx
from xmtpu_torch.kernels import envelope, fftconv, iir
from xmtpu_torch.ops import biquad, fftmm, limiter, reverb
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

N = 8820
SR = 44100
BANDS = [{"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
         {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
         {"freq_hz": 7000.0, "gain_db": 3.0, "q": 0.8}]
CHAIN = [
    {"name": "equalizer", "bands": BANDS},
    {"name": "reverb", "ir_seconds": 0.05, "wet": 0.3, "dry": 0.7},
    {"name": "limiter", "threshold_db": -3.0},
]


@pytest.fixture(scope="module")
def sig():
    """(2, 3, N) float64 noise with a hot burst (the limiter's knee)."""
    rng = np.random.default_rng(21)
    x = 0.3 * rng.standard_normal((2, 3, N))
    x[:, :, 2000:2600] *= 6.0
    return x


@pytest.fixture(scope="module")
def sos():
    return biquad.eq_sos(BANDS, SR)


def test_sosfilt_scan_vs_jax(sig, sos):
    """With and without zi, float64 and float32 in, an empty cascade,
    and block carry: float64 <= -200 dB against the JAX scan and equal
    to scipy's float64 sosfilt to -200 dB; float32 in <= -120 dB. At
    the detector's (2, N), whose scans the envelope tests share."""
    sig = sig[:, 0]
    zi = 0.1 * np.random.default_rng(2).standard_normal((len(sos), 2, 2))
    for z in (None, zi):
        y_j, zf_j = xbiquad.sosfilt_scan(
            sos, jnp.asarray(sig), zi=None if z is None else jnp.asarray(z))
        y_t, zf_t = biquad.sosfilt_scan(
            sos, torch.from_numpy(sig),
            zi=None if z is None else torch.from_numpy(z))
        assert y_t.dtype == zf_t.dtype == torch.float64
        assert refs.db(y_t, y_j) <= -200.0 and refs.db(zf_t, zf_j) <= -200.0
        ref, zf_ref = biquad.sosfilt_np(sos, sig, zi=z)
        assert refs.db(y_t, ref) <= -200.0 and refs.db(zf_t, zf_ref) <= -200.0
    x32 = sig.astype(np.float32)
    y_j, _ = xbiquad.sosfilt_scan(sos, jnp.asarray(x32))
    y_t, zf_t = biquad.sosfilt_scan(sos, torch.from_numpy(x32))
    assert y_t.dtype == torch.float32 and zf_t.dtype == torch.float64
    assert refs.db(y_t, y_j) <= -120.0
    y_e, zf_e = biquad.sosfilt_scan(np.zeros((0, 6)), torch.from_numpy(x32))
    assert torch.equal(y_e, torch.from_numpy(x32)) and zf_e.shape == (0, 2, 2)
    whole, _ = biquad.sosfilt_scan(sos, torch.from_numpy(sig))
    z, parts = None, []
    for i in range(0, N, 2205):
        y, z = biquad.sosfilt_scan(sos, torch.from_numpy(sig[..., i:i + 2205]),
                                   zi=z)
        parts.append(y)
    assert refs.db(torch.cat(parts, -1), whole) <= -200.0


@pytest.mark.parametrize("k,init", [(0.9995, 0.7), (0.0, 0.4), (0.99, 0.0)])
def test_decaying_max_scan_vs_jax(sig, k, init):
    d = np.abs(sig).max(axis=1)  # the linked detector limiter() scans
    env_j, last_j = xlimiter.decaying_max_scan(jnp.asarray(d), k,
                                               jnp.full(2, init))
    env_t, last_t = limiter.decaying_max_scan(torch.from_numpy(d), k, init)
    assert refs.db(env_t, env_j) <= -200.0
    assert refs.db(last_t, last_j) <= -200.0


@pytest.mark.parametrize("c,init", [(0.02, 0.7), (1.0, 0.3), (1.5, 0.2),
                                    (0.5, 0.0)])
def test_onepole_scan_vs_jax(sig, c, init):
    u = np.abs(sig[::-1]).max(axis=1)  # the detector's shape, other data
    e_j, last_j = xlimiter.onepole_scan(jnp.asarray(u), c, jnp.full(2, init))
    e_t, last_t = limiter.onepole_scan(torch.from_numpy(u), c,
                                       torch.full((2,), init,
                                                  dtype=torch.float64))
    assert refs.db(e_t, e_j) <= -200.0 and refs.db(last_t, last_j) <= -200.0


def test_limiter_scan_vs_jax_and_oracle(sig):
    """limiter(backend="scan"): float64 state and work; float64 in <=
    -200 dB against the JAX scan limiter, float32 in <= -120 dB, both <=
    -100 dB against limiter_np; the state carries across blocks; n_valid
    and linked_fuse are checked."""
    kw = dict(threshold_db=-6.0, knee_db=4.0, attack_ms=2.0,
              release_ms=50.0)
    st = (np.full(2, 0.5), np.full(2, 0.3))
    y_j, s_j = xlimiter.limiter(jnp.asarray(sig), SR, backend="scan",
                                state=tuple(jnp.asarray(s) for s in st), **kw)
    y_t, s_t = limiter.limiter(torch.from_numpy(sig), SR, backend="scan",
                               state=tuple(torch.from_numpy(s) for s in st),
                               **kw)
    assert y_t.dtype == s_t[0].dtype == torch.float64
    assert refs.db(y_t, y_j) <= -200.0
    assert all(refs.db(a, b) <= -200.0 for a, b in zip(s_t, s_j))
    ref, _ = limiter.limiter_np(sig, SR, state=st, **kw)
    assert refs.db(y_t, ref) <= -100.0
    x32 = torch.from_numpy(sig.astype(np.float32))
    y32, _ = limiter.limiter(x32, SR, backend="scan", **kw)
    y32_j, _ = xlimiter.limiter(jnp.asarray(x32.numpy()), SR,
                                backend="scan", **kw)
    assert y32.dtype == torch.float32 and refs.db(y32, y32_j) <= -120.0
    whole, _ = limiter.limiter(torch.from_numpy(sig), SR, backend="scan",
                               **kw)
    state, parts = None, []
    for i in range(0, N, 2940):
        y, state = limiter.limiter(torch.from_numpy(sig[..., i:i + 2940]),
                                   SR, backend="scan", state=state, **kw)
        parts.append(y)
    assert refs.db(torch.cat(parts, -1), whole) <= -200.0
    y_nv, _ = limiter.limiter(torch.from_numpy(sig), SR, backend="scan",
                              n_valid=N - 100, **kw)
    assert torch.equal(y_nv, limiter.limiter(
        torch.from_numpy(sig[..., :N - 100]), SR, backend="scan", **kw)[0])
    for bad in (0, -1, N + 1):
        with pytest.raises(ValueError, match="n_valid"):
            limiter.limiter(x32, SR, backend="scan", n_valid=bad)
    with pytest.raises(ConfigError, match="linked_fuse"):
        limiter.limiter(x32, SR, backend="scan", linked_fuse=True)
    with pytest.raises(ValueError, match="backend"):
        limiter.limiter(x32, SR, backend="xla")


@pytest.fixture(scope="module")
def ir():
    return xreverb.synthetic_ir(0.05, SR).astype(np.float32)  # 2205 taps


def test_fir_convolve_xla_forms(sig, ir):
    """fir_convolve_full / fir_convolve_os on torch.fft: float32 in <=
    -120 dB against the JAX forms, float64 in <= -200 dB, and <= -100 dB
    against the float64 convolution."""
    x32 = sig[0].astype(np.float32)
    full_j = np.asarray(xreverb.fir_convolve_full(jnp.asarray(x32),
                                                  jnp.asarray(ir)))
    full_t = reverb.fir_convolve_full(torch.from_numpy(x32), ir)
    assert full_t.dtype == torch.float32 and full_t.shape == full_j.shape
    assert refs.db(full_t, full_j) <= -120.0
    ref = refs.direct_conv(sig[0], ir)
    assert refs.db(full_t, ref) <= -100.0
    full64 = reverb.fir_convolve_full(torch.from_numpy(sig[0]),
                                      torch.from_numpy(ir))
    assert full64.dtype == torch.float64
    assert refs.db(full64, xreverb.fir_convolve_full(
        jnp.asarray(sig[0]), jnp.asarray(ir))) <= -200.0
    for block in (4096, 8192, 16384):  # 3 blocks, 2, the full transform
        os_j = np.asarray(xreverb.fir_convolve_os(jnp.asarray(x32),
                                                  jnp.asarray(ir), block))
        os_t = reverb.fir_convolve_os(torch.from_numpy(x32), ir, block)
        assert refs.db(os_t, os_j) <= -120.0
        assert refs.db(os_t, ref[:, :N]) <= -100.0


@pytest.mark.parametrize("backend,block", [("xla", None), ("xla", 8192),
                                           ("mxu", None), ("mxu", 8192)])
def test_reverb_xla_and_mxu_vs_jax(sig, ir, backend, block):
    x32 = sig[0].astype(np.float32)
    y_j = np.asarray(xreverb.reverb(
        jnp.asarray(x32), jnp.asarray(ir) if backend == "xla" else ir,
        block=block, backend=backend, prescale=0.5))
    y_t = reverb.reverb(torch.from_numpy(x32), ir, block=block,
                        backend=backend, prescale=0.5)
    db = refs.db(y_t, y_j)
    db_o = refs.db(y_t, 0.5 * reverb.reverb_np(x32, ir))
    print(f"reverb {backend} block {block}: {db:.1f} dB vs JAX, "
          f"{db_o:.1f} dB vs float64")
    assert y_t.dtype == torch.float32 and db <= -120.0 and db_o <= -100.0


def test_reverb_checks_and_block_chain(sig, ir):
    """The JAX argument checks, and reverb_block chained over blocks
    equal to the offline reverb (float32, <= -120 dB)."""
    x = torch.from_numpy(sig[0].astype(np.float32))
    with pytest.raises(ValueError, match="pre_row"):
        reverb.reverb(x, ir, backend="xla", pre_col=torch.ones(N))
    with pytest.raises(ValueError, match="backend"):
        reverb.reverb(x, ir, backend="fft")
    whole = reverb.reverb(x, ir, backend="xla")
    tail = reverb.reverb_tail_init((3,), len(ir))
    assert tail.shape == (3, len(ir) - 1) and tail.dtype == torch.float32
    parts = []
    for i in range(0, N, 2000):  # blocks shorter than the IR, and a tail
        y, tail = reverb.reverb_block(x[:, i:i + 2000], torch.from_numpy(ir),
                                      tail)
        parts.append(y)
    assert refs.db(torch.cat(parts, -1), whole) <= -120.0
    y_j, t_j = xreverb.reverb_block(jnp.asarray(x[:, :2000].numpy()),
                                    jnp.asarray(ir),
                                    xreverb.reverb_tail_init((3,), len(ir)))
    y_t, t_t = reverb.reverb_block(x[:, :2000], torch.from_numpy(ir),
                                   reverb.reverb_tail_init((3,), len(ir)))
    assert refs.db(y_t, y_j) <= -120.0 and refs.db(t_t, t_j) <= -120.0


@pytest.mark.parametrize("block", [8192, 32768])  # fused, four_step
def test_fir_convolve_os_mxu_vs_jax(sig, ir, block):
    """At its defaults against the JAX form at its own ("auto" variant,
    full float32 matmuls): <= -120 dB, and <= -100 dB vs float64."""
    x32 = sig[0].astype(np.float32)
    y_j = np.asarray(xfftmm.fir_convolve_os_mxu(jnp.asarray(x32), ir, block))
    y_t = fftmm.fir_convolve_os_mxu(torch.from_numpy(x32), ir, block)
    ref = reverb.reverb_np(x32, ir, wet=1.0, dry=0.0)
    assert refs.db(y_t, y_j) <= -120.0 and refs.db(y_t, ref) <= -100.0
    with pytest.raises(ValueError, match="too small"):
        fftmm.fir_convolve_os_mxu(torch.from_numpy(x32), ir, 4096)
    with pytest.raises(ValueError, match="power of two"):
        fftmm.fir_convolve_os_mxu(torch.from_numpy(x32), ir, 6000)


# fir_convolve_os_mxu's rungs on sig[0] (3 x 8820) and the 2205-tap IR,
# block 8192, measured first: HIGHEST -127.7..-134.8 dB against float64
# (bit-equal to JAX's four_step), HIGH -101.1..-105.0, DEFAULT
# -45.5..-49.8 (gauss a few dB worse). The JAX form on the CPU computes
# every precision in float32, so it is held at the rung's own error.
MXU_VS_JAX = {"highest": -120.0, "high": -95.0, "default": -40.0}
MXU_WINDOWS = {"highest": (-200.0, -120.0), "high": (-110.0, -95.0),
               "default": (-55.0, -40.0)}


@pytest.mark.parametrize("variant", ["auto", "fused", "four_step"])
@pytest.mark.parametrize("gauss", [False, True])
@pytest.mark.parametrize("rung", ["highest", "high", "default"])
def test_fir_convolve_os_mxu_rungs_vs_jax(sig, ir, variant, gauss, rung):
    """Every variant x gauss x precision rung against the JAX form, and
    against float64 in a window that proves the rung rounded."""
    x32 = sig[0].astype(np.float32)
    y_j = np.asarray(xfftmm.fir_convolve_os_mxu(
        jnp.asarray(x32), ir, 8192, precision=rung, variant=variant,
        gauss=gauss))
    y_t = fftmm.fir_convolve_os_mxu(torch.from_numpy(x32), ir, 8192,
                                    precision=rung, variant=variant,
                                    gauss=gauss)
    ref = reverb.reverb_np(x32, ir, wet=1.0, dry=0.0)
    d, d64 = refs.db(y_t, y_j), refs.db(y_t, ref)
    print(f"mxu {variant} gauss={gauss} {rung}: {d:.1f} dB vs JAX, "
          f"{d64:.1f} vs float64")
    lo, hi = MXU_WINDOWS[rung]
    assert y_t.dtype == torch.float32 and d <= MXU_VS_JAX[rung]
    assert lo <= d64 <= hi


def test_fir_convolve_os_mxu_refusals(sig, ir):
    """The JAX errors: an unknown variant, ``fused`` past the bake limit
    (block 32768: 64 MB of circulant constants), an unknown precision;
    and reverb(backend="mxu", precision=) against the JAX reverb."""
    x = torch.from_numpy(sig[0].astype(np.float32))
    for kw, match in (({"variant": "radix2"}, "unknown variant"),
                      ({"variant": "fused", "block": 32768}, "bakes 64 MB"),
                      ({"precision": "tf64"}, "precision")):
        kw = {"block": 8192, **kw}
        with pytest.raises(ValueError, match=match):
            fftmm.fir_convolve_os_mxu(x, ir, **kw)
        if "precision" not in kw:
            with pytest.raises(ValueError, match=match):
                xfftmm.fir_convolve_os_mxu(jnp.asarray(x.numpy()), ir, **kw)
    y_j = np.asarray(xreverb.reverb(jnp.asarray(x.numpy()), ir, block=8192,
                                    backend="mxu", precision="high"))
    y_t = reverb.reverb(x, ir, block=8192, backend="mxu", precision="high")
    assert refs.db(y_t, y_j) <= MXU_VS_JAX["high"]
    y_mxu = reverb.reverb(x, ir, block=8192, backend="mxu")
    assert refs.db(y_t, y_mxu) > -120.0


@pytest.fixture(scope="module")
def clip():
    """(N, 2) float32 stereo clip with a hot burst."""
    rng = np.random.default_rng(8)
    x = (0.3 * rng.standard_normal((N, 2))).astype(np.float32)
    x[3000:3500] *= 5.0
    return x


@pytest.mark.parametrize("backend", ["scan", "oracle", "xla"])
@pytest.mark.parametrize("block_size", [None, 2048])
def test_effects_scan_backends_vs_jax(clip, backend, block_size):
    """The chain on the scan engine, whole and blocked (the IIR and
    limiter state in float64, the reverb's output tail): <= -120 dB
    against the JAX scan chain, <= -100 dB against the float64 oracle."""
    y_j = np.asarray(xfx.apply_chain(clip, SR, CHAIN, backend=backend,
                                     block_size=block_size))
    y_t = xmtpu_torch.effects(clip, SR, CHAIN, backend=backend,
                              block_size=block_size, device="cpu")
    db = refs.db(y_t, y_j)
    effects = tfx.build_chain(SR, CHAIN, default_backend=backend,
                              device_type="cpu")
    assert [type(e).__name__ for e in effects] == ["EqualizerFx", "ReverbFx",
                                                    "LimiterFx"]
    sos = effects[0].sos
    ref, _ = biquad.sosfilt_np(sos, clip.T.astype(np.float64))
    ref = reverb.reverb_np(ref, effects[1].ir, wet=0.3, dry=0.7)
    ref = limiter.limiter_np(ref, SR, threshold_db=-3.0)[0].T
    db_o = refs.db(y_t, ref)
    print(f"effects backend={backend} block {block_size}: {db:.1f} dB vs "
          f"JAX scan chain, {db_o:.1f} dB vs float64 oracle")
    assert y_t.shape == clip.shape and y_t.dtype == np.float32
    assert db <= -120.0 and db_o <= -100.0


def test_scan_engine_states():
    """The scan engine's states are the JAX scan engine's: float64 IIR
    and limiter state, the reverb's output tail (float32)."""
    t = tfx.build_chain(SR, CHAIN, default_backend="scan", fold=False)
    j = xfx.build_chain(SR, CHAIN, default_backend="scan", fold=False)
    st_t = tfx.chain_init_state(t, (2,))
    st_j = xfx.chain_init_state(j, (2,))
    assert st_t[0].shape == st_j[0].shape and st_t[0].dtype == torch.float64
    assert st_t[1].shape == st_j[1].shape and st_t[1].dtype == torch.float32
    assert all(a.dtype == torch.float64 and a.shape == b.shape
               for a, b in zip(st_t[2], st_j[2]))
    p = tfx.build_chain(SR, CHAIN, default_backend="pallas", fold=False)
    assert tfx.chain_init_state(p, (2,))[0].dtype == torch.float32


@pytest.mark.parametrize("layout", ["(n, 2)", "(B, n, 2)"])
def test_auto_on_the_cpu_is_the_scan_engine(clip, layout):
    """No backend on the CPU: the JAX auto chain (its scan engine) to
    <= -120 dB, and nothing folds; the same chain built for cuda folds
    (the kernels); linked_fuse under auto runs the gain form's twin, no
    kernel launch."""
    x = clip if layout == "(n, 2)" else np.stack([clip, clip[::-1].copy()])
    y_j = np.asarray(xfx.apply_chain(x, SR, CHAIN))
    y_t = xmtpu_torch.effects(x, SR, CHAIN, device="cpu")
    db = refs.db(y_t, y_j)
    print(f"auto on the CPU {layout}: {db:.1f} dB vs JAX auto (gate -120)")
    assert db <= -120.0
    names = [type(e).__name__ for e in
             tfx.get_compiled_chain(SR, CHAIN, device_type="cpu")]
    assert names == ["EqualizerFx", "ReverbFx", "LimiterFx"]
    assert [type(e).__name__ for e in tfx.get_compiled_chain(SR, CHAIN)] \
        == ["ConvLimiterFx"]
    linked = CHAIN[:2] + [dict(CHAIN[2], linked_fuse=True)]
    (eq, rv, lim) = tfx.build_chain(SR, linked, device_type="cpu")
    assert (eq.engine, rv.engine, lim.engine) == ("scan", "scan", "pallas")
    before = (fftconv.launches, envelope.gain_launches, iir.launches)
    y_l = xmtpu_torch.effects(x, SR, linked, device="cpu")
    assert (fftconv.launches, envelope.gain_launches, iir.launches) == before
    assert refs.db(y_l, y_t) <= -100.0


@pytest.fixture(scope="module")
def pcm():
    """Two int16 voice and BGM clips of N samples at 44.1 kHz."""
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((2, N)) * 9000).astype(np.int16)
    b = (np.sin(np.arange(N) / 50.0)[None].repeat(2, 0) * 12000).astype(
        np.int16)
    return v, b


def test_flagship_scan_step_vs_jax(pcm):
    """make_flagship_step(iir_backend="scan"): the EQ and limiter as
    float64 scans, the reverb on the fftconv kernel's twin, nothing
    folded, never the fused branch under auto; against the JAX scan step
    (int16 out, at most 1 LSB apart, <= -80 dB: the JAX step's mixfirst
    front multiplies in 3-pass bf16 and its reverb is the Pallas fftconv
    in interpret mode, each about -98 dB against float64; the port's step
    tests hold other JAX steps at the same -80 dB) and on clip 0 the
    float64 oracle (<= -100 dB)."""
    v, b = pcm
    step = tbatch.make_flagship_step(iir_backend="scan", device="cpu")
    assert not step.fold and step.iir_backend == "scan"
    y_t = step(torch.from_numpy(v), torch.from_numpy(b)).numpy()
    y_j = np.asarray(xbatch.make_flagship_step(iir_backend="scan",
                                               interpret=True)(
        jnp.asarray(v), jnp.asarray(b)))
    assert y_t.shape == y_j.shape and y_t.dtype == np.int16
    diff = np.abs(y_t.astype(np.int32) - y_j.astype(np.int32))
    db = refs.db(y_t, y_j)
    ref = tbatch.flagship_oracle_np(v[0], b[0]).astype(np.float64)
    db_o = refs.db(y_t[0], ref)
    print(f"scan step vs JAX scan step: {db:.1f} dB, max {diff.max()} LSB; "
          f"clip 0 vs float64 oracle {db_o:.1f} dB")
    assert diff.max() <= 1 and db <= -80.0 and db_o <= -100.0
