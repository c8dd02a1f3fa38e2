"""Parity of the port's public effect chain (``xmtpu_torch.effects`` /
``xmtpu_torch.graph.fx``) with the JAX package's
(``xmtpu.graph.fx.apply_chain``), on the CPU: the port on
``device="cpu"`` with ``backend="pallas"`` (the kernels' plain twins;
with no backend the CPU runs the float64 scan engine,
tests/test_torch_scan.py), the JAX chain on its ``"pallas"`` backend
(Pallas kernels in interpret mode) and on its float64 ``"scan"``
backend.

One size: 1 s at 48 kHz, stereo (two clips where batched), the JAX
tests' lighter chain (5-band EQ -> 0.1 s reverb at wet 0.3 / dry 0.7 ->
limiter), which folds EQ + reverb into one 5,279-tap FIR and pairs it
with the limiter; the host-only tests also take config 3's 0.5 s IR.

Tolerances:
- against the JAX Pallas chain: -85 dB (float32 on both sides; the
  floor is the JAX fftconv kernel's 3-pass bf16 DFT, -92.6 dB here);
  int16 output: -80 dB (1-LSB rounding flips where the two float32
  chains differ);
- against the JAX float64 scan chain: -100 dB (-104 dB measured);
- block-size invariance: -100 dB (the overlap-save history, the IIR
  state and the envelope state carry exactly; segment and block float32
  rounding);
- the unfolded chain (fold=False) against the folded one: -80 dB (the
  float32 IIR cascade's own noise at 48 kHz);
- the combined IR and the fold structure: bit-exact.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu.graph import fx as xfx
from xmtpu_torch import api
from xmtpu_torch.batch import DEFAULT_BANDS
from xmtpu_torch.graph import fx as tfx
from xmtpu_torch.kernels import envelope, fftconv
from xmtpu_torch.ops import convert
from xmtpu_torch.ops.reverb import synthetic_ir
from xmtpu_torch.utils.errors import ConfigError, DeviceError

from . import torch_refs as refs

SR = 48000
FIVE_BANDS = [
    {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0},
    {"freq_hz": 400.0, "gain_db": -3.0, "q": 1.2},
    {"freq_hz": 1000.0, "gain_db": 2.5, "q": 0.9},
    {"freq_hz": 4000.0, "gain_db": -2.0, "q": 1.1},
    {"freq_hz": 12000.0, "gain_db": 3.0, "q": 0.8},
]
PCHAIN = [
    {"name": "equalizer", "bands": FIVE_BANDS},
    {"name": "reverb", "ir_seconds": 0.1, "wet": 0.3, "dry": 0.7, "seed": 7},
    {"name": "limiter", "threshold_db": -3.0, "knee_db": 6.0,
     "attack_ms": 1.0, "release_ms": 100.0},
]
LINKED = PCHAIN[:2] + [dict(PCHAIN[2], linked_fuse=True)]
COMPRESSOR = PCHAIN[:2] + [{"name": "compressor", "threshold_db": -12.0,
                            "ratio": 3.0, "makeup_db": 2.0}]


@pytest.fixture(scope="module")
def clips():
    """(2, n, 2) float32 clips with hot bursts (knee and ceiling)."""
    rng = np.random.default_rng(33)
    x = (0.3 * rng.standard_normal((2, SR, 2))).astype(np.float32)
    x[0, 2000:4000] *= 5.0
    x[1, 30000:31000] *= 4.0
    return x


def clips_small():
    """(4800, 2) float32: a 0.1 s stereo clip with a hot burst."""
    rng = np.random.default_rng(34)
    x = (0.3 * rng.standard_normal((4800, 2))).astype(np.float32)
    x[1000:1500] *= 5.0
    return x


@pytest.mark.parametrize("case,chain,gate", [
    ("(n, ch) float32", PCHAIN, -85.0),
    ("(n, ch) int16, linked", LINKED, -80.0),
    ("(n,) float32", PCHAIN, -85.0),
    ("(B, n, ch) float32, linked", LINKED, -85.0),
    ("(n, ch) float32, compressor", COMPRESSOR, -85.0),
])
def test_effects_vs_jax_pallas_chain(clips, case, chain, gate):
    x = {"(n,)": clips[0, :, 0], "(B,": clips}.get(case[:4], clips[0])
    if "int16" in case:
        x = convert.f32_to_pcm16_np(x)
    y_j = xfx.apply_chain(x, SR, chain, backend="pallas")
    y_t = xmtpu_torch.effects(x, SR, chain, device="cpu", backend="pallas")
    assert y_t.shape == y_j.shape == x.shape and y_t.dtype == x.dtype
    db = refs.db(y_t, y_j)
    print(f"effects {case} vs JAX pallas chain: {db:.1f} dB (gate {gate})")
    assert db <= gate


def test_effects_vs_jax_scan_chain(clips):
    """The kernels' twins against the JAX float64 oracle engine, both
    limiter forms."""
    x = clips[0]
    ref = np.asarray(xfx.apply_chain(x, SR, PCHAIN, backend="scan"),
                     np.float64)
    for chain in (PCHAIN, LINKED):
        db = refs.db(xmtpu_torch.effects(x, SR, chain, device="cpu",
                                         backend="pallas"), ref)
        print(f"effects vs JAX scan chain (linked_fuse="
              f"{chain[2].get('linked_fuse', False)}): {db:.1f} dB (gate "
              "-100)")
        assert db <= -100.0


@pytest.mark.parametrize("chain", [PCHAIN, LINKED])
def test_block_size_invariance(clips, chain):
    """Blocked mode carries the overlap-save history and the limiter
    state: the output does not depend on the block size."""
    x = clips[0]
    whole = xmtpu_torch.effects(x, SR, chain, device="cpu", backend="pallas")
    for blk in (4096, 16384):
        got = xmtpu_torch.effects(x, SR, chain, device="cpu",
                                  backend="pallas", block_size=blk)
        db = refs.db(got, whole)
        print(f"block {blk} vs whole clip: {db:.1f} dB (gate -100)")
        assert got.shape == whole.shape and db <= -100.0


def test_unfolded_chain_and_blocked_eq(clips):
    """fold=False runs each effect on its own kernel (the EQ on the
    segmented biquad kernel with zi/zf carry, the wet/dry reverb): the
    folded chain's function to -80 dB (the float32 IIR cascade's own
    noise at 48 kHz, -89.5 dB measured), and blocked equal to whole to
    -100 dB."""
    x = torch.from_numpy(clips[0].T.copy())[None]  # (1, ch, n)
    folded = tfx.build_chain(SR, PCHAIN)
    unfolded = tfx.build_chain(SR, PCHAIN, fold=False)
    y_f, _ = tfx.chain_apply(folded, x, (None,))
    y_u, _ = tfx.chain_apply(unfolded, x, (None,) * 3)
    db = refs.db(y_u.numpy(), y_f.numpy())
    print(f"unfolded vs folded chain: {db:.1f} dB (gate -80)")
    assert db <= -80.0
    states = tfx.chain_init_state(unfolded, x.shape[:-1])
    outs = []
    for i in range(0, x.shape[-1], 12000):
        y, states = tfx.chain_apply(unfolded, x[..., i:i + 12000], states)
        outs.append(y)
    db = refs.db(torch.cat(outs, -1).numpy(), y_u.numpy())
    print(f"unfolded, blocks of 12000 vs whole: {db:.1f} dB (gate -100)")
    assert db <= -100.0


def _names(effects):
    return [type(e).__name__ for e in effects]


CONFIG3_REVERB = {"name": "reverb", "params": {
    "ir": synthetic_ir(0.5, SR).astype(np.float32), "wet": 0.3, "dry": 0.7}}


@pytest.mark.parametrize("reverb,taps", [(PCHAIN[1], 5279),
                                         (CONFIG3_REVERB, 24082)])
def test_fold_structure_and_combined_ir(reverb, taps):
    """The same fold structure as the JAX chain, and the same combined
    IR bit for bit: the lighter chain's, and config 3's (its 0.5 s IR
    behind the default 5-band EQ folds to 24,082 taps, past the short
    fftconv form's 8,193)."""
    chain = [PCHAIN[0], reverb, {"name": "volume", "gain_db": -2.0},
             PCHAIN[2]]
    for kw in ({}, {"fold": False}):
        t = tfx.build_chain(SR, chain, default_backend="pallas", **kw)
        j = xfx.build_chain(SR, chain, default_backend="pallas", **kw)
        assert _names(t) == _names(j)
    assert _names(t) == ["EqualizerFx", "ReverbFx", "VolumeFx", "LimiterFx"]
    eq_only = tfx.build_chain(SR, [PCHAIN[0], PCHAIN[2]])
    assert _names(eq_only) == ["EqualizerFx", "LimiterFx"]
    chain = [{"name": "equalizer", "params": {"bands": list(DEFAULT_BANDS)}},
             reverb, {"name": "limiter", "params": {}}]
    t = tfx.build_chain(SR, chain)  # auto: the kernels
    j = xfx.build_chain(SR, chain, default_backend="pallas")
    assert _names(t) == ["ConvLimiterFx"] and len(t[0].folded) == 3
    assert len(t[0].conv.folded) == 2
    assert t[0].conv.ir.dtype == np.float32 and len(t[0].conv.ir) == taps
    assert np.array_equal(t[0].conv.ir, j[0].conv.ir)
    assert t[0].conv.block == j[0].conv.block


def test_reverb_block_rule_matches_jax():
    for m in (1, 2, 4000, 16385, 16386, 24082, 32769, 65537, 65538, 200000):
        assert tfx._reverb_block_for(m) == xfx._reverb_block_for(m)[0], m


def test_long_ir_auto_runs_explicit_pallas_refused():
    """An IR past the JAX kernel's largest block: an explicit kernel
    backend raises the JAX package's ConfigError; the auto pick runs
    (on the card the port's partitioned fftconv, which takes any IR, and
    here its twin; on the CPU the scan engine's torch.fft) and matches a
    float64 convolution."""
    rng = np.random.default_rng(3)
    ir = (rng.standard_normal(70000) * np.exp(-np.arange(70000) / 9000.0)
          ).astype(np.float32)
    for backend in ("pallas", "pallas_interpret"):
        with pytest.raises(ConfigError, match=backend):
            tfx.build_chain(SR, [{"name": "reverb", "params": {
                "ir": ir, "backend": backend}}])
    x = (0.3 * rng.standard_normal(6000)).astype(np.float32)
    chain = [{"name": "reverb", "params": {"ir": ir, "wet": 1.0,
                                           "dry": 0.0}}]
    y = xmtpu_torch.effects(x, SR, chain, device="cpu")
    ref = refs.direct_conv(x, ir, 6000)
    assert refs.db(y, ref) <= -120.0
    (rv,) = tfx.build_chain(SR, chain)  # the auto pick on the card
    assert rv.engine == "pallas"
    y_k, _ = rv.apply(torch.from_numpy(x)[None], None)
    assert refs.db(y_k[0].numpy(), ref) <= -120.0


def test_chain_cache_is_lru_and_keys_on_content():
    tfx._cache.clear()
    hot = tfx.get_compiled_chain(SR, PCHAIN)
    assert tfx.get_compiled_chain(SR, PCHAIN) is hot and len(tfx._cache) == 1
    for g in range(70):
        tfx.get_compiled_chain(
            SR, [{"name": "volume", "params": {"gain_db": float(g)}}])
        assert tfx.get_compiled_chain(SR, PCHAIN) is hot
    assert len(tfx._cache) == 64
    ir_a = np.zeros(64, np.float32)
    ir_a[0] = 1.0
    ir_b = ir_a.copy()
    ir_b[60] = 0.5  # differs deep in the array
    x = np.random.default_rng(1).standard_normal(4800).astype(np.float32)
    ya, yb, yc = (xmtpu_torch.effects(x, SR, [{"name": "reverb", "ir": ir,
                                               "wet": 1.0, "dry": 0.0}],
                                      device="cpu")
                  for ir in (ir_a, ir_b, torch.from_numpy(ir_b)))
    assert not np.array_equal(ya, yb) and np.array_equal(yb, yc)
    assert tfx._json_default(np.float32(2.5)) == 2.5


def test_public_entry_and_device():
    """xmtpu_torch.effects is api.effects; it runs on cuda unless a
    device is given, and refuses the JAX interpret backend off the
    CPU; a tensor in with device_out gives a tensor out."""
    assert xmtpu_torch.effects is api.effects
    x = np.zeros(4800, np.float32)
    chain = [{"name": "volume", "gain_db": -6.0}]
    orig = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(DeviceError, match='device="cpu"'):
            xmtpu_torch.effects(x, SR, chain)
    finally:
        torch.cuda.is_available = orig
    with pytest.raises(ConfigError, match="CPU only"):
        xmtpu_torch.effects(x, SR, [{"name": "limiter", "backend":
                                     "pallas_interpret"}], device="meta")
    xt = torch.full((4800, 2), 0.5)
    y = xmtpu_torch.effects(xt, SR, chain, device="cpu", device_out=True)
    assert torch.is_tensor(y) and y.shape == (4800, 2)
    assert torch.allclose(y, xt * 10 ** (-6.0 / 20.0))
    with pytest.raises(ValueError, match="pcm must be"):
        xmtpu_torch.effects(np.zeros((1, 1, 1, 8), np.float32), SR, chain,
                            device="cpu")


def test_typed_errors():
    """The JAX package's ConfigError cases (an unreadable ir_wav among
    them), the scan engine, which runs: the same engines as the JAX
    chain, its output to -120 dB, and noise suppression, which runs
    whole-clip and refuses blocked mode."""
    bad = [
        [{"name": "flanger"}],
        [3.5],
        [{"gain_db": 1.0}],
        [{"name": "volume", "params": 3.5}],
        [{"name": "volume", "params": {}, "backend": "auto"}],
        [{"name": "volume", "strength": 1}],
        [{"name": {"x": 1}}],
        [{"name": "equalizer"}],
        [{"name": "equalizer", "bands": True}],
        [{"name": "equalizer", "bands": [{"gain_db": 3.0}]}],
        [{"name": "reverb", "ir": []}],
        [{"name": "reverb", "ir": np.zeros((4, 2))}],
        [{"name": "reverb", "ir": [1.0, float("nan")]}],
        [{"name": "reverb", "wet": float("inf")}],
        [{"name": "reverb", "wet": "0.5s"}],
        [{"name": "reverb", "ir_seconds": 0}],
        [{"name": "compressor", "ratio": 0.5}],
        [{"name": "volume", "gain_db": 1e999}],
        [{"name": "limiter", "backend": "tpu"}],
        [{"name": "noise_suppression", "nfft": "x"}],
    ]
    for chain in bad:
        with pytest.raises(ConfigError):
            tfx.build_chain(SR, chain)
        with pytest.raises(Exception):  # the JAX chain refuses each too
            xfx.build_chain(SR, chain)
    with pytest.raises(ConfigError, match="cannot decode WAV"):
        tfx.build_chain(SR, [{"name": "reverb", "ir_wav": "missing.wav"}])
    (lim,) = tfx.build_chain(SR, [{"name": "limiter", "backend": "scan"}])
    (lim_j,) = xfx.build_chain(SR, [{"name": "limiter", "backend": "scan"}])
    assert lim.engine == lim_j.engine == "scan"
    t = tfx.build_chain(SR, PCHAIN, default_backend="oracle")
    j = xfx.build_chain(SR, PCHAIN, default_backend="oracle")
    assert _names(t) == _names(j) == ["EqualizerFx", "ReverbFx", "LimiterFx"]
    xs = clips_small()
    y_t = xmtpu_torch.effects(xs, SR, PCHAIN, device="cpu", backend="oracle")
    y_j = xfx.apply_chain(xs, SR, PCHAIN, backend="oracle")
    assert refs.db(y_t, np.asarray(y_j, np.float64)) <= -120.0
    x = np.zeros(4800, np.float32)
    y = xmtpu_torch.effects(x, SR, [{"name": "ns"}], device="cpu")
    assert y.shape == x.shape and not y.any()
    with pytest.raises(ConfigError, match="whole clip"):
        xmtpu_torch.effects(x, SR, [{"name": "noise_suppression"}],
                            device="cpu", block_size=1024)


def test_config3_chain_launches_nothing_on_the_cpu(clips):
    """On CPU tensors the chain runs the twins: no kernel launch."""
    before = (fftconv.launches, fftconv.long_launches, envelope.launches,
              envelope.envelope_launches, envelope.gain_launches)
    xmtpu_torch.effects(clips[0, :9600], SR, LINKED, device="cpu",
                        backend="pallas")
    assert (fftconv.launches, fftconv.long_launches, envelope.launches,
            envelope.envelope_launches, envelope.gain_launches) == before


@pytest.mark.parametrize("ir_sr", [SR, 44100])
def test_reverb_ir_wav_equal_ir(tmp_path, monkeypatch, ir_sr):
    """ReverbFx(ir_wav=) reads channel 0 through the pinned conversion
    and resamples to the bus rate with the float64 oracle: the same IR
    as the JAX package's (its stdlib WAV codec), bit for bit, and the
    same output."""
    from xmtpu.io import wav as xwav
    from xmtpu_torch.io import write_wav

    monkeypatch.setattr(xwav, "_native", lambda: None)
    ir = synthetic_ir(0.05, ir_sr, seed=5)
    pcm = convert.f32_to_pcm16_np(
        np.stack([0.7 * ir / np.abs(ir).max(), -ir], -1))
    p = tmp_path / "ir.wav"
    write_wav(p, pcm, ir_sr)
    chain = [{"name": "reverb", "ir_wav": str(p), "wet": 0.4, "dry": 0.6}]
    (t,) = tfx.build_chain(SR, chain, device_type="cpu")
    (j,) = xfx.build_chain(SR, chain)
    np.testing.assert_array_equal(t.ir, j.ir)
    assert len(t.ir) == (len(ir) if ir_sr == SR else
                         int(np.ceil(len(ir) * SR / ir_sr)))
    x = clips_small()
    y_t = xmtpu_torch.effects(x, SR, chain, device="cpu")
    y_j = np.asarray(xfx.apply_chain(x, SR, chain))
    assert refs.db(y_t, y_j) <= -100.0


def test_ir_wav_rewritten_in_place_rebuilds_chain(tmp_path):
    """The chain cache keys an ir_wav by (path, size, mtime): rewriting
    the file in place rebuilds the chain with the new IR."""
    from xmtpu_torch.io import write_wav

    p = tmp_path / "ir.wav"
    write_wav(p, np.array([16384, 0, 0, 0], np.int16), SR)
    chain = [{"name": "reverb", "ir_wav": str(p), "wet": 1.0, "dry": 0.0}]
    key_a = tfx._chain_key(SR, chain)
    (a,) = tfx.get_compiled_chain(SR, chain, device_type="cpu")
    assert tfx.get_compiled_chain(SR, chain, device_type="cpu")[0] is a
    st = p.stat()
    write_wav(p, np.array([0, 8192, 0, 0], np.int16), SR)  # same size
    # a later mtime even where the clock's resolution is coarse
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert tfx._chain_key(SR, chain) != key_a
    (b,) = tfx.get_compiled_chain(SR, chain, device_type="cpu")
    assert b is not a and np.array_equal(b.ir, [0.0, 0.25, 0.0, 0.0])
    x = np.zeros(64, np.float32)
    x[0] = 1.0
    y = xmtpu_torch.effects(x, SR, chain, device="cpu")
    np.testing.assert_allclose(y[:3], [0.0, 0.25, 0.0], atol=1e-7)
