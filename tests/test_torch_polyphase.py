"""Parity of the port's resample kernels with the JAX package's, on the
CPU: ``xmtpu_torch.kernels.resample`` (K7) against
``xmtpu.kernels.resample.resample_pallas`` and ``xmtpu_torch.kernels.
rsmix`` (K8) against ``xmtpu.kernels.rsmix.resample_mix_pallas``
(Pallas in interpret mode).

On a CPU tensor the wrappers run the kernels' plain twins
(``ops.resample.polyphase_resample``; the aligned banded form of the
fused front). The CUDA kernels are compared with the twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``). What can be checked
here of the kernels themselves is their tiling: a numpy model of
``csrc/polyphase.cuh``'s block loop, fed the wrappers' own host tables
and tile sizes, must compute the twins' function.

Tolerances:
- K7's twin against ``resample_pallas``: -120 dB (the JAX package's own
  gate; both are float32 sums over the same taps); the 48k -> 16k and
  16k -> 48k pairs (filter band wider than 2*M) take ``resample_pallas``'s
  fallback, whose strided convolution the port does not have: they
  raise ``NotPortedError``;
- K8's twin against ``resample_mix_pallas``: -90 dB (the JAX kernel
  multiplies in 3-pass bf16, about -98 dB against float64), and against
  the float64 oracle: -120 dB;
- the numpy models of the kernels against the twins: -120 dB;
- ``resample_mix_supported`` and ``_pick_F``: equal to the JAX package's
  on every point of the grid.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels import resample as xres
from xmtpu.kernels import rsmix as xrsmix
from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels import resample as kres
from xmtpu_torch.kernels import rsmix
from xmtpu_torch.ops import mix as tmix
from xmtpu_torch.ops import resample as tres
from xmtpu_torch.utils.errors import ConfigError, NotPortedError

from .conftest import rms_db

PHASE_TILE = 256  # csrc/polyphase.cuh kPhaseTile


def _db(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return rms_db(a - ref, ref)


def _model(tracks, plan, out_len, epilogue):
    """numpy model of polyphase_kernel: per (frame tile, phase tile)
    block, the window [c0*M + s[r0], + wlen) zero-filled outside the
    row, K2-tap dots from the block's relative starts. ``tracks``: list
    of (R, n) arrays; float64 sums."""
    tabs = kres.poly_tables(plan)
    hsel, soff = tabs["hsel"].astype(np.float64), tabs["soff"]
    L, M, K2 = plan.L, plan.M, plan.K2
    R, n = tracks[0].shape
    nj = -(-out_len // L)
    tc, win_max = kres.frames_per_block(plan, nj)
    out = np.full((R, out_len), np.nan)
    for ft in range(-(-nj // tc)):
        for pt in range(-(-L // PHASE_TILE)):
            r0 = pt * PHASE_TILE
            rl = min(PHASE_TILE, L - r0)
            c0 = ft * tc
            tcc = min(tc, nj - c0)
            starts = soff[r0:r0 + rl] - soff[r0]
            wlen = (tcc - 1) * M + int(starts[-1]) + K2
            assert wlen <= win_max
            t = c0 * M + int(soff[r0]) + np.arange(wlen)
            inside = (t >= 0) & (t < n)
            wins = [np.where(inside, x[:, np.clip(t, 0, n - 1)], 0.0)
                    for x in tracks]
            for cc in range(tcc):
                j = (c0 + cc) * L + r0 + np.arange(rl)
                keep = j < out_len
                idx = cc * M + starts[:, None] + np.arange(K2)  # (rl, K2)
                accs = [np.einsum("rpk,pk->rp", w[:, idx],
                                  hsel[r0:r0 + rl]) for w in wins]
                out[:, j[keep]] = epilogue(j[keep], accs)[:, keep]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n", [44100, 44000])  # aligned, not a multiple
def test_resample_vs_pallas(n):
    rng = np.random.default_rng(n)
    x = (0.3 * rng.standard_normal((3, n))).astype(np.float32)
    y_j = np.asarray(xres.resample_pallas(x, 44100, 16000, interpret=True))
    y_t = kres.resample(torch.from_numpy(x), 44100, 16000).numpy()
    db = _db(y_t, y_j)
    print(f"K7 twin vs resample_pallas, 3 x {n}: {db:.1f} dB (gate -120)")
    assert y_t.shape == y_j.shape == (3, -(-n * 160 // 441))
    assert y_t.dtype == np.float32 and db <= -120.0


def test_resample_rate_pairs():
    """48k -> 44.1k runs the kernel's path; 48k -> 16k and 16k -> 48k
    (filter band wider than 2*M) take resample_pallas's fallback, whose
    strided convolution is not ported; equal rates pass through as
    float32."""
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((2, 9600))).astype(np.float32)
    y_j = np.asarray(xres.resample_pallas(x, 48000, 44100, interpret=True))
    y_t = kres.resample(torch.from_numpy(x), 48000, 44100).numpy()
    db = _db(y_t, y_j)
    print(f"K7 twin vs resample_pallas, 48k -> 44.1k: {db:.1f} dB")
    assert db <= -120.0
    for sr_in, sr_out in ((48000, 16000), (16000, 48000)):
        xres.resample_pallas(x, sr_in, sr_out, interpret=True)  # JAX runs
        with pytest.raises(NotPortedError, match="ROADMAP"):
            kres.resample(torch.from_numpy(x), sr_in, sr_out)
    same = kres.resample(torch.from_numpy(x).double(), 16000, 16000)
    assert same.dtype == torch.float32


@pytest.mark.parametrize("n,sr_in,sr_out", [
    (44100, 44100, 16000),   # aligned, one phase tile
    (44000, 44100, 16000),   # ragged end
    (9600, 48000, 44100),    # L = 147, M = 160
    (30000, 44100, 32000),   # L = 320: two phase tiles
    (700, 44100, 16000),     # one frame tile, window past both ends
    (3200, 32000, 31000),    # M = 32: below resample_pallas's M >= 64
])
def test_kernel_model_matches_twin(n, sr_in, sr_out):
    g = math.gcd(sr_in, sr_out)
    plan = tres.make_plan(sr_out // g, sr_in // g, 24, 9.0)
    rng = np.random.default_rng(n)
    x = (0.3 * rng.standard_normal((3, n))).astype(np.float32)
    out_len = tres.resample_output_len(n, plan.L, plan.M)
    y = _model([x.astype(np.float64)], plan, out_len,
               lambda j, accs: accs[0])
    ref = tres.polyphase_resample(torch.from_numpy(x), sr_in, sr_out)
    db = _db(y, ref.numpy())
    print(f"polyphase kernel model {sr_in}->{sr_out}, n={n}: {db:.1f} dB")
    assert db <= -120.0


def test_resample_wrapper_contract():
    x = torch.zeros((2, 44100))
    before = kres.launches
    kres.resample(x, 44100, 16000)
    assert kres.launches == before  # CPU: the twin, no launch
    with pytest.raises(ValueError, match="no resample kernel"):
        kres.resample(x.to("meta"), 44100, 16000)
    with pytest.raises(ValueError, match="rows"):
        kres.check_rows(65535 * 8 + 1)
    names = {p.name for p in _build.sources()}
    assert {"resample.cu", "rsmix.cu", "polyphase.cuh"} <= names
    assert {"xm_resample_f32", "xm_rsmix_i16"} <= set(_build._SIGNATURES)


# ---------------------------------------------------------------- K8


RSMIX_ROWS = [  # tests/test_rsmix.py's parameter rows
    (3, 44100, 44100, 16000, 4000, 0.4),    # single-block rows (F = nc)
    (8, 441 * 288, 44100, 16000, 0, 1.0),   # multi-block
    (2, 9600, 48000, 44100, 100, 0.7),      # L = 147, M = 160
    (5, 441 * 24, 44100, 16000, 300, 0.4),  # odd batch
]


def _oracle(v, b, sr_in, sr_out, fade, gb):
    rv = tres.resample_oracle_np(v.astype(np.float64), sr_in, sr_out)
    rb = tres.resample_oracle_np(b.astype(np.float64), sr_in, sr_out)
    on = rv.shape[-1]
    return tmix.fade_ramp_np(on, fade, fade, on) * (rv + gb * rb)


@pytest.mark.parametrize("B,n,sr_in,sr_out,fade,gb", RSMIX_ROWS)
def test_resample_mix_vs_pallas_and_oracle(B, n, sr_in, sr_out, fade, gb):
    rng = np.random.default_rng(B * n)
    v = (rng.standard_normal((B, n)) * 9000).astype(np.int16)
    b = (rng.standard_normal((B, n)) * 7000).astype(np.int16)
    assert rsmix.resample_mix_supported(n, B, sr_in, sr_out)
    y_j = np.asarray(xrsmix.resample_mix_pallas(
        jnp.asarray(v), jnp.asarray(b), sr_in, sr_out, bgm_gain=gb,
        fade=fade, interpret=True))
    y_t = rsmix.resample_mix(torch.from_numpy(v), torch.from_numpy(b), sr_in,
                             sr_out, bgm_gain=gb, fade=fade).numpy()
    ref = _oracle(v, b, sr_in, sr_out, fade, gb)
    db_j, db_o = _db(y_t, y_j), _db(y_t, ref)
    print(f"K8 twin ({B}, {n}, {sr_in}->{sr_out}, fade {fade}): {db_j:.1f} "
          f"dB vs resample_mix_pallas (gate -90), {db_o:.1f} dB vs float64 "
          "(gate -120)")
    assert y_t.shape == y_j.shape and y_t.dtype == np.float32
    assert db_j <= -90.0 and db_o <= -120.0


@pytest.mark.parametrize("row", [RSMIX_ROWS[0], RSMIX_ROWS[2]])
def test_rsmix_kernel_model_matches_twin(row):
    """The numpy model of the kernel (two int16 tracks, the float32
    ramp epilogue in its operation order) computes the twin's function."""
    B, n, sr_in, sr_out, fade, gb = row
    g = math.gcd(sr_in, sr_out)
    plan = tres.make_plan(sr_out // g, sr_in // g, 24, 9.0)
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((B, n)) * 9000).astype(np.int16)
    b = (rng.standard_normal((B, n)) * 7000).astype(np.int16)
    out_len = (n // plan.M) * plan.L
    f32 = np.float32

    def epilogue(j, accs):
        i = j.astype(f32)
        ramp = np.ones_like(i)
        if fade > 0:
            ramp = np.minimum((i + f32(1)) / f32(fade), f32(1)) * np.clip(
                (f32(out_len) - i) / f32(fade), f32(0), f32(1))
        return ramp * (accs[0].astype(f32) + f32(gb) * accs[1].astype(f32))

    y = _model([v.astype(np.float64), b.astype(np.float64)], plan, out_len,
               epilogue)
    ref = rsmix.resample_mix(torch.from_numpy(v), torch.from_numpy(b), sr_in,
                             sr_out, bgm_gain=gb, fade=fade).numpy()
    db = _db(y, ref)
    print(f"rsmix kernel model {row}: {db:.1f} dB vs twin (gate -120)")
    assert db <= -120.0


def test_fade_ramp_is_the_jax_kernels():
    """The float32 ramp: the JAX kernel's formula in numpy float32, and
    within float32 rounding of the float64 fade_ramp."""
    for out_n, fade in ((16000, 4000), (160, 300), (8000, 0)):
        r = rsmix.fade_ramp_f32(out_n, fade).numpy()
        i = np.arange(out_n, dtype=np.float32)
        ref = np.ones(out_n, np.float32)
        if fade > 0:
            ref = (np.minimum((i + np.float32(1)) / np.float32(fade), 1)
                   * np.clip((np.float32(out_n) - i) / np.float32(fade), 0,
                             1)).astype(np.float32)
        assert np.array_equal(r, ref)
        r64 = tmix.fade_ramp_np(out_n, fade, fade, out_n)
        assert np.max(np.abs(r - r64)) <= 1.2e-7


def test_support_gate_bit_exact():
    for nc in range(1, 3000):
        assert rsmix._pick_F(nc) == xrsmix._pick_F(nc), nc
    pairs = [(44100, 16000), (48000, 16000), (48000, 44100), (16000, 16000),
             (44100, 48000), (16000, 48000), (22050, 16000), (44100, 8000)]
    ns = [1, 440, 441, 882, 44100, 44101, 441 * 1024, 441 * 1025,
          441 * 1032, 9600, 160 * 1025, 441 * 104856, 441 * 104864]
    hits = 0
    for sr_in, sr_out in pairs:
        for n in ns:
            got = rsmix.resample_mix_supported(n, 2, sr_in, sr_out)
            assert got == xrsmix.resample_mix_supported(n, 2, sr_in,
                                                        sr_out), (
                n, sr_in, sr_out)
            hits += got
    assert hits > 0
    # the 2^24 output-index guard (both frame counts tile by 8) and the
    # tiling gate, named
    assert rsmix.resample_mix_supported(441 * 104856, 1, 44100, 16000)
    assert not rsmix.resample_mix_supported(441 * 104864, 1, 44100, 16000)
    assert not rsmix.resample_mix_supported(441 * 1025, 1, 44100, 16000)


def test_resample_mix_wrapper_contract():
    v = torch.zeros((2, 44100), dtype=torch.int16)
    before = rsmix.launches
    rsmix.resample_mix(v, v, 44100, 16000)
    assert rsmix.launches == before
    with pytest.raises(ConfigError, match="resample_mix_supported"):
        u = v[:, :44099].contiguous()
        rsmix.resample_mix(u, u, 44100, 16000)
    with pytest.raises(ValueError, match="int16"):
        rsmix.resample_mix(v.float(), v, 44100, 16000)
    with pytest.raises(ValueError, match="no rsmix kernel"):
        rsmix.resample_mix(v.to("meta"), v.to("meta"), 44100, 16000)
