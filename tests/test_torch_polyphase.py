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
  fallback, the strided convolution, as the port's wrapper takes its
  twin's, -120 dB;
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
from xmtpu.ops import resample as xresample
from xmtpu_torch.kernels import _build, _seg
from xmtpu_torch.kernels import resample as kres
from xmtpu_torch.kernels import rsmix
from xmtpu_torch.ops import mix as tmix
from xmtpu_torch.ops import resample as tres
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs


def _model(tracks, plan, out_len, epilogue, blocks=7):
    """numpy model of csrc/polyphase.cuh's polyphase_kernel on the
    wrapper's own geometry (``kres.poly_geometry``, K7's for one track,
    K8's for two): ``blocks`` persistent blocks, a multiple of the group
    count, each keeping one group of G phases and walking its (row,
    frame tile) items; each item staged as one window row per frame at
    the odd pitch (unstaged words NaN), K8's rows from the even global
    sample at or before the row's start (``shift``) in aligned pairs;
    lanes on frames, the consumer warps on the group's phases (for the
    default filter in pairs, both from one window of K2 + PAIR_SKEW words
    with each phase's taps shifted to its offset), into a (frames,
    tile_pitch) tile (NaN where unwritten),
    read back in output order. ``tracks``: list of (R, n) arrays;
    float64 sums. Every output must be written exactly once, from staged
    words only."""
    tabs = kres.poly_tables(plan)
    hsel, soff = tabs["hsel"].astype(np.float64), tabs["soff"]
    L, M, K2 = plan.L, plan.M, plan.K2
    R, n = tracks[0].shape
    nj = -(-out_len // L)
    pairs = len(tracks) == 2
    geo = kres.poly_geometry(plan, nj, tracks=len(tracks))
    F, G, P, TP = geo.frames, geo.G, geo.pitch, geo.tile_pitch
    assert P % 2 == 1 and TP % 2 == 1 and TP >= G
    assert not hsel[:, K2:].any()
    blocks = geo.groups * max(1, blocks // geo.groups)
    stride = blocks // geo.groups
    out = np.full((R, out_len), np.nan)
    written = np.zeros((R, out_len), np.int64)
    for blk in range(blocks):
        r0 = (blk % geo.groups) * G
        gl = min(G, L - r0)
        s0 = int(soff[r0])
        W = int(soff[r0 + gl - 1]) - s0 + K2
        taps = hsel[r0:r0 + gl]
        starts = soff[r0:r0 + gl] - s0
        if geo.paired:
            # phases in pairs (2q, 2q + 1) from one window of KW words: each
            # phase's taps shifted to its start's offset from the pair's
            KW = K2 + kres.PAIR_SKEW
            d = np.zeros(gl, int)
            d[1::2] = starts[1::2] - starts[0:gl - 1:2]
            assert d.max() <= kres.PAIR_SKEW
            shifted = np.zeros((gl, KW))
            for rr in range(gl):
                shifted[rr, d[rr]:d[rr] + K2] = taps[rr, :K2]
        for it in range(blk // geo.groups, R * geo.tiles, stride):
            row, ft = divmod(it, geo.tiles)
            c0 = ft * F
            cnt = min(F, nj - c0)
            x0 = c0 * M + s0 + M * np.arange(cnt)  # each row's start
            # K8: aligned pairs from the even global sample at or before,
            # the row placed `shift` words early; K7: the row and
            # PAIR_SKEW zeros past it. Window sample i at column 1 + i
            shift = (row * n + x0) % 2 if pairs else np.zeros(cnt, int)
            Wst = W + kres.PAIR_SKEW
            width = 2 * ((Wst + 2) // 2) if pairs else Wst
            assert width + 1 <= P  # no row runs into the next
            t = (x0 - shift)[:, None] + np.arange(width)[None, :]
            inside = (t >= 0) & (t < n)
            chunks = (not pairs and M % 2 and x0[0] >= 3
                      and x0[-1] + Wst + 3 <= n)
            if chunks:
                # K7 at odd M inside the row: 16-byte chunks (real samples
                # past W), each row's first chunk on an aligned word
                gs = row * n + x0
                o = gs[0] % 4
                assert ((o + np.arange(cnt) * P - gs % 4) % 4 == 0).all()
                assert P >= Wst + 6
            elif not pairs:
                inside &= np.arange(width)[None, :] < W
            wins = []
            for x in tracks:
                w = np.full((F, P + 1), np.nan)
                for cc in range(cnt):
                    w[cc, 1 - shift[cc]:1 - shift[cc] + width] = np.where(
                        inside[cc], x[row, np.clip(t[cc], 0, n - 1)], 0.0)
                wins.append(w)
            tile = np.full((F, TP), np.nan)
            lanes = np.arange(cnt)
            for rr in range(gl):
                if geo.paired:
                    first = starts[rr - rr % 2]
                    k = 1 + first + np.arange(KW)[None, :]
                    accs = [w[lanes[:, None], k] @ shifted[rr] for w in wins]
                else:
                    k = 1 + starts[rr] + np.arange(K2)[None, :]
                    accs = [w[lanes[:, None], k] @ taps[rr, :K2]
                            for w in wins]
                j = (c0 + lanes) * L + r0 + rr
                tile[lanes, rr] = epilogue(j, accs)
            e = np.arange(cnt * gl)
            cc, rr = e // gl, e % gl
            j = (c0 + cc) * L + r0 + rr
            keep = j < out_len
            out[row, j[keep]] = tile[cc[keep], rr[keep]]
            written[row, j[keep]] += 1
    assert (written == 1).all() and not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n", [44100, 44000])  # aligned, not a multiple
def test_resample_vs_pallas(n):
    rng = np.random.default_rng(n)
    x = (0.3 * rng.standard_normal((3, n))).astype(np.float32)
    y_j = np.asarray(xres.resample_pallas(x, 44100, 16000, interpret=True))
    y_t = kres.resample(torch.from_numpy(x), 44100, 16000).numpy()
    db = refs.db(y_t, y_j)
    print(f"K7 twin vs resample_pallas, 3 x {n}: {db:.1f} dB (gate -120)")
    assert y_t.shape == y_j.shape == (3, -(-n * 160 // 441))
    assert y_t.dtype == np.float32 and db <= -120.0


def test_resample_rate_pairs():
    """48k -> 44.1k runs the kernel's path; 48k -> 16k and 16k -> 48k
    (filter band wider than 2*M) take resample_pallas's fallback, the
    strided convolution, and the wrapper its twin's (-120 dB); equal
    rates pass through as float32."""
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((2, 9600))).astype(np.float32)
    y_j = np.asarray(xres.resample_pallas(x, 48000, 44100, interpret=True))
    y_t = kres.resample(torch.from_numpy(x), 48000, 44100).numpy()
    db = refs.db(y_t, y_j)
    print(f"K7 twin vs resample_pallas, 48k -> 44.1k: {db:.1f} dB")
    assert db <= -120.0
    for sr_in, sr_out in ((48000, 16000), (16000, 48000)):
        y_j = np.asarray(xres.resample_pallas(x, sr_in, sr_out,
                                              interpret=True))
        y_t = kres.resample(torch.from_numpy(x), sr_in, sr_out).numpy()
        db = refs.db(y_t, y_j)
        print(f"K7 wrapper (strided conv) vs resample_pallas, {sr_in} -> "
              f"{sr_out}: {db:.1f} dB")
        assert y_t.shape == y_j.shape and db <= -120.0
    same = kres.resample(torch.from_numpy(x).double(), 16000, 16000)
    assert same.dtype == torch.float32


@pytest.mark.parametrize("n,sr_in,sr_out", [
    (44100, 44100, 16000),   # aligned, two phase groups of 80
    (44000, 44100, 16000),   # ragged end
    (9600, 48000, 44100),    # L = 147, M = 160
    (30000, 44100, 32000),   # L = 320: two phase groups of 160
    (700, 44100, 16000),     # one frame tile, window past both ends
    (3200, 32000, 31000),    # M = 32: below resample_pallas's M >= 64
    (44100, 44100, 8000),    # paired windows 6 apart: one phase at a time
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
    db = refs.db(y, ref.numpy())
    print(f"polyphase kernel model {sr_in}->{sr_out}, n={n}: {db:.1f} dB")
    assert db <= -120.0


@pytest.mark.parametrize("n,sr_in,sr_out", [
    (44000, 44100, 16000),   # K2 = 41: two register blocks, 3 groups
    (9600, 48000, 44100),    # M = 160, one group, K2 = 41
])
def test_kernel_model_taps_past_one_register_block(n, sr_in, sr_out):
    """taps_per_phase = 40 (K2 = 41 > kTapRegs = 32) through the model
    against the twin at the same taps_per_phase."""
    g = math.gcd(sr_in, sr_out)
    plan = tres.make_plan(sr_out // g, sr_in // g, 40, 9.0)
    assert plan.K2 == 41
    rng = np.random.default_rng(n + 40)
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    out_len = tres.resample_output_len(n, plan.L, plan.M)
    y = _model([x.astype(np.float64)], plan, out_len,
               lambda j, accs: accs[0])
    ref = tres.polyphase_resample(torch.from_numpy(x), sr_in, sr_out,
                                  taps_per_phase=40)
    db = refs.db(y, ref.numpy())
    print(f"polyphase kernel model {sr_in}->{sr_out}, K2 = 41: {db:.1f} dB")
    assert db <= -120.0


RATES = (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 96000)


def test_pitch_is_conflict_free_at_every_supported_pair():
    """At every pair of common rates the kernel runs (band no wider than
    2M) and at taps_per_phase 24 and 40, for K7 and K8: both pitches are
    odd, so the 32 lanes of a warp (one frame each) load from 32
    distinct banks at any window offset and store to 32 distinct banks
    of the tile; a block's shared bytes stay within the card's 232,448;
    every group's window fits its row."""
    runs = 0
    for sr_in in RATES:
        for sr_out in RATES:
            g = math.gcd(sr_in, sr_out)
            L, M = sr_out // g, sr_in // g
            if L == M:
                continue
            for tpp in (24, 40):
                plan = tres.make_plan(L, M, tpp, 9.0)
                if plan.width > 2 * M:
                    continue
                for tracks in (1, 2):
                    geo = kres.poly_geometry(plan, 1000, tracks=tracks)
                    for pitch in (geo.pitch, geo.tile_pitch):
                        assert math.gcd(pitch, 32) == 1, (sr_in, sr_out, tpp)
                        for off in range(32):
                            banks = (np.arange(32) * pitch + off) % 32
                            assert len(set(banks.tolist())) == 32
                    assert geo.smem <= kres.BLOCK_BYTES <= 232448
                    assert geo.smem == kres.poly_smem(
                        geo.G, geo.frames // 32, geo.pitch, geo.tile_pitch,
                        plan.K2, tracks)
                    s = kres.poly_tables(plan)["soff"]
                    for r0 in range(0, L, geo.G):
                        r1 = min(r0 + geo.G, L) - 1
                        assert (s[r1] - s[r0] + plan.K2 + kres.PAIR_SKEW + 4
                                <= geo.pitch)
                    assert geo.groups == -(-L // geo.G)
                    assert geo.tile_pitch >= geo.G
                    runs += 1
    assert runs >= 40


def test_i16_pair_word_decodes_exactly():
    """K8's staged word: voice in the low half and BGM in the high half,
    each in offset binary; float(0x4B40 << 16 | half) - (2^23 + 32768)
    in float32 is the int16 sample, for every int16 value."""
    a = np.arange(-32768, 32768, dtype=np.int64)
    b = a[::-1].copy()
    word = ((a & 0xFFFF) | ((b & 0xFFFF) << 16)) ^ 0x80008000
    bias = np.float32(12615680.0)
    for half, ref in ((word & 0xFFFF, a), (word >> 16, b)):
        f = (np.uint32(0x4B400000) | half.astype(np.uint32)).view(
            np.float32) - bias
        assert f.dtype == np.float32 and np.array_equal(f, ref)


def test_aligned16_copies_only_unaligned_rows():
    """The wrappers' alignment step: a tensor whose data starts on a
    16-byte boundary passes as it is; a view one sample in is copied to
    aligned storage with the same values."""
    buf = torch.arange(2 * 441 + 1, dtype=torch.float32)
    x = buf[:2 * 441].view(2, 441)
    assert kres.aligned16(x) is x
    y = buf[1:].view(2, 441)
    z = kres.aligned16(y)
    assert y.data_ptr() % 16 and z.data_ptr() % 16 == 0
    assert torch.equal(z, y)


def test_resample_wrapper_contract(monkeypatch):
    x = torch.zeros((2, 44100))
    before = kres.launches
    kres.resample(x, 44100, 16000)
    assert kres.launches == before  # CPU: the twin, no launch
    with pytest.raises(ValueError, match="no resample kernel"):
        kres.resample(x.to("meta"), 44100, 16000)
    # no row limit: the persistent grid walks the work items, however
    # many rows (the parent's grid.y limit, 65535 x 8 rows, is gone)
    monkeypatch.setattr(_seg, "card_slots", lambda q, i, smem: (132, 2))
    plan = tres.make_plan(160, 441, 24, 9.0)
    dev = torch.device("cuda", 0)
    # 5 groups of 32 phases: a multiple of 5, at most one block per group
    # and item (128 frames an item)
    for nj, rows, blocks in ((1000, 65535 * 8 + 1, 260), (1000, 3, 120),
                             (40, 1, 5), (40, 3, 15)):
        geo = kres.poly_geometry(plan, nj)
        assert kres.persistent_blocks("xm_resample_blocks_per_sm", geo, rows,
                                      dev) == blocks
    names = {p.name for p in _build.sources()}
    assert {"resample.cu", "rsmix.cu", "polyphase.cuh"} <= names
    assert {"xm_resample_f32", "xm_rsmix_i16", "xm_resample_blocks_per_sm",
            "xm_rsmix_blocks_per_sm", "xm_resample_nan_fixup"} <= set(
        _build._SIGNATURES)


# ------------------------------------------- the twin's other methods

RATE_PAIRS = [(44100, 16000), (48000, 44100), (16000, 48000),
              (8000, 44100), (48000, 16000), (22050, 96000),
              (96000, 8000), (44100, 32000)]


@pytest.mark.parametrize("sr_in,sr_out", RATE_PAIRS)
def test_conv_and_window_methods_vs_jax(sr_in, sr_out):
    """polyphase_resample(method="conv"|"window") against the JAX
    package's same methods, and "banded" (the conv where the band is
    wider than 2M), at rate pairs check_rates accepts, on an aligned and
    a ragged length: -120 dB (tests/test_resample.py:84's gate)."""
    tres.check_rates(sr_in, sr_out)
    rng = np.random.default_rng(sr_in + sr_out)
    g = math.gcd(sr_in, sr_out)
    M = sr_in // g
    for n in (M * max(2, -(-4000 // M)), 4001):
        x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
        for method in ("banded", "conv", "window"):
            y_t = tres.polyphase_resample(torch.from_numpy(x), sr_in, sr_out,
                                          method=method).numpy()
            y_j = np.asarray(xresample.polyphase_resample(
                jnp.asarray(x), sr_in, sr_out, method=method))
            assert y_t.shape == y_j.shape == (2, tres.resample_output_len(
                n, sr_out // g, M))
            assert refs.db(y_t, y_j) <= -120.0, (n, method)
    with pytest.raises(ValueError, match="method"):
        tres.polyphase_resample(torch.from_numpy(x), sr_in, sr_out,
                                method="fft")


def test_plan_rows_and_resample_window_vs_jax():
    """plan_rows and resample_window (streaming's core) against the JAX
    package's: the same row count, and the same output for a window
    that starts mid-signal (c0 > 0), -120 dB."""
    rng = np.random.default_rng(12)
    for L, M in ((160, 441), (147, 160), (3, 1)):
        plan = tres.make_plan(L, M, 24, 9.0)
        xplan = xresample.make_plan(L, M, 24, 9.0)
        for nj in (1, 7, 64):
            assert tres.plan_rows(plan, nj) == xresample.plan_rows(xplan, nj)
        nj = 7
        xs = (0.3 * rng.standard_normal((2, tres.plan_rows(plan, nj) * M))
              ).astype(np.float32)
        y_t = tres.resample_window(torch.from_numpy(xs), plan, nj).numpy()
        y_j = np.asarray(xresample.resample_window(jnp.asarray(xs), xplan,
                                                   nj))
        assert y_t.shape == y_j.shape == (2, nj * L)
        assert refs.db(y_t, y_j) <= -120.0


def test_conv_resample_owns_its_precision(monkeypatch):
    """The strided conv runs with cuDNN's TF32 off whatever the caller
    set (torch's default is on), puts the caller's flag back, and
    matches JAX ``method="conv"`` (<= -120 dB)."""
    seen = []
    conv1d = torch.nn.functional.conv1d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv1d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    old = torch.backends.cudnn.allow_tf32
    x = (0.3 * np.random.default_rng(13).standard_normal((2, 1600))
         ).astype(np.float32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        y_t = tres.polyphase_resample(torch.from_numpy(x), 16000, 48000,
                                      method="conv")
        assert seen == [False] and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    y_j = xresample.polyphase_resample(jnp.asarray(x), 16000, 48000,
                                       method="conv")
    assert refs.db(y_t.numpy(), np.asarray(y_j)) <= -120.0


def _nonfinite_rows(n, L, M, rng):
    """Rows of noise, each with non-finite samples at one place: a
    frame's interior, its first and last sample, the previous frame's
    tail the band reaches (lo), the next frame's head (hi); NaN, +inf
    and -inf in turn (and NaN alone in the second array)."""
    t = tres.aligned_tables(tres.make_plan(L, M, 24, 9.0))
    nc = max(3, n // M)
    mixed = (0.3 * rng.standard_normal((21, n))).astype(np.float32)
    nan = mixed.copy()
    for r in range(21):
        c = 1 + r % (nc - 2)
        spots = [c * M + M // 2, c * M, c * M + M - 1, c * M + t.lo,
                 c * M - 1, (c + 1) * M + t.hi - 1, (c + 1) * M]
        p = min(max(spots[r % 7], 0), n - 1)
        mixed[r, p] = (np.nan, np.inf, -np.inf)[r % 3]
        nan[r, p] = np.nan
    return mixed, nan


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (48000, 44100)])
@pytest.mark.parametrize("branch", ["aligned", "windowed"])
def test_twin_nonfinite_masks_vs_jax(sr_in, sr_out, branch):
    """The twin's ~isfinite mask (NaN, +inf, -inf) and isnan mask
    (NaN alone) equal JAX polyphase_resample's, in both of its banded
    branches (n % M == 0, and not): the mask K7 must reproduce."""
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    n = 10 * M if branch == "aligned" else 10 * M + 37
    aligned, _, _ = kres.twin_branch(tres.make_plan(L, M, 24, 9.0), n,
                                     tres.resample_output_len(n, L, M))
    assert aligned == (branch == "aligned")
    mixed, nan = _nonfinite_rows(n, L, M, np.random.default_rng(n))
    for x, test in ((mixed, np.isfinite), (nan, np.isnan)):
        y_t = tres.polyphase_resample(torch.from_numpy(x), sr_in,
                                      sr_out).numpy()
        y_j = np.asarray(xresample.polyphase_resample(jnp.asarray(x), sr_in,
                                                      sr_out))
        assert np.array_equal(test(y_t), test(y_j))
        assert (~np.isfinite(y_t)).any()


def _kernel_mask_model(x, plan, out_len):
    """numpy model of K7's non-finite mask (csrc/polyphase.cuh and
    resample.cu's nan_fixup): each phase group's block scans the window
    it stages for a frame (the group's s0 .. s0 + W), the frame's bits
    (1: within its own M samples, 2: before, 4: after) OR over the
    groups, then the fixup by the twin's branch."""
    R, n = x.shape
    L, M, K2 = plan.L, plan.M, plan.K2
    nj = -(-out_len // L)
    geo = kres.poly_geometry(plan, nj)
    soff = kres.poly_tables(plan)["soff"]
    bad = ~np.isfinite(x)
    bits = np.zeros((R, nj), np.int64)
    for r0 in range(0, L, geo.G):
        gl = min(geo.G, L - r0)
        s0 = int(soff[r0])
        W = int(soff[r0 + gl - 1]) - s0 + K2
        for c in range(nj):
            rel = s0 + np.arange(W)
            pos = c * M + rel
            ok = (pos >= 0) & (pos < n)
            hit = np.zeros((R, W), bool)
            hit[:, ok] = bad[:, pos[ok]]
            for cls, sel in ((1, (rel >= 0) & (rel < M)), (2, rel < 0),
                             (4, rel >= M)):
                bits[:, c] |= cls * hit[:, sel].any(axis=1)
    aligned, r0, r2 = kres.twin_branch(plan, n, out_len)
    r = np.arange(L)
    mask = np.zeros((R, nj, L), bool)
    for row in range(R):
        for c in range(nj):
            f = bits[row, c]
            if aligned:
                mask[row, c] = bool(f & 1) | (bool(f & 2) & (r < r0)) | (
                    bool(f & 4) & (r >= r2))
            else:
                mask[row, c] = f != 0
    return mask.reshape(R, nj * L)[:, :out_len]


@pytest.mark.parametrize("n,sr_in,sr_out", [
    (4410, 44100, 16000),    # aligned, five groups of 32 phases
    (4447, 44100, 16000),    # windowed
    (3200, 48000, 44100),    # aligned, two groups (L = 147, M = 160)
    (3237, 48000, 44100),    # windowed
    (4410, 44100, 32000),    # aligned, L = 320
])
def test_kernel_nonfinite_mask_model_matches_twin(n, sr_in, sr_out):
    """The flag-and-fixup design on the wrapper's own tiling: the union
    of the groups' staged windows of a frame is the frame's whole band,
    so the model's mask equals the twin's ~isfinite mask."""
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    plan = tres.make_plan(L, M, 24, 9.0)
    mixed, _ = _nonfinite_rows(n, L, M, np.random.default_rng(n + 1))
    out_len = tres.resample_output_len(n, L, M)
    want = ~np.isfinite(tres.polyphase_resample(torch.from_numpy(mixed),
                                                sr_in, sr_out).numpy())
    assert np.array_equal(_kernel_mask_model(mixed, plan, out_len), want)


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
    db_j, db_o = refs.db(y_t, y_j), refs.db(y_t, ref)
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
    db = refs.db(y, ref)
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
