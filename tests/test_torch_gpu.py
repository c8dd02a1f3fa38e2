"""The port's CUDA kernels against their plain torch twins on the card,
at edge shapes the flagship runs do not reach (ragged tiles, fewer
rows than a warp, an IR longer than the signal, one sample, one
section, carried state; the IIR kernel at 1 to 8 sections, bit for
bit, the float64 state-chain kernel, and the
segmented IIR with NaN; the fftconv kernel at every transform size
(1024 to 16384 points) and the long-IR form at 8193 / 8194 / 24,082 /
65,537 taps, odd rows, a signal shorter than its hop or than its
partitions' frames, and its window spectra as a ring; the envelope
kernel's gain form with NaN input and a carried init, segmented and at
S = 1; the |x| detector of the segmented fused limiter's pass A and the
segmented limiter itself, with NaN too; the segmented eq_env path and
the unfolded steps that run it; the public effects chain on both
limiter forms; the envelope core of the envelope-only and gain forms at
1, 31, 33 and 1024 rows of 1, 127, 129 and 5000 samples and on rows off
a 16-byte boundary, its occupancy queries, and envelope() and
linked_limiter() at the card's segment rule; the resample kernel's
non-finite masks at edge shapes of both of its twin's branches; the
public resample, int16 and float32, on the kernel and on the strided
conv; the effects chain on its float64 scan engine on the card;
measure_lufs (the K-weighting on the IIR kernel, the block powers on
their kernel), suppress and the mixer with its voice chain on the card
against the CPU; BS.1770's block-power kernel against a direct float64
sum of each block at 8 to 48 kHz, one to three channels, around a
block's length, off a 16-byte boundary, over silence and at the mix
cell's 2 x 28.8 M (the same powers on a second run, the gates' blocks
and loudness as on the cumulative-sum twin), and a NaN and an inf each
confined to the blocks that hold them; the mixer's duck at
the mix cell's length over speech and pauses against the float64
reference; the suppressor's
Wiener kernel through suppress (a prime frame count over many segments,
one segment, 2 and 3 frames, 3 rows, a silence around a loud tone, a
floor that binds, a caller's estimate per bin and per row, int16; the
adaptive path launching nothing) and alone at forced segment counts
(T < S, NaN), its launch count and its four ranges; the adaptive
estimate's tracker kernel against its twin bit for bit (a prime T, one
row, T at and below the lead-in, one frame, a partial block, NaN and
inf), its branch decisions against the float64 definition at the
voice44k_adaptive cell's 32 x 60 s on three seeds, a noise step tracked,
the adaptive suppress against the CPU and the oracle at edge shapes, its
four ranges and a launch count that does not grow with the frames, and
the frozen path bit for bit as the Wiener path; the parallel paths on
4 virtual shards of the card against their unsharded forms: the SP
chain on both engines -80 dB, the sharded flagship step -120 dB, a
sharded pool -80 dB, the dryrun twin; where the sharded step's and the
sharded pool's 1-LSB flips come from (the front's and the streaming
resample's ``torch.matmul``: max abs 0 once they run in the shard's row
count); ``xmtpu_torch.entry.entry()`` on the card against the CPU and
the oracle, -80 dB; ``interpret=True`` refused on the card; the
matmul precision rungs card against CPU, -120 dB, rounding apart; K1's
hop-padded ``trim=False`` against its twin, -120 dB, its first n samples
and every ``gp`` bit for bit; K7 at each rung against its split twin,
-120 dB, and its non-finite masks; the ``mixfirst_pad`` step against
``mixfirst``, 1 LSB, -100 dB).

Marked ``gpu``; each test skips without a CUDA device. The module
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: -100 dB RMS against the twin (float32 on both sides; the
kernel's mixed-radix FFTs and the twin's library FFT round differently,
the fused limiter differs by FMA contraction only, and its segmented
form also by the segment carries' reassociation (states: rtol 1e-5); the IIR and envelope-only
kernels round every operation as their twins do and should read exactly
0: the envelope core's tests assert it, and envelope() at the card's
rule equals its twin path bit for bit). The eq_env kernel rounds every
operation as its twin does: max abs 0, asserted; it and the
envelope-only kernel propagate NaN as their twins' torch.maximum does:
equal to the twins with NaN in the same places. The segmented eq_env
path on the kernels runs every pass bit for bit as the same path on the
twins, with the same torch glue: -100 dB, max abs
0 expected (printed); against the one-pass kernel -100 dB (each segment
starts from the float64 state rounded to float32). The fused limiter
propagates NaN as its twin: the same NaN mask, -100 dB elsewhere. The
two resample kernels sum 25 float32 products per
output where the twins' banded matmuls sum the same taps in another
order: -120 dB. The gain form's e2 chain rounds as its twin's (final
states equal); its gain goes through the card's approximate log2 / exp2
where the twin's goes through torch.log/exp: -100 dB, NaN where the
twin's is NaN. The
effects chain on the card against the same chain on the CPU: -90 dB
(the fftconv kernel's and the limiter's differences above); on the
scan engine, the card against the CPU: -120 dB (the same float64 scans;
the reverb's float32 FFTs round differently). The resample kernel's non-finite outputs sit
exactly where its twin's do (~isfinite masks equal; isnan masks equal
for NaN input), -100 dB elsewhere. The fused
step on the card against the same step on the CPU: -90
dB at the int16 output (quantization plus those differences); the
unfused step: -85 dB, because its IIR carries the front's small
card-vs-CPU differences (the resample matmuls sum in another order)
through a long memory into 1-LSB flips of the int16 output (measured
-89.5 dB on an H100); the unfolded, "pallas", "rsmix" and ragged steps
(each branch of the ragged one) likewise: -85 dB. measure_lufs on the
card against the CPU and the float64 oracle: 0.02 LU; the block powers
against the direct float64 sum: rtol 1e-12 in every block (float64
sums in two orders), against the twin at the cell's length the gates
keep the same blocks and the loudness agrees within 1e-9 LU; suppress on the
card against the CPU: -100 dB (two float32 FFT libraries), against its
float64 oracle -80 dB; the Wiener kernel against its twin -100 dB (the
same float32 steps, the smoothing sequential against the twin's scan),
NaN where the twin's is; the tracker kernel against its twin bit for
bit (both round every float64 operation once, in the same order); the
adaptive suppress on the card against the CPU -100 dB (the float64
analyses through two FFT libraries, the float32 synthesis); the mixer
with its voice chain on the card against the CPU (float64 scans): -80
dB; the duck's gain within 1e-4 of the reference at every sample, and
-80 dB; the duck kernel, float64 like its twin (the scans) but composed
in another order: its gain within 1e-9 of the reference at the mix
cell's length, within 1e-12 of the twin at edge lengths and 1e-11 across
carried blocks (states rtol 1e-12), NaN where the twin's is; its mix
form bit for bit its gain form's ``s + bed * g.to(float32)``, and the
shortcut past the knee's ends bit for bit the knee itself.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu_torch import batch as tbatch
from xmtpu_torch.bench import config3_chain, config3_inputs
from xmtpu_torch.kernels import (_build, _seg, duck, envelope, eq_env,
                                  fftconv, iir, lufs, resample, rsmix)
from xmtpu_torch.ops import resample as tres
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("R,n,m", [
    (3, 5000, 37),        # odd rows (a pair with no imaginary row), N 1024
    (2, 3000, 1),         # one tap
    (1, 100, 4093),       # IR longer than the signal
    (2, 20000, 8193),     # the largest FFT block (16384)
    (4, 160000, 4093),    # the flagship row length and IR (N 8192)
])
def test_fftconv_kernel_vs_twin(cuda, R, n, m):
    rng = np.random.default_rng(R * n + m)
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    ir = torch.from_numpy((rng.standard_normal(m) * np.exp(
        -np.arange(m) / (m / 4 + 1))).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(0.5, 2.0, R).astype(np.float32))
    pc = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    args = [t.to(cuda) for t in (x, ir, pr, pc)]
    before = fftconv.launches
    y = fftconv.fir_convolve(*args)
    torch.cuda.synchronize()
    assert fftconv.launches == before + 1
    ref = fftconv.fir_convolve_plain(*args)
    assert y.shape == (R, n) and bool(torch.isfinite(y).all())
    assert refs.db(y, ref) <= -100.0


@pytest.mark.parametrize("m", [2, 513, 1025, 2049, 4093, 8193])
def test_fftconv_every_transform_size(cuda, m):
    """Each compiled transform size (N = 1024, 1024, 2048, 4096, 8192,
    16384) over odd rows and frames that end past n."""
    R, n = 3, 30000
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    ir = torch.from_numpy((rng.standard_normal(m) * np.exp(
        -np.arange(m) / (m / 4 + 1))).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(0.5, 2.0, R).astype(np.float32))
    pc = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    args = [t.to(cuda) for t in (x, ir, pr, pc)]
    y = fftconv.fir_convolve(*args)
    ref = fftconv.fir_convolve_plain(*args)
    db = refs.db(y, ref)
    print(f"fftconv N = {1 << fftconv.fft_log_size(m)} ({m} taps) vs twin: "
          f"{db:.1f} dB")
    assert bool(torch.isfinite(y).all()) and db <= -100.0


@pytest.mark.parametrize("R,n", [(33, 1003), (1, 1), (64, 192), (8, 384)])
def test_envelope_kernel_vs_twin(cuda, R, n):
    rng = np.random.default_rng(R + n)
    x = torch.from_numpy((2.0 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    curve = envelope.curve_of(-3.0, ratio=4.0, makeup_db=1.0)
    k_rel, c_att = 0.99937, 0.0606
    before = envelope.launches
    y, zf = envelope.limiter(x, k_rel, c_att, curve, init=init)
    torch.cuda.synchronize()
    assert envelope.launches == before + 1
    y_p, zf_p = envelope.limiter_plain(x, k_rel, c_att,
                                       envelope.curve_consts(curve), init)
    assert refs.db(y, y_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("R,n,ns", [
    (33, 1003, 5),   # rows not a multiple of 32, n not of the chunk
    (2, 1, 5),       # one sample
    (40, 700, 1),    # one section
    (3, 200, 8),     # the largest template instance
])
def test_iir_kernel_vs_twin(cuda, R, n, ns):
    rng = np.random.default_rng(R * n + ns)
    sos = np.tile(tbatch._biquad.eq_sos(list(tbatch.DEFAULT_BANDS),
                                        16000), (2, 1))[:ns]
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(
        np.float32)).to(cuda)
    s32 = torch.from_numpy(sos.astype(np.float32)).to(cuda)
    zi = torch.from_numpy((0.1 * rng.standard_normal((ns, 2, R))).astype(
        np.float32)).to(cuda)
    before = iir.launches
    y, zf = iir.sosfilt_pass(x, s32, zi)
    torch.cuda.synchronize()
    assert iir.launches == before + 1
    y_p, zf_p = iir.sosfilt_plain(x, s32, zi)
    err = float((y - y_p).abs().max())
    print(f"iir kernel vs twin ({R}, {n}, ns={ns}): max abs {err:.3g}")
    assert refs.db(y, y_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=1e-5, atol=1e-7)


def test_iir_kernel_refuses_too_many_sections(cuda):
    ns = iir.MAX_SECTIONS + 1
    x = torch.zeros((2, 10), device=cuda)
    with pytest.raises(ValueError, match="sections"):
        iir.sosfilt_pass(x, torch.zeros((ns, 6), device=cuda),
                         torch.zeros((ns, 2, 2), device=cuda))


def _iir_operands(cuda, R, n, ns, seed):
    rng = np.random.default_rng(seed)
    sos = np.tile(tbatch._biquad.eq_sos(list(tbatch.DEFAULT_BANDS), 16000),
                  (2, 1))[:ns]
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(
        np.float32)).to(cuda)
    zi = torch.from_numpy((0.1 * rng.standard_normal((ns, 2, R))).astype(
        np.float32)).to(cuda)
    return sos, x, zi


@pytest.mark.parametrize("ns", range(1, 9))
@pytest.mark.parametrize("R,n", [
    (1, 1003),   # one row, many chunks, a ragged last one
    (7, 130),    # rows that do not fill a warp; one steady chunk
    (33, 67),    # the last chunk shorter than the pipeline's lag
    (1024, 1),   # the unfused step's segment-row count, one sample
])
def test_iir_kernel_bit_equal_to_twin(cuda, ns, R, n):
    """The kernel (the cascade pipelined across lanes) equals the twin
    bit for bit, y and zf, from a carried state."""
    sos, x, zi = _iir_operands(cuda, R, n, ns, 100 * ns + R + n)
    s32 = torch.from_numpy(sos.astype(np.float32)).to(cuda)
    y_p, zf_p = iir.sosfilt_plain(x, s32, zi)
    before = iir.launches
    y, zf = iir.sosfilt_pass(x, s32, zi)
    torch.cuda.synchronize()
    assert iir.launches == before + 1
    assert torch.equal(y, y_p)
    assert torch.equal(zf, zf_p)


@pytest.mark.parametrize("ns", range(1, 9))
def test_state_chain_kernel_vs_loop(cuda, ns):
    """The float64 state-chain kernel against its torch loop: 1e-12
    relative (the loop's product may sum in another order); a NaN final
    reaches only the later segments of its row, in both."""
    rng = np.random.default_rng(ns)
    R, S, D = 37, 9, 2 * ns
    zf0 = torch.from_numpy(rng.standard_normal((ns, 2, R * S)).astype(
        np.float32)).to(cuda)
    zf0[0, 1, 4 * S + 3] = float("nan")  # row 4, segment 3
    zi3 = torch.from_numpy(rng.standard_normal((ns, 2, R)).astype(
        np.float32)).to(cuda)
    a_t = torch.from_numpy(np.linalg.matrix_power(
        rng.uniform(-0.3, 0.3, (D, D)), 2)).to(cuda).T
    before = iir.chain_launches
    zin, z = iir._state_chain(zf0, zi3, a_t, S)
    torch.cuda.synchronize()
    assert iir.chain_launches == before + 1
    zin_p, z_p = iir.state_chain_plain(zf0, zi3, a_t, S)
    for a, b in ((zin, zin_p), (z, z_p)):
        assert torch.equal(a.isnan(), b.isnan())
        ok = ~b.isnan()
        assert float((a[ok] - b[ok]).abs().max()) <= 1e-12 * float(
            b[ok].abs().max())
    bad = zin.isnan().any(1).reshape(R, S)
    assert bool(bad[4, 4:].all()) and int(bad.sum()) == S - 4


@pytest.mark.parametrize("S", [None, 2])  # the card's rule (8 here), 2
def test_segmented_sosfilt_on_card_vs_twin_path(cuda, S):
    """The segmented cascade on the kernels (the pass, the state chain)
    against the same path on the plain twin from a carried state: the
    pass equals its twin and the glue is the same code, so max abs 0;
    and against the unsegmented twin: -100 dB (each segment starts from
    the float64 state rounded to float32)."""
    R, n = 3, 16384
    sos, x, zi = _iir_operands(cuda, R, n, 5, 31)
    zi_b = zi.permute(0, 2, 1)  # (ns, R, 2), sosfilt's layout
    assert iir.sosfilt_segments(R, n, cuda, 5) == 8
    before = (iir.launches, iir.chain_launches)
    y, zf = iir.sosfilt(sos, x, zi=zi_b, segments=S)
    torch.cuda.synchronize()
    assert (iir.launches, iir.chain_launches) == (before[0] + 1,
                                                  before[1] + 1)
    y_t, zf_t = iir.sosfilt(sos, x, zi=zi_b, segments=S,
                            run=iir.sosfilt_plain)
    y1, zf1 = iir.sosfilt_plain(x, torch.from_numpy(sos.astype(
        np.float32)).to(cuda), zi)
    err = max(float((y - y_t).abs().max()), float((zf - zf_t).abs().max()))
    db = refs.db(y, y1)
    print(f"segmented sosfilt (segments={S}) vs its twin path: max abs "
          f"{err:.3g}; vs the unsegmented twin {db:.1f} dB")
    assert err == 0.0
    assert db <= -100.0
    # final states as tests/test_torch_iir.py holds them: within 1e-4
    torch.testing.assert_close(zf, zf1.permute(0, 2, 1), rtol=0, atol=1e-4)


def test_segmented_sosfilt_propagates_nan(cuda):
    """A NaN sample in segment 4 of row 1 at the card's rule (S = 8):
    NaN from that sample to the row's end and in its final states, as
    the unsegmented twin puts it, and nowhere else."""
    R, n = 3, 16384
    sos, x, zi = _iir_operands(cuda, R, n, 5, 32)
    x[1, 9000] = float("nan")
    y, zf = iir.sosfilt(sos, x, zi=zi.permute(0, 2, 1))
    y1, zf1 = iir.sosfilt_plain(x, torch.from_numpy(sos.astype(
        np.float32)).to(cuda), zi)
    assert bool(y1[1, 9000:].isnan().all()) and int(y1.isnan().sum()) == (
        n - 9000)
    assert torch.equal(y.isnan(), y1.isnan())
    assert torch.equal(zf.isnan(), zf1.permute(0, 2, 1).isnan())
    ok = ~y1.isnan()
    assert refs.db(y[ok], y1[ok]) <= -100.0


@pytest.mark.parametrize("R,n,corr", [
    (33, 1003, False), (33, 1003, True), (1, 1, True), (64, 192, True),
])
def test_envelope_only_kernel_vs_twin(cuda, R, n, corr):
    rng = np.random.default_rng(R + n + corr)
    d = torch.from_numpy(np.abs(rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    extra = ()
    if corr:
        extra = (torch.from_numpy(envelope.seg_ktab(0.999, n)).to(cuda),
                 torch.from_numpy(rng.uniform(0.0, 3.0, R).astype(
                     np.float32)).to(cuda))
    before = envelope.envelope_launches
    e2, zf = envelope.envelope_pass(d, 0.99937, 0.0606, init, *extra)
    torch.cuda.synchronize()
    assert envelope.envelope_launches == before + 1
    e2_p, zf_p = envelope.envelope_plain(d, 0.99937, 0.0606, init, *extra)
    err = float((e2 - e2_p).abs().max())
    print(f"envelope-only kernel vs twin ({R}, {n}, corr={corr}): max abs "
          f"{err:.3g}")
    assert refs.db(e2, e2_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=1e-5, atol=1e-7)


def test_unfused_step_on_card_matches_cpu(cuda):
    """The small-batch branch (2 x 2 s: 4 segments for both segmented
    kernels) on the card against the same step on the CPU."""
    rng = np.random.default_rng(6)
    v = (rng.standard_normal((2, 88200)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 88200)) * 6000).astype(np.int16)
    y_cpu = tbatch.make_flagship_step(device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    step = tbatch.make_flagship_step(device=cuda)
    counts = (fftconv.launches, iir.launches, envelope.envelope_launches)
    y = step(torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    assert (fftconv.launches, iir.launches, envelope.envelope_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 2)
    assert y.dtype == torch.int16 and y.shape == (2, 32000)
    assert refs.db(y, y_cpu) <= -85.0


def test_step_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((2, 22050)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22050)) * 6000).astype(np.int16)
    y_cpu = tbatch.make_flagship_step(fused=True, device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    step = tbatch.make_flagship_step(fused=True, device=cuda)
    counts = (fftconv.launches, envelope.launches)
    y = step(torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    assert (fftconv.launches, envelope.launches) == (counts[0] + 1,
                                                      counts[1] + 1)
    assert y.dtype == torch.int16 and y.shape == (2, 8000)
    assert refs.db(y, y_cpu) <= -90.0


def test_step_refuses_tf32_and_mixed_devices(cuda):
    step = tbatch.make_flagship_step(fused=True, device=cuda)
    v = torch.zeros((2, 22050), dtype=torch.int16, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ConfigError):
            step(v, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.zeros((2, 100), device=cuda)
    with pytest.raises(ValueError):
        fftconv.fir_convolve(x, torch.ones(3), torch.ones(2, device=cuda),
                             torch.ones(100, device=cuda))


@pytest.mark.parametrize("R,n,ns", [
    (33, 1003, 5),   # rows not a multiple of 32, n not of the chunk (32)
    (2, 1, 5),       # one sample
    (40, 700, 1),    # one section
    (3, 200, 8),     # the largest template instance
    (64, 96, 5),     # whole chunks, two blocks
])
def test_eq_env_kernel_vs_twin(cuda, R, n, ns):
    rng = np.random.default_rng(R * n + ns + 1)
    sos = np.tile(tbatch._biquad.eq_sos(list(tbatch.DEFAULT_BANDS),
                                        16000), (2, 1))[:ns]
    s32 = torch.from_numpy(sos.astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(
        np.float32)).to(cuda)
    zi = torch.from_numpy((0.1 * rng.standard_normal((ns, 2, R))).astype(
        np.float32)).to(cuda)
    ei = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    k_rel, c_att = 0.99937, 0.0606
    before = eq_env.launches
    out = eq_env.eq_env_pass(x, s32, zi, ei, k_rel, c_att)
    torch.cuda.synchronize()
    assert eq_env.launches == before + 1
    ref = eq_env.eq_env_plain(x, s32, zi, ei, k_rel, c_att)
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    print(f"eq_env kernel vs twin ({R}, {n}, ns={ns}): max abs (y, e2, zf, "
          f"ef) {errs}")
    assert errs == [0.0, 0.0, 0.0, 0.0]


def test_eq_env_kernel_propagates_nan(cuda):
    """A NaN sample (row 1) and a NaN envelope state (row 2, with a
    finite signal: only the envelope's max can carry it) give NaN where
    the twin gives NaN, and the other rows stay bit-equal."""
    rng = np.random.default_rng(11)
    sos = tbatch._biquad.eq_sos(list(tbatch.DEFAULT_BANDS), 16000)
    ns = sos.shape[0]
    s32 = torch.from_numpy(sos.astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((3, 300)).astype(
        np.float32)).to(cuda)
    x[1, 100] = float("nan")
    zi = torch.zeros((ns, 2, 3), device=cuda)
    ei = torch.zeros((2, 3), device=cuda)
    ei[0, 2] = float("nan")
    out = eq_env.eq_env_pass(x, s32, zi, ei, 0.99937, 0.0606)
    ref = eq_env.eq_env_plain(x, s32, zi, ei, 0.99937, 0.0606)
    assert bool(ref[1][2].isnan().all()) and bool(ref[1][1, 100:].isnan().all())
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("corr", [False, True])
def test_envelope_only_kernel_propagates_nan(cuda, corr):
    rng = np.random.default_rng(12)
    R, n = 3, 300
    d = torch.from_numpy(np.abs(rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    d[1, 100] = float("nan")
    init = torch.zeros((2, R), device=cuda)
    init[0, 2] = float("nan")
    extra = ()
    if corr:
        extra = (torch.from_numpy(envelope.seg_ktab(0.999, n)).to(cuda),
                 torch.tensor([0.5, 1.0, 2.0], device=cuda))
    out = envelope.envelope_pass(d, 0.99937, 0.0606, init, *extra)
    ref = envelope.envelope_plain(d, 0.99937, 0.0606, init, *extra)
    assert bool(ref[0][2].isnan().all()) and bool(ref[0][1, 100:].isnan().all())
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("R,n,sr_in,sr_out", [
    (3, 44100, 44100, 16000),   # aligned rows
    (5, 44000, 44100, 16000),   # odd rows, not a multiple of 441
    (1, 700, 44100, 16000),     # one frame tile, window past both ends
    (2, 9600, 48000, 44100),    # L = 147, M = 160
    (2, 30000, 44100, 32000),   # L = 320: two phase groups
    (2, 3200, 32000, 31000),    # M = 32: resample_pallas's M < 64 exit
    (3, 19200, 48000, 11025),   # even M = 640, three phase groups
    (37, 50000, 44100, 16000),  # 37 rows, a ragged last frame tile
    (2, 44100, 44100, 8000),    # K2 = 25, pair skew 6: the any-K2 instance
])
def test_resample_kernel_vs_twin(cuda, R, n, sr_in, sr_out):
    rng = np.random.default_rng(R + n)
    x = torch.from_numpy((0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    before = resample.launches
    y = resample.resample(x, sr_in, sr_out)
    torch.cuda.synchronize()
    assert resample.launches == before + 1
    ref = tres.polyphase_resample(x, sr_in, sr_out)
    db = refs.db(y, ref)
    print(f"resample kernel vs twin ({R}, {n}, {sr_in}->{sr_out}): {db:.1f} "
          "dB")
    assert y.shape == ref.shape and db <= -120.0


@pytest.mark.parametrize("R,n,sr_in,sr_out", [
    (1, 882, 44100, 16000),     # n = 2M: the smallest aligned row
    (3, 441 * 10, 44100, 16000),    # aligned, five phase groups
    (3, 441 * 10 + 1, 44100, 16000),  # windowed
    (2, 700, 44100, 16000),     # windowed, one tile past both ends
    (37, 50000, 44100, 16000),  # 37 rows, a ragged last frame tile
    (2, 9600, 48000, 44100),    # L = 147, M = 160, aligned
    (2, 9601, 48000, 44100),    # windowed
    (2, 30000, 44100, 32000),   # L = 320: two phase groups
    (2, 44100, 44100, 8000),    # the any-K2 instance (pair skew 6)
])
def test_resample_kernel_nonfinite_masks(cuda, R, n, sr_in, sr_out):
    """NaN, +inf and -inf at a frame's interior and edges, a row's first
    and last sample and in the band's reach of the neighbour frames: the
    kernel's ~isfinite mask equals its twin's (isnan for NaN alone), and
    the finite outputs read -100 dB against it."""
    g = np.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    t = tres.aligned_tables(tres.make_plan(L, M, 24, 9.0))
    rng = np.random.default_rng(R + n)
    x = (0.3 * rng.standard_normal((R, n))).astype(np.float32)
    only_nan = x.copy()
    c = max(1, n // M // 2)
    spots = [0, n - 1, c * M, c * M + M // 2, c * M - 1, c * M + t.lo,
             (c + 1) * M + t.hi - 1]
    for r in range(R):
        for k, p in enumerate(spots[r % 3::3]):
            p = min(max(p, 0), n - 1)
            x[r, p] = (np.nan, np.inf, -np.inf)[(r + k) % 3]
            only_nan[r, p] = np.nan
    for arr, nan in ((x, False), (only_nan, True)):
        xd = torch.from_numpy(arr).to(cuda)
        y = resample.resample(xd, sr_in, sr_out)
        ref = tres.polyphase_resample(xd, sr_in, sr_out)
        torch.cuda.synchronize()
        fin, fin_ref = torch.isfinite(y), torch.isfinite(ref)
        assert torch.equal(fin, fin_ref) and bool((~fin_ref).any())
        if nan:
            assert torch.equal(torch.isnan(y), torch.isnan(ref))
        db = refs.db(y[fin], ref[fin]) if fin.any() else -np.inf
        print(f"resample kernel non-finite ({R}, {n}, {sr_in}->{sr_out}, "
              f"NaN only {nan}): masks equal, finite {db:.1f} dB")
        assert db <= -100.0


@pytest.mark.parametrize("rates", [(44100, 16000), (16000, 48000)])
def test_api_resample_on_card(cuda, rates):
    """xmtpu_torch.resample on the card (K7 at 44.1k -> 16k; the strided
    conv at 16k -> 48k, band wider than 2M) against the CPU twin: int16
    (n, 2) within 1 LSB, float32 (n,) -120 dB. It runs at torch's
    default flags (cuDNN's TF32 on): the conv turns TF32 off itself."""
    rng = np.random.default_rng(9)
    x16 = (rng.standard_normal((16000, 2)) * 9000).astype(np.int16)
    x32 = (0.3 * rng.standard_normal(16001)).astype(np.float32)
    before = resample.launches
    old = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True  # torch's default
        y16 = xmtpu_torch.resample(x16, *rates)
        y32 = xmtpu_torch.resample(torch.from_numpy(x32).to(cuda), *rates)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    assert resample.launches - before == (2 if rates[1] == 16000 else 0)
    c16 = xmtpu_torch.resample(x16, *rates, device="cpu")
    c32 = xmtpu_torch.resample(x32, *rates, device="cpu")
    assert y16.shape == c16.shape and y16.dtype == np.int16
    assert np.abs(y16.astype(np.int32) - c16.astype(np.int32)).max() <= 1
    assert y32.shape == c32.shape and y32.dtype == np.float32
    assert refs.db(y32, c32) <= -120.0


def test_effects_scan_engine_on_card(cuda):
    """effects(backend="scan") on the card: no kernel launches, the same
    result as the CPU scan engine (-120 dB: the reverb's float32 FFTs),
    whole and blocked."""
    x, _ = config3_inputs(batch=2, seconds=0.5)
    chain = config3_chain()
    y_cpu = xmtpu_torch.effects(x, 48000, chain, device="cpu",
                                backend="scan")
    before = _counts()
    for blk in (None, 8192):
        y = xmtpu_torch.effects(torch.from_numpy(x).to(cuda), 48000, chain,
                                device=cuda, backend="scan", block_size=blk,
                                device_out=True)
        torch.cuda.synchronize()
        db = refs.db(y, y_cpu)
        print(f"effects scan engine (block {blk}) on the card vs the CPU: "
              f"{db:.1f} dB")
        assert y.shape == x.shape and db <= -120.0
    assert _launched(before) == set()


@pytest.mark.parametrize("B,n,sr_in,sr_out,fade,gb", [
    (3, 44100, 44100, 16000, 4000, 0.4),   # single block (_pick_F == nc)
    (5, 441 * 24, 44100, 16000, 0, 0.4),   # odd rows, no fade
    (2, 9600, 48000, 44100, 100, 0.7),     # 48k -> 44.1k
    (3, 160 * 128, 48000, 44100, 12000, 0.4),  # fade > a 9408-output tile
])
def test_rsmix_kernel_vs_twin(cuda, B, n, sr_in, sr_out, fade, gb):
    if (B, n) == (3, 44100):
        assert rsmix._pick_F(n // 441) == n // 441
    rng = np.random.default_rng(B * n)
    v = torch.from_numpy((rng.standard_normal((B, n)) * 9000).astype(
        np.int16)).to(cuda)
    b = torch.from_numpy((rng.standard_normal((B, n)) * 7000).astype(
        np.int16)).to(cuda)
    before = rsmix.launches
    y = rsmix.resample_mix(v, b, sr_in, sr_out, bgm_gain=gb, fade=fade)
    torch.cuda.synchronize()
    assert rsmix.launches == before + 1
    g = np.gcd(sr_in, sr_out)
    plan = tres.make_plan(sr_out // g, sr_in // g, 24, 9.0)
    ref = rsmix.resample_mix_plain(v, b, plan, gb, fade)
    db = refs.db(y, ref)
    print(f"rsmix kernel vs twin ({B}, {n}, {sr_in}->{sr_out}, fade {fade}):"
          f" {db:.1f} dB")
    assert y.shape == ref.shape and db <= -120.0


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (48000, 44100)])
def test_polyphase_kernels_past_one_register_block(cuda, sr_in, sr_out):
    """taps_per_phase = 40 (K2 = 41, two blocks of register taps) on K7
    and K8 against their twins at the same taps."""
    g = np.gcd(sr_in, sr_out)
    plan = tres.make_plan(sr_out // g, sr_in // g, 40, 9.0)
    assert plan.K2 == 41
    rng = np.random.default_rng(41)
    n = plan.M * 64
    x = torch.from_numpy((0.3 * rng.standard_normal((3, n))).astype(
        np.float32)).to(cuda)
    y = resample.resample(x, sr_in, sr_out, taps_per_phase=40)
    ref = tres.polyphase_resample(x, sr_in, sr_out, taps_per_phase=40)
    db = refs.db(y, ref)
    v, b = (torch.from_numpy((rng.standard_normal((3, n)) * 9000).astype(
        np.int16)).to(cuda) for _ in range(2))
    y8 = rsmix.resample_mix(v, b, sr_in, sr_out, bgm_gain=0.4, fade=500,
                            taps_per_phase=40)
    ref8 = rsmix.resample_mix_plain(v, b, plan, 0.4, 500)
    db8 = refs.db(y8, ref8)
    print(f"K2 = 41, {sr_in}->{sr_out}: resample {db:.1f} dB, rsmix "
          f"{db8:.1f} dB vs twins")
    assert y.shape == ref.shape and db <= -120.0
    assert y8.shape == ref8.shape and db8 <= -120.0


def test_polyphase_kernels_take_unaligned_rows(cuda):
    """Rows whose data starts off a 16-byte boundary (a view one sample
    into its buffer): the wrappers copy them aligned; K7 (16-byte chunks
    at odd M) and K8 (sample pairs) match their twins."""
    rng = np.random.default_rng(5)
    R, n = 3, 441 * 40
    buf = torch.from_numpy((0.3 * rng.standard_normal(R * n + 1)).astype(
        np.float32)).to(cuda)
    x = buf[1:].view(R, n)
    assert x.is_contiguous() and x.data_ptr() % 16
    y = resample.resample(x, 44100, 16000)
    ref = tres.polyphase_resample(x, 44100, 16000)
    db = refs.db(y, ref)
    ibuf = torch.from_numpy((rng.standard_normal(2 * R * n + 2) * 9000).astype(
        np.int16)).to(cuda)
    v = ibuf[1:R * n + 1].view(R, n)  # one and R*n + 1 samples in: 2 bytes
    b = ibuf[R * n + 1:2 * R * n + 1].view(R, n)  # off a 4-byte boundary
    assert v.data_ptr() % 4 and b.data_ptr() % 4
    y8 = rsmix.resample_mix(v, b, 44100, 16000, bgm_gain=0.4, fade=300)
    ref8 = rsmix.resample_mix_plain(v, b, tres.make_plan(160, 441, 24, 9.0),
                                    0.4, 300)
    db8 = refs.db(y8, ref8)
    print(f"unaligned rows: resample {db:.1f} dB, rsmix {db8:.1f} dB")
    assert db <= -120.0 and db8 <= -120.0


@pytest.mark.parametrize("kw", [
    {"fused": True, "lti_fold": False},
    {"fused": True, "resample_backend": "pallas"},
    {"fused": False, "resample_backend": "rsmix"},
])
def test_new_branches_on_card_match_cpu(cuda, kw):
    rng = np.random.default_rng(8)
    v = (rng.standard_normal((2, 22050)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22050)) * 6000).astype(np.int16)
    y_cpu = tbatch.make_flagship_step(device="cpu", **kw)(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    y = tbatch.make_flagship_step(device=cuda, **kw)(
        torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    assert y.dtype == torch.int16 and y.shape == (2, 8000)
    assert refs.db(y, y_cpu) <= -85.0


def _counts() -> dict:
    return {"fftconv": fftconv.launches, "iir": iir.launches,
            "envelope": envelope.launches,
            "envelope_seg": envelope.envelope_launches,
            "eq_env": eq_env.launches, "resample": resample.launches,
            "rsmix": rsmix.launches, "fftconv_long": fftconv.long_launches,
            "gain": envelope.gain_launches, "lufs": lufs.launches,
            "duck": duck.launches}


def _launched(before: dict) -> set:
    return {k for k, v in _counts().items() if v > before[k]}


def test_rsmix_fallback_on_card_runs_resample_kernel(cuda):
    """At a length K8's gate refuses, the "rsmix" step's two-track front
    resamples on K7."""
    rng = np.random.default_rng(10)
    v = (rng.standard_normal((2, 22000)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22000)) * 6000).astype(np.int16)
    assert not rsmix.resample_mix_supported(22000, 2, 44100, 16000)
    kw = {"fused": True, "resample_backend": "rsmix"}
    y_cpu = tbatch.make_flagship_step(device="cpu", **kw)(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    before = _counts()
    y = tbatch.make_flagship_step(device=cuda, **kw)(
        torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    torch.cuda.synchronize()
    assert _launched(before) == {"resample", "fftconv", "envelope"}
    assert refs.db(y, y_cpu) <= -85.0


@pytest.mark.parametrize("kw,kernels", [
    ({}, {"iir", "fftconv", "envelope_seg"}),   # 2 rows: unfused
    ({"fused": True}, {"fftconv", "envelope_seg"}),
    ({"fused": True, "lti_fold": False}, {"fftconv", "eq_env"}),
])
def test_batch_step_on_card_matches_cpu(cuda, kw, kernels):
    """Each branch of the ragged step on the card: exactly its kernels
    launch, the output matches the CPU step, the pad stays 0."""
    rng = np.random.default_rng(9)
    v = (rng.standard_normal((2, 22050)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22050)) * 6000).astype(np.int16)
    v[1, 15000:] = 0
    b[1, 15000:] = 0
    lengths = torch.tensor([22050, 15000])
    y_cpu = tbatch.make_batch_step(device="cpu", **kw)(
        torch.from_numpy(v), torch.from_numpy(b), lengths).double()
    before = _counts()
    y = tbatch.make_batch_step(device=cuda, **kw)(
        torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda),
        lengths.to(cuda))
    torch.cuda.synchronize()
    assert _launched(before) == kernels
    assert y.dtype == torch.int16 and y.shape == (2, 8000)
    assert not y[1, 5443:].any()
    db = refs.db(y, y_cpu)
    print(f"ragged step {kw} on the card vs the CPU: {db:.1f} dB")
    assert db <= -85.0


@pytest.mark.parametrize("R,n,m", [
    (2, 20000, 8193),     # the short form's largest IR
    (2, 40000, 8194),     # the first partitioned one: a 2-tap last part
    (3, 30000, 24082),    # config 3's folded IR (3 parts), odd rows
    (2, 5000, 24082),     # n < hop: one partial frame, all parts padding
    (3, 10000, 24082),    # fewer frames (2) than parts (3), odd rows
    (2, 100000, 65537),   # 9 parts: the JAX kernel's largest block's IR
])
def test_fftconv_long_kernel_vs_twin(cuda, R, n, m):
    """The long form runs one forward transform a frame and row pair
    (``long_forward_transforms``), not one a partition too."""
    args = _fir_operands(cuda, R, n, m)
    before = _counts()
    fwd = fftconv.long_forward_transforms
    y = fftconv.fir_convolve(*args)
    torch.cuda.synchronize()
    long = m > fftconv.MAX_SHORT_TAPS
    assert _launched(before) == {"fftconv_long" if long else "fftconv"}
    assert fftconv.long_forward_transforms - fwd == (
        -(-R // 2) * -(-n // fftconv.LONG_HOP) if long else 0)
    ref = fftconv.fir_convolve_plain(*args)
    db = refs.db(y, ref)
    print(f"fftconv ({R}, {n}) x {m} taps vs twin: {db:.1f} dB")
    assert y.shape == (R, n) and bool(torch.isfinite(y).all())
    assert db <= -100.0


def _fir_operands(cuda, R, n, m):
    rng = np.random.default_rng(R * n + m)
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    ir = torch.from_numpy((rng.standard_normal(m) * np.exp(
        -np.arange(m) / (m / 4 + 1))).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(0.5, 2.0, R).astype(np.float32))
    pc = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    return [t.to(cuda) for t in (x, ir, pr, pc)]


@pytest.mark.parametrize("R,n,m,cap", [
    (4, 100000, 24082, 2 << 20),   # a ring of 8 spectra a pair, chunks of 6
    (3, 120000, 65537, 1 << 10),   # room for none: 9 slots, 1 frame a chunk
])
def test_fftconv_long_ring_vs_twin(cuda, monkeypatch, R, n, m, cap):
    """Past ``LONG_SPECTRA_BYTES`` the window spectra run as a ring and
    the frames in chunks: bit for bit the output with all windows kept."""
    args = _fir_operands(cuda, R, n, m)
    y_all = fftconv.fir_convolve(*args)
    monkeypatch.setattr(fftconv, "LONG_SPECTRA_BYTES", cap)
    assert fftconv.long_schedule(R, n, m)[0] < -(-n // fftconv.LONG_HOP)
    y = fftconv.fir_convolve(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, y_all)
    ref = fftconv.fir_convolve_plain(*args)
    assert refs.db(y, ref) <= -100.0


def _gain_operands(cuda, R, n, corr, seed):
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(np.abs(2.0 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    extra = ()
    if corr:
        extra = (torch.from_numpy(envelope.seg_ktab(0.999, n)).to(cuda),
                 torch.from_numpy(rng.uniform(0.0, 3.0, R).astype(
                     np.float32)).to(cuda))
    return d, init, extra


@pytest.mark.parametrize("R,n,corr", [
    (33, 1003, False), (33, 1003, True), (1, 1, True), (64, 192, False),
])
def test_gain_kernel_vs_twin(cuda, R, n, corr):
    """The gain form from a carried (caller-given) init, with and
    without the inline correction (pass B k_rel = 0 and a full pass)."""
    d, init, extra = _gain_operands(cuda, R, n, corr, R + n + corr)
    curve = envelope.curve_of(-3.0, ratio=4.0, makeup_db=1.0)
    k_rel = 0.0 if corr else 0.99937
    before = _counts()
    g, zf = envelope.envelope_pass(d, k_rel, 0.0606, init, *extra,
                                   curve=curve, curve_mode="gain")
    torch.cuda.synchronize()
    assert _launched(before) == {"gain"}
    g_p, zf_p = envelope.envelope_plain(d, k_rel, 0.0606, init, *extra,
                                        curve=curve, curve_mode="gain")
    print(f"gain kernel vs twin ({R}, {n}, corr={corr}): "
          f"{refs.db(g, g_p):.1f} dB, max abs "
          f"{float((g - g_p).abs().max()):.3g}")
    assert refs.db(g, g_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=0, atol=0)


@pytest.mark.parametrize("corr", [False, True])
def test_gain_kernel_propagates_nan(cuda, corr):
    d, init, extra = _gain_operands(cuda, 3, 300, corr, 13)
    d[1, 100] = float("nan")
    init[0, 2] = float("nan")
    curve = envelope.curve_of(-3.0)
    g, zf = envelope.envelope_pass(d, 0.99937, 0.0606, init, *extra,
                                   curve=curve, curve_mode="gain")
    g_p, zf_p = envelope.envelope_plain(d, 0.99937, 0.0606, init, *extra,
                                        curve=curve, curve_mode="gain")
    assert bool(g_p[2].isnan().all()) and bool(g_p[1, 100:].isnan().all())
    assert torch.equal(g.isnan(), g_p.isnan())
    ok = ~g_p.isnan()
    assert refs.db(g[ok], g_p[ok]) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("segments,kernels", [
    (None, {"envelope_seg", "gain"}),   # S = 8: pass A, gain-form pass B
    (1, {"gain"}),                      # one gain-form pass
])
def test_linked_limiter_on_card_vs_twin_path(cuda, segments, kernels):
    rng = np.random.default_rng(21)
    x = torch.from_numpy((0.5 * rng.standard_normal((2, 2, 48000))).astype(
        np.float32)).to(cuda)
    x[0, :, 1000:1300] *= 6.0
    init = (torch.tensor([0.3, 0.0], device=cuda),
            torch.tensor([0.2, 0.1], device=cuda))
    args = (x, 0.99979, 0.0206, -3.0)
    before = _counts()
    y, st = envelope.linked_limiter(*args, init=init, segments=segments)
    torch.cuda.synchronize()
    assert _launched(before) == kernels
    y_p, st_p = envelope.linked_limiter(*args, init=init, segments=segments,
                                        run=envelope.envelope_plain)
    db = refs.db(y, y_p)
    print(f"linked limiter (segments={segments}) vs its twin path: "
          f"{db:.1f} dB")
    assert db <= -100.0
    for a, b in zip(st, st_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("linked,kernels", [
    (False, {"fftconv_long", "envelope_seg"}),
    (True, {"fftconv_long", "envelope_seg", "gain"}),
])
def test_effects_on_card_matches_cpu(cuda, linked, kernels):
    """Config 3's chain (24,082-tap folded IR) on 2 stereo clips of 1 s:
    the long-IR fftconv and the limiter's kernels launch."""
    x, _ = config3_inputs(batch=2, seconds=1.0)
    chain = config3_chain(linked_fuse=linked)
    y_cpu = xmtpu_torch.effects(x, 48000, chain, device="cpu",
                                backend="pallas")
    before = _counts()
    y = xmtpu_torch.effects(torch.from_numpy(x).to(cuda), 48000, chain,
                            device=cuda, device_out=True)
    torch.cuda.synchronize()
    assert _launched(before) == kernels
    db = refs.db(y, y_cpu)
    print(f"effects (linked_fuse={linked}) on the card vs the CPU: {db:.1f} "
          "dB")
    assert y.shape == x.shape and db <= -90.0


@pytest.mark.parametrize("R,n", [(33, 1003), (1, 1), (256, 5000)])
def test_abs_detector_pass_bit_equal(cuda, R, n):
    """Pass A's |x| detector in the kernel equals the pass over a
    stored |x|, bit for bit (NaN included)."""
    rng = np.random.default_rng(R * n)
    x = torch.from_numpy((2.0 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    x[0, n // 2] = float("nan")
    zeros = torch.zeros((2, R), device=cuda)
    before = _counts()
    a = envelope.envelope_pass(x, 0.99937, 1.0, zeros, abs_detector=True)
    torch.cuda.synchronize()
    assert _launched(before) == {"envelope_seg"}
    b = envelope.envelope_pass(x.abs(), 0.99937, 1.0, zeros)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("R,n,S", [
    (256, 160000, None),  # the flagship shape, the card's rule
    (3, 40000, 8),
    (1, 8192, 2),
])
def test_segmented_limiter_on_card(cuda, R, n, S):
    """The segmented fused limiter (pass A, carries, fused pass B)
    against the unsegmented kernel and the plain twin, from a carried
    init."""
    rng = np.random.default_rng(R + n)
    x = torch.from_numpy((0.9 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    curve = envelope.curve_of(-3.0)
    k_rel, c_att = 0.99937, 0.0606
    S_run = envelope.limiter_segments(R, n, c_att, cuda) if S is None else S
    assert S_run > 1
    before = _counts()
    y, zf = envelope.limiter(x, k_rel, c_att, curve, init=init, segments=S)
    torch.cuda.synchronize()
    assert _launched(before) == {"envelope", "envelope_seg"}
    y1, zf1 = envelope.limiter(x, k_rel, c_att, curve, init=init,
                               segments=1)
    y_p, zf_p = envelope.limiter_plain(x, k_rel, c_att,
                                       envelope.curve_consts(curve), init)
    db1, dbp = refs.db(y, y1), refs.db(y, y_p)
    print(f"segmented limiter ({R}, {n}, S = {S_run}) vs the unsegmented "
          f"kernel {db1:.1f} dB, vs the twin {dbp:.1f} dB")
    assert db1 <= -100.0 and dbp <= -100.0
    torch.testing.assert_close(zf, zf1, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(zf, zf_p, rtol=1e-5, atol=1e-7)


def test_step_segments_limiter_on_card(cuda):
    """The fused step at 2 clips of 2 s: on the card its limiter runs
    segmented (the rule's S = 4 at 32000 samples), on the CPU in one
    pass; the outputs agree."""
    rng = np.random.default_rng(14)
    v = (rng.standard_normal((2, 88200)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 88200)) * 6000).astype(np.int16)
    assert envelope.limiter_segments(2, 32000, 0.0606, cuda) == 4
    y_cpu = tbatch.make_flagship_step(fused=True, device="cpu")(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    before = _counts()
    y = tbatch.make_flagship_step(fused=True, device=cuda)(
        torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    torch.cuda.synchronize()
    assert _launched(before) == {"fftconv", "envelope", "envelope_seg"}
    assert y.dtype == torch.int16 and y.shape == (2, 32000)
    assert refs.db(y, y_cpu) <= -90.0


@pytest.mark.parametrize("S", [1, None])  # one fused pass; the card's rule
def test_limiter_propagates_nan(cuda, S):
    """A NaN sample in segment 4 of row 0 and a NaN initial envelope on
    row 1: the fused limiter, unsegmented and at the rule's S (8 here),
    gives NaN exactly where the twin does (never a clamped +-ceiling
    there) and reads -100 dB against it elsewhere."""
    R, n = 3, 40000
    rng = np.random.default_rng(15)
    x = torch.from_numpy((0.9 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    x[0, 22000] = float("nan")
    init = torch.tensor([[0.3, float("nan"), 0.1], [0.2, 0.1, 0.0]],
                        device=cuda)
    curve = envelope.curve_of(-3.0)
    k_rel, c_att = 0.99937, 0.0606
    assert envelope.limiter_segments(R, n, c_att, cuda) == 8
    y, zf = envelope.limiter(x, k_rel, c_att, curve, init=init, segments=S)
    y_p, zf_p = envelope.limiter_plain(x, k_rel, c_att,
                                       envelope.curve_consts(curve), init)
    nan_p = y_p.isnan()
    assert bool(nan_p[0, 22000:].all()) and not bool(nan_p[0, :22000].any())
    assert bool(nan_p[1].all()) and not bool(nan_p[2].any())
    assert torch.equal(y.isnan(), nan_p)
    assert torch.equal(zf.isnan(), zf_p.isnan())
    ok = ~nan_p
    db = refs.db(y[ok], y_p[ok])
    print(f"limiter with NaN (segments={S}): NaN where the twin's, "
          f"{db:.1f} dB elsewhere")
    assert db <= -100.0


def _eq_env_operands(cuda, R, n, seed):
    rng = np.random.default_rng(seed)
    sos = tbatch._biquad.eq_sos(list(tbatch.DEFAULT_BANDS), 16000)
    x = torch.from_numpy((0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    zi = torch.from_numpy((0.05 * rng.standard_normal((5, R, 2))).astype(
        np.float32)).to(cuda)
    ei = tuple(torch.from_numpy(rng.uniform(0.0, 0.5, R).astype(
        np.float32)).to(cuda) for _ in range(2))
    return sos, x, zi, ei


@pytest.mark.parametrize("S", [None, 4])  # the card's rule (8 here), 4
def test_segmented_eq_env_on_card_vs_twin_path(cuda, S):
    """The segmented K6 path on the kernels (pass 0 and pass A on K6,
    pass B on the envelope-only form) against the same path on the plain
    twins, from a carried state: every pass equals its twin bit for bit
    and the glue is the same torch code, so max abs 0 is expected (gate
    -100 dB); and against the unsegmented kernel."""
    R, n = 3, 40000
    sos, x, zi, ei = _eq_env_operands(cuda, R, n, 16)
    k_rel, c_att = 0.99937, 0.0606
    assert eq_env.eq_env_segments(R, n, c_att, cuda, 5) == 8
    before = _counts()
    out = eq_env.eq_env(sos, x, k_rel, c_att, zi=zi, env_init=ei,
                        segments=S)
    torch.cuda.synchronize()
    assert _launched(before) == {"eq_env", "envelope_seg"}
    assert (eq_env.launches - before["eq_env"],
            envelope.envelope_launches - before["envelope_seg"]) == (2, 1)
    ref = eq_env.eq_env(sos, x, k_rel, c_att, zi=zi, env_init=ei,
                        segments=S, run=eq_env.TWINS)
    one = eq_env.eq_env(sos, x, k_rel, c_att, zi=zi, env_init=ei,
                        segments=1)
    flat = [out[0], out[1], out[2], *out[3]]
    errs = [float((a - b).abs().max())
            for a, b in zip(flat, [ref[0], ref[1], ref[2], *ref[3]])]
    dbs = [refs.db(a, b) for a, b in zip(flat, [ref[0], ref[1], ref[2],
                                                 *ref[3]])]
    db1 = [refs.db(out[k], one[k]) for k in (0, 1)]
    print(f"segmented eq_env (segments={S}) vs its twin path: max abs (y, "
          f"e2, zf, env, e2 last) {errs}; y, e2 vs the unsegmented kernel "
          f"{db1[0]:.1f}, {db1[1]:.1f} dB")
    assert all(d <= -100.0 for d in dbs), dbs
    assert all(d <= -100.0 for d in db1), db1


def test_segmented_eq_env_propagates_nan(cuda):
    """A NaN sample in segment 4 of row 0 and a NaN initial envelope on
    row 1: the segmented kernel path gives NaN where the unsegmented
    twin does, in y, e2 and the final states."""
    R, n = 3, 40000
    sos, x, zi, ei = _eq_env_operands(cuda, R, n, 17)
    x[0, 22000] = float("nan")
    ei[0][1] = float("nan")
    out = eq_env.eq_env(sos, x, 0.99937, 0.0606, zi=zi, env_init=ei)
    s32 = torch.from_numpy(sos.astype(np.float32)).to(cuda)
    y, e2, zf, ef = eq_env.eq_env_plain(
        x, s32, zi.permute(0, 2, 1).contiguous(), torch.stack(ei),
        0.99937, 0.0606)
    assert bool(y[0, 22000:].isnan().all()) and bool(e2[1].isnan().all())
    assert not bool(y[0, :22000].isnan().any())
    for a, b in ((out[0], y), (out[1], e2), (out[2], zf.permute(0, 2, 1)),
                 (out[3][0], ef[0]), (out[3][1], ef[1])):
        assert torch.equal(a.isnan(), b.isnan())


@pytest.mark.parametrize("ragged", [False, True])
def test_unfolded_steps_segment_eq_env_on_card(cuda, ragged):
    """The unfolded fused step and the ragged step's unfolded branch at 2
    clips of 2 s: on the card eq_env runs segmented (the rule's S = 4 at
    32000 samples: K6 twice, then the envelope-only form), on the CPU in
    one pass; the outputs agree."""
    rng = np.random.default_rng(18)
    v = (rng.standard_normal((2, 88200)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 88200)) * 6000).astype(np.int16)
    assert eq_env.eq_env_segments(2, 32000, 0.0606, cuda, 5) == 4
    kw = {"fused": True, "lti_fold": False}
    if ragged:
        v[1, 60000:] = 0
        b[1, 60000:] = 0
        extra = (torch.tensor([88200, 60000]),)
        make = tbatch.make_batch_step
    else:
        extra = ()
        make = tbatch.make_flagship_step
    y_cpu = make(device="cpu", **kw)(torch.from_numpy(v), torch.from_numpy(b),
                                     *extra).double()
    before = _counts()
    y = make(device=cuda, **kw)(torch.from_numpy(v).to(cuda),
                                torch.from_numpy(b).to(cuda),
                                *(t.to(cuda) for t in extra))
    torch.cuda.synchronize()
    assert _launched(before) == {"fftconv", "eq_env", "envelope_seg"}
    assert y.dtype == torch.int16 and y.shape == (2, 32000)
    db = refs.db(y, y_cpu)
    print(f"unfolded step (ragged={ragged}) on the card vs the CPU: "
          f"{db:.1f} dB")
    assert db <= -85.0


def _core_operands(cuda, R, n, seed, signed=False, offset=0):
    """A detector (signed: a signal for the |x| detector) of R x n, a
    carried init, ktab and the segment corrections. ``offset`` floats
    into its storage, so the rows can start off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(R * n)).astype(np.float32)
    flat = torch.empty(R * n + offset, device=cuda)
    d = flat[offset:].view(R, n)
    d.copy_(torch.from_numpy(x if signed else np.abs(x)).view(R, n))
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    ktab = torch.from_numpy(envelope.seg_ktab(0.999, n)).to(cuda)
    ecorr = torch.from_numpy(rng.uniform(0.0, 3.0, R).astype(
        np.float32)).to(cuda)
    return d, init, ktab, ecorr


@pytest.mark.parametrize("form", ["plain", "corr", "abs"])
@pytest.mark.parametrize("R", [1, 31, 33, 1024])
@pytest.mark.parametrize("n", [1, 127, 129, 5000])
def test_envelope_core_bit_equal_to_twin(cuda, form, R, n):
    """The envelope-only core (32 rows a block, lanes past R idle, the
    ragged last chunk, 4-byte copies where n % 4 != 0) in each
    specialisation equals the twin bit for bit, final states too."""
    d, init, ktab, ecorr = _core_operands(cuda, R, n, R * n + len(form),
                                          signed=form == "abs")
    args = {"plain": (d, 0.99937, 0.0606, init),
            "corr": (d, 0.0, 0.0606, init, ktab, ecorr),
            "abs": (d, 0.99937, 1.0, init)}[form]
    kw = {"abs_detector": True} if form == "abs" else {}
    before = _counts()
    out = envelope.envelope_pass(*args, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {"envelope_seg"}
    ref = envelope.envelope_plain(*args, **kw)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["corr", "gain"])
def test_envelope_core_unaligned_rows(cuda, form):
    """Rows that start 4 bytes past a 16-byte boundary (n % 4 == 0) take
    the 4-byte copies: the same result as the twin."""
    d, init, ktab, ecorr = _core_operands(cuda, 40, 1000, 7, offset=1)
    kw = ({"curve": envelope.curve_of(-3.0), "curve_mode": "gain"}
          if form == "gain" else {})
    out = envelope.envelope_pass(d, 0.0, 0.0606, init, ktab, ecorr, **kw)
    ref = envelope.envelope_plain(d, 0.0, 0.0606, init, ktab, ecorr, **kw)
    if form == "gain":
        assert refs.db(out[0], ref[0]) <= -100.0
    else:
        torch.testing.assert_close(out[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=0)


@pytest.mark.parametrize("corr", [False, True])
@pytest.mark.parametrize("R", [1, 31, 33, 1024])
@pytest.mark.parametrize("n", [1, 127, 129, 5000])
def test_gain_core_vs_twin(cuda, corr, R, n):
    """The gain form on the same core: the gain -100 dB against the twin
    (logf/expf against torch.log/exp), the final states bit for bit."""
    d, init, ktab, ecorr = _core_operands(cuda, R, n, R + n + corr)
    curve = envelope.curve_of(-3.0, ratio=4.0, makeup_db=1.0)
    extra = (ktab, ecorr) if corr else ()
    k_rel = 0.0 if corr else 0.99937
    before = _counts()
    g, zf = envelope.envelope_pass(d, k_rel, 0.0606, init, *extra,
                                   curve=curve, curve_mode="gain")
    torch.cuda.synchronize()
    assert _launched(before) == {"gain"}
    g_p, zf_p = envelope.envelope_plain(d, k_rel, 0.0606, init, *extra,
                                        curve=curve, curve_mode="gain")
    assert bool(torch.isfinite(g).all()) and refs.db(g, g_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=0, atol=0)


def test_envelope_occupancy_queries(cuda):
    """Each form's occupancy query gives the segment rules at least one
    resident block per SM; an unknown form gives 0."""
    lib = _build.load()
    assert lib.xm_envelope_blocks_per_sm(0) >= 1
    assert lib.xm_envelope_blocks_per_sm(1) >= 1
    assert lib.xm_envelope_blocks_per_sm(2) == 0
    assert lib.xm_limiter_blocks_per_sm() >= 1


def test_envelope_call_at_the_card_rule_vs_twin_path(cuda):
    """envelope() at the card's S (32 x 160000: past the JAX rule's 8)
    from a carried init, against the same path on the twin: bit for
    bit (the kernels equal their twins, the glue is the same)."""
    R, n = 32, 160000
    rng = np.random.default_rng(31)
    d = torch.from_numpy(np.abs(0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = (torch.rand(R, device=cuda), torch.rand(R, device=cuda))
    S = envelope.envelope_segments(R, n, cuda)
    assert S > envelope.pick_segments(R, n, lanes=256)
    rows = []

    def recording(*args, **kw):
        rows.append(tuple(args[0].shape))
        return envelope.envelope_pass(*args, **kw)

    e2, st = envelope.envelope(d, 0.99937, 0.0606, init=init, run=recording)
    assert rows == [(R * S, n // S)] * 2
    e2_p, st_p = envelope.envelope(d, 0.99937, 0.0606, init=init,
                                   run=envelope.envelope_plain)
    print(f"envelope() at the card's S = {S}: max abs "
          f"{float((e2 - e2_p).abs().max()):.3g} against its twin path")
    torch.testing.assert_close(e2, e2_p, rtol=0, atol=0)
    for a, b in zip(st, st_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_envelope_at_a_divisor_of_n_vs_the_power_of_two(cuda):
    """The voice cell's 32 x 2,646,000 (n = 2^4 x 165,375): the card's
    rule leaves the powers of two (S = 4, four blocks) for a divisor
    that fills the card, and envelope() there matches the same call at
    segments=4 from a carried init: -100 dB, states rtol 3e-5 (the
    segment joins round differently). The effects cell's 64 x 480,000
    keeps S = 64."""
    R, n = 32, 2646000
    k_rel, c_att = 0.99977327, 0.02242057  # 100 ms / 1 ms at 44.1 kHz
    rng = np.random.default_rng(35)
    d = torch.from_numpy(np.abs(0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = (torch.rand(R, device=cuda), torch.rand(R, device=cuda))
    before = _seg.wide_picks
    S = envelope.envelope_segments(R, n, cuda)
    assert _seg.wide_picks == before + 1
    assert S & (S - 1) and n % S == 0 and n // S % 4 == 0
    e2, st = envelope.envelope(d, k_rel, c_att, init=init)
    e2_4, st_4 = envelope.envelope(d, k_rel, c_att, init=init, segments=4)
    db = refs.db(e2, e2_4)
    print(f"envelope() at the card's S = {S} vs S = 4: {db:.1f} dB")
    assert db <= -100.0
    for a, b in zip(st, st_4):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=0)
    assert envelope.envelope_segments(64, 480000, cuda) == 64


def test_linked_limiter_at_the_card_rule_vs_twin_path(cuda):
    """linked_limiter() at the card's S (4 stereo clips of 2 s at 48
    kHz: segments of at least the carries' 4,421 samples) against the
    same path on the twin: -100 dB on y, the states bit for bit."""
    rng = np.random.default_rng(33)
    x = torch.from_numpy((0.5 * rng.standard_normal((4, 2, 96000))).astype(
        np.float32)).to(cuda)
    x[2, :, 30000:31000] *= 5.0
    args = (x, 0.99979, 0.0206, -3.0)
    S = envelope.linked_segments(4, 96000, 0.0206, cuda)
    assert S > 1 and 96000 // S >= envelope.carry_min_seglen(0.0206, 96000)
    before = _counts()
    y, st = envelope.linked_limiter(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {"envelope_seg", "gain"}
    y_p, st_p = envelope.linked_limiter(*args, segments=S,
                                        run=envelope.envelope_plain)
    db = refs.db(y, y_p)
    print(f"linked_limiter() at the card's S = {S} vs its twin path: "
          f"{db:.1f} dB")
    assert db <= -100.0
    for a, b in zip(st, st_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_measure_lufs_on_card_vs_cpu(cuda):
    """measure_lufs on the card (the K-weighting on the IIR kernel, the
    block powers on theirs) and on the CPU (the kernels' plain twins), 5 s
    of stereo at 48 kHz: within
    0.02 LU of each other and of the float64 oracle; lufs_normalize on
    the card lands on its target."""
    from xmtpu_torch.ops import loudness

    rng = np.random.default_rng(91)
    x = (0.1 * rng.standard_normal((2, 240000))).astype(np.float32)
    x[:, 96000:144000] *= 4.0
    before = _counts()
    got = loudness.measure_lufs(x, 48000)  # cuda by default
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert {"iir", "lufs"} <= _launched(before)
    cpu = float(loudness.measure_lufs(x, 48000, device="cpu"))
    ref = loudness.measure_lufs_np(x, 48000)
    print(f"LUFS card {float(got):.5f}, CPU {cpu:.5f}, float64 {ref:.5f}")
    assert abs(float(got) - cpu) <= 0.02 and abs(float(got) - ref) <= 0.02
    y, g = loudness.lufs_normalize(torch.from_numpy(x).to(cuda), 48000, -16.0)
    assert g.dtype == torch.float32 and y.device.type == "cuda"
    assert abs(float(loudness.measure_lufs(y, 48000)) + 16.0) <= 0.02


def _on_card_at(x: np.ndarray, offset: int) -> torch.Tensor:
    """``x`` as a contiguous card tensor whose data start ``offset``
    floats past its allocation's (256-byte aligned) start."""
    buf = torch.zeros(offset + x.size, device="cuda")
    return buf[offset:].view(x.shape).copy_(torch.from_numpy(x))


def _block_powers_on_card(x, xt, sr: int):
    from xmtpu_torch.ops import loudness

    geo = loudness._block_geometry(x.shape[-1], sr)
    before = _counts()
    got = lufs.block_powers(xt, *geo)
    torch.cuda.synchronize()
    assert _launched(before) == {"lufs"} and got.dtype == torch.float64
    return got.cpu().numpy(), refs.block_powers(x, *geo), geo


@pytest.mark.parametrize("sr", [48000, 44100, 11025, 8000])
@pytest.mark.parametrize("ch", [1, 2, 3])
@pytest.mark.parametrize("which", range(4))
def test_block_powers_kernel_vs_direct_sum(cuda, sr, ch, which):
    """The block-power kernel against the direct float64 sum of each
    block, rtol 1e-12: one sample short of a block (one block of
    everything), a block, and a block and three hops without and with
    their last sample (11,025 Hz: a 4,410-sample block over 1,102-sample
    hops); rows of n % 4 != 0 start off a 16-byte boundary."""
    from xmtpu_torch.ops import loudness

    block, hop, _ = loudness._block_geometry(10**9, sr)
    n = [block - 1, block, block + 3 * hop - 1, block + 3 * hop][which]
    x = refs.loud_stretch(ch, n, sr + 10 * ch + which)
    got, want, _ = _block_powers_on_card(x, _on_card_at(x, 0), sr)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("sr", [48000, 44100])
def test_block_powers_kernel_off_a_boundary_over_silence(cuda, sr, offset):
    """Stereo whose data start 1-3 floats past a 16-byte boundary, with
    four whole blocks of silence: rtol 1e-12, those blocks exactly 0."""
    from xmtpu_torch.ops import loudness

    block, hop, _ = loudness._block_geometry(10**9, sr)
    n = block + 12 * hop
    x = refs.loud_stretch(2, n, sr + offset)
    x[:, 2 * hop: 2 * hop + block + 3 * hop] = 0.0
    got, want, _ = _block_powers_on_card(x, _on_card_at(x, offset), sr)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.sum(got == 0.0) == 4


def test_block_powers_kernel_confines_nan_and_inf(cuda):
    """A NaN in one channel and an inf in the other, 48 kHz stereo: each
    reaches only the four blocks that hold it (the twin's running sum
    carries the NaN into every later block); elsewhere rtol 1e-12."""
    from xmtpu_torch.ops import loudness

    block, hop, _ = loudness._block_geometry(10**9, 48000)
    x = refs.loud_stretch(2, block + 12 * hop, 94)
    x[0, 5 * hop + 10] = np.nan
    x[1, 10 * hop + 7] = np.inf
    xt = torch.from_numpy(x).to(cuda)
    got, want, geo = _block_powers_on_card(x, xt, 48000)
    j = np.arange(len(got))
    assert np.array_equal(np.isnan(got), (j >= 2) & (j <= 5))
    assert np.array_equal(np.isposinf(got), (j >= 7) & (j <= 10))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    plain = lufs.block_powers_plain(xt, *geo).cpu().numpy()
    assert np.isnan(plain[2:]).all()


def test_block_powers_kernel_at_the_mix_cell_length(cuda):
    """The K-weighted bus of a 600 s stereo episode at 48 kHz (2 x 28.8
    M; talk and pauses, so both gates drop blocks): the kernel against
    the direct float64 sum of every block, rtol 1e-12; a second run bit
    for bit; the gates on its powers and on the cumulative-sum twin's
    keep the same blocks, their loudness within 1e-9 LU."""
    from xmtpu_torch.ops import loudness

    sr = 48000
    s = refs.speech_with_pauses(600.0, sr, 96).astype(np.float32)
    xw = iir.sosfilt(loudness.k_weighting_sos(sr),
                     torch.from_numpy(s).to(cuda))[0].contiguous()
    got, want, geo = _block_powers_on_card(xw.cpu().numpy(), xw, sr)
    assert geo == (19200, 4800, 5997)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    again = lufs.block_powers(xw, *geo)
    assert torch.equal(again, torch.from_numpy(got).to(cuda))
    plain = lufs.block_powers_plain(xw, *geo)
    kept = _gated(got)
    print(f"block powers at 2 x 28.8 M: gates keep {int(kept.sum())} of "
          f"{geo[2]} blocks; LUFS kernel {float(loudness._gates(again)):.12f}"
          f", twin {float(loudness._gates(plain)):.12f}")
    assert 0 < kept.sum() < geo[2]
    assert np.array_equal(kept, _gated(plain.cpu().numpy()))
    assert abs(float(loudness._gates(again))
               - float(loudness._gates(plain))) <= 1e-9


def _gated(power: np.ndarray) -> np.ndarray:
    """The blocks BS.1770's two gates keep, in float64 numpy."""
    from xmtpu_torch.ops import loudness

    level = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-30))
    keep = level > loudness.ABS_GATE_LUFS
    rel = (-0.691 + 10.0 * np.log10(max(np.mean(power[keep]), 1e-30))
           + loudness.REL_GATE_LU)
    return keep & (level > rel)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_measure_lufs_on_card_past_a_non_finite_sample(cuda, bad):
    """A NaN or inf at 2.3 s of 5 s of 48 kHz, 3 channels, 20 dB louder
    after it: the card's loudness (the kernel confines the sample to the
    blocks that hold it) within 0.02 LU of the CPU's (the twin carries it
    on), as the K-weighting has carried it into every later sample; an
    empty signal is refused on the card too, before any launch."""
    from xmtpu_torch.ops import loudness

    sr, t = 48000, int(2.3 * 48000)
    x = refs.quiet_then_loud(sr, 5.0, t, bad)
    before = _counts()
    got = float(loudness.measure_lufs(x, sr))
    assert "lufs" in _launched(before)
    cpu = float(loudness.measure_lufs(x, sr, device="cpu"))
    print(f"LUFS past a {bad}: card {got:.6f}, CPU {cpu:.6f}")
    assert abs(got - cpu) <= 0.02
    before = _counts()
    with pytest.raises(ValueError):
        loudness.measure_lufs(torch.zeros(2, 0, device=cuda), sr)
    with pytest.raises(ValueError):
        lufs.block_powers(torch.zeros(2, 0, device=cuda), 0, 1, 1)
    assert not _launched(before)


@pytest.mark.parametrize("mode", ["frozen", "adaptive"])
def test_suppress_on_card_vs_cpu_and_oracle(cuda, mode):
    """suppress on the card (cuFFT) against the CPU (its FFT) at -100 dB
    and against the float64 oracle at -80 dB, 2 s of stereo at 48 kHz."""
    from xmtpu_torch.ops import ns

    rng = np.random.default_rng(92)
    t = np.arange(96000) / 48000
    x = (0.15 * np.sin(2 * np.pi * 440 * t)
         + 0.03 * rng.standard_normal((2, 96000))).astype(np.float32)
    x[:, :8000] = 0.03 * rng.standard_normal((2, 8000))
    y = ns.suppress(x, noise_update=mode)  # cuda by default
    assert y.device.type == "cuda"
    y_cpu = ns.suppress(x, noise_update=mode, device="cpu")
    ref = torch.from_numpy(ns.suppress_np(x, noise_update=mode))
    db_cpu = refs.db(y, y_cpu)
    db_ref = refs.db(y, ref)
    print(f"suppress {mode}: card vs CPU {db_cpu:.1f} dB, vs float64 "
          f"{db_ref:.1f} dB")
    assert db_cpu <= -100.0 and db_ref <= -80.0


def _ns_signal(shape, seed, n_tone=None):
    """0.03 x Gaussian noise with a 0.15 x 440 Hz tone past the first
    8,000 samples (at 44.1 kHz), float32 of ``shape`` (..., n)."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / 44100
    x = 0.03 * rng.standard_normal(shape)
    x[..., 8000:] += 0.15 * np.sin(2 * np.pi * 440 * t[8000:])
    return x.astype(np.float32)


def _ns_case(case):
    """(x, suppress keywords) of a kernel-path case; the frame count T =
    ceil(n / 256) + 1 at nfft 512."""
    if case == "prime":  # T = 1009, prime, 15 segments
        return _ns_signal((2, 1008 * 256), 1), {}
    if case == "short":  # T = 40, one segment (S = 1)
        return _ns_signal((2, 39 * 256), 2), {}
    if case in ("frames2", "frames3"):  # T = 2 or 3
        return _ns_signal((2, 100 if case == "frames2" else 400), 3), {}
    if case == "odd_rows":  # R = 3 of (3, 1, n), T = 1013
        return _ns_signal((3, 1, 1012 * 256), 4), {}
    if case == "silence_tone":
        # silence (1e-7 x noise), a 0.9 tone, silence: P spans 16
        # decades, the carry holds the tone's P into the quiet
        rng = np.random.default_rng(5)
        n = 1008 * 256
        x = 1e-7 * rng.standard_normal((2, n))
        x[:, 100000:200000] += 0.9 * np.sin(
            2 * np.pi * 1000 * np.arange(100000) / 44100)
        return x.astype(np.float32), {}
    if case == "floor_binds":
        # a loud lead-in sets the frozen estimate far above the rest
        x = _ns_signal((2, 1008 * 256), 6)
        x[1, :4096] *= 300.0
        return x, {}
    # a caller's estimate near the noise's own PSD (0.03^2 x 256 = 0.23)
    if case == "noise_psd_bins":  # (F,), broadcast over the rows
        return _ns_signal((2, 1008 * 256), 7), {
            "noise_psd": np.full(257, 0.2, np.float32)}
    if case == "noise_psd_rows":  # (R, F)
        rng = np.random.default_rng(8)
        return _ns_signal((2, 1008 * 256), 8), {
            "noise_psd": rng.uniform(0.1, 0.4, (2, 257)).astype(np.float32)}
    if case == "int16":
        x = _ns_signal((2, 1008 * 256), 9) * 3.0
        return np.round(x * 32767.0).astype(np.int16), {}
    if case == "adaptive":  # the torch path on the card
        return _ns_signal((2, 1008 * 256), 10), {"noise_update": "adaptive"}
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "prime", "short", "frames2", "frames3", "odd_rows", "silence_tone",
    "floor_binds", "noise_psd_bins", "noise_psd_rows", "int16", "adaptive"])
def test_suppress_kernel_path_vs_cpu_and_oracle(cuda, case):
    """ns.suppress on the card, through the Wiener kernel wherever the
    noise is fixed per row and bin, against the CPU path (the scan and
    the elementwise gain) at -100 dB and the float64 oracle at -80 dB;
    ``kernels.ns.launches`` grows by the kernel's passes (2, or 1 at S =
    1), and not at all on the adaptive path."""
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns

    x, kw = _ns_case(case)
    *lead, n = x.shape
    T = ns._frame_count(n, 512)
    S = kns.wiener_segments(int(np.prod(lead)), T, 257, cuda)
    want = 0 if case == "adaptive" else (2 if S > 1 else 1)
    before = kns.launches
    y = ns.suppress(x, device=cuda, **kw)
    torch.cuda.synchronize()
    assert kns.launches - before == want
    assert y.device.type == "cuda" and y.dtype == torch.from_numpy(x).dtype
    y_cpu = ns.suppress(x, device="cpu", **kw)
    ref = ns.suppress_np(x.astype(np.float64), **kw)
    db_cpu, db_ref = refs.db(y, y_cpu), refs.db(y, ref)
    print(f"suppress {case} {x.shape}, T = {T}, S = {S}: card vs CPU "
          f"{db_cpu:.1f} dB, vs float64 {db_ref:.1f} dB")
    assert y.shape == y_cpu.shape == x.shape
    assert db_cpu <= -100.0 and db_ref <= -80.0


@pytest.mark.parametrize("R,T,F,S", [
    (1, 1, 257, None),  # one frame
    (3, 2, 257, 5),     # T < S: two segments of one frame
    (3, 3, 257, 8),
    (5, 97, 129, 8),    # T prime: 8 segments of 13, the last 6
    (33, 1009, 9, 15),  # R*F = 297 chains: 3 blocks, the last partial
    (2, 1009, 257, 1),  # unsegmented
])
def test_wiener_kernel_vs_twin(cuda, R, T, F, S):
    """The kernel on random spectra (a decade of levels a frame, a quiet
    stretch, NaN in one bin) against its twin at -100 dB, NaN where the
    twin's is; written over X, the twin's output a new tensor."""
    from xmtpu_torch.kernels import ns as kns

    rng = np.random.default_rng(R * T + F)
    scale = 10.0 ** rng.uniform(-1, 1, (R, T, 1))
    X = ((rng.standard_normal((R, T, F)) + 1j * rng.standard_normal(
        (R, T, F))) * scale).astype(np.complex64)
    X[:, T // 2:T // 2 + 5] *= 1e-4
    X[0, T - 1, F // 2] = np.nan
    noise = rng.uniform(0.5, 4.0, (R, F)).astype(np.float32)
    Xc = torch.from_numpy(X).to(cuda)
    nz = torch.from_numpy(noise).to(cuda)
    want = kns.wiener_plain(Xc, nz, 0.7, 0.1)
    got = kns.wiener(Xc, nz, 0.7, 0.1, segments=S)
    torch.cuda.synchronize()
    assert got.data_ptr() == Xc.data_ptr()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    assert torch.equal(nan_g, nan_w) and int(nan_w.sum()) == 1
    g = torch.view_as_real(got.masked_fill(nan_w, 0))
    w = torch.view_as_real(want.masked_fill(nan_w, 0))
    db = refs.db(g, w)
    print(f"wiener ({R}, {T}, {F}) at S = {S}: {db:.1f} dB vs the twin")
    assert db <= -100.0


def test_suppress_on_card_launches_only_under_its_four_ranges(cuda,
                                                              tmp_path):
    """On the kernel's path every device operation of ns.suppress lies
    under ``ns_stft``, ``ns_noise``, ``ns_wiener`` or ``ns_istft``, each
    of them holds one, and the CPU path's ``ns_psd`` and ``ns_gain`` do
    not open."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import TraceView
    from xmtpu_torch.ops import ns
    from xmtpu_torch.utils import profiling

    x = torch.from_numpy(_ns_signal((2, 1008 * 256), 11)).to(cuda)
    ns.suppress(x, device=cuda)  # builds and warms up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("perfbench.traced_window"):
            with profiling.stage("ns"):
                ns.suppress(x, device=cuda)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    view = TraceView.from_file(tmp_path / "trace.json")
    names = ("ns_stft", "ns_noise", "ns_wiener", "ns_istft")
    parts = {k: [o for o in view.ops if o.under(f"xmtpu_torch.{k}")]
             for k in names}
    print({k: len(v) for k, v in parts.items()})
    assert view.ops and all(parts.values())
    assert sum(map(len, parts.values())) == len(view.ops)
    assert not any(o.under("xmtpu_torch.ns_psd", "xmtpu_torch.ns_gain")
                   for o in view.ops)
    assert any("wiener_kernel" in o.name for o in parts["ns_wiener"])


def test_mix_on_card_vs_cpu(cuda):
    """api.mix with the voice chain (noise suppression, the 5-band EQ and
    a 0.2 s reverb: one folded FIR on the fftconv kernel), a looped,
    side-ducked BGM at another rate and LUFS normalization: the card
    against the CPU (the chain on the float64 scans, the resample and the
    K-weighting on their kernels' twins) at -80 dB; the resample (the
    voice's 44.1k -> 48k), IIR (K-weighting), block-power and fftconv
    kernels launch."""
    from xmtpu_torch.batch import DEFAULT_BANDS

    rng = np.random.default_rng(93)
    voice = (0.2 * rng.standard_normal(88200)).astype(np.float32)  # 2 s
    bgm = (0.2 * rng.standard_normal((48000, 2))).astype(np.float32)  # 1 s
    tracks = [dict(pcm=voice, sr=44100, fade_in_ms=250.0),
              dict(pcm=bgm, sr=48000, kind="bgm", loop=True, side_duck=True,
                   gain=0.5)]
    kw = dict(normalize="lufs", target_db=-16.0, voice_effects=[
        {"name": "noise_suppression"},
        {"name": "equalizer", "bands": list(DEFAULT_BANDS)},
        {"name": "reverb", "ir_seconds": 0.2, "wet": 0.2, "dry": 0.8}])
    before = _counts()
    y = xmtpu_torch.mix(tracks, 48000, **kw)
    torch.cuda.synchronize()
    assert {"resample", "iir", "fftconv_long", "lufs",
            "duck"} <= _launched(before)
    y_cpu = xmtpu_torch.mix(tracks, 48000, device="cpu", **kw)
    db = refs.db(y, y_cpu)
    print(f"mix card vs CPU: {db:.1f} dB")
    assert y.shape == y_cpu.shape == (96000, 2) and db <= -80.0


def test_duck_on_card_at_the_episode_length(cuda):
    """The duck kernel's gain form (``ops.mix.duck_gain`` on the card:
    five launches) over the mix cell's side-chain shape, 2 x 28.8 M (600
    s at 48 kHz), of speech and pauses that cross the knee both ways,
    against the reference's closed form and ``lfilter``: within 1e-4 of
    the gain at every sample and -80 dB RMS, and within 1e-9, as both
    are float64. The mix cell's check cannot see the duck's recurrences
    (its voice never pauses), so this is the gate for a rewrite of
    them."""
    from perfbench.reference import episode_mix
    from xmtpu_torch.ops import mix as mixops

    s = refs.speech_with_pauses(600.0, 48000, 95).astype(np.float32)
    want = episode_mix.duck_gain(s.astype(np.float64), 48000)
    before = duck.launches
    got = mixops.duck_gain(torch.from_numpy(s).to(cuda), 48000)
    torch.cuda.synchronize()
    assert duck.launches == before + 5
    err = np.max(np.abs(got.cpu().numpy() - want))
    db = refs.db(got, want)
    inside = np.mean((want > 0.26) & (want < 0.99))
    print(f"duck on card, 2 x 28.8 M: max abs {err:.3g}, {db:.1f} dB, "
          f"{100 * inside:.2f}% of samples inside the knee")
    assert want.min() < 0.3 and want.max() == 1.0 and inside > 0.01
    assert err < 1e-4 and db < -80.0
    assert err < 1e-9


def test_duck_mix_form_at_the_episode_length(cuda, monkeypatch):
    """The mix form (``ops.mix.duck_apply``, as the mixer calls it, over
    ``side`` in place) at 2 x 28.8 M of speech and pauses with a bed:
    against ``side + bed * float32(reference gain)`` within an ulp of
    the output where float32 rounds the two gains apart, -120 dB; bit
    for bit the gain form's ``side + bed * g.to(float32)`` (the product
    and the sum rounded as torch rounds them, no FMA); one launch of
    five passes; with no knee bounds (``knee_bounds`` NaN, the knee at
    every sample): the same bits."""
    from perfbench.reference import episode_mix
    from xmtpu_torch.ops import mix as mixops

    s = refs.speech_with_pauses(600.0, 48000, 96).astype(np.float32)
    rng = np.random.default_rng(96)
    bed = (0.5 * np.sin(np.arange(s.shape[-1]) / 37.0)
           + 0.01 * rng.standard_normal(s.shape)).astype(np.float32)
    g_ref = episode_mix.duck_gain(s.astype(np.float64), 48000)
    want = s + bed * g_ref.astype(np.float32)
    side, bed_d = torch.from_numpy(s).to(cuda), torch.from_numpy(bed).to(cuda)
    g = mixops.duck_gain(side, 48000)
    same = side + bed_d * g.to(torch.float32)
    del g
    before = duck.launches
    got = mixops.duck_apply(side, bed_d, 48000, overwrite=True)
    torch.cuda.synchronize()
    assert duck.launches == before + 5
    assert got.data_ptr() == side.data_ptr() and got.dtype == torch.float32
    assert torch.equal(got, same)
    err = np.abs(got.cpu().numpy() - want)
    print(f"duck mix form, 2 x 28.8 M: max abs {err.max():.3g} against "
          f"the reference's gain, {np.mean(err > 0):.2e} of samples apart")
    assert err.max() <= 2.0**-23 * np.abs(want).max()  # an ulp
    assert refs.db(got, want) < -120.0
    side = torch.from_numpy(s).to(cuda)
    monkeypatch.setattr(duck, "knee_bounds",
                        lambda *a: (float("nan"), float("nan")))
    slow = mixops.duck_apply(side, bed_d, 48000)
    assert torch.equal(slow, same)


@pytest.mark.parametrize("R,n", [
    (1, 1), (2, 7), (3, 320), (2, 997), (1, duck.TILE - 1), (2, duck.TILE),
    (2, duck.TILE + 1), (3, 65537), (2, 1_000_003)])
def test_duck_kernel_vs_twin_at_edge_lengths(cuda, R, n):
    """The gain form against its twin (the float64 scans on the CPU) at
    prime and odd lengths, one sample, a 20 ms frame at 16 kHz (one tile:
    one launch), around a tile, over the knee's band with a carried
    state: the gain within 1e-12, the final state rtol 1e-12; launches 1
    at one tile a row, 5 past it. The mix form beside it against the
    twin's product and sum."""
    rng = np.random.default_rng(n)
    s = (refs.speech_with_pauses(n / 8000 + 1.0, 8000, R)[:1].repeat(R, 0)
         [:, :n] * rng.uniform(0.01, 1.0, (R, 1))).astype(np.float32)
    bed = rng.standard_normal((R, n)).astype(np.float32)
    kw = dict(threshold_db=-30.0, depth_db=9.0, knee_db=12.0, attack_ms=5.0,
              release_ms=120.0)
    from xmtpu_torch.ops import mix as mixops

    state = (torch.full((R,), 0.05, dtype=torch.float64),
             torch.full((R,), 0.02, dtype=torch.float64))
    g_p, st_p = mixops.duck_gain_block(torch.from_numpy(s), 8000, state, **kw)
    before = duck.launches
    g_k, st_k = mixops.duck_gain_block(
        torch.from_numpy(s).to(cuda), 8000,
        tuple(t.to(cuda) for t in state), **kw)
    torch.cuda.synchronize()
    assert duck.launches - before == (1 if n <= duck.TILE else 5)
    assert g_k.shape == (R, n) and st_k[0].shape == (R,)
    assert torch.max(torch.abs(g_k.cpu() - g_p)) <= 1e-12
    for a, b in zip(st_k, st_p):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=0.0)
    y_k = mixops.duck_apply(torch.from_numpy(s).to(cuda),
                            torch.from_numpy(bed).to(cuda), 8000, **kw)
    y_p = mixops.duck_apply(torch.from_numpy(s), torch.from_numpy(bed),
                            8000, **kw)
    assert refs.db(y_k, y_p) < -140.0


def test_duck_gain_block_carried_on_card(cuda):
    """``duck_gain_block`` on the card over 20 ms blocks (960 samples at
    48 kHz: one tile) and over uneven blocks past a tile, the state
    carried, against the CPU twin's blocks and the card's whole signal:
    the gain within 1e-11 (1.3e-12 on an H100: the two sides compose
    the blocks' float64 powers in other orders), the final states rtol
    1e-12."""
    from xmtpu_torch.ops import mix as mixops

    s = refs.speech_with_pauses(6.0, 48000, 44).astype(np.float32)
    x = torch.from_numpy(s)
    whole, _ = mixops.duck_gain_block(x.to(cuda), 48000, None)
    for cuts in (list(range(0, s.shape[-1], 960)),
                 [0, 5, 4101, 40000, 150001, 200000]):
        st_k = st_p = None
        parts_k, parts_p = [], []
        for a, b in zip(cuts, cuts[1:] + [s.shape[-1]]):
            g, st_k = mixops.duck_gain_block(x[:, a:b].to(cuda), 48000, st_k)
            parts_k.append(g)
            g, st_p = mixops.duck_gain_block(x[:, a:b], 48000, st_p)
            parts_p.append(g)
        g_k = torch.cat(parts_k, -1).cpu()
        d_twin = float(torch.max(torch.abs(g_k - torch.cat(parts_p, -1))))
        d_whole = float(torch.max(torch.abs(g_k - whole.cpu())))
        print(f"duck carried over {len(cuts)} blocks: max abs {d_twin:.3g} "
              f"vs the twin's blocks, {d_whole:.3g} vs the whole signal")
        assert d_twin <= 1e-11 and d_whole <= 1e-11
        for a, b in zip(st_k, st_p):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-12, atol=0.0)


def test_duck_kernel_nan_where_the_twin_s(cuda):
    """A NaN in the side chain: the kernel's gain (and the mix form's
    output) NaN exactly where the twin's ``torch.maximum`` carries it,
    in that row from the NaN on, in a middle tile and in the last; the
    other samples within 1e-12."""
    from xmtpu_torch.ops import mix as mixops

    s = refs.speech_with_pauses(2.0, 48000, 8).astype(np.float32)
    s = np.concatenate([s, s[:1]])
    s[0, 50_000] = np.nan
    s[2, s.shape[-1] - 3] = np.nan
    g_p = mixops.duck_gain(torch.from_numpy(s), 48000)
    g_k = mixops.duck_gain(torch.from_numpy(s).to(cuda), 48000).cpu()
    nan = torch.isnan(g_p)
    assert nan[0, 50_000:].all() and not nan[0, :50_000].any()
    assert torch.equal(torch.isnan(g_k), nan) and not nan[1].any()
    assert torch.max(torch.abs(g_k[~nan] - g_p[~nan])) <= 1e-12
    bed = torch.ones(s.shape)
    y_k = mixops.duck_apply(torch.from_numpy(s).to(cuda), bed.to(cuda),
                            48000).cpu()
    y_p = mixops.duck_apply(torch.from_numpy(s), bed, 48000)
    assert torch.equal(torch.isnan(y_k), torch.isnan(y_p))


def test_duck_kernel_refuses_what_it_cannot_take(cuda):
    """A float64 side chain and a bed of another shape raise on the
    card; there is no fallback."""
    from xmtpu_torch.ops import mix as mixops

    x = torch.zeros((2, 100), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        mixops.duck_gain(x.double(), 48000)
    with pytest.raises(ValueError, match="shape"):
        mixops.duck_apply(x, x[:1], 48000)


def _stream_config(effects=(), master=()):
    from xmtpu_torch.config import EffectConfig, PipelineConfig, TrackConfig

    return PipelineConfig(
        tracks=(TrackConfig(url="v", fade_in_ms=50.0),
                TrackConfig(url="b", kind="bgm", volume=0.4, loop=True,
                            side_duck=True)),
        effects=tuple(EffectConfig(n, p) for n, p in effects),
        master_effects=tuple(EffectConfig(n, p) for n, p in master),
        sample_rate=16000, normalize=None)


_STREAM_CHAIN = [("noise_suppression", {}),
                 ("equalizer", {"bands": [{"freq_hz": 300.0, "gain_db": 2.0,
                                           "q": 1.0}]}),
                 ("reverb", {"ir_seconds": 0.1, "wet": 0.2, "dry": 0.8})]


def _stream_sources(k, seconds=1.0):
    rng = np.random.default_rng(41)
    b = (0.2 * np.sin(np.arange(8000) / 9.0)).astype(np.float32)
    return [{"v": ((0.3 * rng.standard_normal(int(44100 * seconds)))
                   .astype(np.float32), 44100), "b": (b, 16000)}
            for _ in range(k)]


@pytest.mark.parametrize("engine", ["scan", "pallas"])
def test_session_and_pool_on_card_vs_cpu(cuda, engine):
    """A streaming session (the scan engine; the kernels when the effects
    name "pallas") and a 4-slot pool on the card against the same on the
    CPU, 10 frames of float32: -100 dB (the scans), -90 dB (the kernels
    against their twins); the kernel engine launches K1 (the folded EQ +
    reverb) and the envelope kernel."""
    from xmtpu_torch.graph.pool import SessionPool
    from xmtpu_torch.graph.streaming import StreamSession

    chain = [(n, dict(p, backend=engine) if n != "noise_suppression" else p)
             for n, p in _STREAM_CHAIN]
    cfg = _stream_config(chain, [("limiter", {"backend": engine})])
    src = _stream_sources(4)
    gate = -100.0 if engine == "scan" else -90.0
    outs = {}
    before = _counts()
    for d in ("cuda", "cpu"):
        s = StreamSession(cfg, sources=src[0], output_dtype=np.float32,
                          device=d)
        outs[d] = np.concatenate([s.read() for _ in range(10)])
    db = refs.db(outs["cuda"], outs["cpu"])
    pools = {d: SessionPool(cfg, 4, sources=src, output_dtype=np.float32,
                            effects_backend=engine, device=d).read(10)
             for d in ("cuda", "cpu")}
    torch.cuda.synchronize()
    db_p = refs.db(pools["cuda"], pools["cpu"])
    print(f"{engine}: session card vs CPU {db:.1f} dB, pool {db_p:.1f} dB")
    assert db <= gate and db_p <= gate
    if engine == "pallas":
        assert {"fftconv", "envelope_seg"} <= _launched(before)


def test_stream_dispatch_does_not_sync(cuda):
    """After a first frame (which copies the device tables), a session's
    frames and a pool's groups dispatch on both engines without a
    synchronisation."""
    from xmtpu_torch.graph.pool import SessionPool
    from xmtpu_torch.graph.streaming import StreamSession

    cfg = _stream_config(_STREAM_CHAIN, [("limiter", {})])
    src = _stream_sources(4)
    sess = StreamSession(cfg, sources=src[0], prefetch_depth=3)
    sess.read()
    pools = [SessionPool(cfg, 4, sources=src, effects_backend=be)
             for be in ("scan", "pallas")]
    for p in pools:
        p.read(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess._dispatch(sess.frame_idx + 3, sess.fx_state)
        for p in pools:
            p._dispatch(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("R,n", [(32, 320), (16, 960)])
def test_stream_shape_kernels_vs_twins(cuda, R, n):
    """The frame shapes of config 5 (32 rows of 320) and the 48 kHz
    stereo serving chain (16 rows of 960): K5 with a carried zi and the
    envelope kernel with a carried init bit for bit against their twins;
    K1 over an (m - 1) + n input history with a 24,082-tap IR (the long
    form) at -100 dB."""
    from xmtpu_torch.ops.reverb import synthetic_ir

    rng = np.random.default_rng(R + n)
    x = torch.from_numpy((0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    sos = torch.tensor([[0.9, -1.7, 0.8, 1.0, -1.6, 0.7]],
                       dtype=torch.float32, device=cuda)
    zi = torch.from_numpy((0.1 * rng.standard_normal((1, 2, R))).astype(
        np.float32)).to(cuda)
    for a, b in zip(iir.sosfilt_pass(x, sos, zi),
                    iir.sosfilt_plain(x, sos, zi)):
        assert float((a - b).abs().max()) == 0.0
    d = x.abs()
    init = torch.from_numpy(np.abs(0.2 * rng.standard_normal((2, R))).astype(
        np.float32)).to(cuda)
    for a, b in zip(envelope.envelope_pass(d, 0.999, 0.06, init),
                    envelope.envelope_plain(d, 0.999, 0.06, init)):
        assert float((a - b).abs().max()) == 0.0
    ir = torch.from_numpy(synthetic_ir(24082 / 48000, 48000)[:24082].astype(
        np.float32)).to(cuda)
    xa = torch.from_numpy((0.3 * rng.standard_normal(
        (R, ir.shape[0] - 1 + n))).astype(np.float32)).to(cuda)
    ones_r = torch.ones(R, device=cuda)
    ones_c = torch.ones(xa.shape[1], device=cuda)
    yk = fftconv.fir_convolve(xa, ir, ones_r, ones_c)
    yp = fftconv.fir_convolve_plain(xa, ir, ones_r, ones_c)
    assert refs.db(yk, yp) <= -100.0


def _runner_clips(tmp_path, lengths, seed=1717):
    from xmtpu_torch.io import write_wav

    rng = np.random.default_rng(seed)
    jobs = []
    for i, n in enumerate(lengths):
        p = tmp_path / f"in_{i}.wav"
        write_wav(p, (rng.standard_normal(n) * 9000).astype(np.int16), 44100)
        jobs.append({"voice": str(p), "out": str(tmp_path / f"o_{i}.wav")})
    return jobs


@pytest.mark.parametrize("pipeline", [True, False])
def test_run_batch_on_card_vs_cpu(cuda, tmp_path, pipeline):
    """The file runner on the card (the default device): every clip
    written, the card's peak memory reported, each output within -85 dB
    of the same run on the CPU (the ragged step's tolerance)."""
    from xmtpu_torch.io import read_wav
    from xmtpu_torch.runner import run_batch

    jobs = _runner_clips(tmp_path, (44100, 60000, 30000, 8000))
    rep = run_batch(jobs, batch_size=2, pipeline=pipeline)
    assert rep.done == 4 and not rep.failed, rep.failed
    assert rep.peak_hbm_bytes is not None and rep.peak_hbm_bytes > 0
    cpu_jobs = [dict(j, out=j["out"] + ".cpu.wav") for j in jobs]
    assert run_batch(cpu_jobs, batch_size=2, device="cpu").done == 4
    for j, c in zip(jobs, cpu_jobs):
        y, sr = read_wav(j["out"])
        ref, _ = read_wav(c["out"])
        assert sr == 16000 and y.shape == ref.shape
        db = refs.db(y, ref)
        print(f"runner on the card vs the CPU, {y.shape[0]} samples: "
              f"{db:.1f} dB")
        assert db <= -85.0


def test_run_batch_refuses_interpret_on_card(cuda, tmp_path):
    from xmtpu_torch.runner import run_batch

    jobs = _runner_clips(tmp_path, (8000,))
    with pytest.raises(ConfigError, match="interpret"):
        run_batch(jobs, step_kw={"interpret": True})


# -- the parallel paths on 4 virtual shards of the card ----------------------


def _virtual(cuda, axes=("sp",), shape=(4,)):
    from xmtpu_torch.parallel import Mesh

    return Mesh(np.array([str(cuda)] * 4, dtype=object).reshape(shape), axes)


@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_sp_chain_on_virtual_shards_vs_single_device(cuda, engine):
    """One stereo clip time-sharded over 4 shards of the card, both
    engines, against the port's single-device chain on the card (the IIR
    kernel, K1, the envelope kernel): -80 dB; the kernel engine launches
    K5, its state chain and the envelope core on every shard."""
    from xmtpu_torch.ops import biquad, limiter, reverb
    from xmtpu_torch.parallel import sp_effects_chain

    sos = biquad.eq_sos(list(tbatch.DEFAULT_BANDS), 48000)
    ir = reverb.synthetic_ir(0.1, 48000).astype(np.float32)
    rng = np.random.default_rng(15)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 4 * 65536))).astype(
        np.float32)).to(cuda)
    before = (iir.launches, iir.chain_launches, envelope.envelope_launches)
    got = sp_effects_chain(x, 48000, _virtual(cuda), bands=sos, ir=ir,
                           engine=engine)
    torch.cuda.synchronize()
    after = (iir.launches, iir.chain_launches, envelope.envelope_launches)
    ref, _ = iir.sosfilt(sos, x)
    ref = limiter.limiter(reverb.reverb(ref, ir, wet=0.3, dry=0.7),
                          48000)[0]
    db = refs.db(got, ref)
    print(f"sp chain ({engine}) on 4 virtual shards vs one device: "
          f"{db:.1f} dB; launches {before} -> {after}")
    assert got.device == x.device and db <= -80.0
    if engine == "kernel":
        assert all(a - b >= 4 and (a - b) % 4 == 0
                   for a, b in zip(after, before))


def test_sharded_step_and_pool_on_virtual_shards(cuda):
    """The flagship step over 4 dp shards of the card against the
    unsharded step, the fused branch from the global batch: every sample
    within 1 LSB and -100 dB: K1 and K2 give every row bit for bit, but
    the mixfirst front's float32 matmul (``ops.resample.apply_aligned``)
    rounds otherwise at 32 rows a shard than at 128 on the card (1-LSB
    flips, -107.8 dB at 128 x 1 s; chip_smoke.py phase 28's 256 x 10 s
    reads -inf); ``test_sharded_step_flips_come_from_the_front_matmul``
    pins it. A 16-slot pool over them against the unsharded pool on the
    kernels: -80 dB (on the card each frame's resample matmul,
    ``ops.resample.resample_window``, rounds otherwise at 4 slots than
    at 16: 1-LSB flips, -96.1 dB;
    ``test_sharded_pool_flips_come_from_the_window_matmul`` pins it; on
    the CPU the two are bit for bit)."""
    from xmtpu_torch.bench import config5_config, config5_sources, make_inputs
    from xmtpu_torch.graph.pool import SessionPool

    mesh = _virtual(cuda, ("dp",))
    voice, bgm = make_inputs(128, 1.0)
    v, b = (torch.from_numpy(a).to(cuda) for a in (voice, bgm))
    before = (fftconv.launches, envelope.launches, iir.launches)
    got = tbatch.flagship_step_sharded(mesh)(v, b)
    torch.cuda.synchronize()
    after = (fftconv.launches, envelope.launches, iir.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [4, 4, 0]
    ref = tbatch.make_flagship_step(device=cuda)(v, b)
    db = refs.db(got, ref)
    err = int((got.int() - ref.int()).abs().max())
    print(f"sharded step (128 x 1 s, 4 virtual shards) vs unsharded: "
          f"{db:.1f} dB, max abs {err} LSB")
    assert err <= 1 and db <= -100.0
    _, srcs = config5_sources(pool_slots=16, pool_seconds=1.0)
    pools = [SessionPool(config5_config(), 16, sources=srcs,
                         effects_backend="pallas", **kw)
             for kw in ({"mesh": mesh}, {"device": cuda})]
    a, r = (p.read(10).astype(np.float64) for p in pools)
    db = refs.db(a, r)
    print(f"16-slot pool on 4 virtual shards vs unsharded: {db:.1f} dB")
    assert db <= -80.0


def _in_pieces(fn, rows: int):
    """``fn(A, *args)`` computed on ``rows`` rows of A's leading axis at
    a time and concatenated: what a shard of that many rows computes."""
    def pieces(A, *args):
        return torch.cat([fn(A[i:i + rows], *args)
                          for i in range(0, A.shape[0], rows)])
    return pieces


def test_sharded_step_flips_come_from_the_front_matmul(cuda, monkeypatch):
    """Where the sharded step's 1-LSB flips come from, on the clips of
    the test above (128 x 1 s, 4 virtual shards of 32 rows):

    - the front (``FlagshipStep.front``) at 128 rows and on each 32-row
      shard: the ramp is the same, the normalize gain differs only in
      rows whose ``m`` differs, and ``m`` is the aligned resample's
      ``torch.matmul`` (``ops.resample.apply_aligned``) on framed input
      that is bit for bit the same at both row counts, so every
      difference in ``m`` is that matmul's: cuBLAS picks its kernel by
      the row count, and the kernels round otherwise;
    - K1 (the fused branch's reverb with ``pre_row``/``pre_col``) and K2
      (the fused limiter) on the same rows, once as 128 and once as 4 x
      32: max abs 0, row for row;
    - the unsharded step with that matmul computed 32 rows at a time
      equals the sharded step bit for bit: nothing else in the step
      rounds by its row count."""
    from xmtpu_torch.bench import make_inputs
    from xmtpu_torch.ops import reverb as _reverb

    voice, bgm = make_inputs(128, 1.0)
    v, b = (torch.from_numpy(a).to(cuda) for a in (voice, bgm))
    step = tbatch.make_flagship_step(device=cuda)
    m, scale, ramp = step.front(v, b)
    parts = [step.front(v[i:i + 32], b[i:i + 32]) for i in range(0, 128, 32)]
    m4 = torch.cat([p[0] for p in parts])
    scale4 = torch.cat([p[1] for p in parts])
    assert all(torch.equal(p[2], ramp) for p in parts)
    rows_m = (m4 != m).any(-1)
    rows_s = scale4 != scale
    assert not bool((rows_s & ~rows_m).any())
    A = (b.reshape(128, -1, step.M) * step.gain).add_(
        v.reshape(128, -1, step.M))
    tables = (step.H1, step.H0, step.H2, step.lo, step.hi, step.r0, step.r2)
    mm = tres.apply_aligned(A, *tables).reshape(128, -1)
    mm4 = _in_pieces(tres.apply_aligned, 32)(A, *tables).reshape(128, -1)
    assert torch.equal(mm, m) and torch.equal(mm4, m4)
    print(f"front at 128 rows vs 4 x 32 (the aligned resample's matmul): "
          f"m differs in {int(rows_m.sum())} of 128 rows, max abs "
          f"{float((m4 - m).abs().max()):.3g}; the normalize gain in "
          f"{int(rows_s.sum())} rows, max abs "
          f"{float((scale4 - scale).abs().max()):.3g}; the ramp in none")

    def k1_k2(m_, s_):
        y = _reverb.reverb(m_, step.ir, wet=1.0, dry=0.0, pre_row=s_,
                           pre_col=ramp)
        return y, envelope.limiter(y, step.k_rel, step.c_att, step.curve)[0]

    y, z = k1_k2(m, scale)
    for i in range(0, 128, 32):
        yi, zi = k1_k2(m[i:i + 32], scale[i:i + 32])
        assert torch.equal(yi, y[i:i + 32]) and torch.equal(zi, z[i:i + 32])

    sharded = tbatch.flagship_step_sharded(_virtual(cuda, ("dp",)))(v, b)
    whole = step(v, b)
    monkeypatch.setattr(tres, "apply_aligned",
                        _in_pieces(tres.apply_aligned, 32))
    pieced = step(v, b)
    flips = int((sharded != whole).sum())
    print(f"sharded step vs unsharded: {flips} samples differ (max abs "
          f"{int((sharded.int() - whole.int()).abs().max())} LSB); with the "
          f"front's matmul in 32-row pieces: "
          f"{int((sharded != pieced).sum())}")
    assert torch.equal(pieced, sharded)


def test_sharded_pool_flips_come_from_the_window_matmul(cuda, monkeypatch):
    """Where the sharded pool's flips come from (config 5's 16-slot pool
    on the kernels, 4 virtual shards of 4 slots, 10 frames): each
    frame's resample (``ops.resample.resample_window``, a
    ``torch.matmul`` of the framed window by the band) at 16 slots
    against 4 x 4 slots on the same recorded windows; then, with that
    matmul computed 4 slots at a time, the unsharded pool equals the
    sharded pool bit for bit: the EQ (K5) and the limiter (the envelope
    core) add no flip."""
    from xmtpu_torch.bench import config5_config, config5_sources
    from xmtpu_torch.graph.pool import SessionPool

    _, srcs = config5_sources(pool_slots=16, pool_seconds=1.0)
    mesh = _virtual(cuda, ("dp",))
    window = tres.resample_window

    def pools():
        return [SessionPool(config5_config(), 16, sources=srcs,
                            effects_backend="pallas", **kw)
                for kw in ({"mesh": mesh}, {"device": cuda})]

    calls = []

    def recording(xs, plan, nj):
        y = window(xs, plan, nj)
        calls.append((xs, plan, nj, y))
        return y

    sharded, whole = pools()
    a = sharded.read(10)
    with monkeypatch.context() as mp:
        mp.setattr(tres, "resample_window", recording)
        r = whole.read(10)
    calls = [c for c in calls if c[0].shape[0] == 16]
    assert calls
    diff = [float((_in_pieces(window, 4)(xs, plan, nj) - y).abs().max())
            for xs, plan, nj, y in calls]
    monkeypatch.setattr(tres, "resample_window", _in_pieces(window, 4))
    a2, r2 = (p.read(10) for p in pools())
    print(f"16-slot pool vs 4 x 4: {int((a != r).sum())} samples differ; "
          f"resample_window at 16 vs 4 x 4 slots: {sum(d > 0 for d in diff)} "
          f"of {len(diff)} frames differ, max abs {max(diff):.3g}; with "
          f"the window's matmul 4 slots at a time: "
          f"{int((a2 != r2).sum())} samples differ")
    assert np.array_equal(a2, a) and np.array_equal(a2, r2)


def test_entry_on_the_card_vs_cpu(cuda):
    """``entry()`` builds on the card with its clips there, runs the
    small-batch branch (K5, its state chain, K1 and the envelope core
    launch) and reads -80 dB against ``entry(device="cpu")`` and, clip
    by clip, against the float64 oracle."""
    from xmtpu_torch import entry as tentry

    fn, args = tentry.entry()
    assert all(a.device.type == "cuda" for a in args)
    keys = ("launches", "chain_launches")
    before = ([getattr(iir, k) for k in keys]
              + [fftconv.launches, envelope.envelope_launches])
    y = fn(*args)
    torch.cuda.synchronize()
    after = ([getattr(iir, k) for k in keys]
             + [fftconv.launches, envelope.envelope_launches])
    assert all(a > b for a, b in zip(after, before)), (before, after)
    fn_c, args_c = tentry.entry(device="cpu")
    ref = fn_c(*args_c)
    y = y.cpu()
    db = refs.db(y, ref)
    print(f"entry() on the card vs the CPU: {db:.1f} dB; launches "
          f"{before} -> {after}")
    assert y.shape == (2, 16000) and db <= -80.0
    for i in range(2):
        o = torch.from_numpy(tbatch.flagship_oracle_np(
            args_c[0][i].numpy(), args_c[1][i].numpy())).double()
        assert refs.db(y[i], o) <= -80.0


def test_interpret_true_refused_on_the_card(cuda):
    """``interpret=True`` raises on the card in the step factories and
    ``reverb``; False and None launch the kernels."""
    from xmtpu_torch.ops import reverb as treverb

    x = torch.zeros(2, 4000, device=cuda)
    for f in (lambda: tbatch.make_flagship_step(interpret=True, device=cuda),
              lambda: tbatch.make_batch_step(interpret=True),
              lambda: tbatch.flagship_step_sharded(
                  _virtual(cuda, ("dp",)), interpret=True),
              lambda: treverb.reverb(x, np.ones(8), interpret=True)):
        with pytest.raises(ConfigError, match="CPU only"):
            f()
    before = fftconv.launches
    for it in (False, None):
        treverb.reverb(x, np.ones(8), interpret=it)
    torch.cuda.synchronize()
    assert fftconv.launches == before + 2


def test_dryrun_multichip_on_virtual_shards_of_the_card(cuda, capsys):
    from xmtpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device=str(cuda))
    out = capsys.readouterr().out
    assert out.count(" OK") == 5, out


# ------------------------------------------- precision rungs, trim, gp


@pytest.mark.parametrize("shape_a,shape_b", [
    ((3, 1000, 441), (441, 160)),   # (..., k) @ (k, n): the front's form
    ((64, 64), (5, 64, 128)),       # (m, k) @ (..., k, n): a left DFT
    ((4, 64, 128), (64, 128, 128)),  # the fused middle, batched over k1
])
def test_precision_rungs_card_vs_cpu(cuda, shape_a, shape_b):
    """ops.precision.matmul on the card (tensor-core bf16 passes with
    float32 output) against the CPU plain version (the same parts
    through FP32 matmuls): the same products, float32 sums in another
    order, -120 dB at every rung; HIGH and DEFAULT round apart from
    HIGHEST (a rung equal to FP32 fails)."""
    from xmtpu_torch.ops import precision as tprec

    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.standard_normal(shape_a).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(shape_b).astype(np.float32))
    if len(shape_a) == 3 and len(shape_b) == 3:  # batched over the first
        a = a.transpose(0, 1)
        b = b.transpose(1, 2)
    exact = torch.matmul(a.double(), b.double())
    dbs = {}
    for rung in tprec.RUNGS:
        yc = tprec.matmul(a.to(cuda), b.to(cuda), rung)
        yp = tprec.matmul(a, b, rung)
        assert yc.dtype == torch.float32 and yc.shape == yp.shape
        assert refs.db(yc, yp) <= -120.0, rung
        dbs[rung] = refs.db(yc, exact)
    assert dbs["highest"] < dbs["high"] < dbs["default"], dbs


@pytest.mark.parametrize("R,n,m,block", [
    (3, 30000, 4093, 32768),   # short form, odd rows
    (4, 50000, 24082, 65536),  # long form (3 partitions)
    (2, 100, 50, 1024),        # a signal shorter than one hop
])
def test_fftconv_trim_false_and_gp(cuda, R, n, m, block):
    """K1's hop-padded output (the JAX trim=False) against its twin,
    -120 dB over the whole padded length, its first n samples equal to
    trim=True (max abs 0), and the output at every gp equal to gp=None
    (max abs 0)."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy((0.3 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    h = torch.from_numpy((rng.standard_normal(m) * np.exp(
        -np.arange(m) / (m / 5))).astype(np.float32)).to(cuda)
    pr = torch.from_numpy(rng.uniform(0.5, 2.0, R).astype(np.float32)).to(cuda)
    pc = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32)).to(cuda)
    n_pad = fftconv.padded_length(n, m, block)
    y = fftconv.fir_convolve(x, h, pr, pc)
    y_pad = fftconv.fir_convolve(x, h, pr, pc, trim=False, block=block)
    torch.cuda.synchronize()
    assert y_pad.shape == (R, n_pad)
    twin = fftconv.fir_convolve_plain(x, h, pr, pc, n_out=n_pad)
    assert refs.db(y_pad, twin) <= -120.0
    assert torch.equal(y_pad[:, :n], y)
    for gp in (1, 2, 3, 16, 1000):
        assert torch.equal(fftconv.fir_convolve(x, h, pr, pc, gp=gp), y), gp
    assert torch.equal(fftconv.fir_convolve(x, h, pr, pc, trim=False,
                                            block=block, gp=2), y_pad)


def test_resample_kernel_rungs(cuda):
    """K7 at HIGH (three launches over the split operands) and DEFAULT
    (one launch on bf16-rounded operands) against the twin's split
    matmuls on the card: -120 dB; the non-finite masks equal the twin's
    at every rung (isnan too for NaN input)."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy((0.5 * rng.standard_normal((5, 44100))).astype(
        np.float32)).to(cuda)
    for rung, launches in (("highest", 1), ("high", 3), ("default", 1)):
        resample.launches = 0
        yk = resample.resample(x, 44100, 16000, precision=rung)
        torch.cuda.synchronize()
        assert resample.launches == launches
        yp = tres.polyphase_resample(x, 44100, 16000, precision=rung)
        assert refs.db(yk, yp) <= -120.0, rung
        for n in (44100, 44000):
            xn = x[:, :n].clone()
            xn[1, 300] = float("nan")
            xn[3, 2000] = float("inf")
            yk = resample.resample(xn, 44100, 16000, precision=rung)
            yp = tres.polyphase_resample(xn, 44100, 16000, precision=rung)
            assert torch.equal(~torch.isfinite(yk), ~torch.isfinite(yp))
            assert torch.equal(yk[1].isnan(), yp[1].isnan())
    with pytest.raises(ConfigError, match="precision"):
        resample.resample(x, 44100, 16000, precision="tf64")


def test_mixfirst_pad_step_vs_mixfirst(cuda):
    """The mixfirst_pad front (441 -> 512 zero lanes) against mixfirst on
    the card: the same FP32 matmuls at another depth, so at most 1 LSB
    at the int16 output and -100 dB (cuBLAS may take another kernel for
    K = 512)."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal((128, 44100)) * 8000).astype(
        np.int16)).to(cuda)
    b = torch.from_numpy((rng.standard_normal((128, 44100)) * 6000).astype(
        np.int16)).to(cuda)
    y = tbatch.make_flagship_step(fused=True, device=cuda)(v, b)
    y_pad = tbatch.make_flagship_step(fused=True, device=cuda,
                                      resample_backend="mixfirst_pad")(v, b)
    d = (y_pad.int() - y.int()).abs().max().item()
    assert d <= 1
    assert refs.db(y_pad, y) <= -100.0


# The adaptive noise estimate's tracker kernel (csrc/ns_track.cu).
_TRACK = dict(smooth=0.7, floor=0.1, noise_frames=8, noise_smooth=0.95,
              presence_thresh=4.0, up_leak=1.02)


def _track_spectra(R, T, F, seed):
    """Random complex128 spectra (R, T, F): a decade of levels a frame
    and a stretch 40 dB louder, so both branches of the tracker run."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-0.5, 0.5, (R, T, 1))
    scale[:, T // 3:T // 3 + 4] *= 100.0
    return torch.from_numpy((rng.standard_normal((R, T, F)) + 1j
                             * rng.standard_normal((R, T, F))) * scale)


def _same(a, b) -> bool:
    """Equal bit for bit where finite, NaN where the other is NaN."""
    a, b = torch.view_as_real(a) if a.is_complex() else a, (
        torch.view_as_real(b) if b.is_complex() else b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


@pytest.mark.parametrize("R,T,F,S", [
    (2, 1009, 257, None),  # T prime, the card's S
    (2, 1009, 257, 1),     # unsegmented: pass B alone
    (1, 97, 33, 13),       # one row; 13 segments of 8, the last 1
    (3, 5, 9, 8),          # T < noise_frames: one segment
    (2, 8, 17, 3),         # T = noise_frames
    (2, 30, 17, 4),        # 4 of 8, the first all lead-in, the last 6
    (1, 1, 257, None),     # one frame
    (33, 300, 9, 7),       # 297 chains: partial blocks; 7 of 48, the last 12
    (2, 1000, 17, 10),     # 10 of 104, the last 64
])
def test_track_kernel_vs_twin(cuda, R, T, F, S):
    """The kernel against its twin on the CPU, bit for bit: Y and each
    frame's estimate; a NaN and an inf in a bin each spread as in the
    twin; two launches, one at S = 1."""
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns

    X = _track_spectra(R, T, F, R * T + F)
    X[0, T - 1, F // 2] = complex(np.nan, 0.0)
    X[-1, T // 2, 0] = complex(np.inf, 1.0)
    psd = X.real * X.real + X.imag * X.imag
    seed = ns.median(psd[..., :8, :], dim=-2)
    want_n = torch.empty(X.shape, dtype=torch.float64)
    want = kns.track_plain(X, seed, **_TRACK, noise_out=want_n)
    got_n = torch.empty(X.shape, dtype=torch.float64, device=cuda)
    segs = kns.track_plan(T, kns.track_segments(R, T, F, cuda)
                        if S is None else S)[0]
    before = kns.track_launches
    got = kns.track(X.to(cuda), seed.to(cuda), **_TRACK, noise_out=got_n,
                    segments=S)
    torch.cuda.synchronize()
    print(f"track ({R}, {T}, {F}) at S = {segs}")
    assert kns.track_launches - before == (2 if segs > 1 else 1)
    assert got.dtype == torch.complex64 and got.shape == X.shape
    assert _same(got.cpu(), want) and _same(got_n.cpu(), want_n)
    assert int(torch.isnan(torch.view_as_real(want)).sum()) > 0


@pytest.mark.parametrize("seed", [2**31 + 2801, 2**31 + 2802, 2**31 + 2803])
def test_track_makes_the_float64_definition_s_decisions_at_the_cell_shape(
        cuda, seed):
    """32 tracks of 60 s at 44.1 kHz, 0.3 x Gaussian (the voice44k_adaptive
    cell's batch): the kernel's estimate over the card's float64 spectra
    takes the branch the float64 definition takes (numpy's FFT,
    ``torch_refs.adaptive_noise``) at every frame and bin after the
    lead-in, its estimates within 1e-9 of the definition's, and every
    row of ``suppress`` reads -80 dB or better against ``suppress_np``.
    Printed beside it: what float32 spectra and a float32 tracker (the
    path before the kernel) give, bins and frames whose estimate is off
    by more than 1% and the worst row."""
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns

    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = 2646000
    x = 0.3 * torch.randn((32, n), generator=gen, device=cuda)
    X = ns.stft(x.double())
    psd = X.real * X.real + X.imag * X.imag
    sd = ns.median(psd[..., :8, :], dim=-2)
    del psd
    got = torch.empty(X.shape, dtype=torch.float64, device=cuda)
    kns.track(X, sd, **_TRACK, noise_out=got)
    del X
    got = got.cpu().numpy()
    xh = x.cpu().numpy()
    want, upd = refs.adaptive_noise(xh)
    apart = int(np.sum(refs.leak_taken(got)[..., 8:, :]
                       == upd[..., 8:, :]))
    rel = float(np.max(np.abs(got - want) / want))
    del got
    y = ns.suppress(x, noise_update="adaptive")
    ref = ns.suppress_np(xh.astype(np.float64), noise_update="adaptive")
    dbs = [refs.db(y[i], ref[i]) for i in range(32)]
    del y
    X32 = ns.stft(x)
    p32 = torch.square(torch.abs(X32))
    n32 = ns._adaptive_noise_track(p32, 8, 0.95, 4.0, 1.02)
    off = int(np.sum(np.abs(n32.double().cpu().numpy() - want) / want > 0.01))
    y32 = ns.istft(X32 * kns.wiener_gain(kns.onepole_frames(p32, 0.7), n32,
                                         0.1), n)
    db32 = max(refs.db(y32[i], ref[i]) for i in range(32))
    print(f"seed {seed}: {apart} decisions apart from the float64 "
          f"definition ({upd[..., 8:, :].size} after the lead-in, "
          f"{upd[..., 8:, :].mean():.3f} updates), estimates within "
          f"{rel:.2e}; rows {min(dbs):.1f} to {max(dbs):.1f} dB; float32 "
          f"spectra and tracker: {off} estimates off by more than 1%, "
          f"worst row {db32:.1f} dB")
    assert apart == 0 and rel < 1e-9
    assert max(dbs) <= -80.0


def test_adaptive_tracks_a_noise_step_on_card(cuda):
    """A noise floor 12 dB up 2 s into a 6 s track at 16 kHz
    (``tests/test_ns.py``'s case): on the card the adaptive estimate
    climbs onto it, so the last 1.5 s keep half the frozen estimate's
    residual or less; -80 dB against ``suppress_np``."""
    from xmtpu_torch.ops import ns

    rng = np.random.default_rng(8)
    sr = 16000
    x = (0.02 * rng.standard_normal((2, 6 * sr))).astype(np.float32)
    x[:, 2 * sr:] *= 4.0
    frozen = ns.suppress(x).cpu().numpy().astype(np.float64)
    adapt = ns.suppress(x, noise_update="adaptive")
    ref = ns.suppress_np(x.astype(np.float64), noise_update="adaptive")
    db = refs.db(adapt, ref)
    adapt = adapt.cpu().numpy().astype(np.float64)
    tail = slice(9 * sr // 2, 6 * sr)
    res_f = np.sqrt(np.mean(frozen[:, tail] ** 2))
    res_a = np.sqrt(np.mean(adapt[:, tail] ** 2))
    print(f"noise step: residual {res_a:.2e} adaptive, {res_f:.2e} frozen; "
          f"{db:.1f} dB vs float64")
    assert res_a <= 0.5 * res_f and db <= -80.0


@pytest.mark.parametrize("case", ["lead_only", "one_row", "prime", "int16"])
def test_adaptive_suppress_on_card_vs_cpu_and_oracle(cuda, case):
    """suppress(noise_update="adaptive") on the card (the kernel) against
    the CPU (the twin) at -100 dB (the float64 analyses through two FFT
    libraries, the float32 synthesis) and the float64 oracle at -80 dB:
    T = 5 frames (all lead-in), one row, T = 1009 (prime), int16."""
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns

    x = {"lead_only": lambda: _ns_signal((2, 1000), 21),
         "one_row": lambda: _ns_signal((1, 200 * 256), 22),
         "prime": lambda: _ns_signal((2, 1008 * 256), 23),
         "int16": lambda: np.round(_ns_signal((2, 1008 * 256), 24)
                                   * 3.0 * 32767.0).astype(np.int16)}[case]()
    kw = {"noise_update": "adaptive"}
    *lead, n = x.shape
    T = ns._frame_count(n, 512)
    S = kns.track_segments(int(np.prod(lead)), T, 257, cuda)
    before, wiener = kns.track_launches, kns.launches
    y = ns.suppress(x, device=cuda, **kw)
    torch.cuda.synchronize()
    assert kns.track_launches - before == (2 if S > 1 else 1)
    assert kns.launches == wiener
    y_cpu = ns.suppress(x, device="cpu", **kw)
    ref = ns.suppress_np(x.astype(np.float64), **kw)
    assert y.shape == y_cpu.shape == x.shape
    assert y.dtype == y_cpu.dtype == torch.from_numpy(x).dtype
    db_cpu, db_ref = refs.db(y, y_cpu), refs.db(y, ref)
    print(f"adaptive {case} {x.shape}, T = {T}, S = {S}: card vs CPU "
          f"{db_cpu:.1f} dB, vs "
          f"float64 {db_ref:.1f} dB")
    assert db_cpu <= -100.0 and db_ref <= -80.0


def test_adaptive_suppress_on_card_launches_only_under_its_four_ranges(
        cuda, tmp_path):
    """With the adaptive estimate every device operation of ns.suppress
    lies under ``ns_stft``, ``ns_noise``, ``ns_track`` or ``ns_istft``,
    each holds one, ``ns_track`` the kernel's two passes; a call
    launches as many operations at twice the frames (no loop over
    frames)."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import TraceView
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns
    from xmtpu_torch.utils import profiling

    names = ("ns_stft", "ns_noise", "ns_track", "ns_istft")
    counts = []
    for k, n in enumerate((1008 * 256, 2016 * 256)):
        x = torch.from_numpy(_ns_signal((2, n), 25)).to(cuda)
        ns.suppress(x, noise_update="adaptive")  # warm-up outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a call before the window, as the harness's traced slice has
            # one: a session can lose its first device records
            ns.suppress(x, noise_update="adaptive")
            torch.cuda.synchronize()
            before = kns.track_launches
            with torch.profiler.record_function("perfbench.traced_window"):
                with profiling.stage("ns"):
                    ns.suppress(x, noise_update="adaptive")
                torch.cuda.synchronize()
        assert kns.track_launches - before == 2
        path = tmp_path / f"trace{k}.json"
        prof.export_chrome_trace(str(path))
        view = TraceView.from_file(path)
        parts = {m: [o for o in view.ops if o.under(f"xmtpu_torch.{m}")]
                 for m in names}
        print(n, {m: len(v) for m, v in parts.items()})
        assert view.ops and all(parts.values())
        assert sum(map(len, parts.values())) == len(view.ops)
        assert {"track_kernel", "checkpoints_kernel"} <= {
            k for o in parts["ns_track"]
            for k in ("track_kernel", "checkpoints_kernel") if k in o.name}
        counts.append(len(view.ops))
    assert counts[0] == counts[1]


def test_frozen_suppress_is_the_wiener_path_bit_for_bit(cuda):
    """At the voice cell's shape (32 x 60 s at 44.1 kHz) the frozen
    suppressor is the float32 analysis, the lead-in median and the Wiener
    kernel: bit for bit, and launches no tracker."""
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns

    gen = torch.Generator(device=cuda).manual_seed(2**31 + 2804)
    n = 2646000
    x = 0.3 * torch.randn((32, n), generator=gen, device=cuda)
    before = kns.track_launches
    y = ns.suppress(x)
    X = ns.stft(x)
    noise = ns.median(torch.square(torch.abs(X[..., :8, :])), dim=-2)
    want = ns.istft(kns.wiener(X, noise, 0.7, 0.1), n)
    torch.cuda.synchronize()
    assert kns.track_launches == before
    assert y.dtype == torch.float32 and torch.equal(y, want)
