"""Parity of the port's kernel wrappers (``xmtpu_torch.kernels``) with
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain torch twin; the
CUDA kernels themselves are compared with the twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 2 rows x 8000 samples (the flagship chain's bus signal for
0.5 s clips), the chain's 4093-tap combined EQ+reverb IR. At 2 rows and
8000 samples ``pick_segments`` is 1, so the JAX limiter takes the
unsegmented in-kernel-curve path (K2) the port replaces.

Tolerances:
- fftconv twin against the Pallas kernel: -95 dB. The gate is set by
  the reference, not the port: the Pallas kernel's 3-pass bf16 DFT
  matmuls read -99.2 dB against a float64 direct convolution at this
  shape (block 32768), while the twin reads -135 dB. The twin is
  therefore also gated at -120 dB against the float64 convolution;
- limiter twin against the Pallas kernel and the float64 oracle:
  -100 dB (float32 on both sides; association order and exp/log vs
  log10/pow rounding only).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu import batch as xbatch
from xmtpu.kernels.envelope import limiter_pallas
from xmtpu.kernels.fftconv import fir_convolve_os_pallas
from xmtpu.kernels.iir import pick_segments
from xmtpu.ops import reverb as xreverb
from xmtpu_torch.kernels import _build, envelope, fftconv
from xmtpu_torch.ops import reverb
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff

from . import torch_refs as refs

R, N, SR_BUS = 2, 8000, 16000


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = (0.3 * rng.standard_normal((R, N))).astype(np.float32)
    pre_row = np.array([0.8, 1.7], np.float32)
    pre_col = xbatch._mix.fade_ramp_np(N, 4000, 4000, N).astype(np.float32)
    sos = xbatch._biquad.eq_sos(list(xbatch.DEFAULT_BANDS), SR_BUS)
    ir = xbatch._combined_ir(
        sos, xreverb.synthetic_ir(0.25, SR_BUS).astype(np.float32),
        0.25, 0.75)
    return x, pre_row, pre_col, ir


def _t(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


# ---------------------------------------------------------------- fftconv


def test_fftconv_twin_vs_pallas(data):
    x, pre_row, pre_col, ir = data
    blk, gp = xbatch._reverb_block(ir.shape[-1])
    y_j = np.asarray(fir_convolve_os_pallas(
        jnp.asarray(x), ir, blk, gp=gp, interpret=True,
        pre_row=jnp.asarray(pre_row), pre_col=jnp.asarray(pre_col)))[..., :N]
    y_t = fftconv.fir_convolve(*_t(x, ir, pre_row, pre_col)).numpy()
    db = refs.db(y_t, y_j)
    print(f"fftconv twin vs Pallas (interpret): {db:.1f} dB")
    assert y_t.shape == (R, N) and db <= -95.0


@pytest.mark.parametrize("m", [4093, 50])  # one block; many 1024 blocks
def test_fftconv_twin_vs_direct_f64(data, m):
    x, pre_row, pre_col, ir = data
    h = np.ascontiguousarray(ir[:m])
    y_t = fftconv.fir_convolve_plain(*_t(x, h, pre_row, pre_col)).numpy()
    xin = (x.astype(np.float64) * pre_row[:, None]) * pre_col
    ref = refs.direct_conv(xin, h, N)
    assert refs.db(y_t, ref) <= -120.0


def _fdl_model(x, ir, pre_row, pre_col, log_n, part, n_out=None,
               slots=None, chunk=None):
    """float64 torch model of the long-IR kernel's frequency-domain delay
    line, index for index: the gained rows in complex pairs (row 2i the
    real part, 2i+1 the imaginary); window j the N points from (j-1)*part,
    zero outside [0, n), its spectrum taken once into slot j % slots of
    the pair's spectra; frame f, outputs [f*part, (f+1)*part), the points
    [part, N) of one inverse of sum_{p <= min(f, P-1)} X_{f-p} H_p; the
    frames in chunks, each chunk's windows before its frames (slots =
    chunk = frames unless given). Asserts that every spectrum a frame
    reads is the window it wants. Returns (y (R, n_out), forward and
    inverse transforms run, one per pair each)."""
    R, n = x.shape
    N = 1 << log_n
    assert N == 2 * part  # window f-p of frame f starts at f*part - (p+1)*part
    n_out = n if n_out is None else n_out
    xin = x.double() * pre_row.double()[:, None] * pre_col.double()
    xin = torch.cat([xin, torch.zeros((R % 2, n), dtype=torch.float64)])
    z = torch.complex(xin[0::2], xin[1::2])
    pairs = z.shape[0]
    parts = -(-ir.shape[0] // part)
    H = [torch.fft.fft(ir[p * part:(p + 1) * part].double(), n=N)
         for p in range(parts)]
    frames = -(-n_out // part)
    slots = frames if slots is None else slots
    chunk = frames if chunk is None else chunk
    X = torch.zeros((slots, pairs, N), dtype=torch.complex128)
    held = [None] * slots
    y = torch.zeros((pairs, frames * part), dtype=torch.complex128)
    forward = inverse = 0
    for f0 in range(0, frames, chunk):
        run = range(f0, min(frames, f0 + chunk))
        for j in run:
            g = torch.arange(N) + (j - 1) * part
            ok = (g >= 0) & (g < n)
            win = torch.where(ok, z[:, g.clamp(0, n - 1)], 0.0)
            X[j % slots], held[j % slots] = torch.fft.fft(win, dim=-1), j
            forward += pairs
        for f in run:
            acc = torch.zeros((pairs, N), dtype=torch.complex128)
            for p in range(min(f + 1, parts)):
                assert held[(f - p) % slots] == f - p
                acc += X[(f - p) % slots] * H[p]
            y[:, f * part:(f + 1) * part] = torch.fft.ifft(acc)[:, part:]
            inverse += pairs
    out = torch.stack([y.real, y.imag], dim=1).reshape(2 * pairs, -1)
    return out[:R, :n_out], forward, inverse


@pytest.mark.parametrize("R,n,m,log_n,part", [
    (3, 1500, 1000, 8, 128),     # 8 partitions, a short last one, R odd
    (2, 100, 700, 9, 256),       # n < hop: one partial frame
    (2, 20000, 24082, 14, 8192),  # the kernel's geometry at config 3's IR
    (3, 10000, 24082, 14, 8192),  # fewer frames (2) than partitions (3)
    (1, 70000, 65537, 14, 8192),  # 9 partitions, the last of one tap
])
def test_fftconv_partition_loop_model(data, R, n, m, log_n, part):
    """The long-IR kernel's frequency-domain delay line, as a float64
    torch model, against the twin and a float64 direct convolution: -120
    dB. Run again on the tightest ring of spectra (P slots a pair, one
    frame a chunk), the model reads the same windows and gives the same
    output bit for bit."""
    if part == fftconv.LONG_PART:
        assert log_n == fftconv.LONG_LOG_N
        assert fftconv.LONG_HOP == (1 << log_n) - part
    rng = np.random.default_rng(m)
    x = (0.3 * rng.standard_normal((R, n))).astype(np.float32)
    h = (rng.standard_normal(m) * np.exp(-np.arange(m) / (m / 5))).astype(
        np.float32)
    pre_row = rng.uniform(0.5, 2.0, R).astype(np.float32)
    pre_col = rng.uniform(0.0, 1.0, n).astype(np.float32)
    args = _t(x, h, pre_row, pre_col)
    y_m = _fdl_model(*args, log_n, part)[0]
    frames, parts = -(-n // part), -(-m // part)
    if frames > parts:
        y_ring = _fdl_model(*args, log_n, part, slots=parts, chunk=1)[0]
        assert torch.equal(y_ring, y_m)
    xin = (x.astype(np.float64) * pre_row[:, None]) * pre_col
    ref = refs.direct_conv(xin, h[:n], n)  # y[:n] reads no tap past n
    y_t = fftconv.fir_convolve_plain(*args).numpy()
    db_m, db_t = refs.db(y_m.numpy(), ref), refs.db(y_t, ref)
    print(f"FDL model ({R}, {n}) x {m} taps: {db_m:.1f} dB vs "
          f"float64 (gate -120); twin {db_t:.1f} dB (gate -120)")
    assert db_m <= -120.0 and db_t <= -120.0


@pytest.mark.parametrize("R,n,n_out,m", [
    (3, 5000, 5000, 24082),      # R odd, n < LONG_HOP: one frame
    (5, 5000, 40000, 24082),     # n_out > n: 5 frames, 4 past the input
    (1, 30000, 40000, 65537),    # 9 partitions, 5 frames
    (7, 100, 8193, 8194),        # n_out one past a frame: 2 frames
])
def test_fftconv_long_transform_count(R, n, n_out, m):
    """The long form's counter arithmetic (``long_transforms``, which
    the wrapper adds to ``long_forward_transforms`` a call): the forward
    and inverse transforms the float64 model of the kernel runs, pairs x
    frames whatever the partitions, on the wrapper's schedule and on the
    tightest ring; and the first n outputs do not depend on n_out."""
    pairs, frames = -(-R // 2), -(-n_out // fftconv.LONG_HOP)
    assert fftconv.long_transforms(R, n_out) == pairs * frames
    rng = np.random.default_rng(R * n_out + m)
    args = _t((0.3 * rng.standard_normal((R, n))).astype(np.float32),
              (rng.standard_normal(m) * 0.01).astype(np.float32),
              rng.uniform(0.5, 2.0, R).astype(np.float32),
              rng.uniform(0.0, 1.0, n).astype(np.float32))
    geo = (fftconv.LONG_LOG_N, fftconv.LONG_PART)
    slots, chunk = fftconv.long_schedule(R, n_out, m)
    y, fwd, inv = _fdl_model(*args, *geo, n_out=n_out, slots=slots,
                             chunk=chunk)
    assert fwd == inv == fftconv.long_transforms(R, n_out)
    parts = fftconv.long_parts(m)
    if frames > parts:
        ring = _fdl_model(*args, *geo, n_out=n_out, slots=parts, chunk=1)
        assert ring[1:] == (fwd, inv) and torch.equal(ring[0], y)
    y_n = _fdl_model(*args, *geo)[0]
    assert y.shape == (R, n_out) and torch.equal(y[:, :n], y_n)


@pytest.mark.parametrize("R,n_out,m,cap,want", [
    (128, 480000, 24082, None, (59, 59)),   # the effects cell: no ring
    (2, 28_800_000, 24164, None, (3516, 3516)),  # the episode's voice
    (2, 172_800_000, 24082, None, (4096, 4094)),  # the hour clip: a ring
    (4, 100000, 24082, 2 << 20, (8, 6)),   # a ring of 8 spectra a pair
    (256, 100000, 65537, 1 << 20, (9, 1)),  # room for none: P slots
    (256, 30000, 65537, 1 << 20, (4, 4)),   # frames <= P: all windows
])
def test_fftconv_long_schedule(monkeypatch, R, n_out, m, cap, want):
    """The long form's workspace of window spectra: all windows' while
    they fit ``LONG_SPECTRA_BYTES``, else a ring whose chunks of frames
    read no window that a later chunk overwrote (slots >= chunk + P -
    1), within the cap unless P spectra a pair already exceed it."""
    if cap is not None:
        monkeypatch.setattr(fftconv, "LONG_SPECTRA_BYTES", cap)
    slots, chunk = fftconv.long_schedule(R, n_out, m)
    frames, parts = -(-n_out // fftconv.LONG_HOP), fftconv.long_parts(m)
    assert (slots, chunk) == want and 1 <= chunk <= frames
    assert slots == frames or frames > slots >= chunk + parts - 1
    spectrum = 8 << fftconv.LONG_LOG_N
    assert (-(-R // 2) * slots * spectrum <= fftconv.LONG_SPECTRA_BYTES
            or slots == min(frames, parts))


def _plan_stages(z, log_n, dit):
    """float64 model of the kernel's transform core (``Plan`` in
    ``csrc/fftconv.cu``, described by ``fftconv.fft_plan``), stage by
    stage over the last axis of ``z``: stage s takes the points (b // L)
    * M + b % L + L * k, k < R, of butterfly b, runs the R-point DFT and
    multiplies by w^(j*k*N/M), j = b % L, after it (dif, stages in
    order) or before it (dit, stages in reverse order), and writes the
    results back to the same points."""
    N = 1 << log_n
    w = torch.exp(-2j * np.pi * torch.arange(N, dtype=torch.float64) / N)
    a = z.clone()
    stages = fftconv.fft_plan(log_n)[2]
    for R, M, L in (reversed(stages) if dit else stages):
        b = torch.arange(N // R)[:, None]
        k = torch.arange(R)[None, :]
        pos = (b // L) * M + b % L + L * k
        tw = w[(b % L) * k * (N // M)]
        x = a[..., pos]
        x = torch.fft.fft(x * tw if dit else x, dim=-1)
        a[..., pos] = x if dit else x * tw
    return a


def _digit_reversed(log_n):
    """Where dif leaves bin f: f = f0 + R0 f1 + R0 R1 f2 + ... lands at
    f0 L0 + f1 L1 + ... (L_s the stage strides)."""
    f = torch.arange(1 << log_n)
    where = torch.zeros_like(f)
    for R, _, L in fftconv.fft_plan(log_n)[2]:
        where += (f % R) * L
        f = f // R
    return where


@pytest.mark.parametrize("log_n", [10, 11, 12, 13, 14])
def test_fft_plan_model(log_n):
    """K1's mixed-radix plan against torch.fft (float64, so only the
    index maps and twiddle exponents are on trial): dif leaves the
    spectrum in the digit-reversed order, dit takes that order back to a
    natural-order DFT, and the overlap-save round trip through both
    (conj(dit(conj(X * H / N)))) is the circular convolution. Each
    stage's butterflies, b = t + T*q over the T threads, cover every
    point once, and each half-warp's padded shared-memory indices (p +
    p // 16) differ modulo 16: no bank conflict."""
    N = 1 << log_n
    T, P, stages = fftconv.fft_plan(log_n)
    assert T * P == N and P in (16, 32)
    assert int(np.prod([r for r, _, _ in stages])) == N
    assert fftconv.exchanges(log_n) == len(stages) - 1 <= 3
    rng = np.random.default_rng(log_n)
    x, h = (torch.from_numpy(rng.standard_normal((2, N))
                             + 1j * rng.standard_normal((2, N)))
            for _ in range(2))
    ref = torch.fft.fft(x, dim=-1)
    pos = _digit_reversed(log_n)
    X = _plan_stages(x, log_n, dit=False)
    assert torch.allclose(X[:, pos], ref, rtol=0, atol=1e-9 * N)
    Y = torch.zeros_like(x)
    Y[:, pos] = h  # spectrum h stored in dif order
    assert torch.allclose(_plan_stages(Y, log_n, dit=True),
                          torch.fft.fft(h, dim=-1), rtol=0, atol=1e-9 * N)
    H = _plan_stages(h, log_n, dit=False) / N
    y = _plan_stages((X * H).conj(), log_n, dit=True).conj()
    circ = torch.fft.ifft(ref * torch.fft.fft(h, dim=-1), dim=-1)
    assert torch.allclose(y, circ, rtol=0, atol=1e-9 * N)
    t = torch.arange(T)
    for R, M, L in stages:
        seen = torch.zeros(N, dtype=torch.int64)
        for q in range(P // R):
            b = (t + T * q)[:, None]
            p = (b // L) * M + b % L + L * torch.arange(R)[None, :]
            seen[p.reshape(-1)] += 1
            banks = ((p + p // 16) % 16).reshape(T // 16, 16, R)
            assert bool((banks.sort(dim=1).values
                         == torch.arange(16)[None, :, None]).all())
        assert bool((seen == 1).all())


def test_reverb_op_vs_jax(data):
    """ops.reverb's folded-chain form (dry=0, in-kernel gains, output
    prescale) and its wet/dry form against the JAX op on its Pallas
    backend."""
    x, pre_row, pre_col, ir = data
    blk, gp = xbatch._reverb_block(ir.shape[-1])
    kw = dict(wet=0.5, dry=0.0, pre_row=pre_row, pre_col=pre_col)
    y_j = np.asarray(xreverb.reverb(
        jnp.asarray(x), ir, block=blk, gp=gp, backend="pallas",
        interpret=True, prescale=jnp.asarray([[1.5], [0.5]], jnp.float32),
        **kw))
    y_t = reverb.reverb(torch.from_numpy(x), ir,
                        prescale=torch.tensor([[1.5], [0.5]]), **kw).numpy()
    assert refs.db(y_t, y_j) <= -95.0  # the Pallas kernel's own floor
    y_j = np.asarray(xreverb.reverb(jnp.asarray(x), ir, wet=0.25, dry=0.75,
                                    block=blk, gp=gp, backend="pallas",
                                    interpret=True))
    y_t = reverb.reverb(torch.from_numpy(x), ir, wet=0.25, dry=0.75).numpy()
    assert refs.db(y_t, y_j) <= -95.0


def test_reverb_wet_dry_vs_jax():
    """The unfused chain's reverb: the raw 4000-tap IR, wet 0.25 and
    dry 0.75, with and without a prescale, against the JAX op on its
    Pallas backend (interpret mode); the gate is the Pallas kernel's own
    floor, as above."""
    rng = np.random.default_rng(29)
    x = (0.3 * rng.standard_normal((R, N))).astype(np.float32)
    ir = xreverb.synthetic_ir(0.25, SR_BUS).astype(np.float32)
    assert ir.shape == (4000,)
    blk = xbatch._reverb_block(ir.shape[-1])[0]
    s = np.array([[0.6], [1.4]], np.float32)
    for prescale in (None, s):
        y_j = np.asarray(xreverb.reverb(
            jnp.asarray(x), ir, wet=0.25, dry=0.75, block=blk,
            backend="pallas", interpret=True,
            prescale=None if prescale is None else jnp.asarray(prescale)))
        y_t = reverb.reverb(
            torch.from_numpy(x), ir, wet=0.25, dry=0.75,
            prescale=None if prescale is None else torch.from_numpy(
                prescale)).numpy()
        db = refs.db(y_t, y_j)
        print(f"wet/dry reverb vs Pallas (prescale "
              f"{prescale is not None}): {db:.1f} dB (gate -95)")
        assert db <= -95.0


# --------------------------------------------------------------- envelope


@pytest.mark.parametrize("init", [None, (0.4, 0.2)])
def test_limiter_twin_vs_pallas(data, init):
    assert pick_segments(R, N, lanes=256) == 1  # unsegmented JAX path
    x = 3.0 * data[0]  # drive well into the knee and the ceiling
    k_rel = _release_coeff(100.0, SR_BUS)
    c_att = _attack_coeff(1.0, SR_BUS)
    init_j = None if init is None else tuple(
        jnp.full((R,), v, jnp.float32) for v in init)
    y_j, st_j = limiter_pallas(jnp.asarray(x), k_rel, c_att, -3.0,
                               init=init_j, interpret=True)
    y_j = np.asarray(y_j)
    init_t = None if init is None else torch.tensor(
        [[init[0]] * R, [init[1]] * R], dtype=torch.float32)
    y_t, zf_t = envelope.limiter(torch.from_numpy(x), k_rel, c_att,
                                 envelope.curve_of(-3.0), init=init_t)
    db = refs.db(y_t.numpy(), y_j)
    print(f"limiter twin vs Pallas (interpret): {db:.1f} dB")
    assert db <= -100.0
    assert np.abs(y_t.numpy()).max() <= 1.0
    np.testing.assert_allclose(zf_t.numpy(), np.stack(
        [np.asarray(s) for s in st_j]), rtol=1e-5)


def test_limiter_twin_vs_oracle(data):
    """The twin against the float64 oracle of ops.limiter."""
    from xmtpu_torch.ops.limiter import limiter_np

    x = 3.0 * data[0]
    y_ref, _ = limiter_np(x[:, None, :], SR_BUS, threshold_db=-3.0)
    y_t, _ = envelope.limiter(torch.from_numpy(x),
                              _release_coeff(100.0, SR_BUS),
                              _attack_coeff(1.0, SR_BUS),
                              envelope.curve_of(-3.0))
    assert refs.db(y_t.numpy(), y_ref[:, 0]) <= -100.0


# ------------------------------------------------------- wrapper contract


def test_wrappers_refuse_bad_operands(data):
    x, pre_row, pre_col, ir = _t(*data)
    with pytest.raises(ValueError):
        fftconv.fir_convolve(x.double(), ir, pre_row, pre_col)
    with pytest.raises(ValueError):
        fftconv.fir_convolve(x.T, ir, pre_row, pre_col[:R])  # strided
    with pytest.raises(ValueError):
        fftconv.fir_convolve(x, ir, pre_row[:1], pre_col)
    rows = fftconv._MAX_ROWS + 1  # past the launch grid's row pairs
    with pytest.raises(ValueError, match="rows"):
        fftconv.fir_convolve(torch.zeros(rows, 1), ir, torch.ones(rows),
                             torch.ones(1))
    # no tap limit: past 8193 taps the partitioned form takes over
    assert fftconv.fir_convolve(x, torch.ones(8194), pre_row,
                                pre_col).shape == x.shape
    assert fftconv.fft_log_size(4093) == 13  # the chain: 8192-point blocks
    assert fftconv.MAX_SHORT_TAPS == 8193
    assert [fftconv.long_parts(m) for m in (8194, 16384, 24082, 65537)] == [
        2, 2, 3, 9]
    with pytest.raises(ValueError):
        envelope.limiter(x[None], 0.9, 0.1, envelope.curve_of(-3.0))
    with pytest.raises(ValueError):
        envelope.limiter(x, 0.9, 0.1, envelope.curve_of(-3.0),
                         init=torch.zeros(2, R + 1))


def test_wrappers_launch_only_on_cuda(data):
    """A CPU tensor runs the twin and counts no launch; a tensor on any
    other non-CUDA device raises instead of falling back."""
    x, pre_row, pre_col, ir = _t(*data)
    before = (fftconv.launches, envelope.launches)
    fftconv.fir_convolve(x, ir, pre_row, pre_col)
    envelope.limiter(x, 0.9, 0.1, envelope.curve_of(-3.0))
    assert (fftconv.launches, envelope.launches) == before
    meta = [t.to("meta") for t in (x, ir, pre_row, pre_col)]
    with pytest.raises(ValueError, match="no fftconv kernel"):
        fftconv.fir_convolve(*meta)
    with pytest.raises(ValueError, match="no envelope kernel"):
        envelope.limiter(meta[0], 0.9, 0.1, envelope.curve_of(-3.0))


def test_build_key_covers_sources():
    """The build is keyed by the flags and every CUDA source, for
    Hopper's sm_90a; the library lands in the ignored build dir."""
    names = [p.name for p in _build.sources()]
    assert {"fftconv.cu", "envelope.cu"} <= set(names)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    key = _build.source_key()
    assert len(key) == 16 and key == _build.source_key()
    assert _build.library_path().parent.parent == _build.BUILD_DIR


# ------------------------------------------------- fftconv trim=False, gp


def _pallas_padded(data, **kw):
    x, pre_row, pre_col, ir = data
    blk, gp = xbatch._reverb_block(ir.shape[-1])
    return np.asarray(fir_convolve_os_pallas(
        jnp.asarray(x), ir, blk, gp=gp, interpret=True,
        pre_row=jnp.asarray(pre_row), pre_col=jnp.asarray(pre_col),
        trim=False, **kw)), blk


def test_fftconv_trim_false_twin_vs_pallas(data):
    """The twin's whole hop-padded output against the Pallas kernel's
    trim=False in interpret mode. Over the padded length the reference
    itself reads -94.9 dB against a float64 direct convolution (its tail
    past n -57.6 dB: the 3-pass bf16 error is absolute and the tail
    holds little energy; its first n samples -99.3), so the gate there
    is -94 dB, and -95 dB on the first n samples as for trim=True. The
    twin against float64 over the whole padded output: -120 dB (it
    reads -133.4). Its first n samples equal trim=True bit for bit."""
    x, pre_row, pre_col, ir = data
    y_j, blk = _pallas_padded(data)
    args = _t(x, ir, pre_row, pre_col)
    y_t = fftconv.fir_convolve(*args, trim=False, block=blk).numpy()
    assert y_t.shape == y_j.shape == (R, fftconv.padded_length(
        N, ir.shape[-1], blk))
    xin = (x.astype(np.float64) * pre_row[:, None]) * pre_col
    L = y_t.shape[-1]
    ref = refs.direct_conv(xin, ir, L)
    ref = np.pad(ref, ((0, 0), (0, L - ref.shape[-1])))
    d, d_n, d64 = (refs.db(y_t, y_j),
                   refs.db(y_t[:, :N], y_j[:, :N]),
                   refs.db(y_t, ref))
    print(f"trim=False twin vs Pallas {d:.1f} dB (first n {d_n:.1f}), vs "
          f"float64 {d64:.1f} dB; Pallas vs float64 "
          f"{refs.db(y_j, ref):.1f}")
    assert d <= -94.0 and d_n <= -95.0 and d64 <= -120.0
    assert np.array_equal(y_t[:, :N], fftconv.fir_convolve(*args).numpy())


@pytest.mark.parametrize("gp", [None, 1, 2, 3, 16, 0, -4])
def test_fftconv_gp_invariance(data, gp):
    """Output does not depend on gp (the JAX kernel's row pairs a TPU
    grid step, not a parameter of the card's launch), as the JAX
    kernel's does not; gp is capped as the JAX kernel caps it."""
    x, pre_row, pre_col, ir = data
    args = _t(x, ir, pre_row, pre_col)
    y = fftconv.fir_convolve(*args)
    assert torch.equal(fftconv.fir_convolve(*args, gp=gp), y)
    assert fftconv.pairs_per_block(gp, R) == (
        1 if gp is None else max(1, min(gp, -(-R // 2))))
    with pytest.raises(TypeError):
        fftconv.fir_convolve(*args, gp=1.5)


@pytest.mark.parametrize("m", [2, 50, 4093, 24082])
def test_fftconv_padded_length_is_the_jax_geometry(m):
    """padded_length against the JAX kernel's trim=False output length
    at its own blocks (interpret mode, a short signal), and its block
    refusals."""
    rng = np.random.default_rng(m)
    h = rng.standard_normal(m)
    for block, n in ((65536, 1000), (32768, 70000), (16384, 3000)):
        try:
            y = fir_convolve_os_pallas(jnp.zeros((1, n), jnp.float32), h,
                                       block, interpret=True, trim=False)
        except ValueError as e:  # the JAX refusal, in the same words
            assert "too small" in str(e)
            with pytest.raises(ValueError, match="too small"):
                fftconv.padded_length(n, m, block)
            continue
        assert fftconv.padded_length(n, m, block) == y.shape[-1]
    with pytest.raises(ValueError, match="power of two"):
        fftconv.padded_length(1000, 50, 6000)


def test_fftconv_gp_table():
    for block in (1024, 16384, 32768, 65536, 131072):
        assert fftconv.fftconv_gp(block) == xreverb.fftconv_gp(block)
        assert reverb.fftconv_gp(block) == xreverb.fftconv_gp(block)


def test_reverb_trim_false_and_gp_vs_jax(data):
    """reverb(backend="pallas", trim=False, dry=0, gp=) against the JAX
    reverb in interpret mode over the padded length (-94 dB, the
    reference's floor above), and the JAX refusals."""
    x, pre_row, pre_col, ir = data
    blk, gp = xbatch._reverb_block(ir.shape[-1])
    y_j = np.asarray(xreverb.reverb(
        jnp.asarray(x), ir, wet=0.5, dry=0.0, block=blk, backend="pallas",
        gp=gp, interpret=True, trim=False, pre_row=jnp.asarray(pre_row)))
    y_t = reverb.reverb(torch.from_numpy(x), ir, wet=0.5, dry=0.0, block=blk,
                        gp=gp, trim=False, pre_row=torch.from_numpy(pre_row))
    assert y_t.shape == y_j.shape and refs.db(y_t.numpy(), y_j) <= -94.0
    xt = torch.from_numpy(x)
    for kw in ({"trim": False}, {"trim": False, "backend": "xla", "dry": 0.0},
               {"trim": False, "backend": "mxu", "dry": 0.0}):
        with pytest.raises(ValueError, match="trim=False requires"):
            reverb.reverb(xt, ir, **kw)
    for kw in ({"gp": 2, "backend": "xla"}, {"gp": 1, "backend": "mxu"}):
        with pytest.raises(ValueError, match="gp/interpret apply to"):
            reverb.reverb(xt, ir, **kw)
    for kw in ({"precision": "high"}, {"precision": "high", "backend": "xla"}):
        with pytest.raises(ValueError, match="precision applies to"):
            reverb.reverb(xt, ir, **kw)
    # a given block is checked whatever trim is, in the JAX kernel's words
    args = _t(x, ir, pre_row, pre_col)
    for bad, words in ((6000, "must be a power of two"),
                       (4096, "too small for")):
        with pytest.raises(ValueError, match=words):
            xreverb.reverb(jnp.asarray(x), ir, block=bad, backend="pallas",
                           interpret=True)
        with pytest.raises(ValueError, match=words):
            reverb.reverb(xt, ir, block=bad)
        with pytest.raises(ValueError, match=words):
            fftconv.fir_convolve(*args, block=bad)
