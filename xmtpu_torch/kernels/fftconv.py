"""Same-length causal FIR convolution with in-kernel input gains
(counterpart of ``xmtpu.kernels.fftconv.fir_convolve_os_pallas``).

    y[r, t] = sum_k ir[k] * pre_row[r] * pre_col[t-k] * x[r, t-k]

On a CUDA tensor :func:`fir_convolve` launches the hand-written kernels
of ``csrc/fftconv.cu`` (FFT overlap-save, two rows per complex
transform, the frame in registers through mixed-radix stages that
:func:`fft_plan` describes; see the note at the top of that file): for
IRs of up to 8193 taps one transform of at most 16384 points per frame,
for longer ones the long form, a frequency-domain delay line
(:func:`long_parts` partitions of ``LONG_PART`` taps; each input
window's 16384-point spectrum taken once, the partitions' products
summed in registers before one inverse a frame; :func:`long_schedule`
sizes its workspace of spectra). On a CPU tensor it runs
:func:`fir_convolve_plain`, a float32 ``torch.fft`` overlap-save with
the same gains at any length, which the CPU tests and the on-card
comparison use.

``trim=False`` returns the JAX kernel's hop-padded output, (R,
nblk*hop) by the JAX hop geometry (:func:`padded_length`, ``block``
65536 by default): samples [n, nblk*hop) are the valid convolution tail
of the zero-padded input. The kernel writes that length itself (input
past n reads as zero), in the same frames and stores, so the first n
samples are bit-identical to ``trim=True``. The port's chains keep
``trim=True``: the kernel writes exactly the n samples the limiter
reads. A ``block`` that is given is checked as the JAX kernel checks it
(a power of two with room for the IR) whatever ``trim`` is; the
kernel's own frame size does not depend on it. ``gp`` is the JAX
kernel's row pairs a TPU grid step: validated and capped as the JAX
kernel caps it (:func:`pairs_per_block`), and, like the JAX kernel's
``wide``, not a parameter of the card's launch, whose grid is one row
pair a block; the JAX output does not depend on it either.
:func:`fftconv_gp` is the JAX package's block -> gp table.
"""

from __future__ import annotations

import operator

import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.utils.device import check_interpret

# Launches of the CUDA kernel in this process, by form (short IRs, the
# long form), and the long form's forward transforms of input windows
# (:func:`long_transforms`; the IR's spectra aside); callers may reset
# them.
launches = 0
long_launches = 0
long_forward_transforms = 0

_MAX_ROWS = 2 * 65535  # grid.y of the launch counts row pairs
_MAX_LOG_N = 14  # the kernel's largest FFT block (16384 points)
MAX_SHORT_TAPS = (1 << (_MAX_LOG_N - 1)) + 1  # 8193: one transform
LONG_LOG_N = _MAX_LOG_N  # the long form's transform
LONG_PART = 1 << (LONG_LOG_N - 1)  # taps per partition, 8192
LONG_HOP = (1 << LONG_LOG_N) - LONG_PART  # outputs per frame, 8192
# the long form's window spectra may take this much before they run as
# a ring (:func:`long_schedule`)
LONG_SPECTRA_BYTES = 1 << 29


DEFAULT_OS_BLOCK = 65536  # the JAX kernel's default overlap-save block


def padded_length(n: int, m: int, block: int = DEFAULT_OS_BLOCK) -> int:
    """Length of the JAX kernel's ``trim=False`` output for an m-tap IR
    over n samples: nblk*hop with the JAX hop geometry, ``hop = (block -
    (m-1)) // (8*n2) * (8*n2)`` (n2 the larger power-of-two factor of
    ``block``), nblk = ceil(n / hop); its ValueErrors for a block that
    is not a power of two or too small for the IR."""
    if block < 2 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    p = block.bit_length() - 1
    n1, n2 = 1 << (p // 2), 1 << (p - p // 2)
    hop = (block - (m - 1)) // (8 * n2) * (8 * n2)
    if hop <= 0 or 2 * (block - hop) > n1 * n2:
        raise ValueError(
            f"block {block} too small for {m}-tap IR (needs an aligned "
            f"hop >= block/2; got hop={hop})")
    return -(-n // hop) * hop


def pairs_per_block(gp, R: int) -> int:
    """``gp`` as the JAX kernel takes it: None = 1, else capped as the
    JAX kernel caps it, ``max(1, min(gp, ceil(R/2)))``; an integer, else
    TypeError."""
    if gp is None:
        return 1
    return max(1, min(operator.index(gp), -(-R // 2)))


def fftconv_gp(block: int) -> int:
    """The JAX package's pair-group count for its fftconv kernel at an
    overlap-save block size (``xmtpu.ops.reverb.fftconv_gp``): 16 at
    32768, 4 at 65536, 1 otherwise. A TPU tuning table; the card's
    launch does not read it."""
    return {32768: 16, 65536: 4}.get(block, 1)


def fft_log_size(m: int) -> int:
    """log2 of the kernel's FFT block for an m-tap IR: the smallest
    power of two >= 2*(m-1), at least 1024, so that each block outputs
    at least half its points."""
    log_n = 10
    while (1 << log_n) < 2 * (m - 1):
        log_n += 1
    return log_n


def fft_plan(log_n: int) -> tuple[int, int, list[tuple[int, int, int]]]:
    """The kernel's transform of 2^log_n points (``Plan`` in
    ``csrc/fftconv.cu``): (threads, points per thread, one (radix,
    span M, stride L) per stage). The first stage takes the radix
    2^(log_n mod 4) (16 if 0), the others 16; stage s works on
    sub-transforms of M points at stride L = M / radix."""
    n_fft = 1 << log_n
    threads = min(n_fft // 16, 512)
    n_stages = (log_n + 3) // 4
    r0 = 1 << (log_n - 4 * (n_stages - 1))
    stages, span = [], n_fft
    for s in range(n_stages):
        r = r0 if s == 0 else 16
        stages.append((r, span, span // r))
        span //= r
    return threads, n_fft // threads, stages


def exchanges(log_n: int) -> int:
    """Passes of the frame through shared memory per transform: one
    between two radix stages."""
    return len(fft_plan(log_n)[2]) - 1


def long_parts(m: int) -> int:
    """Partitions of the long-IR form for an m-tap IR."""
    return -(-m // LONG_PART)


def long_transforms(R: int, n_out: int) -> int:
    """Forward transforms of input windows in a long-form call over R
    rows to n_out outputs, and as many inverse ones: one of each per
    frame of ``LONG_HOP`` outputs and row pair, whatever the
    partitions."""
    return -(-R // 2) * -(-n_out // LONG_HOP)


def long_schedule(R: int, n_out: int, m: int) -> tuple[int, int]:
    """(slots, chunk) of a long-form call: the window spectra kept a row
    pair and the frames run a launch pair. All windows' (slots = chunk =
    frames) if they fit ``LONG_SPECTRA_BYTES`` or the frames are no more
    than the partitions P; else a ring of as many as fit, at least P:
    window j at slot j % slots, the frames in chunks of slots - P + 1,
    each chunk's windows computed before its frames, so that a chunk
    overwrites only windows that no later frame reads."""
    frames, parts = -(-n_out // LONG_HOP), long_parts(m)
    fit = LONG_SPECTRA_BYTES // (-(-R // 2) * (8 << LONG_LOG_N))
    if frames <= max(fit, parts):
        return frames, frames
    slots = max(fit, parts)
    return slots, slots - parts + 1


def _check(x, ir, pre_row, pre_col) -> None:
    for name, t, nd in (("x", x, 2), ("ir", ir, 1), ("pre_row", pre_row, 1),
                        ("pre_col", pre_col, 1)):
        if not torch.is_tensor(t) or t.dtype != torch.float32 or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-D float32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    R, n = x.shape
    if R < 1 or n < 1 or ir.numel() < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, ir {ir.numel()}")
    if pre_row.shape[0] != R or pre_col.shape[0] != n:
        raise ValueError(
            f"pre_row {tuple(pre_row.shape)} / pre_col "
            f"{tuple(pre_col.shape)} do not match x {tuple(x.shape)}")
    if R > _MAX_ROWS:
        raise ValueError(f"{R} rows exceed the kernel's {_MAX_ROWS}")


def os_block(m: int) -> int:
    """Power-of-two overlap-save block >= 4*(m-1) (hop >= 3/4 block),
    at least 1024."""
    b = 1024
    while b < 4 * max(1, m - 1):
        b *= 2
    return b


def fir_convolve_plain(x: torch.Tensor, ir: torch.Tensor,
                       pre_row: torch.Tensor, pre_col: torch.Tensor,
                       n_out: int | None = None) -> torch.Tensor:
    """Plain float32 overlap-save twin of the kernel (``torch.fft``):
    (R, n_out) with the input zero from n on (n_out None: n). The frames
    that cover [0, n) go through one transform batch whatever n_out is,
    so the first n samples do not depend on it, as in the kernel."""
    R, n = x.shape
    n_out = n if n_out is None else n_out
    m = ir.shape[0]
    block = os_block(m)
    hop = block - (m - 1)
    nblk, nblk_n = -(-n_out // hop), -(-n // hop)
    xin = x * pre_row[:, None] * pre_col
    xp = torch.nn.functional.pad(xin, (m - 1, nblk * hop - n))
    frames = xp.unfold(-1, block, hop)  # (R, nblk, block)
    H = torch.fft.rfft(ir, n=block)

    def conv(f):
        return torch.fft.irfft(torch.fft.rfft(f, dim=-1) * H, n=block, dim=-1)

    Y = conv(frames[:, :nblk_n])
    if nblk > nblk_n:
        Y = torch.cat([Y, conv(frames[:, nblk_n:])], dim=1)
    return Y[..., m - 1:].reshape(R, nblk * hop)[:, :n_out].contiguous()


def fir_convolve(x: torch.Tensor, ir: torch.Tensor, pre_row: torch.Tensor,
                 pre_col: torch.Tensor, trim: bool = True,
                 block: int | None = None, gp=None,
                 interpret: bool | None = None) -> torch.Tensor:
    """x (R, n), ir (m,), pre_row (R,), pre_col (n,): contiguous float32
    on one device -> y (R, n) float32, or with ``trim=False`` (R,
    :func:`padded_length` (n, m, block)), ``block`` None meaning the JAX
    default 65536. A given ``block`` and ``gp`` are checked as the JAX
    kernel checks them (module docstring). ``interpret=True`` means the
    twin and needs x on the CPU (``utils.device.check_interpret``)."""
    check_interpret(interpret, x.device)
    _check(x, ir, pre_row, pre_col)
    R, n = x.shape
    m = ir.shape[0]
    n_out = n
    if block is not None or not trim:
        n_pad = padded_length(n, m, DEFAULT_OS_BLOCK if block is None
                              else block)
        n_out = n if trim else n_pad
    pairs_per_block(gp, R)
    if x.device.type == "cpu":
        return fir_convolve_plain(x, ir, pre_row, pre_col, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"no fftconv kernel for device {x.device}")
    return _launch(x, ir, pre_row, pre_col,
                   LONG_LOG_N if m > MAX_SHORT_TAPS else fft_log_size(m),
                   n_out)


def _launch(x, ir, pre_row, pre_col, log_n: int,
            n_out: int | None = None) -> torch.Tensor:
    """The kernel on checked CUDA operands, the short form at a
    transform of 2^log_n points (>= 2*(m-1)) or, past
    ``MAX_SHORT_TAPS``, the long form; (R, n_out) out (None: n)."""
    global launches, long_launches, long_forward_transforms
    R, n = x.shape
    n_out = n if n_out is None else n_out
    m = ir.shape[0]
    long = m > MAX_SHORT_TAPS
    lib = _build.load()
    y = torch.empty((R, n_out), dtype=torch.float32, device=x.device)
    # the IR spectra (one per partition), the twiddles and, in the long
    # form, the window spectra: N complex each, filled in-kernel
    spectra = 1
    if long:
        slots, chunk = long_schedule(R, n_out, m)
        spectra = long_parts(m) + -(-R // 2) * slots
    work = torch.empty((2 * spectra + 2) << log_n, dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), pre_row.data_ptr(), pre_col.data_ptr(),
            ir.data_ptr(), work.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if long:
            rc = lib.xm_fir_convolve_long_f32(*ptrs, R, n, m, n_out,
                                              slots, chunk, stream)
        else:
            rc = lib.xm_fir_convolve_f32(*ptrs, R, n, m, log_n, n_out,
                                         stream)
    _build.check(rc, "fftconv")
    if long:
        long_launches += 1
        long_forward_transforms += long_transforms(R, n_out)
    else:
        launches += 1
    return y
