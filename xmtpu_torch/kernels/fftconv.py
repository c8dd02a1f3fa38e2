"""Same-length causal FIR convolution with in-kernel input gains
(counterpart of ``xmtpu.kernels.fftconv.fir_convolve_os_pallas``).

    y[r, t] = sum_k ir[k] * pre_row[r] * pre_col[t-k] * x[r, t-k]

On a CUDA tensor :func:`fir_convolve` launches the hand-written kernels
of ``csrc/fftconv.cu`` (FFT overlap-save, two rows per complex
transform, the frame in registers through mixed-radix stages that
:func:`fft_plan` describes; see the note at the top of that file): for
IRs of up to 8193 taps one transform of at most 16384 points per frame,
for longer ones the partitioned form (:func:`long_parts` partitions of
``LONG_PART`` taps, each through the 16384-point transform, summed in
registers). On a CPU tensor it runs :func:`fir_convolve_plain`, a
float32 ``torch.fft`` overlap-save with the same gains at any length,
which the CPU tests and the on-card comparison use.

The JAX kernel's ``trim=False`` hop-padded output does not carry over:
it saved a slice copy between two opaque TPU calls, while this kernel
writes exactly the n samples the limiter reads, so no ``n_valid=``
exists downstream.
"""

from __future__ import annotations

import torch

from xmtpu_torch.kernels import _build

# Launches of the CUDA kernel in this process, by form (short IRs, the
# partitioned long-IR form); callers may reset them.
launches = 0
long_launches = 0

_MAX_ROWS = 2 * 65535  # grid.y of the launch counts row pairs
_MAX_LOG_N = 14  # the kernel's largest FFT block (16384 points)
MAX_SHORT_TAPS = (1 << (_MAX_LOG_N - 1)) + 1  # 8193: one transform
LONG_LOG_N = _MAX_LOG_N  # the partitioned form's transform
LONG_PART = 1 << (LONG_LOG_N - 1)  # taps per partition, 8192
LONG_HOP = (1 << LONG_LOG_N) - LONG_PART  # outputs per frame, 8192


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
                       pre_row: torch.Tensor,
                       pre_col: torch.Tensor) -> torch.Tensor:
    """Plain float32 overlap-save twin of the kernel (``torch.fft``)."""
    R, n = x.shape
    m = ir.shape[0]
    block = os_block(m)
    hop = block - (m - 1)
    nblk = -(-n // hop)
    xin = x * pre_row[:, None] * pre_col
    xp = torch.nn.functional.pad(xin, (m - 1, nblk * hop - n))
    frames = xp.unfold(-1, block, hop)  # (R, nblk, block)
    H = torch.fft.rfft(ir, n=block)
    Y = torch.fft.irfft(torch.fft.rfft(frames, dim=-1) * H, n=block, dim=-1)
    return Y[..., m - 1:].reshape(R, nblk * hop)[:, :n].contiguous()


def fir_convolve(x: torch.Tensor, ir: torch.Tensor, pre_row: torch.Tensor,
                 pre_col: torch.Tensor) -> torch.Tensor:
    """x (R, n), ir (m,), pre_row (R,), pre_col (n,): contiguous float32
    on one device -> y (R, n) float32."""
    _check(x, ir, pre_row, pre_col)
    if x.device.type == "cpu":
        return fir_convolve_plain(x, ir, pre_row, pre_col)
    if x.device.type != "cuda":
        raise ValueError(f"no fftconv kernel for device {x.device}")
    m = ir.shape[0]
    return _launch(x, ir, pre_row, pre_col,
                   LONG_LOG_N if m > MAX_SHORT_TAPS else fft_log_size(m))


def _launch(x, ir, pre_row, pre_col, log_n: int) -> torch.Tensor:
    """The kernel on checked CUDA operands, the short form at a
    transform of 2^log_n points (>= 2*(m-1)) or, past
    ``MAX_SHORT_TAPS``, the partitioned form."""
    global launches, long_launches
    R, n = x.shape
    m = ir.shape[0]
    long = m > MAX_SHORT_TAPS
    lib = _build.load()
    y = torch.empty_like(x)
    # the IR spectra (one per partition, N complex each) and the N
    # twiddles, filled in-kernel
    spectra = long_parts(m) if long else 1
    work = torch.empty((2 * spectra + 2) << log_n, dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), pre_row.data_ptr(), pre_col.data_ptr(),
            ir.data_ptr(), work.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if long:
            rc = lib.xm_fir_convolve_long_f32(*ptrs, R, n, m, stream)
        else:
            rc = lib.xm_fir_convolve_f32(*ptrs, R, n, m, log_n, stream)
    _build.check(rc, "fftconv")
    if long:
        long_launches += 1
    else:
        launches += 1
    return y
