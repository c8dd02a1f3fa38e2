"""Polyphase-FIR sample-rate conversion (counterpart of
``xmtpu.ops.resample``).

The host tables (filter design, polyphase plan, aligned banded tables)
are re-implemented here in numpy and are bit-exact with the JAX
package's. The device part is plain torch, as the JAX package leaves it
to XLA outside any kernel; :func:`polyphase_resample` takes its three
methods:

* ``"banded"`` (default), at most three matmuls. Where n divides
  by M, output frame ``c = A[c] @ H1`` for the framed input ``A`` (...,
  nc, M), with two narrow edge corrections against the neighbour
  frames: ``A[c-1]``'s last ``|lo|`` samples patch output phases [0,
  r0) through ``H0``, and ``A[c+1]``'s first ``hi`` samples patch phases
  [r2, L) through ``H2``. Otherwise the padded window's frames times the
  dense band, in two matmuls. Rate pairs whose band is wider than 2M
  (upsampling by a large factor) take the conv;
* ``"conv"``: the strided convolution, ``conv1d`` with stride M and L
  output channels over the padded window;
* ``"window"``: the explicit frame matrix times the dense band
  (:func:`resample_window`, shared with streaming).

Pinned semantics: odd-length symmetric Kaiser filter, output sample
``j`` is the upsampled-domain convolution at ``t = j*M + (ntaps-1)//2``,
``out_len = ceil(n * L / M)`` (``scipy.signal.resample_poly``'s rule for
odd-length filters).

Precision: ``precision=`` takes the JAX package's three rungs
(``ops.precision``), HIGHEST (full float32) by default, as in the JAX
package. A TF32 product keeps 10 mantissa bits, which costs the chain
its -80 dB margin, so on CUDA the FP32 rung refuses to run matmuls while
TF32 is enabled (``ops.precision.require_fp32_matmul``), and the strided
conv turns cuDNN's TF32 off (:func:`_cudnn_fp32`) for its own call, since
``torch.backends.cudnn.allow_tf32`` is True by default. HIGH and
DEFAULT are bf16 products with float32 sums (tensor cores on CUDA); the
strided conv takes them on the bf16 parts through FP32 convolutions,
which compute the same rung exactly. ``dtype=torch.bfloat16`` casts the
operand and the tables to bf16, as the JAX ``_apply_plan`` does, and
returns bf16.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from scipy import signal as _sig

from xmtpu_torch.ops import precision as _prec
from xmtpu_torch.utils.errors import ConfigError


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=64)
def design_polyphase_filter(
    L: int, M: int, taps_per_phase: int = 24, beta: float = 9.0
) -> np.ndarray:
    """Odd-length Kaiser-window lowpass for L/M resampling: cutoff
    min(pi/L, pi/M) in the L-upsampled domain, gain L. Float64, length
    ``taps_per_phase * L`` (+1 to make it odd)."""
    nt = taps_per_phase * L
    if nt % 2 == 0:
        nt += 1
    cutoff = 1.0 / max(L, M)  # fraction of the upsampled Nyquist
    h = _sig.firwin(nt, cutoff, window=("kaiser", beta))
    return (L * h).astype(np.float64)


@dataclass(frozen=True, eq=False)
class ResamplePlan:
    """Static host tables for one (L, M, filter) combination."""

    L: int
    M: int
    taps: np.ndarray  # full filter, float64, odd length
    K2: int  # taps per phase (padded)
    base: int  # min window start (folded into the left pad)
    width: int  # frame width needed to cover all phases
    col_start: np.ndarray  # [L] window start inside a frame, per residue
    hsel: np.ndarray  # [L, K2] reversed taps for residue r's phase
    hbank: np.ndarray  # [width, L] dense filter bank (hsel placed at col_start)
    pad_left: int

    @property
    def ntaps(self) -> int:
        return len(self.taps)


@lru_cache(maxsize=64)
def make_plan(L: int, M: int, taps_per_phase: int = 24,
              beta: float = 9.0) -> ResamplePlan:
    h = design_polyphase_filter(L, M, taps_per_phase, beta)
    nt = len(h)
    offset = (nt - 1) // 2  # integer group delay in upsampled samples
    K2 = _cdiv(nt, L)
    hpad = np.zeros(K2 * L, np.float64)
    hpad[:nt] = h
    hpoly = hpad.reshape(K2, L).T  # [L, K2]: hpoly[p, q] = h[p + q*L]
    # output j = c*L + r: t = j*M + offset; phase p(r) = t mod L and
    # window base B(r) = (t - p)/L - c*M depend only on r
    r = np.arange(L)
    t0 = r * M + offset
    p = t0 % L
    B = (t0 - p) // L
    pad_left = K2  # start indices are >= 0 after padding
    S = B - K2 + 1 + pad_left
    base = int(S.min())
    width = int(S.max()) - base + K2
    hsel = hpoly[p][:, ::-1]  # window ends at c*M + B[r]: taps reversed
    col_start = (S - base).astype(np.int64)
    hbank = np.zeros((width, L), np.float64)
    for rr in range(L):
        hbank[col_start[rr]: col_start[rr] + K2, rr] = hsel[rr]
    return ResamplePlan(
        L=L, M=M, taps=h, K2=K2, base=base, width=width,
        col_start=col_start,
        hsel=np.ascontiguousarray(hsel, dtype=np.float64),
        hbank=hbank, pad_left=pad_left,
    )


def resample_output_len(n: int, L: int, M: int) -> int:
    """Pinned output-length rule: ceil(n * L / M)."""
    return _cdiv(n * L, M)


def check_rates(sr_in: int, sr_out: int) -> None:
    """Both rates in [4000, 192000], neither side of the reduced ratio
    above 2048 phases; raises :class:`ConfigError` otherwise."""
    for rate, nm in ((sr_in, "input rate"), (sr_out, "output rate")):
        if not (4000 <= int(rate) <= 192000):
            raise ConfigError(
                f"unreasonable {nm} {rate}: must be in [4000, 192000]")
    g = math.gcd(int(sr_in), int(sr_out))
    if sr_in // g > 2048 or sr_out // g > 2048:
        raise ConfigError(
            f"unreasonable polyphase ratio {sr_out // g}/{sr_in // g} "
            f"for {sr_in} -> {sr_out} Hz")


def _ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(int(sr_in), int(sr_out))
    return sr_out // g, sr_in // g


@dataclass(frozen=True, eq=False)
class AlignedTables:
    """Filter tables of the frame-aligned banded formulation (n % M ==
    0); see the module docstring."""

    H1: np.ndarray  # (M, L) f64
    H0: np.ndarray  # (-lo, r0) f64 (empty-dim if lo == 0)
    H2: np.ndarray  # (hi, L - r2) f64 (empty-dim if hi == 0)
    lo: int
    hi: int
    r0: int
    r2: int


@lru_cache(maxsize=64)
def aligned_tables(plan: ResamplePlan) -> AlignedTables:
    delta = plan.base - plan.pad_left
    s = delta + plan.col_start  # [L] window start relative to c*M
    K2 = plan.K2
    M = plan.M
    lo = int(s.min())  # < 0: first |lo| taps live in row c-1
    hi = int(s.max()) + K2 - M  # > 0: last hi taps live in row c+1
    Hfull = np.zeros((M + max(hi, 0) - min(lo, 0), plan.L), np.float64)
    for r in range(plan.L):
        Hfull[int(s[r]) - min(lo, 0): int(s[r]) - min(lo, 0) + K2, r] \
            = plan.hsel[r]
    off = -min(lo, 0)
    r0 = int(np.sum(s < 0))  # s monotone: phases [0, r0)
    r2 = int(np.argmax(s + K2 > M)) if np.any(s + K2 > M) else plan.L
    return AlignedTables(H1=Hfull[off: off + M], H0=Hfull[:off, :r0],
                         H2=Hfull[off + M:, r2:], lo=lo, hi=hi, r0=r0, r2=r2)


def aligned_supported(n: int, sr_in: int, sr_out: int,
                      taps_per_phase: int = 24, beta: float = 9.0) -> bool:
    """True if the aligned banded path applies to length n."""
    L, M = _ratio(sr_in, sr_out)
    if L == M or n % M or n < 2 * M:
        return False
    plan = make_plan(L, M, taps_per_phase, beta)
    out_len = resample_output_len(n, L, M)
    return plan.width <= 2 * M and _cdiv(out_len, L) * L == out_len


@contextmanager
def _cudnn_fp32():
    """cuDNN convolutions in full float32 inside the block, whatever the
    caller set; the caller's ``torch.backends.cudnn.allow_tf32`` is put
    back after it."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def work_dtype(dtype) -> torch.dtype:
    """The resample ops' ``dtype=``: float32 (the default) or bfloat16,
    as a torch dtype or by name (a numpy or JAX dtype's ``name`` /
    ``__name__`` too); else :class:`ConfigError`."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = (dtype if isinstance(dtype, str) else getattr(
            dtype, "name", None) or getattr(dtype, "__name__", None))
    if name not in _DTYPES:
        raise ConfigError(f"resample dtype {dtype!r} is not supported; "
                          "accepted: float32, bfloat16")
    return _DTYPES[name]


def _dot(a: torch.Tensor, b: torch.Tensor, precision) -> torch.Tensor:
    """``a @ b`` at ``precision`` in a's dtype (float32 or bf16: the
    float32 sums rounded once, as XLA's bf16 dot)."""
    return _prec.matmul(a, b, precision).to(a.dtype)


def apply_aligned(A: torch.Tensor, H1: torch.Tensor, H0: torch.Tensor,
                  H2: torch.Tensor, lo: int, hi: int, r0: int,
                  r2: int, precision=None) -> torch.Tensor:
    """Aligned banded resample of framed ``A`` (..., nc, Mp) -> (..., nc,
    L) output frames in A's dtype (float32 or bf16), with the tables
    (M = ``H1.shape[0]`` rows) already on A's device, at ``precision``
    (``ops.precision``; HIGHEST by default). Lanes of A past M are pad:
    H1 takes zero rows there and the corrections read real lanes only,
    so pad values never reach the output. The two edge corrections add
    in place into the main product."""
    M = H1.shape[0]
    Mp = A.shape[-1]
    if Mp < M:
        raise ValueError(f"framed input last axis {Mp} < M={M}")
    if Mp > M:
        H1 = torch.nn.functional.pad(H1, (0, 0, 0, Mp - M))
    dt = A.dtype
    out = _dot(A, H1.to(dt), precision)
    if lo < 0:
        C0 = _dot(A[..., M + lo: M], H0.to(dt), precision)
        out[..., 1:, :r0] += C0[..., :-1, :]
    if hi > 0:
        C2 = _dot(A[..., :hi], H2.to(dt), precision)
        out[..., :-1, r2:] += C2[..., 1:, :]
    return out


def device_tables(t: AlignedTables, device=None) -> tuple[torch.Tensor, ...]:
    """(H1, H0, H2) as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(h, dtype=torch.float32, device=device)
                 for h in (t.H1, t.H0, t.H2))


def polyphase_resample_framed(A: torch.Tensor, sr_in: int, sr_out: int,
                              taps_per_phase: int = 24,
                              beta: float = 9.0, dtype=torch.float32,
                              precision=None) -> torch.Tensor:
    """Aligned banded resample of pre-framed input (..., nc, M) ->
    (..., nc, L) frames in ``dtype`` at ``precision`` (module
    docstring). Check applicability with :func:`aligned_supported` on n
    = nc*M first. The last axis may exceed M (lane padding, the
    ``mixfirst_pad`` front's 441 -> 512): lanes past M are ignored (zero
    filter rows)."""
    L, M = _ratio(sr_in, sr_out)
    if A.shape[-1] < M:
        raise ValueError(f"framed input last axis {A.shape[-1]} < M={M}")
    plan = make_plan(L, M, taps_per_phase, beta)
    if plan.width > 2 * M:
        raise ValueError(
            f"rate pair {sr_in}->{sr_out} (L={L}, M={M}, filter width "
            f"{plan.width} > 2*M) is outside the aligned banded "
            "formulation; use polyphase_resample() instead")
    t = aligned_tables(plan)
    H1, H0, H2 = device_tables(t, A.device)
    return apply_aligned(A.to(work_dtype(dtype)), H1, H0, H2,
                         t.lo, t.hi, t.r0, t.r2, precision)


def plan_rows(plan: ResamplePlan, nj: int) -> int:
    """Input rows (of M samples) needed to emit nj output blocks."""
    return nj + _cdiv(plan.width, plan.M) + 1


def resample_window(xs: torch.Tensor, plan: ResamplePlan, nj: int,
                    dtype=torch.float32, precision=None) -> torch.Tensor:
    """Contiguous input window -> nj*L output samples in ``dtype`` at
    ``precision``, by the explicit frame matrix: ``xs`` (...,
    plan_rows(plan, nj) * M) holds input samples ``x[k + c0*M + base -
    pad_left]`` for the first output block c0 (zeros where that index
    is out of range); frames F[..., c, u] = xs[..., c*M + u], u < width,
    times the dense band (width, L). Shared by the offline path (c0 =
    0) and streaming (c0 = the block clock), so the two agree block for
    block."""
    dt = work_dtype(dtype)
    L, M = plan.L, plan.M
    batch = xs.shape[:-1]
    rows = plan_rows(plan, nj)
    A = xs.to(dt).reshape(*batch, rows, M)
    F = torch.cat([A[..., i: i + nj, :] for i in range(rows - nj)],
                  dim=-1)[..., : plan.width]
    band = _band_on(plan, str(xs.device)).to(dt)
    return _dot(F, band, precision).reshape(*batch, nj * L)


@lru_cache(maxsize=32)
def _band_on(plan: ResamplePlan, device: str) -> torch.Tensor:
    """The plan's dense band as float32 on ``device``, copied once: a
    copy from pageable host memory per call would synchronise the
    stream, and streaming calls :func:`resample_window` every frame."""
    return torch.as_tensor(plan.hbank, dtype=torch.float32, device=device)


def _conv(xs: torch.Tensor, w: torch.Tensor, M: int,
          precision) -> torch.Tensor:
    """The stride-M convolution of rows ``xs`` (R, 1, k) with ``w`` (L,
    1, width) at ``precision`` -> float32 (R, L, frames). Every rung
    runs FP32 convolutions: HIGHEST on the operands, HIGH and DEFAULT on
    their bf16 parts (exact products in float32, as in
    ``ops.precision``); bf16 operands take one pass."""
    def conv(a, b):
        with _cudnn_fp32():
            return torch.nn.functional.conv1d(a.float(), b.float(),
                                              stride=M)

    rung = _prec.resolve(precision)
    if xs.dtype == torch.bfloat16 or rung == _prec.HIGHEST:
        return conv(xs, w)
    x_hi, x_lo = _prec.split(xs)
    w_hi, w_lo = _prec.split(w)
    if rung == _prec.DEFAULT:
        return conv(x_hi, w_hi)
    return conv(x_hi, w_lo) + conv(x_lo, w_hi) + conv(x_hi, w_hi)


RESAMPLE_METHODS = ("banded", "conv", "window")


def polyphase_resample(x: torch.Tensor, sr_in: int, sr_out: int,
                       taps_per_phase: int = 24, beta: float = 9.0,
                       dtype=torch.float32, method: str = "banded",
                       precision=None) -> torch.Tensor:
    """Resample the last axis of float ``x`` (..., n) from sr_in to
    sr_out -> (..., ceil(n*L/M)) in ``dtype`` (float32 or bfloat16), by
    ``method`` (module docstring): ``"banded"`` (its band within 2M,
    else the conv), ``"conv"`` or ``"window"``, at ``precision``
    (``ops.precision``; None = HIGHEST). The JAX package's argument
    order."""
    if method not in RESAMPLE_METHODS:
        raise ValueError(f"unknown resample method {method!r}; accepted: "
                         + ", ".join(RESAMPLE_METHODS))
    _prec.resolve(precision)
    dt = work_dtype(dtype)
    L, M = _ratio(sr_in, sr_out)
    x = x.to(dt)
    if L == M:
        return x
    plan = make_plan(L, M, taps_per_phase, beta)
    if method == "banded" and plan.width > 2 * M:
        method = "conv"  # small M (upsampling): the band spans many rows
    n = x.shape[-1]
    bshape = x.shape[:-1]
    out_len = resample_output_len(n, L, M)
    nj = _cdiv(out_len, L)  # number of L-sample output blocks
    if method == "banded" and n % M == 0 and n >= 2 * M and nj * L == out_len:
        # aligned: the frame matrix is a free reshape of x
        A = x.reshape(*bshape, n // M, M)
        t = aligned_tables(plan)
        H1, H0, H2 = device_tables(t, x.device)
        out = apply_aligned(A, H1, H0, H2, t.lo, t.hi, t.r0, t.r2,
                            precision)
        return out.reshape(*bshape, nj * L)
    # window xs[k] = x[k + base - pad_left], zeros outside [0, n)
    need = plan_rows(plan, nj) * M
    pad_r = max(0, plan.base + need - (n + plan.pad_left))
    xpad = torch.nn.functional.pad(x, (plan.pad_left, pad_r))
    xs = xpad[..., plan.base: plan.base + need]
    if method == "banded":
        hbank = torch.as_tensor(plan.hbank, dtype=torch.float32,
                                device=x.device).to(dt)
        A = xs[..., : nj * M].reshape(*bshape, nj, M)
        out = _dot(A, hbank[:M], precision)
        if plan.width > M:
            k2 = plan.width - M
            A1 = xs[..., M: (nj + 1) * M].reshape(*bshape, nj, M)[..., :k2]
            out = out + _dot(A1, hbank[M:], precision)
        return out.reshape(*bshape, nj * L)[..., :out_len]
    if method == "conv":
        # out[.., c, r] = sum_u xs[.., c*M + u] * hbank[u, r]: a stride-M
        # convolution with L output channels (conv1d correlates)
        R = int(np.prod(bshape)) if bshape else 1
        w = torch.as_tensor(plan.hbank.T[:, None, :], dtype=torch.float32,
                            device=x.device).to(dt)  # (L, 1, width)
        out = _conv(xs.reshape(R, 1, -1), w, M, precision).to(dt)
        out = out[:, :, :nj].transpose(1, 2).reshape(*bshape, nj * L)
        return out[..., :out_len]
    return resample_window(xs, plan, nj, dt, precision)[..., :out_len]


def resample_oracle_np(
    x: np.ndarray, sr_in: int, sr_out: int, taps_per_phase: int = 24,
    beta: float = 9.0
) -> np.ndarray:
    """Float64 host implementation of the pinned semantics through
    ``scipy.signal.upfirdn``; the group-delay offset is folded into the
    filter by pre-padding zeros so the M-strided output lands on
    ``t = j*M + offset``."""
    L, M = _ratio(sr_in, sr_out)
    if L == M:
        return x.astype(np.float64)
    h = design_polyphase_filter(L, M, taps_per_phase, beta)
    nt = len(h)
    offset = (nt - 1) // 2
    out_len = resample_output_len(x.shape[-1], L, M)
    s = (-offset) % M
    d = (offset + s) // M
    h2 = np.concatenate([np.zeros(s), h])
    z = _sig.upfirdn(h2, x.astype(np.float64), up=L, down=M, axis=-1)
    y = z[..., d: d + out_len]
    if y.shape[-1] < out_len:  # upfirdn's conv can end before the last sample
        padw = [(0, 0)] * (y.ndim - 1) + [(0, out_len - y.shape[-1])]
        y = np.pad(y, padw)
    return y
