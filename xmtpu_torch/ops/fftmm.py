"""Overlap-save FIR filtering whose DFTs are matmuls (counterpart of
``xmtpu.ops.fftmm``, the JAX ``reverb(backend="mxu")``).

The JAX package writes these transforms as XLA einsums, never as a
Pallas kernel, so the port runs them as plain matmuls at the rung
``precision=`` names (``ops.precision``): HIGHEST (the default) as FP32
``torch.matmul``, which refuses TF32 on CUDA; HIGH and DEFAULT as bf16
products with float32 sums (tensor cores on CUDA). The constants are
host numpy, as the JAX package builds them.

Size-B complex DFT with B = N1*N2, input index n = n1*N2 + n2, output
index k = k2*N1 + k1 kept in the scrambled layout [k1, k2]:

    A[k1, n2] = sum_n1 W_N1^(k1 n1) x[n1, n2]        (matmul, N1-DFT)
    Bm[k1,n2] = A[k1, n2] * W_B^(k1 n2)              (twiddle)
    X[k1, k2] = sum_n2 W_N2^(k2 n2) Bm[k1, n2]       (matmul, N2-DFT)

The inverse consumes the scrambled layout symmetrically, and the IR
spectrum is pre-scrambled into the same layout. Two real rows ride one
complex transform: ``ifft(fft(x0 + i x1) * H) = (x0*h) + i (x1*h)`` for
a real filter h. The ``fused`` variant folds everything between the two
N1-DFTs for a fixed filter into one (N1, N2, N2) complex matrix.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from xmtpu_torch.ops import precision as _prec


def _split_factors(block: int) -> tuple[int, int]:
    """Balanced power-of-two factorization N1*N2 = block (N1 <= N2)."""
    if block < 4 or block & (block - 1):
        raise ValueError(f"block must be a power of two >= 4, got {block}")
    p = block.bit_length() - 1
    return 1 << (p // 2), 1 << (p - p // 2)


@lru_cache(maxsize=16)
def _dft_consts(block: int) -> dict:
    """Host float64 -> float32 DFT matrices and twiddles for one size."""
    n1, n2 = _split_factors(block)
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(j1, j1) / n1)  # [k1, n1]
    w2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)  # [k2, n2]
    tw = np.exp(-2j * np.pi * np.outer(j1, j2) / block)  # [k1, n2]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {
        "n1": n1, "n2": n2,
        "w1r": f32(w1.real), "w1i": f32(w1.imag),
        "w2r": f32(w2.real), "w2i": f32(w2.imag),
        "twr": f32(tw.real), "twi": f32(tw.imag),
    }


def _on(c: dict, device) -> dict:
    """The constants' arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray)
            else v for k, v in c.items()}


def _cmatmul(ar, ai, br, bi, mm, gauss: bool = False):
    """Complex product from real and imaginary parts, ``mm`` the real
    contraction (at the call's precision). ``gauss``: Gauss's
    three-multiplication form, re = m1 - m2, im = m3 - m1 - m2 with m3 =
    (ar + ai)(br + bi), as the JAX ``_cmatmul``."""
    m1 = mm(ar, br)
    m2 = mm(ai, bi)
    if gauss:
        m3 = mm(ar + ai, br + bi)
        return m1 - m2, m3 - m1 - m2
    ri = mm(ar, bi)
    ir = mm(ai, br)
    return m1 - m2, ri + ir


def _left(prec):
    """[k, n] x [r, n, m] -> [r, k, m] (the JAX "kn,rnm->rkm")."""
    return lambda w, z: _prec.matmul(w, z, prec)


def _right(prec):
    """[l, m] x [r, k, m] -> [r, k, l] (the JAX "lm,rkm->rkl")."""
    return lambda w, z: _prec.matmul(z, w.transpose(0, 1), prec)


def _dft_scrambled(zr, zi, c, prec=None, gauss: bool = False):
    """(R, block) complex -> (R, n1, n2) scrambled spectrum."""
    r = zr.shape[0]
    zr = zr.reshape(r, c["n1"], c["n2"])
    zi = zi.reshape(r, c["n1"], c["n2"])
    ar, ai = _cmatmul(c["w1r"], c["w1i"], zr, zi, _left(prec), gauss)
    br = ar * c["twr"] - ai * c["twi"]
    bi = ar * c["twi"] + ai * c["twr"]
    return _cmatmul(c["w2r"], c["w2i"], br, bi, _right(prec), gauss)


def _idft_scrambled(xr, xi, c, prec=None, gauss: bool = False):
    """(R, n1, n2) scrambled spectrum -> (R, block) complex (scaled):
    the JAX "ml,rkl->rkm" (a right product) and "nk,rkm->rnm" (a left
    one) on the conjugate matrices."""
    ar, ai = _cmatmul(c["w2r"], -c["w2i"], xr, xi, _right(prec), gauss)
    br = ar * c["twr"] + ai * c["twi"]
    bi = -ar * c["twi"] + ai * c["twr"]
    yr, yi = _cmatmul(c["w1r"], -c["w1i"], br, bi, _left(prec), gauss)
    r = yr.shape[0]
    block = c["n1"] * c["n2"]
    s = float(np.float32(1.0 / block))
    return yr.reshape(r, block) * s, yi.reshape(r, block) * s


def scramble_spectrum(h_lin: np.ndarray, block: int):
    """Linear length-``block`` complex spectrum -> the scrambled [k1, k2]
    layout (k = k2*n1 + k1), as float32 host arrays (real, imag)."""
    n1, n2 = _split_factors(block)
    hs = h_lin.reshape(n2, n1).T  # [k1, k2]
    return (np.ascontiguousarray(hs.real, np.float32),
            np.ascontiguousarray(hs.imag, np.float32))


# the fused variant's middle matrix is (N1, N2, N2) complex float32; it
# is taken only up to this size, as the JAX package's "auto" does
_BAKE_LIMIT_BYTES = 48 << 20
_FUSED_CACHE: dict = {}


def _fused_consts(block: int, ir_np: np.ndarray) -> dict:
    """The fused variant's constants for a fixed filter: M[k1] =
    diag(ctw[k1]) . W2^H diag(H[k1]) W2 . diag(tw[k1]) / B (circulant in
    the middle), and the N1-DFT matrices."""
    key = (block, ir_np.tobytes())
    if key in _FUSED_CACHE:
        return _FUSED_CACHE[key]
    n1, n2 = _split_factors(block)
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    H = np.fft.fft(ir_np, block)
    Hs = H.reshape(n2, n1).T  # [k1, k2] scrambled layout
    g = np.fft.ifft(Hs, axis=1)
    g *= n2 / block  # the circulant's n2 and the inverse's 1/block
    idx = (j2[:, None] - j2[None, :]) % n2  # [m, n]
    tw = np.exp(-2j * np.pi * np.outer(j1, j2) / block)  # [k1, n2]
    w1 = np.exp(-2j * np.pi * np.outer(j1, j1) / n1)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    Mr = np.empty((n1, n2, n2), np.float32)
    Mi = np.empty((n1, n2, n2), np.float32)
    for k1 in range(n1):  # per-k1 float64 build: small peak host memory
        Mk = np.conj(tw[k1])[:, None] * g[k1][idx] * tw[k1][None, :]
        Mr[k1] = Mk.real
        Mi[k1] = Mk.imag
    consts = {"n1": n1, "n2": n2, "Mr": Mr, "Mi": Mi,
              "w1r": f32(w1.real), "w1i": f32(w1.imag)}
    _FUSED_CACHE[key] = consts
    if len(_FUSED_CACHE) > 4:  # entries are up to ~48 MB each
        _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
    return consts


def _convolve_fused(zr, zi, c, prec=None, gauss: bool = False):
    """(R, block) complex rows -> (R, block) filtered rows (scaled)."""
    r = zr.shape[0]
    n1, n2 = c["n1"], c["n2"]
    zr = zr.reshape(r, n1, n2)
    zi = zi.reshape(r, n1, n2)
    ar, ai = _cmatmul(c["w1r"], c["w1i"], zr, zi, _left(prec), gauss)

    def middle(a, m):  # "rkn,kmn->rkm": batched over k1
        return _prec.matmul(a.transpose(0, 1), m.transpose(1, 2),
                            prec).transpose(0, 1)

    dr, di = _cmatmul(ar, ai, c["Mr"], c["Mi"], middle, gauss)
    yr, yi = _cmatmul(c["w1r"], -c["w1i"], dr, di, _left(prec), gauss)
    return yr.reshape(r, -1), yi.reshape(r, -1)


def fir_convolve_os_mxu(x: torch.Tensor, ir, block: int = 16384,
                        precision=None, variant: str = "auto",
                        gauss: bool = False) -> torch.Tensor:
    """Same-length causal convolution of ``x`` (..., n) float32 with a
    host-known 1-D IR by overlap-save blocks whose DFTs are matmuls.
    ``block``: a power of two > 2*(len(ir)-1). ``precision``: the
    matmuls' rung (``ops.precision``; None = HIGHEST). ``variant``:
    ``"fused"`` (three matmul stages, the filter baked into the middle
    one), ``"four_step"`` (the forward and inverse DFT pair) or
    ``"auto"`` (fused while its (N1, N2, N2) complex middle matrix stays
    within 48 MB, else four_step), with the JAX package's errors.
    ``gauss``: the three-multiplication complex product."""
    _prec.resolve(precision)
    ir_np = np.asarray(ir.detach().cpu() if torch.is_tensor(ir) else ir,
                       np.float64)
    m = ir_np.shape[-1]
    n = x.shape[-1]
    if block <= 2 * (m - 1):
        raise ValueError(f"block {block} too small for {m}-tap IR")
    if variant == "auto":
        n1, n2 = _split_factors(block)
        variant = ("fused" if n1 * n2 * n2 * 8 <= _BAKE_LIMIT_BYTES
                   else "four_step")
    if variant not in ("fused", "four_step"):
        raise ValueError(f"unknown variant {variant!r}; "
                         "use 'fused', 'four_step' or 'auto'")
    dev = x.device
    if variant == "fused":
        n1, n2 = _split_factors(block)
        baked = n1 * n2 * n2 * 8
        if baked > _BAKE_LIMIT_BYTES:
            raise ValueError(
                f"variant='fused' at block {block} bakes "
                f"{baked >> 20} MB of circulant constants "
                f"(limit {_BAKE_LIMIT_BYTES >> 20} MB); use "
                f"variant='four_step' or a smaller block")
        c = _on(_fused_consts(block, ir_np), dev)
    else:
        c = _on(_dft_consts(block), dev)
        hr, hi = (torch.as_tensor(a, device=dev) for a in
                  scramble_spectrum(np.fft.fft(ir_np, block), block))

    hop = block - (m - 1)
    nblk = -(-n // hop)
    batch = x.shape[:-1]
    xp = torch.nn.functional.pad(x.to(torch.float32), (m - 1, nblk * hop - n))
    rows = xp.unfold(-1, block, hop).reshape(-1, block)  # (.., nblk, block)
    r = rows.shape[0]
    if r % 2:
        rows = torch.cat([rows, rows.new_zeros(1, block)])
    zr, zi = rows[0::2], rows[1::2]

    if variant == "fused":
        yr, yi = _convolve_fused(zr, zi, c, precision, gauss)
    else:
        xr_s, xi_s = _dft_scrambled(zr, zi, c, precision, gauss)
        yr_s = xr_s * hr - xi_s * hi
        yi_s = xr_s * hi + xi_s * hr
        yr, yi = _idft_scrambled(yr_s, yi_s, c, precision, gauss)

    y = torch.stack([yr, yi], dim=1).reshape(-1, block)[:r]
    y = y.reshape(*batch, nblk, block)[..., m - 1:]  # valid region
    y = y.reshape(*batch, nblk * hop)[..., :n]
    return y.to(x.dtype)
