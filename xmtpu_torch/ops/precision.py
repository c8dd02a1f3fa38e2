"""Matmul precision rungs of the DSP products (counterpart of the
``precision=`` that the JAX package passes to its dots as a
``jax.lax.Precision``).

Three rungs, named as JAX names them:

* ``"highest"`` (None, ``"float32"``): full float32. The port's
  default; on CUDA an FP32 ``torch.matmul`` behind
  :func:`require_fp32_matmul`;
* ``"high"`` (``"bfloat16_3x"``, ``"tensorfloat32"``): the TPU's
  three-pass bf16 product. Each operand splits into a bf16 head and a
  bf16 tail, ``a = a_hi + a_lo`` (``a_lo`` the bf16 rounding of ``a -
  a_hi``), and the product is ``a_hi b_lo + a_lo b_hi + a_hi b_hi``
  (``a_lo b_lo`` dropped), each pass a bf16 product with float32
  sums;
* ``"default"`` (``"bfloat16"``, ``"fastest"``): one bf16 pass, ``a_hi
  b_hi``, with float32 sums.

On CUDA each bf16 pass is one tensor-core product with float32 output
(``torch.mm`` / ``torch.bmm`` with ``out_dtype=torch.float32``). On the
CPU, which has no such kernel, the plain version takes the same parts,
upcast, through FP32 matmuls: a product of two bf16 values is exact in
float32, so it computes the same rung, its sums in float32 too. No rung
touches the global TF32 flags.

These are the plain matmuls the JAX package leaves to XLA outside any
Pallas kernel; K7's rungs (``kernels.resample.resample``) split the
same way around the kernel.
"""

from __future__ import annotations

import torch

from xmtpu_torch.utils.errors import ConfigError

HIGHEST, HIGH, DEFAULT = "highest", "high", "default"
RUNGS = (HIGHEST, HIGH, DEFAULT)

# JAX's names for its three precisions (jax.lax.Precision's string forms)
_NAMES = {"highest": HIGHEST, "float32": HIGHEST,
          "high": HIGH, "bfloat16_3x": HIGH, "tensorfloat32": HIGH,
          "default": DEFAULT, "bfloat16": DEFAULT, "fastest": DEFAULT}


def resolve(precision) -> str:
    """The rung of ``precision``: None (HIGHEST, the JAX default of the
    resample ops and the matmul DFTs), one of JAX's names for a
    precision in any case, or an object whose ``.name`` is one (a
    ``jax.lax.Precision``, without importing JAX); else
    :class:`ConfigError`."""
    if precision is None:
        return HIGHEST
    name = (precision if isinstance(precision, str)
            else getattr(precision, "name", None))
    rung = _NAMES.get(name.lower()) if isinstance(name, str) else None
    if rung is None:
        raise ConfigError(
            f"unknown matmul precision {precision!r}; accepted: None, "
            + ", ".join(repr(k) for k in _NAMES)
            + " (any case), or a jax.lax.Precision")
    return rung


def require_fp32_matmul(device: torch.device) -> None:
    """Refuse to run FP32 DSP matmuls on CUDA while TF32 is enabled.

    The port does not flip global flags itself: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (and keeps
    ``torch.get_float32_matmul_precision() == "highest"``)."""
    if torch.device(device).type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise ConfigError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul."
            "allow_tf32 / set_float32_matmul_precision); the DSP matmuls "
            "need full float32 — TF32's 10 mantissa bits cost the chain "
            "its -80 dB accuracy margin")


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_hi, a_lo) bf16 with ``a_hi + a_lo`` the float32 ``a`` to about
    16 bits: a_hi = bf16(a), a_lo = bf16(a - a_hi) (the difference is
    exact in float32)."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(a.dtype)).to(torch.bfloat16)


def bf16_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 product with float32 sums and output, with
    ``torch.matmul``'s shapes for the forms the port takes: (..., k) @
    (k, n), (m, k) @ (..., k, n), and equal-rank batched (..., m, k) @
    (..., k, n). On CUDA a tensor-core ``mm``/``bmm`` with
    ``out_dtype=float32``; elsewhere the parts upcast through an FP32
    matmul (the same products, exact in float32)."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    f32 = torch.float32
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=f32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    if a.dim() == 2:  # a @ b[i] for every leading index: (b[i]^T a^T)^T
        bt = b.transpose(-1, -2)
        out = torch.mm(bt.reshape(-1, bt.shape[-1]), a.t(), out_dtype=f32)
        return out.reshape(*bt.shape[:-1], a.shape[0]).transpose(-1, -2)
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"batched bf16 pass needs equal batch shapes, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=f32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``a @ b`` at ``precision`` (:func:`resolve`; module docstring)
    -> float32. HIGHEST is an FP32 ``torch.matmul`` (TF32 refused on
    CUDA); HIGH and DEFAULT split float32 operands into bf16 parts, and
    bf16 operands (whose tails are zero) take one pass at any rung."""
    rung = resolve(precision)
    if rung == HIGHEST and a.dtype != torch.bfloat16:
        require_fp32_matmul(a.device)
        return torch.matmul(a, b.to(a.dtype))
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return bf16_pass(a.to(torch.bfloat16), b.to(torch.bfloat16))
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if rung == DEFAULT:
        return bf16_pass(a_hi, b_hi)
    # the two small terms first, then the head product
    out = bf16_pass(a_hi, b_lo)
    out += bf16_pass(a_lo, b_hi)
    out += bf16_pass(a_hi, b_hi)
    return out
