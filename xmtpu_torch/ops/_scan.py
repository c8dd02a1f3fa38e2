"""Log-depth associative scan over the last axis (counterpart of
``jax.lax.associative_scan``, the engine under the JAX package's float64
scans).

Plain torch, following the same odd/even recursion: combine adjacent
pairs, scan the half, fix up the evens. The work is O(n) and the depth
O(log n); no Python loop over samples. ``fn(a, b)`` combines a tuple of
tensors ``a`` (earlier) with ``b`` (later) elementwise and returns a
tuple of the same length.
"""

from __future__ import annotations

import torch


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` over the last axis (len(even) is
    len(odd) or len(odd) + 1)."""
    n = even.shape[-1] + odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (n,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def associative_scan(fn, elems: tuple) -> tuple:
    """Inclusive scan of the tuple ``elems`` (tensors of one shape) over
    the last axis with the associative combine ``fn``."""
    elems = tuple(elems)
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[..., 0:n - 1:2] for e in elems),
                 tuple(e[..., 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[..., :-1] for e in odd),
                  tuple(e[..., 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[..., 2::2] for e in elems))
    even = tuple(torch.cat([e[..., :1], r], dim=-1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))
