"""What the time-segmented kernels share: the segment-count rules (the
JAX package's lane-filling :func:`pick_segments`, and the card's
:func:`gpu_segments`) and a per-device cache of their host tables
(``kernels.iir`` and ``kernels.envelope``)."""

from __future__ import annotations

import torch

LANES = 128  # the JAX IIR kernel's lane tile, pick_segments' default

_DEVICE_CACHE: dict = {}


def pick_segments(R: int, n: int, min_seglen: int = 4096,
                  lanes: int = LANES) -> int:
    """Segment count that (a) keeps R*S <= lanes, (b) divides n exactly
    (exact state math needs equal segments), and (c) leaves segments of
    at least ``min_seglen`` samples. The JAX package's rule, kept so
    both packages segment alike; the GPU's own rule is open work."""
    s = 1
    while (R * s * 2 <= lanes and n % (s * 2) == 0
           and n // (s * 2) >= min_seglen):
        s *= 2
    return s


def gpu_segments(R: int, n: int, sm_count: int, blocks_per_sm: int,
                 rows_per_block: int = 8, min_seglen: int = 4096) -> int:
    """Segment count of a row-chain kernel on a card: the power of two S
    that divides n, leaves segments of at least ``min_seglen`` samples,
    and spreads the ceil(R*S / rows_per_block) blocks over the card's
    ``sm_count * blocks_per_sm`` resident slots so that the chain a
    block runs (n / S steps) times the waves it takes is least; on a tie
    the larger S, which spreads the blocks' other work (the curve, the
    copies) over more of the slots. 1 when n is odd."""
    slots = sm_count * blocks_per_sm
    best, best_cost, s = 1, None, 1
    while True:
        blocks = -(-R * s // rows_per_block)
        cost = -(-blocks // slots) * (n // s)  # waves x chain
        if best_cost is None or cost <= best_cost:
            best, best_cost = s, cost
        if n % (2 * s) or n // (2 * s) < min_seglen:
            return best
        s *= 2


def on_device(key, device, make) -> dict:
    """Tensors from ``make()`` cached per (key, device), so a step does
    not copy its host tables to the card on every call."""
    k = (key, str(device))
    hit = _DEVICE_CACHE.get(k)
    if hit is None:
        hit = {name: torch.as_tensor(a, device=device)
               for name, a in make().items()}
        _DEVICE_CACHE[k] = hit
        if len(_DEVICE_CACHE) > 32:
            _DEVICE_CACHE.pop(next(iter(_DEVICE_CACHE)))
    return hit
