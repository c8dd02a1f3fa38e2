"""What the time-segmented kernels share: the segment-count rules (the
JAX package's lane-filling :func:`pick_segments`, and the card's
:func:`gpu_segments`, fed by :func:`card_segments`) and a per-device
cache of their host tables (``kernels.iir``, ``kernels.envelope`` and
``kernels.eq_env``)."""

from __future__ import annotations

import functools

import torch

from xmtpu_torch.kernels import _build

# the JAX package's lane tile (xmtpu.kernels.iir / envelope / eq_env
# LANES), pick_segments' default; the card's kernels tile by their own
# rules (gpu_segments)
LANES = 128

_DEVICE_CACHE: dict = {}  # device name -> {key: tables}


def pick_segments(R: int, n: int, min_seglen: int = 4096,
                  lanes: int = LANES, aligned: bool = False) -> int:
    """Segment count that (a) keeps R*S <= lanes, (b) divides n exactly
    (exact state math needs equal segments), and (c) leaves segments of
    at least ``min_seglen`` samples. The JAX package's rule, kept so
    both packages segment alike on the CPU; a card's rule is
    :func:`gpu_segments`. ``aligned=True`` is the JAX probe's
    lane-aligned pick, bit for bit: where the power of two leaves
    ``n/S % 128 != 0``, the largest S <= lanes/R that divides n into
    segments of at least ``min_seglen`` and a multiple of 128 samples,
    if it keeps 3/4 of the power of two's S, else the power of two."""
    s = 1
    while (R * s * 2 <= lanes and n % (s * 2) == 0
           and n // (s * 2) >= min_seglen):
        s *= 2
    if aligned and s > 1 and (n // s) % 128:
        for cand in range(lanes // R, 1, -1):
            if (n % cand == 0 and n // cand >= min_seglen
                    and (n // cand) % 128 == 0):
                if 4 * cand >= 3 * s:  # occupancy within 25% of pow2
                    return cand
                break
    return s


def gpu_segments(R: int, n: int, sm_count: int, blocks_per_sm: int,
                 rows_per_block: int = 8, min_seglen: int = 4096,
                 align: int = 1) -> int:
    """Segment count of a row-chain kernel on a card: the power of two S
    that divides n, leaves segments of at least ``min_seglen`` samples
    (and, past S = 1, a multiple of ``align``), and spreads the
    ceil(R*S / rows_per_block) blocks over the card's ``sm_count *
    blocks_per_sm`` resident slots so that the chain a block runs (n / S
    steps) times the waves it takes is least; on a tie the larger S,
    which spreads the blocks' other work (the curve, the copies) over
    more of the slots. 1 when n is odd."""
    slots = sm_count * blocks_per_sm
    best, best_cost, s = 1, None, 1
    while True:
        blocks = -(-R * s // rows_per_block)
        cost = -(-blocks // slots) * (n // s)  # waves x chain
        if best_cost is None or cost <= best_cost:
            best, best_cost = s, cost
        if (n % (2 * s) or n // (2 * s) < min_seglen
                or n // (2 * s) % align):
            return best
        s *= 2


@functools.cache
def card_slots(query: str, index: int, *args) -> tuple[int, int]:
    """(SMs, resident blocks per SM of a kernel) of card ``index``; the
    blocks from the built library's occupancy function ``query`` (for
    example ``xm_sosfilt_blocks_per_sm``) called with ``args``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        per_sm = getattr(_build.load(), query)(*args)
    if per_sm < 1:
        raise RuntimeError(f"the occupancy query {query}{args} failed")
    return sms, per_sm


def card_segments(R: int, n: int, device, query: str, args: tuple,
                  rows_per_block: int, min_seglen: int, cpu: int,
                  align: int = 1) -> int:
    """A segmented call's segment count: ``cpu`` off a card; on one,
    :func:`gpu_segments` over its SM count and the kernel's resident
    blocks per SM (:func:`card_slots` of ``query`` and ``args``), with
    ``rows_per_block`` rows per block and segments of at least
    ``min_seglen`` samples, a multiple of ``align``."""
    device = torch.device(device)
    if device.type != "cuda":
        return cpu
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms, per_sm = card_slots(query, index, *args)
    return gpu_segments(R, n, sms, per_sm, rows_per_block, min_seglen,
                        align)


def _device_name(device) -> str:
    """``device`` as a string that names one device: ``cuda`` alone is
    the current card's index, so it shares that card's tables."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def on_device(key, device, make) -> dict:
    """Tensors from ``make()`` cached per (key, device), so a step does
    not copy its host tables to the card on every call. Each device
    keeps its own 32 most recently used entries, so the tables of
    several cards (a mesh's shards) do not evict each other; the least
    recently used entry goes first, so a call made once before a
    CUDA-graph capture finds every table it needs during the capture."""
    cache = _DEVICE_CACHE.setdefault(_device_name(device), {})
    hit = cache.pop(key, None)
    if hit is None:
        hit = {name: torch.as_tensor(a, device=device)
               for name, a in make().items()}
        if len(cache) >= 32:
            cache.pop(next(iter(cache)))
    cache[key] = hit
    return hit
