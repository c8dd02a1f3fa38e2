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

# Picks of gpu_segments in this process that are not a power of two (a
# divisor of n where the powers of two starve the card); callers may
# reset it, as the drivers' launch counters.
wide_picks = 0

# How many times shorter a divisor's chain must be than the power of
# two's waves x chain before gpu_segments takes the divisor: the powers
# of two stand wherever they come near one (config 3's 16 x 480,000:
# 7,500 steps against 2,400 at S = 200), and give way where a length's
# odd factors leave the card nearly idle (the voice cell's 32 x
# 2,646,000: 661,500 steps at S = 4 against 21,000 at S = 126)
_STARVED = 8


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
    more of the slots. 1 when n is odd. Where the powers of two starve
    the card, a divisor of n that is none (:func:`_pick`);
    :data:`wide_picks` counts those picks."""
    global wide_picks
    S, wide = _pick(R, n, sm_count, blocks_per_sm, rows_per_block,
                    min_seglen, align)
    wide_picks += wide
    return S


@functools.lru_cache(maxsize=256)
def _pick(R: int, n: int, sm_count: int, blocks_per_sm: int,
          rows_per_block: int, min_seglen: int,
          align: int) -> tuple[int, bool]:
    """:func:`gpu_segments`' S, and whether it is a divisor taken over
    the powers of two. After the powers of two, the largest allowed
    divisor of n whose blocks fit one an SM: past that the envelope
    core's launch is bound by its bytes, not its chain, while the glue
    between the passes (the segment chains, the corrections) grows with
    S (the envelope() call at 32 x 2,646,000 on an H100: the two
    launches 0.52-0.60 ms from S = 105 to 1,050, the glue 0.18 ms at S
    = 126 and 0.73 at 525). It is taken where its chain is at least
    :data:`_STARVED` times shorter than the power of two's waves x
    chain."""
    def blocks(s):
        return -(-R * s // rows_per_block)

    def cost(s):
        return -(-blocks(s) // (sm_count * blocks_per_sm)) * (n // s)

    def allowed(s):
        return n % s == 0 and n // s >= min_seglen and n // s % align == 0

    best, s = 1, 1
    while allowed(2 * s):
        s *= 2
        if cost(s) <= cost(best):
            best = s
    wide = max((d for d in _divisors(n)
                if d > 1 and allowed(d) and blocks(d) <= sm_count),
               default=1)
    if _STARVED * cost(wide) <= cost(best):
        return wide, True
    return best, False


def _divisors(n: int) -> list[int]:
    """The divisors of n, from its prime factors."""
    divs, m, p = [1], n, 2
    while p * p <= m:
        e = 0
        while m % p == 0:
            m //= p
            e += 1
        divs = [d * p ** k for d in divs for k in range(e + 1)]
        p += 1
    if m > 1:
        divs += [d * m for d in divs]
    return sorted(divs)


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
