"""BS.1770's block powers (``xmtpu_torch.kernels.lufs``) on the CPU:
the twin :func:`block_powers_plain` (a float64 cumulative sum and a
strided gather) against a direct float64 sum of each block, as
``ops.loudness.measure_lufs_np`` computes it
(``torch_refs.block_powers``), at 48,000, 44,100, 11,025 (a 400 ms
block of 4,410 samples is no whole number of 1,102-sample hops) and
8,000 Hz, one to three channels, lengths one short of a block,
a block, and a block and three hops with and without their last sample,
and across a run of silence; ``block_powers`` on a CPU tensor runs the
twin and launches nothing; its argument checks, an empty signal among
them; the twin's running sum carrying a NaN or inf into every later
block, while ``measure_lufs`` keeps the blocks that the kernel's
confined powers keep (the K-weighting has carried the sample on;
``tests/test_torch_gpu.py`` holds the card to the CPU there); and a model
of the kernel's split of a row among its threads (``csrc/lufs_blocks.cu``
``row_sum``: a scalar head to the first 16-byte boundary, float4s, a
scalar tail), which covers every sample once at every alignment.

Tolerance: max abs error within 1e-12 of the largest block power. The
cumulative sum's differences lose a quiet block's low digits after loud
ones, so an error relative to each block would not hold.

The kernel itself runs on the card only: ``tests/test_torch_gpu.py``
(``-k block_powers``) holds it to the same direct sum, rtol 1e-12 in
every block.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xmtpu_torch.kernels import lufs
from xmtpu_torch.kernels.iir import sosfilt
from xmtpu_torch.ops import loudness

from . import torch_refs as refs

K = 3  # hops past the first block


def _lengths(sr: int) -> list[int]:
    block, hop, _ = loudness._block_geometry(10**9, sr)
    return [block - 1, block, block + K * hop - 1, block + K * hop]


def _check(x: np.ndarray, sr: int) -> np.ndarray:
    geo = loudness._block_geometry(x.shape[-1], sr)
    got = lufs.block_powers_plain(torch.from_numpy(x), *geo)
    want = refs.block_powers(x, *geo)
    assert got.dtype == torch.float64 and got.shape == want.shape
    err = np.max(np.abs(got.numpy() - want))
    assert err <= 1e-12 * np.max(want), (err, np.max(want))
    return want


@pytest.mark.parametrize("sr", [48000, 44100, 11025, 8000])
@pytest.mark.parametrize("ch", [1, 2, 3])
@pytest.mark.parametrize("which", range(4))
def test_block_powers_plain_vs_direct_sum(sr, ch, which):
    n = _lengths(sr)[which]
    want = _check(refs.loud_stretch(ch, n, sr + 10 * ch + which), sr)
    # one block of everything below a block's length; whole blocks only
    # above it
    assert len(want) == [1, 1, K, K + 1][which]


@pytest.mark.parametrize("sr", [48000, 11025])
def test_block_powers_plain_over_a_run_of_silence(sr):
    block, hop, _ = loudness._block_geometry(10**9, sr)
    x = refs.loud_stretch(2, block + 12 * hop, sr)
    x[:, 2 * hop: 2 * hop + block + 3 * hop] = 0.0  # four whole blocks
    want = _check(x, sr)
    assert np.sum(want == 0.0) == 4


def test_block_powers_on_the_cpu_is_the_twin():
    sr = 11025
    x = torch.from_numpy(refs.loud_stretch(2, _lengths(sr)[3], 7))
    geo = loudness._block_geometry(x.shape[-1], sr)
    before = lufs.launches
    got = lufs.block_powers(x, *geo)
    assert lufs.launches == before
    assert torch.equal(got, lufs.block_powers_plain(x, *geo))


def test_measure_lufs_on_the_cpu_launches_nothing():
    x = refs.loud_stretch(2, 48000, 8)
    before = lufs.launches
    got = float(loudness.measure_lufs(x, 16000, device="cpu"))
    assert lufs.launches == before
    assert abs(got - loudness.measure_lufs_np(x, 16000)) <= 0.02


@pytest.mark.parametrize("bad", ["float64", "1-D", "strided", "too long",
                                 "empty"])
def test_block_powers_refuses(bad):
    x = torch.zeros(2, 1000)
    geo = (400, 100, 7)
    if bad == "float64":
        x = x.double()
    elif bad == "1-D":
        x = x[0]
    elif bad == "strided":
        x = torch.zeros(1000, 2).t()
    elif bad == "too long":
        geo = (400, 100, 8)
    else:  # _block_geometry(0, sr): the twin would divide 0 by 0
        x, geo = torch.zeros(2, 0), (0, 1, 1)
    with pytest.raises(ValueError):
        lufs.block_powers(x, *geo)


def test_measure_lufs_refuses_an_empty_signal():
    """No block powers of nothing: the K-weighting refuses n == 0 on
    every device, before either block-power path."""
    with pytest.raises(ValueError, match="empty"):
        loudness.measure_lufs(np.zeros((2, 0), np.float32), 48000,
                              device="cpu")


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_block_powers_plain_carries_a_non_finite_sample_on(bad):
    """The twin's running sum: the blocks before the one that first holds
    the sample stay finite, and every block from it on is NaN or inf
    (the kernel confines it to the four blocks that hold it)."""
    sr = 48000
    block, hop, _ = loudness._block_geometry(10**9, sr)
    x = refs.loud_stretch(2, block + 12 * hop, 95)
    x[1, 5 * hop + 10] = bad
    geo = loudness._block_geometry(x.shape[-1], sr)
    got = lufs.block_powers_plain(torch.from_numpy(x), *geo).numpy()
    j = np.arange(len(got))
    assert np.array_equal(np.isfinite(got), j < 2)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("sr", [48000, 11025])
def test_measure_lufs_keeps_the_same_blocks_past_a_non_finite_sample(sr,
                                                                     bad):
    """A NaN or inf at sample t: the twin's loudness is that of the gates
    on the direct sums of the same K-weighted signal, which poison only
    the blocks that hold a bad sample, as the kernel's powers do. The
    K-weighting's recurrence has carried the sample into every later one,
    so both keep the same blocks. With a NaN those are the blocks that
    end by t: the loudness of x[..., :t] (within 0.02 LU of the float64
    oracle's), where keeping the rest, 20 dB up, would read over 10 LU
    louder."""
    t = int(2.3 * sr)
    x = refs.quiet_then_loud(sr, 5.0, t, bad)
    xw = sosfilt(loudness.k_weighting_sos(sr), torch.from_numpy(x))[0]
    with np.errstate(invalid="ignore"):
        direct = refs.block_powers(xw.numpy(), *loudness._block_geometry(
            x.shape[-1], sr))
    got = float(loudness.measure_lufs(x, sr, device="cpu"))
    assert got == pytest.approx(
        float(loudness._gates(torch.from_numpy(direct))), abs=1e-9)
    if np.isnan(bad):
        prefix = loudness.measure_lufs_np(x[:, :t], sr)
        assert abs(got - prefix) <= 0.02
        x[1, t] = 0.0
        assert loudness.measure_lufs_np(x, sr) > prefix + 10.0


def _row_indices(offset: int, length: int, threads: int = 256) -> list:
    """The samples each thread of ``row_sum`` reads, for a row starting
    ``offset`` floats past a 16-byte boundary: a copy of the index
    arithmetic of ``row_sum`` in ``csrc/lufs_blocks.cu`` (``head``,
    ``vecs``, ``tail``), to be kept in step with it; the card tests hold
    the kernel itself at rows 1-3 floats off a boundary."""
    head = min(length, (16 - 4 * offset) % 16 // 4)
    vecs = (length - head) // 4
    tail = head + 4 * vecs
    got = []
    for t in range(threads):
        if t < head:
            got.append(t)
        for i in range(t, vecs, threads):
            got.extend(range(head + 4 * i, head + 4 * i + 4))
        if tail + t < length:
            got.append(tail + t)
    return got


@pytest.mark.parametrize("offset", range(4))
@pytest.mark.parametrize("length", [0, 1, 2, 3, 5, 1102, 4410, 19200])
def test_kernel_row_split_covers_every_sample_once(offset, length):
    got = _row_indices(offset, length)
    assert sorted(got) == list(range(length))
