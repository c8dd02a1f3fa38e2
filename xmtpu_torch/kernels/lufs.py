"""BS.1770's block powers over the K-weighted bus (``ops.loudness``
step 2): for a float32 (ch, n) signal ``xw``,

    power[j] = sum_ch sum_{t in [j*hop, j*hop + block)} xw[ch, t]^2 / block

for j = 0 .. nblk-1, in float64, with the geometry of
``ops.loudness._block_geometry``. On a CUDA tensor :func:`block_powers`
launches the hand-written kernel ``csrc/lufs_blocks.cu`` (one block of
threads per 400 ms block, every square and sum in float64, the same sums
in the same order on every run); on a CPU tensor it runs
:func:`block_powers_plain`, a float64 cumulative sum and a strided
gather, which the CPU tests and the JAX comparison use. No TPU kernel is
ported: the JAX package takes the powers in XLA.

Non-finite samples: on the kernel a NaN or inf reaches only the blocks
that hold it; on the twin the running sum carries it into every later
block. Through ``ops.loudness.measure_lufs`` both give the same blocks:
the K-weighting's recurrence has already carried the NaN into every
later sample, so every block that ends past it is NaN and fails the
absolute gate on either path.
"""

from __future__ import annotations

import torch

from xmtpu_torch.kernels import _build

# Launches of the CUDA kernel in this process (1 a call); callers may
# reset it.
launches = 0


def block_powers_plain(xw: torch.Tensor, block: int, hop: int,
                       nblk: int) -> torch.Tensor:
    """Plain twin of the kernel: (nblk,) float64 from the float64
    cumulative sum of the squares and a strided gather."""
    cs = torch.cat([
        xw.new_zeros(xw.shape[:-1] + (1,), dtype=torch.float64),
        torch.cumsum(torch.square(xw.to(torch.float64)), dim=-1)], dim=-1)
    starts = torch.arange(nblk, device=xw.device) * hop
    z = (cs[..., starts + block] - cs[..., starts]) / block  # (ch, nblk)
    return torch.sum(z, dim=0)  # channel weights G=1 (mono/stereo)


def block_powers(xw: torch.Tensor, block: int, hop: int,
                 nblk: int) -> torch.Tensor:
    """The block powers (module docstring) of ``xw``, a contiguous
    float32 (ch, n) tensor, as a (nblk,) float64 tensor on its device:
    the kernel on CUDA, :func:`block_powers_plain` on the CPU. Block j
    covers samples [j * hop, j * hop + block), which must lie inside n."""
    global launches
    if (not torch.is_tensor(xw) or xw.dtype != torch.float32
            or xw.dim() != 2 or not xw.is_contiguous()):
        raise ValueError("xw must be a contiguous float32 tensor (ch, n)")
    ch, n = xw.shape
    if nblk < 1 or block < 1 or hop < 1 or (nblk - 1) * hop + block > n:
        raise ValueError(f"{nblk} blocks of {block} samples a hop of {hop} "
                         f"do not fit {n} samples")
    if xw.device.type == "cpu":
        return block_powers_plain(xw, block, hop, nblk)
    if xw.device.type != "cuda":
        raise ValueError(f"no block-power kernel for device {xw.device}")
    power = torch.empty(nblk, dtype=torch.float64, device=xw.device)
    lib = _build.load()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.xm_lufs_blocks_f32(xw.data_ptr(), power.data_ptr(), ch, n,
                                    block, hop, nblk, stream)
    _build.check(rc, "lufs_blocks")
    launches += 1
    return power
