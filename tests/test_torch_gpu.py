"""The port's CUDA kernels against their plain torch twins on the card,
at edge shapes the flagship run does not reach (ragged tiles, fewer
rows than a warp, an IR longer than the signal, carried state).

Marked ``gpu``; each test skips without a CUDA device. The module
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: -100 dB RMS against the twin (float32 on both sides; the
kernel's radix-2 FFTs and the twin's library FFT round differently, the
envelope differs by FMA contraction only). The step on the card against the step on the
CPU: -90 dB at the int16 output (quantization plus those differences).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xmtpu_torch import batch as tbatch
from xmtpu_torch.kernels import envelope, fftconv
from xmtpu_torch.utils.errors import ConfigError

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _db(err: torch.Tensor, ref: torch.Tensor) -> float:
    e = float(err.double().pow(2).mean())
    r = float(ref.double().pow(2).mean())
    return -np.inf if e == 0 else 10.0 * np.log10(e / r)


@pytest.mark.parametrize("R,n,m", [
    (3, 5000, 37),        # odd rows (a pair with no imaginary row), N 1024
    (2, 3000, 1),         # one tap
    (1, 100, 4093),       # IR longer than the signal
    (2, 20000, 8193),     # the largest FFT block (16384)
    (4, 160000, 4093),    # the flagship row length and IR (N 8192)
])
def test_fftconv_kernel_vs_twin(cuda, R, n, m):
    rng = np.random.default_rng(R * n + m)
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    ir = torch.from_numpy((rng.standard_normal(m) * np.exp(
        -np.arange(m) / (m / 4 + 1))).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(0.5, 2.0, R).astype(np.float32))
    pc = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    args = [t.to(cuda) for t in (x, ir, pr, pc)]
    before = fftconv.launches
    y = fftconv.fir_convolve(*args)
    torch.cuda.synchronize()
    assert fftconv.launches == before + 1
    ref = fftconv.fir_convolve_plain(*args)
    assert y.shape == (R, n) and bool(torch.isfinite(y).all())
    assert _db(y - ref, ref) <= -100.0


@pytest.mark.parametrize("R,n", [(33, 1003), (1, 1), (64, 192), (8, 384)])
def test_envelope_kernel_vs_twin(cuda, R, n):
    rng = np.random.default_rng(R + n)
    x = torch.from_numpy((2.0 * rng.standard_normal((R, n))).astype(
        np.float32)).to(cuda)
    init = torch.from_numpy(rng.uniform(0.0, 1.0, (2, R)).astype(
        np.float32)).to(cuda)
    curve = envelope.curve_of(-3.0, ratio=4.0, makeup_db=1.0)
    k_rel, c_att = 0.99937, 0.0606
    before = envelope.launches
    y, zf = envelope.limiter(x, k_rel, c_att, curve, init=init)
    torch.cuda.synchronize()
    assert envelope.launches == before + 1
    y_p, zf_p = envelope.limiter_plain(x, k_rel, c_att,
                                       envelope.curve_consts(curve), init)
    assert _db(y - y_p, y_p) <= -100.0
    torch.testing.assert_close(zf, zf_p, rtol=1e-5, atol=1e-7)


def test_step_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((2, 22050)) * 8000).astype(np.int16)
    b = (rng.standard_normal((2, 22050)) * 6000).astype(np.int16)
    y_cpu = tbatch.make_flagship_step(fused=True)(
        torch.from_numpy(v), torch.from_numpy(b)).double()
    step = tbatch.make_flagship_step(fused=True, device=cuda)
    counts = (fftconv.launches, envelope.launches)
    y = step(torch.from_numpy(v).to(cuda), torch.from_numpy(b).to(cuda))
    assert (fftconv.launches, envelope.launches) == (counts[0] + 1,
                                                      counts[1] + 1)
    assert y.dtype == torch.int16 and y.shape == (2, 8000)
    assert _db(y.cpu().double() - y_cpu, y_cpu) <= -90.0


def test_step_refuses_tf32_and_mixed_devices(cuda):
    step = tbatch.make_flagship_step(fused=True, device=cuda)
    v = torch.zeros((2, 22050), dtype=torch.int16, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ConfigError):
            step(v, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.zeros((2, 100), device=cuda)
    with pytest.raises(ValueError):
        fftconv.fir_convolve(x, torch.ones(3), torch.ones(2, device=cuda),
                             torch.ones(100, device=cuda))
