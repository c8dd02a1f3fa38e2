"""The noise suppressor's Wiener kernel (``kernels/ns.py``) on the CPU:
the algebra of its frame split, its segment rule and its plain twin.

- ``_segmented_model``, the kernel's split in float64
  (``seg_plan``'s segments with a shorter last one, pass A's local
  finals, the ``a^L`` carry chain, each segment from its carry), against
  the sequential recurrence: max abs <= 1e-12 of the largest P, at T
  prime, T < S, one frame and the voice cell's 10,337 frames, over a PSD
  spanning 16 decades with runs of silence.
- ``seg_plan``: every segment holds a frame, the last one T - (S-1) L.
- ``segment_count`` on fake cards: the voice cell's 32 x 10,337 x 257
  fills 132 SMs four times over at 5, 12 or 16 resident blocks; short
  tracks run unsplit, one track's frames bound S.
- ``wiener`` on a CPU tensor is the twin (the scan and the elementwise
  gain), launches nothing, and reads -120 dB against the float64 model
  carried through the gain.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from xmtpu_torch.kernels import _build, _seg
from xmtpu_torch.kernels import ns as kns

from . import torch_refs as refs


def _psd(C: int, T: int, seed: int) -> np.ndarray:
    """(C, T) float64 PSD over 16 decades with a run of zeros a row."""
    rng = np.random.default_rng(seed)
    psd = 10.0 ** rng.uniform(-12.0, 4.0, (C, T))
    for c in range(C):
        a = rng.integers(0, T)
        psd[c, a:a + rng.integers(0, T // 3 + 2)] = 0.0
    return psd


def _segmented_model(psd: np.ndarray, a: float, S: int) -> np.ndarray:
    """The kernel's split in float64 on psd (C, T): the local finals of
    the first S - 1 segments, the a^L carry chain, each segment from its
    carry -> P (C, T)."""
    T = psd.shape[-1]
    S, L = kns.seg_plan(T, S)
    b = 1.0 - a
    fin = np.zeros((S, psd.shape[0]))
    for s in range(S - 1):  # pass A
        P = np.zeros(psd.shape[0])
        for t in range(s * L, (s + 1) * L):
            P = a * P + b * psd[:, t]
        fin[s] = P
    out = np.empty_like(psd, dtype=np.float64)
    for s in range(S):  # pass B
        P = np.zeros(psd.shape[0])
        for j in range(s):
            P = a ** L * P + fin[j]
        for t in range(s * L, min((s + 1) * L, T)):
            P = a * P + b * psd[:, t]
            out[:, t] = P
    return out


def _sequential(psd: np.ndarray, a: float) -> np.ndarray:
    out, P = np.empty_like(psd), np.zeros(psd.shape[0])
    for t in range(psd.shape[1]):
        P = a * P + (1.0 - a) * psd[:, t]
        out[:, t] = P
    return out


@pytest.mark.parametrize("T,S,a", [
    (1, 1, 0.7),       # one frame
    (1, 4, 0.7),       # one frame, more segments asked
    (2, 5, 0.7),       # T < S: segments of one frame
    (3, 8, 0.95),
    (97, 8, 0.7),      # T prime: L = 13, the last segment 6
    (1009, 15, 0.7),   # T prime: L = 68, the last 57
    (1009, 1009, 0.3),  # a frame a segment
    (4096, 64, 0.99),  # equal segments, a slow decay
    (10337, 32, 0.7),  # the voice cell: L = 324, the last 293
])
def test_segmented_model_matches_the_sequential_recurrence(T, S, a):
    psd = _psd(5, T, T * S)
    want = _sequential(psd, a)
    got = _segmented_model(psd, a, S)
    err = np.max(np.abs(got - want))
    print(f"T = {T}, S = {S} -> {kns.seg_plan(T, S)}: max abs {err:.3g} "
          f"of {np.max(want):.3g}")
    assert err <= 1e-12 * np.max(want)


@pytest.mark.parametrize("T,S", [(1, 1), (2, 5), (10, 6), (97, 8),
                                 (1009, 15), (10337, 32), (10337, 24),
                                 (64, 64), (65, 64)])
def test_seg_plan_covers_every_frame(T, S):
    S2, L = kns.seg_plan(T, S)
    assert 1 <= S2 <= min(S, T)
    last = T - (S2 - 1) * L
    assert 1 <= last <= L and L == -(-T // min(S, T))
    assert kns.seg_plan(T, S2) == (S2, L)  # the wrapper plans twice


@pytest.mark.parametrize("per_sm,want,planned", [(5, 40, 40), (12, 97, 97),
                                                 (16, 129, 128)])
def test_segment_count_fills_the_card_at_the_voice_shape(monkeypatch, per_sm,
                                                         want, planned):
    """65 blocks a segment (8,224 chains): S = 4 * 132 * per_sm // 65,
    then as many segments of ceil(T / S) frames as T needs."""
    assert kns.WAVES == 4
    assert kns.segment_count(32, 10337, 257, 132, per_sm) == want
    monkeypatch.setattr(_seg, "card_slots", lambda q, i, *a: (132, per_sm))
    S = kns.wiener_segments(32, 10337, 257, "cuda:0")
    assert S == kns.seg_plan(10337, want)[0] == planned
    assert kns.wiener_segments(32, 10337, 257, "cpu") == 1


@pytest.mark.parametrize("R,T,want", [
    (32, 63, 1),      # shorter than one segment
    (1, 3, 1),
    (1, 10337, 161),  # one track: the frames bound S, not the card
    (2, 1009, 15),
])
def test_segment_count_at_short_and_narrow_shapes(R, T, want):
    assert kns.segment_count(R, T, 257, 132, 16) == want


def test_wiener_on_the_cpu_is_the_twin():
    rng = np.random.default_rng(25)
    R, T, F = 3, 97, 33
    X = torch.from_numpy((rng.standard_normal((R, T, F))
                          + 1j * rng.standard_normal((R, T, F)))
                         .astype(np.complex64))
    X[1, 40:] *= 1e-5  # a row quiet after a loud start: the carry decays
    noise = torch.from_numpy(rng.uniform(0.5, 4.0, (R, F)).astype(np.float32))
    noise[2] = 1e6  # the floor binds everywhere in this row
    before = kns.launches
    Y = kns.wiener(X, noise, 0.7, 0.1)
    assert kns.launches == before and Y.data_ptr() != X.data_ptr()
    assert torch.equal(Y, kns.wiener_plain(X, noise, 0.7, 0.1))
    # the float64 model carried through the gain
    x = X.numpy().astype(np.complex128)
    psd = (np.abs(x) ** 2).transpose(0, 2, 1).reshape(R * F, T)
    P = _segmented_model(psd, float(np.float32(0.7)), 8)
    P = P.reshape(R, F, T).transpose(0, 2, 1)
    nz = np.maximum(noise.numpy().astype(np.float64), 1e-20)[:, None, :]
    snr = np.maximum(P / nz - 1.0, 0.0)
    want = x * np.maximum(snr / (1.0 + snr), float(np.float32(0.1)))
    assert np.array_equal(Y.numpy()[2], X.numpy()[2] * np.float32(0.1))
    db = refs.db(Y.numpy().view(np.float32), want.view(np.float64))
    print(f"twin vs the float64 model: {db:.1f} dB")
    assert db <= -120.0


def test_wiener_refuses_what_the_kernel_does_not_take():
    X = torch.zeros((2, 5, 9), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        kns.wiener(X.to(torch.complex128), torch.zeros(2, 9), 0.7, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        kns.wiener(X.transpose(0, 1), torch.zeros(2, 9), 0.7, 0.1)
    with pytest.raises(ValueError, match="float32"):
        kns.wiener(X, torch.zeros(2, 9, dtype=torch.float64), 0.7, 0.1)
    with pytest.raises(ValueError, match="no Wiener kernel"):
        kns.wiener(X.to("meta"), torch.zeros(2, 9, device="meta"), 0.7, 0.1)
    assert "ns_wiener.cu" in {p.name for p in _build.sources()}
    assert {"xm_ns_wiener_f32", "xm_ns_wiener_blocks_per_sm"} <= set(
        _build._SIGNATURES)
