"""The port's time-segmented fused limiter
(``xmtpu_torch.kernels.envelope.limiter(segments=S)``: pass A with the
|x| detector, the exact segment carries, the fused pass B from them) on
the plain twins, against the JAX package's unsegmented
``limiter_pallas`` (interpret mode) and the float64 oracle; the card's
segment rule (``_seg.gpu_segments``); the closed-form segment chains.

On a CPU tensor every pass runs its kernel's plain torch twin; the
kernels themselves are compared with the twins on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

One shape: 2 rows x 8000 samples (the flagship bus signal of 0.5 s
clips), where the JAX limiter takes its unsegmented path; S = 2 and 4
(segments of 4000 and 2000 samples, each longer than the carries'
1474-sample decay window).

Tolerances:
- y against the Pallas kernel and the float64 oracle: -100 dB (float32
  on both sides; the segment carries reassociate the recurrences);
- the final states: rtol 1e-5;
- S = 1, and pass A against the pass over a stored |x|: bit for bit;
- the closed-form chains against the sequential loops: rtol 1e-6
  (float32 powers rounded once against products rounded per step).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels.envelope import limiter_pallas
from xmtpu.kernels.iir import pick_segments as jax_pick_segments
from xmtpu_torch.kernels import envelope
from xmtpu_torch.kernels._seg import gpu_segments
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff, limiter_np

from . import torch_refs as refs

R, N, SR_BUS = 2, 8000, 16000
K_REL = _release_coeff(100.0, SR_BUS)
C_ATT = _attack_coeff(1.0, SR_BUS)
CURVE = envelope.curve_of(-3.0)
INITS = {"zeros": None, "carried": (0.4, 0.2)}


@pytest.fixture(scope="module")
def x():
    """Noise driven into the knee and the ceiling, quiet over [2500,
    5200) so the envelope decays across the segment boundaries at 4000
    (S = 2) and 4000, 6000 (S = 4) and recovers before the end."""
    rng = np.random.default_rng(31)
    gate = np.ones(N, np.float32)
    gate[2500:5200] = 0.0
    return (3.0 * 0.3 * rng.standard_normal((R, N)) * (0.1 + gate)).astype(
        np.float32)


@pytest.fixture(scope="module")
def pallas(x):
    """The JAX limiter's unsegmented path, once per init."""
    assert jax_pick_segments(R, N, lanes=256) == 1
    out = {}
    for name, init in INITS.items():
        init_j = None if init is None else tuple(
            jnp.full((R,), v, jnp.float32) for v in init)
        y, st = limiter_pallas(jnp.asarray(x), K_REL, C_ATT, -3.0,
                               init=init_j, interpret=True)
        out[name] = np.asarray(y), np.stack([np.asarray(s) for s in st])
    return out


def _init_t(init):
    return None if init is None else torch.tensor(
        [[init[0]] * R, [init[1]] * R], dtype=torch.float32)


@pytest.mark.parametrize("init", list(INITS))
@pytest.mark.parametrize("S", [2, 4])
def test_segmented_limiter_vs_pallas(x, pallas, S, init):
    y_j, st_j = pallas[init]
    y_t, zf_t = envelope.limiter(torch.from_numpy(x), K_REL, C_ATT, CURVE,
                                 init=_init_t(INITS[init]), segments=S)
    db = refs.db(y_t.numpy(), y_j)
    print(f"segmented limiter (S={S}, init {init}) vs Pallas (interpret): "
          f"{db:.1f} dB (gate -100)")
    assert y_t.shape == (R, N) and db <= -100.0
    assert np.abs(y_t.numpy()).max() <= 1.0
    np.testing.assert_allclose(zf_t.numpy(), st_j, rtol=1e-5)


@pytest.mark.parametrize("S", [2, 4])
def test_segmented_limiter_vs_oracle(x, S):
    y_ref, st_ref = limiter_np(x[:, None, :], SR_BUS, threshold_db=-3.0)
    y_t, zf_t = envelope.limiter(torch.from_numpy(x), K_REL, C_ATT, CURVE,
                                 segments=S)
    db = refs.db(y_t.numpy(), y_ref[:, 0])
    print(f"segmented limiter (S={S}) vs float64 oracle: {db:.1f} dB "
          "(gate -100)")
    assert db <= -100.0
    np.testing.assert_allclose(zf_t.numpy(), np.stack(st_ref), rtol=1e-5)


@pytest.mark.parametrize("init", list(INITS))
def test_one_segment_is_todays_limiter(x, init):
    """segments=1 and the CPU default (None) are the one fused pass,
    bit for bit."""
    xt, it = torch.from_numpy(x), _init_t(INITS[init])
    ref = envelope.limiter_plain(
        xt, K_REL, C_ATT, envelope.curve_consts(CURVE),
        torch.zeros((2, R)) if it is None else it)
    for seg in (None, 1):
        y, zf = envelope.limiter(xt, K_REL, C_ATT, CURVE, init=it,
                                 segments=seg)
        assert torch.equal(y, ref[0]) and torch.equal(zf, ref[1])
    assert envelope.limiter_segments(R, N, C_ATT, "cpu") == 1


def test_pass_a_runs_the_abs_detector(x):
    """Pass A (``run``) sees the signed segment rows with the |x|
    detector, and equals the pass over a stored |x| bit for bit."""
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return envelope.envelope_pass(*args, **kw)

    y_r, _ = envelope.limiter(torch.from_numpy(x), K_REL, C_ATT, CURVE,
                              segments=4, run=recording)
    y, _ = envelope.limiter(torch.from_numpy(x), K_REL, C_ATT, CURVE,
                            segments=4)
    assert torch.equal(y_r, y)
    (args, kw), = calls
    assert kw == {"abs_detector": True} and args[0].shape == (R * 4, N // 4)
    assert bool((args[0] < 0).any()) and args[2] == 1.0
    init = torch.tensor([[0.3, 0.0], [0.2, 0.1]])
    for fn in (envelope.envelope_pass, envelope.envelope_plain):
        a, za = fn(torch.from_numpy(x), K_REL, 1.0, init, abs_detector=True)
        b, zb = fn(torch.from_numpy(np.abs(x)), K_REL, 1.0, init)
        assert torch.equal(a, b) and torch.equal(za, zb)


def test_segmented_limiter_refusals(x):
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="does not divide"):
        envelope.limiter(xt, K_REL, C_ATT, CURVE, segments=3)
    with pytest.raises(ValueError, match="abs_detector"):
        envelope.envelope_pass(xt, K_REL, C_ATT, torch.zeros((2, R)),
                               torch.ones(N), torch.ones(R),
                               abs_detector=True)
    with pytest.raises(ValueError, match="abs_detector"):
        envelope.envelope_pass(xt, K_REL, C_ATT, torch.zeros((2, R)),
                               curve=CURVE, curve_mode="gain",
                               abs_detector=True)
    with pytest.raises(ValueError, match="no envelope kernel"):
        envelope.limiter(xt.to("meta"), K_REL, C_ATT, CURVE, segments=2)


@pytest.mark.parametrize("R_,n,sms,per_sm", [
    (256, 160000, 132, 3),   # the flagship shape on an H100
    (256, 160000, 132, 2),
    (32, 160000, 132, 3),    # the small batch
    (1, 8192, 132, 3),
    (3, 40000, 108, 2),      # another card
    (1024, 160000, 132, 3),  # the unsegmented grid already fills the card
    (256, 160001, 132, 3),   # n odd
    (16, 480000, 132, 3),    # config 3's rows and length
])
def test_gpu_segment_rule(R_, n, sms, per_sm):
    S = gpu_segments(R_, n, sms, per_sm, 8, 4096)
    assert S >= 1 and S & (S - 1) == 0 and n % S == 0
    if n % 2:
        assert S == 1
        return
    assert S == 1 or n // S >= 4096
    slots, blocks = sms * per_sm, -(-R_ * S // 8)
    # R*S fills the slots, unless a shorter segment is not allowed
    assert blocks >= slots or n % (2 * S) or n // (2 * S) < 4096
    # no other allowed S takes fewer waves x chain steps

    def cost(s):
        return -(-(-(-R_ * s // 8)) // slots) * (n // s)

    s = 1
    while n % s == 0 and (s == 1 or n // s >= 4096):
        assert cost(s) >= cost(S)
        s *= 2
    assert gpu_segments(R_, n, sms, per_sm, 8, n) == 1  # min = n


@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_segment_chains_closed_form(reduce):
    """The chains over the segments as one masked multiply and a max or
    a sum (``envelope._chain``) against the S-step loops they replace;
    a NaN final reaches only the later segments."""
    rng = np.random.default_rng(5)
    S, coef = 8, 0.6
    first = torch.from_numpy(rng.uniform(0, 1, 3).astype(np.float32))
    finals = torch.from_numpy(rng.uniform(0, 1, (3, S)).astype(np.float32))
    got = envelope._chain(first, finals, coef, reduce)
    c = float(np.float32(coef))
    s, ref = first.double(), [first.double()]
    for k in range(S):
        f = finals[:, k].double()
        s = torch.maximum(f, c * s) if reduce == "max" else f + c * s
        ref.append(s)
    torch.testing.assert_close(got.double(), torch.stack(ref, 1), rtol=1e-6,
                               atol=0)
    finals[1, 3] = float("nan")
    got = envelope._chain(first, finals, coef, reduce)
    assert not bool(got[1, :4].isnan().any())
    assert bool(got[1, 4:].isnan().all()) and not bool(got[0].isnan().any())


def test_segmented_limiter_nan_mask_vs_pallas(x):
    """A NaN sample in segment 2 of row 1 and a NaN initial envelope on
    row 0: the segmented twin path (S = 4) gives NaN exactly where the
    JAX limiter does (from the sample on; all of row 0), never a clamped
    +-ceiling there, and agrees with it elsewhere."""
    xn = x.copy()
    xn[1, 4500] = np.nan
    init = np.array([[np.nan, 0.4], [0.2, 0.2]], np.float32)
    y_j, st_j = limiter_pallas(jnp.asarray(xn), K_REL, C_ATT, -3.0,
                               init=tuple(jnp.asarray(v) for v in init),
                               interpret=True)
    y_j = np.asarray(y_j)
    y_t, zf_t = envelope.limiter(torch.from_numpy(xn), K_REL, C_ATT, CURVE,
                                 init=torch.from_numpy(init), segments=4,
                                 run=envelope.envelope_plain)
    nan_j = np.isnan(y_j)
    assert nan_j[0].all() and nan_j[1, 4500:].all()
    assert not nan_j[1, :4500].any()
    assert np.array_equal(y_t.isnan().numpy(), nan_j)
    assert np.array_equal(zf_t.isnan().numpy(),
                          np.isnan(np.stack([np.asarray(s) for s in st_j])))
    ok = ~nan_j
    assert refs.db(y_t.numpy()[ok], y_j[ok]) <= -100.0
