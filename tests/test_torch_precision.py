"""The matmul precision rungs of the port (``xmtpu_torch.ops.precision``)
and the resample ops' ``precision=`` / ``dtype=``, against the JAX
package's functions on the same numpy inputs, on the CPU.

XLA on the CPU computes every ``jax.lax.Precision`` in float32, so the
JAX side cannot show the rounding of HIGH or DEFAULT: each rung is also
held against float64 in a window of dB that proves it rounded (a rung
equal to FP32 fails), and the CPU plain version against an independent
model of the split built with JAX's own bf16 rounding.

One signal: 2 rows x 44100 samples (1 s at 44.1 kHz) to 16 kHz, and
44000 samples for the windowed branches. Gates, measured here first:
- HIGHEST against JAX: -120 dB (measured -139.6 banded, -156.4 conv);
- HIGH against JAX -100 dB, against float64 in [-115, -100] (measured
  -106.8 for every method);
- DEFAULT against JAX -45 dB, against float64 in [-60, -45] (measured
  -52.5);
- ``dtype=bfloat16`` against JAX's ``jnp.bfloat16``: -80 dB (measured
  -87.3 banded and window: a bf16 ulp flips where the float32 sums
  round before the bf16 cast; the conv reads exactly equal), against
  float64 in [-60, -45] (measured -50.7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.kernels import resample as xkres
from xmtpu.ops import resample as xres
from xmtpu_torch.kernels import resample as tkres
from xmtpu_torch.ops import precision as tprec
from xmtpu_torch.ops import resample as tres
from xmtpu_torch.utils.errors import ConfigError

from . import torch_refs as refs

SR_IN, SR_OUT = 44100, 16000
N = 44100
WINDOWS = {"highest": (-200.0, -130.0), "high": (-115.0, -100.0),
           "default": (-60.0, -45.0)}
VS_JAX = {"highest": -120.0, "high": -100.0, "default": -45.0}


@pytest.fixture(scope="module")
def sig():
    rng = np.random.default_rng(2026)
    return (0.5 * rng.standard_normal((2, N))).astype(np.float32)


# ------------------------------------------------------------- resolve


@pytest.mark.parametrize("name,rung", [
    (None, "highest"), ("highest", "highest"), ("HIGHEST", "highest"),
    ("float32", "highest"), ("high", "high"), ("High", "high"),
    ("bfloat16_3x", "high"), ("tensorfloat32", "high"),
    ("default", "default"), ("bfloat16", "default"), ("fastest", "default"),
    (jax.lax.Precision.HIGHEST, "highest"), (jax.lax.Precision.HIGH, "high"),
    (jax.lax.Precision.DEFAULT, "default"),
])
def test_resolve_takes_jax_names(name, rung):
    assert tprec.resolve(name) == rung
    if isinstance(name, str) and name.islower():  # JAX's own spelling
        assert jax.lax.Precision(name).name.lower() == rung


@pytest.mark.parametrize("bad", ["tf64", "", "half", 3, 0.5,
                                 ("high", "high")])
def test_resolve_refuses_the_rest(bad):
    with pytest.raises(ConfigError, match="precision"):
        tprec.resolve(bad)


# ------------------------------------------------------------ matmul


def _bf16(a: np.ndarray) -> np.ndarray:
    """bf16 rounding by JAX (round to nearest even), as float64."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                      np.float64)


@pytest.mark.parametrize("rung", tprec.RUNGS)
def test_matmul_rungs_against_an_independent_split(rung):
    """The CPU plain version against a float64 model of the rung built
    from JAX's bf16 rounding: hi = bf16(a), lo = bf16(a - hi); HIGH sums
    hi*lo + lo*hi + hi*hi, DEFAULT hi*hi. Only float32 sums separate
    them: -130 dB. Every form the port takes ((..., k) @ (k, n), (m, k)
    @ (..., k, n), batched) gives the same."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((3, 7, 200)).astype(np.float32) * 1000.0
    b = rng.standard_normal((200, 33)).astype(np.float32) / 7.0
    if rung == "highest":
        model = a.astype(np.float64) @ b.astype(np.float64)
    else:
        ah, bh = _bf16(a), _bf16(b)
        al, bl = _bf16(a - ah), _bf16(b - bh)
        model = ah @ bh if rung == "default" else ah @ bl + al @ bh + ah @ bh
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tprec.matmul(ta, tb, rung)
    assert got.dtype == torch.float32 and refs.db(got, model) <= -130.0
    left = tprec.matmul(tb.T.contiguous(), ta.transpose(1, 2), rung)
    assert refs.db(left.transpose(1, 2), model) <= -130.0
    batched = tprec.matmul(ta, tb.expand(3, 200, 33), rung)
    assert refs.db(batched, model) <= -130.0
    exact = a.astype(np.float64) @ b.astype(np.float64)
    lo, hi = WINDOWS[rung]
    assert lo <= refs.db(got, exact) <= hi + (20.0 if rung == "highest" else 0)


def test_matmul_never_touches_tf32_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    a = torch.ones(4, 4)
    for rung in tprec.RUNGS:
        tprec.matmul(a, a, rung)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before


# -------------------------------------------------------- resample ops


@pytest.mark.parametrize("method,n", [("banded", N), ("banded", N - 100),
                                      ("conv", N - 100),
                                      ("window", N - 100)])
@pytest.mark.parametrize("rung", tprec.RUNGS)
def test_polyphase_resample_rungs_vs_jax(sig, method, n, rung):
    x = sig[:, :n]
    y_j = np.asarray(xres.polyphase_resample(
        jnp.asarray(x), SR_IN, SR_OUT, method=method,
        precision=jax.lax.Precision(rung)))
    y_t = tres.polyphase_resample(torch.from_numpy(x), SR_IN, SR_OUT,
                                  method=method, precision=rung)
    ref = xres.resample_oracle_np(x.astype(np.float64), SR_IN, SR_OUT)
    d, d64 = refs.db(y_t, y_j), refs.db(y_t, ref)
    print(f"{method} n={n} {rung}: {d:.1f} dB vs JAX, {d64:.1f} vs float64")
    assert y_t.dtype == torch.float32 and y_t.shape == y_j.shape
    lo, hi = WINDOWS[rung]
    assert d <= VS_JAX[rung] and lo <= d64 <= hi


@pytest.mark.parametrize("method,n", [("banded", N), ("conv", N - 100),
                                      ("window", N - 100)])
def test_polyphase_resample_bf16_vs_jax(sig, method, n):
    x = sig[:, :n]
    y_j = np.asarray(xres.polyphase_resample(
        jnp.asarray(x), SR_IN, SR_OUT, method=method, dtype=jnp.bfloat16))
    y_t = tres.polyphase_resample(torch.from_numpy(x), SR_IN, SR_OUT,
                                  method=method, dtype=torch.bfloat16)
    assert y_j.dtype == jnp.bfloat16 and y_t.dtype == torch.bfloat16
    ref = xres.resample_oracle_np(x.astype(np.float64), SR_IN, SR_OUT)
    d = refs.db(y_t, y_j.astype(np.float32))
    d64 = refs.db(y_t, ref)
    print(f"bf16 {method}: {d:.1f} dB vs JAX, {d64:.1f} vs float64")
    assert d <= -80.0 and -60.0 <= d64 <= -45.0
    # the same names the JAX package takes
    for dt in ("bfloat16", jnp.bfloat16, np.dtype(jnp.bfloat16)):
        assert torch.equal(tres.polyphase_resample(
            torch.from_numpy(x), SR_IN, SR_OUT, method=method, dtype=dt), y_t)
    assert tres.polyphase_resample(torch.from_numpy(x), SR_IN, SR_IN,
                                   dtype=jnp.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("rung", tprec.RUNGS)
def test_resample_window_and_framed_vs_jax(sig, rung):
    """resample_window and polyphase_resample_framed (also with the
    frame's minor axis lane-padded 441 -> 512, the mixfirst_pad operand)
    at each rung against the JAX functions."""
    plan_t = tres.make_plan(160, 441)
    plan_j = xres._make_plan(160, 441, 24, 9.0)
    nj = 50
    xs = sig[:, : tres.plan_rows(plan_t, nj) * 441]
    prec = jax.lax.Precision(rung)
    w_j = np.asarray(xres.resample_window(jnp.asarray(xs), plan_j, nj,
                                          precision=prec))
    w_t = tres.resample_window(torch.from_numpy(xs), plan_t, nj,
                               precision=rung)
    assert refs.db(w_t, w_j) <= VS_JAX[rung]
    A = sig.reshape(2, N // 441, 441)
    Ap = np.pad(A, ((0, 0), (0, 0), (0, 512 - 441)))
    Ap[..., 441:] = 7.0  # pad values must never reach the output
    f_j = np.asarray(xres.polyphase_resample_framed(
        jnp.asarray(Ap), SR_IN, SR_OUT, precision=prec))
    f_t = tres.polyphase_resample_framed(torch.from_numpy(Ap), SR_IN,
                                         SR_OUT, precision=rung)
    f_441 = tres.polyphase_resample_framed(torch.from_numpy(A), SR_IN,
                                           SR_OUT, precision=rung)
    assert f_t.shape == f_j.shape == (2, N // 441, 160)
    assert refs.db(f_t, f_j) <= VS_JAX[rung]
    assert refs.db(f_t, f_441.numpy()) <= -130.0
    fb_j = np.asarray(xres.polyphase_resample_framed(
        jnp.asarray(A), SR_IN, SR_OUT, dtype=jnp.bfloat16))
    fb_t = tres.polyphase_resample_framed(torch.from_numpy(A), SR_IN, SR_OUT,
                                          dtype=torch.bfloat16)
    assert fb_t.dtype == torch.bfloat16
    assert refs.db(fb_t, fb_j.astype(np.float32)) <= -80.0
    with pytest.raises(ValueError, match="< M=441"):
        tres.polyphase_resample_framed(torch.from_numpy(A[..., :400]), SR_IN,
                                       SR_OUT)


@pytest.mark.parametrize("rung", tprec.RUNGS)
def test_resample_kernel_twin_rungs_vs_jax(sig, rung):
    """K7's wrapper on the CPU (its twin, which splits as the kernel's
    three launches do) against ``resample_pallas(precision=)`` in
    interpret mode."""
    y_j = np.asarray(xkres.resample_pallas(
        jnp.asarray(sig), SR_IN, SR_OUT, interpret=True,
        precision=jax.lax.Precision(rung)))
    y_t = tkres.resample(torch.from_numpy(sig), SR_IN, SR_OUT,
                         precision=jax.lax.Precision(rung))
    ref = xres.resample_oracle_np(sig.astype(np.float64), SR_IN, SR_OUT)
    lo, hi = WINDOWS[rung]
    assert refs.db(y_t, y_j) <= VS_JAX[rung] and lo <= refs.db(y_t, ref) <= hi


def test_k7_split_tables():
    """The kernel's taps at each part: hi + lo is the float32 tap to
    about 16 bits, each part holds bf16 values (as float32)."""
    plan = tres.make_plan(160, 441)
    full = tkres.poly_tables(plan)["hsel"]
    hi = tkres.poly_tables(plan, "hi")["hsel"]
    lo = tkres.poly_tables(plan, "lo")["hsel"]
    for part in (hi, lo):
        assert part.dtype == np.float32
        assert np.array_equal(_bf16(part), part.astype(np.float64))
    assert np.array_equal(hi, _bf16(full).astype(np.float32))
    err = np.abs(hi.astype(np.float64) + lo - full).max()
    assert 0 < err <= np.abs(full).max() * 2.0 ** -16


def test_refusals(sig):
    x = torch.from_numpy(sig)
    with pytest.raises(ConfigError, match="precision"):
        tres.polyphase_resample(x, SR_IN, SR_OUT, precision="bogus")
    with pytest.raises(ConfigError, match="precision"):
        tkres.resample(x, SR_IN, SR_OUT, precision="bogus")
    with pytest.raises(ConfigError, match="dtype"):
        tres.polyphase_resample(x, SR_IN, SR_OUT, dtype=torch.float16)
    with pytest.raises(ConfigError, match="dtype"):
        tres.polyphase_resample(x, SR_IN, SR_OUT, dtype="int8")
