"""The float64 reference, the side under test here: its closed forms
against their definitions, its tables against the program's host
tables, and the whole chains against the program's CPU path at a tiny
size. The program only checks the reference in these tests; the
reference itself imports nothing of it."""

import numpy as np
import pytest
import torch

from perfbench import compare, harness
from perfbench import inputs as gen
from perfbench.reference import dsp
from perfbench.tests.tiny import SEED, TINY


def test_decaying_max_closed_form_is_the_recurrence():
    rng = np.random.default_rng(0)
    d = np.abs(rng.standard_normal((3, 2000))) * np.linspace(0, 1, 2000)
    d[1, :500] = 0.0  # silence first: log(0) = -inf
    k = dsp.release_coeff(100.0, 16000)
    got, want = dsp.decaying_max(d, k), dsp.decaying_max_loop(d, k)
    assert np.max(np.abs(got - want) / np.maximum(want, 1e-300)) < 1e-12


def test_limiter_closed_form_is_the_loop():
    x = 0.9 * np.random.default_rng(1).standard_normal((2, 2, 3000))
    a = dsp.limiter(x, 48000)
    b = dsp.limiter(x, 48000, loop=True)
    assert np.max(np.abs(a - b)) < 1e-12


def test_tf32_keeps_eleven_significant_bits():
    x = np.random.default_rng(2).standard_normal(10000) * 1e3
    r = dsp.tf32(x)
    rel = np.abs(r - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -11 * 1.0000001
    assert np.array_equal(dsp.tf32(r), r)
    assert rel.mean() > 2.0 ** -14  # it does round


def test_tables_agree_with_the_program_host_tables():
    from xmtpu_torch.batch import DEFAULT_BANDS
    from xmtpu_torch.ops import biquad, resample, reverb

    bands = [dict(b) for b in DEFAULT_BANDS]
    for sr in (16000, 48000):
        np.testing.assert_allclose(dsp.eq_sos(bands, sr),
                                   biquad.eq_sos(bands, sr), rtol=1e-13,
                                   atol=1e-15)
        for s in (0.25, 0.5):
            np.testing.assert_array_equal(dsp.synthetic_ir(s, sr),
                                          reverb.synthetic_ir(s, sr))
    np.testing.assert_allclose(dsp.lowpass(160, 441),
                               resample.design_polyphase_filter(160, 441),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("w,taps", [("podcast256.full10s", 4093),
                                    ("effects48k.stereo64x10s", 24082)])
def test_folded_taps_are_the_program_s_stage(w, taps):
    """The roofline's tap count: the reference's own fold, equal to the
    FIR the program builds for the stage."""
    cell = harness.Cell(w)
    st = harness.load_module("reference", cell.config["reference"]).stages(
        cell.config, cell.traffic)
    assert st["eq_reverb"]["taps"] == taps
    if w.startswith("podcast"):
        from xmtpu_torch.batch import make_flagship_step

        assert make_flagship_step(device="cpu").ir.shape[0] == taps


@pytest.mark.parametrize("w", sorted(TINY))
def test_reference_agrees_with_the_program_cpu_path(w):
    cell = harness.Cell(w, overrides=TINY[w])
    ring = gen.make_ring(cell.traffic, SEED, "cpu")
    call = harness.load_module("entries", cell.config["entry"]).build(
        cell.config, cell.traffic, torch.device("cpu"))
    ref = harness.load_module("reference", cell.config["reference"])
    for batch in ring:
        got = call(batch).numpy()
        want = ref.run(cell.config, {k: v.numpy() for k, v in batch.items()})
        assert got.shape == want.shape
        # the CPU twins read -99 dB (podcast, int16) and -109 dB
        # (effects, float32): a wrong stage in either side reads far
        # above -85
        assert compare.worst_row_db(got, want) < -85.0


def test_row_db_refuses_shapes_and_non_finite():
    r = np.ones((2, 8, 2))
    assert compare.worst_row_db(r, r) == compare.FLOOR_DB
    assert compare.worst_row_db(r[:1], r) == np.inf
    bad = r.copy()
    bad[1, 3, 0] = np.nan
    assert compare.worst_row_db(bad, r) == np.inf
    half = r.copy()
    half[1] = 0.0
    assert compare.worst_row_db(half, r) == pytest.approx(0.0)
