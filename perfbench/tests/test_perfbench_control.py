"""The controls fail the comparison, at a size a test run holds: the
reference computed in TF32 put in the program's place, and (podcast)
the program with its own bf16 front, each through a whole run that has
to read ``correct`` false. The chip readings at the cells' own sizes
are in PERF.md; this keeps the separation from decaying."""

import numpy as np
import pytest

from perfbench import compare, control, harness
from perfbench import inputs as gen
from perfbench.tests.tiny import SEED, TINY


@pytest.mark.parametrize("w", sorted(TINY))
def test_tf32_reference_fails_the_limit(w):
    r = control.tf32_reading(w, SEED, 0.2, device="cpu", overrides=TINY[w])
    assert not r["correct"]
    assert r["worst_row_db"] > harness.Cell(w).config["limit_db"] + 5.0


@pytest.mark.parametrize("w", sorted(TINY))
def test_float64_reference_in_place_is_correct(w):
    """The same wrap at float64 reads the reference against itself: the
    control's failure comes from its precision, not from the wrap."""
    cell = harness.Cell(w, overrides=TINY[w])
    r = harness.run_cell(w, SEED, 0.2, False, device="cpu", overrides=TINY[w],
                         wrap=control.reference_in_place(cell.config,
                                                         "float64"),
                         log=lambda m: None)
    assert r["correct"]
    assert r["checks"]["worst_row_db"]["value"] < -140.0


@pytest.mark.parametrize("w", sorted(TINY))
def test_float64_reference_reads_itself(w):
    cell = harness.Cell(w, overrides=TINY[w])
    ring = gen.make_ring(cell.traffic, SEED, "cpu")
    x = {k: v.numpy() for k, v in ring[0].items()}
    ref = harness.load_module("reference", cell.config["reference"])
    assert compare.worst_row_db(ref.run(cell.config, x),
                                ref.run(cell.config, x)) == compare.FLOOR_DB


def test_program_bf16_front_fails_the_limit():
    w = "podcast256.full10s"
    r = control.bf16_front_reading(w, SEED, 0.2, device="cpu",
                                   overrides=TINY[w])
    assert np.isfinite(r["worst_row_db"]) and not r["correct"]
    assert r["worst_row_db"] > harness.Cell(w).config["limit_db"] + 5.0
