"""A whole run without the card's check, on the CPU's twins at a tiny
size: sound, ``correct`` is true; with the timed path broken underneath,
false, once for each fault these cells can have."""

import json

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import SEED, TINY


def stale(entry):
    """A step that returns its state unchanged: every call hands back
    what the previous call produced (the output buffer not rewritten)."""
    last = []

    def call(batch):
        out = entry(batch)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return call


def alter_row(entry):
    """An answer altered where it is produced: one clip of every batch
    gets its neighbour's output."""
    def call(batch):
        out = entry(batch).clone()
        out[1] = out[0]
        return out
    return call


def half_batch(entry):
    """Half of the batch left out: its second half comes back silent."""
    def call(batch):
        out = entry(batch).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return call


def one_sample(entry):
    """One output sample of one clip altered by a tenth of full scale in
    every batch."""
    def call(batch):
        out = entry(batch).clone()
        out[0, out.shape[1] // 2] += 3277 if out.dtype == torch.int16 else 0.1
        return out
    return call


def one_slot(entry):
    """Only the batches of one slot of the ring come back wrong (every
    row of them scaled by 0.9): a fault a check of fewer slots misses."""
    seen = []

    def call(batch):
        out = entry(batch)
        if not seen:
            seen.append(id(batch))
        if id(batch) != seen[0]:
            return out
        return (out.float() * 0.9).to(out.dtype)
    return call


def _run(w, wrap=None, trace=False):
    return harness.run_cell(w, SEED, 0.3, trace, device="cpu",
                            overrides=TINY[w], wrap=wrap, log=lambda m: None)


@pytest.mark.parametrize("w", sorted(TINY))
def test_sound_run_is_correct(w):
    r = _run(w)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    e2e = {m["name"] for m in harness.Cell(w).end_to_end}
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("w", sorted(TINY))
@pytest.mark.parametrize("fault", [stale, alter_row, half_batch, one_sample,
                                   one_slot])
def test_a_broken_timed_path_is_not_correct(w, fault):
    r = _run(w, fault)
    assert not r["correct"]
    assert r["checks"]["worst_row_db"]["value"] is None or (
        r["checks"]["worst_row_db"]["value"] > r["checks"]["worst_row_db"]["limit"])


def test_traced_run_is_correct_and_has_its_device_keys():
    r = _run("effects48k.stereo64x10s", trace=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("w", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_checked_rows_cover_every_row_index(w):
    """Each slot's rows come from one permutation of the batch's rows, so
    a fault on any one row index shows in some slot's check."""
    t = harness.Cell(w).traffic
    rows = harness.check_rows(t, SEED)
    assert len(rows) == int(t["ring"])
    seen = sorted({int(r) for slot in rows for r in slot})
    assert seen == list(range(int(t["clips_per_batch"])))
