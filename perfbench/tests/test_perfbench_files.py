"""BENCHMARK.json against its contract, and every data file and reader
found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["config"] for w in SPEC["workloads"]]
    names += [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert LINE.match(m["layer"])
    for c in SPEC["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
    for w in SPEC["workloads"]:
        assert LINE.match(w["why"])


def test_entries_have_exactly_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_config_used_and_every_cell_reports_enough():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        if m.get("workloads") and m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"], SPEC)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load_by_name(w):
    cell = harness.Cell(w, SPEC)
    assert harness.load_module("entries", cell.config["entry"]).build
    ref = harness.load_module("reference", cell.config["reference"])
    stages = ref.stages(cell.config, cell.traffic)
    assert set(stages) >= {"eq_reverb", "limiter"}
    for m in cell.end_to_end:
        assert harness.load_module("end_to_end", m["name"]).value
    for m in cell.per_layer:
        assert harness.load_module("layer_metrics", m["name"]).read
    assert cell.config["name"] == cell.workload["config"]
    assert math.isfinite(float(cell.config["limit_db"]))


@pytest.mark.parametrize("kind", ["configs", "traffic", "layer_metrics",
                                  "end_to_end", "entries", "reference"])
def test_every_file_of_a_kind_loads(kind):
    d = ROOT / "perfbench" / kind
    files = sorted(p for p in d.iterdir()
                   if p.suffix in (".json", ".py") and not p.name.startswith("_"))
    assert files
    for p in files:
        assert NAME.match(p.stem), p
        if p.suffix == ".json":
            assert isinstance(json.loads(p.read_text()), dict)
        else:
            harness.load_module(kind, p.stem)


def test_config_files_name_their_source_and_cuts():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
