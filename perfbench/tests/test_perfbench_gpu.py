"""The command on the card, each cell once with a short window, traced
and untraced: one result line with its keys, ``correct`` true, the
compared number last on standard error. Marked ``gpu``; skips without a
card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_command_on_the_card(w, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [*SPEC["command"], "--workload", w, "--seed", str(2**31 + 77),
         "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check worst_row_db")
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for m in r["metrics"].values():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100
