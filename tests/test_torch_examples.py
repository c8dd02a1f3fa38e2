"""The port's five example scripts (``examples/torch_*.py``), each run
end to end with ``--device cpu`` as a user would, their printed lines
checked as ``tests/test_examples.py`` checks the JAX scripts'."""

from __future__ import annotations

import json
import runpy
import sys

import pytest


def _run(name, *args):
    old = sys.argv
    sys.argv = [f"examples/torch_{name}.py", *args, "--device", "cpu"]
    try:
        runpy.run_path(f"examples/torch_{name}.py", run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.parametrize("name,expect", [
    ("streaming_session", "group (8000, 1)"),
    ("serving_pool", "checkpoint/resume bit-exact: True"),
    ("lufs_mastering", "-16.00 LUFS"),
])
def test_example_runs(name, expect, capsys):
    _run(name)
    assert expect in capsys.readouterr().out


def test_example_compat_handles(tmp_path, capsys):
    _run("compat_handles", str(tmp_path))
    out = capsys.readouterr().out
    assert "mixer: 100 frames of 20 ms, then end-of-stream" in out
    assert "generator: status 2 progress 100%" in out


def test_example_batch_pipeline(tmp_path, capsys):
    _run("batch_pipeline", str(tmp_path))
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["done"] == 3 and rep["failed"] == []
    assert (tmp_path / "manifest.json").exists()
    assert all((tmp_path / f"out_{i}.wav.done").exists() for i in range(3))
