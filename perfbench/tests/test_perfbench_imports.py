"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), the reference loads nothing of the
program, and the command refuses to run without the card."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_TINY = """
import json, sys
from perfbench import harness
from perfbench.tests.tiny import SEED, TINY
for w in sorted(TINY):
    for trace in (False, True):
        r = harness.run_cell(w, SEED, 0.2, trace, device="cpu",
                             overrides=TINY[w], log=lambda m: None)
        assert r["correct"], (w, trace, r)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import json, sys
import numpy as np
from perfbench.reference import dsp, effects_chain, flagship_chain
from perfbench import harness
cell = harness.Cell("podcast256.full10s")
x = {"voice": np.zeros((1, 4410), np.int16), "bgm": np.ones((1, 4410), np.int16)}
flagship_chain.run(cell.config, x)
effects_chain.run(harness.Cell("effects48k.stereo64x10s").config,
                  {"pcm": np.ones((1, 960, 2), np.float32)})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(RUN_TINY)
    assert not mods & {"jax", "jaxlib", "flax", "xmtpu"}
    assert "xmtpu_torch" in mods  # the whole-name rule: the port is there


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE_ONLY)
    assert not mods & {"jax", "jaxlib", "flax", "xmtpu", "xmtpu_torch",
                       "torch"}


def test_the_command_refuses_a_host_without_the_card():
    """Here there is no card: the command exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        return  # the refusal is only observable without a card
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "podcast256.full10s", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
