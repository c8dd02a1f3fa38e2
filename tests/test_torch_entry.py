"""``xmtpu_torch.entry`` against the JAX package's ``__graft_entry__``
on the CPU: the same example clips (two int16 clips of 1 s at 44.1 kHz,
bit for bit), the port's step on the kernels' plain twins against the
JAX step jitted in Pallas interpret mode, -80 dB at the int16 output,
and each clip against the float64 oracle, -80 dB. Without a card the
default device raises; the module runs as a command.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from xmtpu_torch import entry as tentry
from xmtpu_torch.batch import flagship_oracle_np
from xmtpu_torch.utils.errors import DeviceError

from . import torch_refs as refs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_on_cpu_vs_graft_entry():
    fn_j, args_j = ge.entry()
    fn_t, args_t = tentry.entry(device="cpu")
    for a_j, a_t in zip(args_j, args_t):
        assert a_t.device.type == "cpu" and a_t.dtype == torch.int16
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    y_j = np.asarray(jax.jit(fn_j)(*args_j))
    y_t = fn_t(*args_t).numpy()
    assert y_t.shape == y_j.shape == (2, 16000) and y_t.dtype == np.int16
    db = refs.db(y_t, y_j)
    print(f"entry(device='cpu') vs __graft_entry__.entry(): {db:.1f} dB")
    assert db <= -80.0
    voice, bgm = (a.numpy() for a in args_t)
    for i in range(2):
        ref = flagship_oracle_np(voice[i], bgm[i])
        dbi = refs.db(y_t[i], ref)
        print(f"entry clip {i} vs the float64 oracle: {dbi:.1f} dB")
        assert dbi <= -80.0


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match='device="cpu"'):
        tentry.entry()


def test_entry_command_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "xmtpu_torch.entry", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "entry(): OK, (2, 16000) int16"
