"""The port's command line (``xmtpu_torch.cli``) against the JAX
package's (``xmtpu.cli``) on the CPU: every subcommand with ``--device
cpu`` (the kernels' plain twins; the JAX package as its own tests run
it, in interpret mode or on its CPU scans), in process and as
``python -m xmtpu_torch.cli`` subprocesses; the exit codes 0, 1 and 2;
``bench``'s one-subprocess-per-config sweep and ``--profile``'s trace.

One signal: a 0.25 s 440 Hz tone at 44.1 kHz (11,025 samples).
Tolerance: outputs within 1 LSB and -80 dB of the JAX package's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from xmtpu.cli import main as xmain
from xmtpu_torch.cli import main as tmain
from xmtpu_torch.io.wav import read_wav, write_wav

from . import torch_refs as refs

REPO = Path(__file__).resolve().parent.parent
SR = 44100
N = 11025


@pytest.fixture()
def tone(tmp_path):
    t = np.arange(N) / SR
    p = tmp_path / "tone.wav"
    write_wav(p, (np.sin(2 * np.pi * 440 * t) * 12000).astype(np.int16), SR)
    return str(p)


def _close(a_path, b_path, rate):
    a, sa = read_wav(a_path)
    b, sb = read_wav(b_path)
    assert sa == sb == rate and a.shape == b.shape
    lsb = int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
    db = refs.db(a, b.astype(np.float64))
    print(f"{Path(a_path).name}: {lsb} LSB, {db:.1f} dB")
    assert lsb <= 1 and db <= -80.0
    return a


def _run_module(*args):
    return subprocess.run(
        [sys.executable, "-m", "xmtpu_torch.cli", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)


def test_resample_vs_jax_in_process_and_subprocess(tone, tmp_path, capsys):
    t_out, j_out, s_out = (str(tmp_path / f"{k}.wav") for k in "tjs")
    assert tmain(["resample", tone, t_out, "--rate", "16000",
                  "--device", "cpu"]) == 0
    assert "44100->16000 Hz" in capsys.readouterr().out
    assert xmain(["resample", tone, j_out, "--rate", "16000"]) == 0
    got = _close(t_out, j_out, 16000)
    assert got.shape[0] == -(-N * 160 // 441)
    proc = _run_module("resample", tone, s_out, "--rate", "16000",
                       "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert Path(s_out).read_bytes() == Path(t_out).read_bytes()


def test_effects_vs_jax(tone, tmp_path):
    """A literal chain, the wrapped {"effects": [...]} form and flat
    params, whole clip and in blocks."""
    chain = [{"name": "equalizer", "params": {"bands": [
                 {"freq_hz": 1000.0, "gain_db": 4.0, "q": 1.0}]}},
             {"name": "volume", "gain_db": -3.0},
             {"name": "limiter", "params": {"threshold_db": -6.0}}]
    cpath = tmp_path / "chain.json"
    cpath.write_text(json.dumps({"effects": chain}))
    for k, (src, extra) in enumerate(((json.dumps(chain), []),
                                      (str(cpath), ["--block-size", "4096"]))):
        t_out, j_out = (str(tmp_path / f"{p}{k}.wav") for p in "tj")
        assert tmain(["effects", tone, t_out, "--chain", src, "--device",
                      "cpu", *extra]) == 0
        assert xmain(["effects", tone, j_out, "--chain", src, *extra]) == 0
        _close(t_out, j_out, SR)


@pytest.mark.parametrize("cmd", ["generate", "mix"])
def test_generate_vs_jax(tone, tmp_path, capsys, cmd):
    cfg = {"sampleRate": 16000, "normalize": "peak",
           "tracks": [{"url": tone, "volume": 0.8, "fadeInTimeMs": 20}],
           "masterEffects": [{"name": "limiter",
                              "params": {"threshold_db": -3.0}}]}
    cpath = tmp_path / "cfg.json"
    cpath.write_text(json.dumps(cfg))
    t_out, j_out = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    assert tmain([cmd, str(cpath), t_out, "--device", "cpu"]) == 0
    assert "progress: 100.0%" in capsys.readouterr().out
    assert xmain([cmd, str(cpath), j_out]) == 0
    _close(t_out, j_out, 16000)


def test_batch_vs_jax_and_exit_codes(tone, tmp_path):
    """``batch`` in a subprocess: exit 0 and the JAX package's bytes
    within 1 LSB; a manifest with a missing clip exits 1 (in process)."""
    jobs_t = [{"voice": tone, "out": str(tmp_path / "t0.wav")}]
    jobs_j = [{"voice": tone, "out": str(tmp_path / "j0.wav")}]
    (tmp_path / "mt.json").write_text(json.dumps(jobs_t))
    (tmp_path / "mj.json").write_text(json.dumps(jobs_j))
    proc = _run_module("batch", str(tmp_path / "mt.json"), "--batch-size",
                       "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["done"] == 1 and rep["failed"] == []
    assert xmain(["batch", str(tmp_path / "mj.json")]) == 0
    _close(jobs_t[0]["out"], jobs_j[0]["out"], 16000)
    bad = [{"voice": str(tmp_path / "missing.wav"),
            "out": str(tmp_path / "bad.wav")}]
    (tmp_path / "mb.json").write_text(json.dumps(bad))
    assert tmain(["batch", str(tmp_path / "mb.json"), "--device",
                  "cpu"]) == 1


def test_typed_errors_exit_2(tone, tmp_path, capsys, monkeypatch):
    """Bad input, a bad rate, invalid JSON, a missing file, a bench
    config that needs the card, and no card: one line on stderr, exit 2."""
    out = str(tmp_path / "o.wav")
    cases = [
        ["effects", tone, out, "--chain", "[{bad json"],
        ["effects", tone, out, "--chain", str(tmp_path / "nochain.json")],
        ["effects", tone, out, "--chain", '[{"name": "nosuchfx"}]'],
        ["resample", tone, out, "--rate", "0"],
        ["resample", str(tmp_path / "ghost.wav"), out, "--rate", "16000"],
        ["generate", str(tmp_path / "nocfg.json"), out],
        ["batch", str(tmp_path / "nomanifest.json")],
        ["bench", "--config", "1"],
    ]
    for argv in cases:
        assert tmain(argv + ["--device", "cpu"]) == 2, argv
        assert "xmtpu-torch: error:" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmain(["resample", tone, out, "--rate", "16000"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(out)
    with pytest.raises(SystemExit):
        tmain(["nosuchcommand"])


def test_bench_sweep_and_profile(tmp_path, monkeypatch, capsys):
    """``bench`` without ``--config`` runs each of the port's configs in
    its own subprocess, passing ``--profile`` and ``--device`` on; with
    one, ``--profile`` writes a torch.profiler Chrome trace."""
    from xmtpu_torch import bench
    from xmtpu_torch.utils.profiling import trace

    seen = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: (
        seen.append(cmd), subprocess.CompletedProcess(cmd, 0))[1])
    assert tmain(["bench", "--profile", str(tmp_path / "p"), "--device",
                  "cuda"]) == 0
    assert [c[c.index("--config") + 1] for c in seen] == ["1", "2", "3",
                                                          "4", "5", "6"]
    assert all(c[1:4] == ["-m", "xmtpu_torch.cli", "bench"]
               and c[-2:] == ["--device", "cuda"] for c in seen)
    assert seen[5][seen[5].index("--profile") + 1] == str(
        tmp_path / "p" / "config6")
    monkeypatch.setattr(bench, "run_config",
                        lambda k, device=None: {"config": k, "ran": device})
    assert tmain(["bench", "--config", "6", "--device", "cpu", "--profile",
                  str(tmp_path / "tr")]) == 0
    assert json.loads(capsys.readouterr().out) == {"config": 6, "ran": "cpu"}
    traces = list((tmp_path / "tr").glob("trace.*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(
        traces[0].read_text())
    with trace(None):
        pass
