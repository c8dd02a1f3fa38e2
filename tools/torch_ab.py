"""A/B of one kernel workload across source trees of the PyTorch port, on
one NVIDIA GPU.

    python3 tools/torch_ab.py WORKLOAD TREE [TREE ...]

Runs one child process per TREE, in the order given (for example parent,
change, change, parent), each importing ``xmtpu_torch`` from TREE (so it
builds and runs that tree's kernels, into TREE/xmtpu_torch/_build), on
the same seeded operands. WORKLOAD is one of:

- ``k7``: the resample kernel, ``kernels.resample.resample``, on the
  two-track front's real input: the root bench's 256 int16 voice and BGM
  clips of 10 s at 44.1 kHz (``bench.make_inputs``) as 512 float32 rows,
  at 44.1k -> 16k (the main path) and 48k -> 44.1k (the same rows,
  M = 160): one call, back to back (20 calls, per call) and as a
  CUDA-graph replay.
- ``envelope``: the envelope kernel's launches (K3, K4'). K3's launches
  at 32 x 160000 (the unfused step's detector shape) through
  ``envelope()`` at the tree's own default S, recorded, and the call;
  K2's pass A (the |x| detector) over 256 x 160000 cut at the fused
  limiter's S (``limiter_segments``); K6's pass B (the corrected
  envelope-only pass) over 256 x 160000 cut at the unfolded step's S
  (``eq_env_segments``); config 3's pass A and K4''s gain-form pass B
  through ``linked_limiter()`` at 16 x 480000 (the channel-linked
  detector of the JAX benchmark's config-3 input after the folded EQ +
  reverb IR), and the call. The envelope-only launches' speed does not
  depend on the data, so their operands are seeded noise; the gain
  form's curve branches on the level, so K4' runs on config 3's own
  signal. Each launch is timed as a CUDA-graph replay (``card``) and from
  the host (``host``, CUDA events around one call).
- ``steps``: the default flagship step (``make_flagship_step`` with its
  defaults on the root bench's 256 clips of 10 s: one call, and back to
  back as ``bench.step_seconds`` times it, with its audio-s/s); config
  6's ragged batch step alone (``make_batch_step``, the 64 clips' voice
  at the runner's bucket edge: one call, the median of 21, and back to
  back); and config 6 end to end (``run_batch`` on
  ``bench.config6_jobs``' 64 WAV clips of 10 s: decode, the step and the
  WAV writes on the host's clock), one cold pass and the median of five
  warm ones, in audio-s/s.

Every time is in ms, the median of 7 after 2 warm-ups. The timers and
the inputs are this checkout's (``xmtpu_torch/bench.py`` beside this
script, loaded under another name), so every tree is timed by the same
code, older trees too; the kernels are each tree's. The card's name and
power limit come first; each child prints one JSON line; the last line
is a table of every tree's numbers. Imports neither ``jax`` nor
``xmtpu``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path


def _harness():
    """This checkout's ``xmtpu_torch/bench.py`` as a module of its own
    name: it imports only numpy and torch at the top, so loading it does
    not import the ``xmtpu_torch`` package of the tree under test."""
    path = Path(__file__).resolve().parents[1] / "xmtpu_torch" / "bench.py"
    spec = importlib.util.spec_from_file_location("_ab_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k7(dev, T) -> dict:
    import torch

    from xmtpu_torch.kernels import resample as kres
    from xmtpu_torch.ops import convert

    voice, bgm = T.make_inputs(256, 10.0)
    x = convert.pcm16_to_f32(torch.cat([torch.from_numpy(voice),
                                        torch.from_numpy(bgm)]).to(dev))
    out = {}
    for label, rates in (("44.1k->16k", (44100, 16000)),
                         ("48k->44.1k", (48000, 44100))):
        def run(rates=rates):
            return kres.resample(x, *rates)

        out[label] = {"call": T.median_ms(run),
                      "back_to_back": T.back_to_back_ms(run),
                      "replay": T.replay_ms(run)}
    return out


def envelope(dev, T) -> dict:
    import numpy as np
    import torch

    from xmtpu_torch.graph import fx as tfx
    from xmtpu_torch.kernels import envelope as kenv
    from xmtpu_torch.kernels import eq_env, fftconv
    from xmtpu_torch.ops import limiter

    rng = np.random.default_rng(10)

    def both(fn):
        return {"card": T.replay_ms(fn), "host": T.median_ms(fn)}

    def recorded(call):
        """The one-pass launches ``call(run)`` makes, by their arguments."""
        got = []

        def run(*args, **kw):
            got.append((args, kw))
            return kenv.envelope_pass(*args, **kw)

        call(run)
        return got

    def launches(got):
        return [both(lambda a=a, kw=kw: kenv.envelope_pass(*a, **kw))
                for a, kw in got]

    out = {}
    # K3 at the unfused step's shape: the 16 kHz limiter's coefficients
    k16, c16 = limiter._release_coeff(100.0, 16000), limiter._attack_coeff(
        1.0, 16000)
    d = torch.from_numpy(np.abs(0.3 * rng.standard_normal((32, 160000)))
                         .astype(np.float32)).to(dev)
    got = recorded(lambda run: kenv.envelope(d, k16, c16, run=run))
    out["k3"] = {"rows": list(got[0][0][0].shape), "launches": launches(got),
                 "call": both(lambda: kenv.envelope(d, k16, c16))}
    # K2's pass A and K6's pass B over 256 x 160000 at their own rules' S
    x = torch.from_numpy((0.3 * rng.standard_normal((256, 160000)))
                         .astype(np.float32)).to(dev)
    S2 = kenv.limiter_segments(256, 160000, c16, dev)
    xs = x.reshape(256 * S2, 160000 // S2)
    z2 = torch.zeros((2, xs.shape[0]), device=dev)
    out["k2_pass_a"] = {"rows": list(xs.shape), **both(
        lambda: kenv.envelope_pass(xs, k16, 1.0, z2, abs_detector=True))}
    S6 = eq_env.eq_env_segments(256, 160000, c16, dev, 5)
    env0 = x.abs().reshape(256 * S6, 160000 // S6)
    z6 = torch.zeros((2, env0.shape[0]), device=dev)
    ktab = torch.from_numpy(kenv.seg_ktab(k16, env0.shape[1])).to(dev)
    e_in = torch.from_numpy(rng.uniform(0.0, 1.0, env0.shape[0]).astype(
        np.float32)).to(dev)
    out["k6_pass_b"] = {"rows": list(env0.shape), **both(
        lambda: kenv.envelope_pass(env0, 0.0, c16, z6, ktab, e_in))}
    del x, xs, env0
    # config 3: linked_limiter() on the folded EQ + reverb output
    x3, chain3 = T.config3_inputs()
    B3, n3, C3 = x3.shape
    folded = tfx.build_chain(48000, chain3)[0]
    rows3 = torch.from_numpy(x3).to(dev).transpose(1, 2).reshape(
        B3 * C3, n3).contiguous()
    ones_r = torch.ones(B3 * C3, device=dev)
    ones_n = torch.ones(n3, device=dev)
    w3 = fftconv.fir_convolve_plain(
        rows3, torch.from_numpy(folded.conv.ir).to(dev), ones_r,
        ones_n).reshape(B3, C3, n3)
    k48 = limiter._release_coeff(folded.lim.kw["release_ms"], 48000)
    c48 = limiter._attack_coeff(folded.lim.kw["attack_ms"], 48000)
    thr = folded.lim.kw["threshold_db"]
    got = recorded(lambda run: kenv.linked_limiter(w3, k48, c48, thr,
                                                   run=run))
    out["config3"] = {
        "rows": list(got[0][0][0].shape), "launches": launches(got),
        "call": both(lambda: kenv.linked_limiter(w3, k48, c48, thr))}
    return out


def steps(dev, T) -> dict:
    import shutil
    import tempfile

    import numpy as np
    import torch

    from xmtpu_torch import batch as tbatch
    from xmtpu_torch import runner as trunner
    from xmtpu_torch.runner import run_batch

    voice, bgm = T.make_inputs(256, 10.0)
    v, b = torch.from_numpy(voice).to(dev), torch.from_numpy(bgm).to(dev)
    step = tbatch.make_flagship_step(sr_in=T.SR_IN, sr_bus=16000, device=dev)
    sec, _ = T.step_seconds(step, v, b, iters=20)
    out = {"default_step": {"call": T.median_ms(lambda: step(v, b)),
                            "back_to_back": sec * 1e3,
                            "audio_s_per_s": 256 * 10.0 / sec}}
    del step, v, b
    n = int(T.SR_IN * 10.0)
    pcm = np.zeros((64, trunner._bucket_edge(n)), np.int16)
    pcm[:, :n] = voice[:64]
    args = (torch.from_numpy(pcm).to(dev),
            torch.zeros(pcm.shape, dtype=torch.int16, device=dev),
            torch.full((64,), n, dtype=torch.int32, device=dev))
    step6 = tbatch.make_batch_step(device=dev)
    out["config6_step"] = {"call": T.median_ms(lambda: step6(*args),
                                               runs=21),
                           "back_to_back": T.back_to_back_ms(
                               lambda: step6(*args), calls=50)}
    del step6, args
    d = tempfile.mkdtemp(prefix="xmtpu_torch_ab6_")
    try:
        jobs = T.config6_jobs(d, 64, 10.0, "wav")
        rates = []
        for _ in range(6):  # cold, then five warm passes
            rep = run_batch(jobs, sr_in=T.SR_IN, sr_bus=16000, resume=False,
                            write_done_markers=False, device=dev)
            if rep.failed:
                raise RuntimeError(f"config 6 had failures: {rep.failed}")
            rates.append(rep.audio_sec / rep.wall_sec)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["config6"] = {"warm_audio_s_per_s": float(np.median(rates[1:])),
                      "cold_audio_s_per_s": rates[0]}
    return out


WORKLOADS = {"k7": k7, "envelope": envelope, "steps": steps}


def child(workload: str, tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    return {"tree": tree,
            **WORKLOADS[workload](torch.device("cuda"), _harness())}


def main(argv) -> None:
    if len(argv) >= 3 and argv[0] == "--child":
        print(json.dumps(child(argv[1], argv[2])), flush=True)
        return
    if len(argv) < 2 or argv[0] not in WORKLOADS:
        raise SystemExit(__doc__)
    workload, trees = argv[0], argv[1:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", workload, tree],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"torch_ab: {workload} on {tree} failed:\n"
                             f"{proc.stderr[-3000:]}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"card": card, "workload": workload, "ms": rows}))


if __name__ == "__main__":
    main(sys.argv[1:])
