"""A/B of the envelope kernel's launches (K3, K4') across source trees of
the PyTorch port, on one NVIDIA GPU.

    python3 tools/torch_envelope_ab.py TREE [TREE ...]

Runs one child process per TREE, in the order given (for example parent,
change, change, parent), each importing ``xmtpu_torch`` from TREE (so it
builds and runs that tree's kernels, into TREE/xmtpu_torch/_build), on
the same seeded operands:

- K3's launches at 32 x 160000 (the unfused step's detector shape)
  through ``envelope()`` at the tree's own default S, recorded, and the
  call;
- K2's pass A (the |x| detector) over 256 x 160000 cut at the fused
  limiter's S (``limiter_segments``);
- K6's pass B (the corrected envelope-only pass) over 256 x 160000 cut
  at the unfolded step's S (``eq_env_segments``);
- config 3's pass A and K4''s gain-form pass B through
  ``linked_limiter()`` at 16 x 480000 (the channel-linked detector of
  the JAX benchmark's config-3 input after the folded EQ + reverb IR),
  and the call.

The envelope-only launches' speed does not depend on the data, so their
operands are seeded noise; the gain form's curve branches on the level,
so K4' runs on config 3's own signal. Each launch is timed as a
CUDA-graph replay (its time on the card) and from the host (CUDA events
around one call), the median of 7 after 2 warm-ups. The card's name and
power limit come first; each child prints one JSON line (tree, S, rows,
ms); the last line is a table of every tree's numbers. Imports neither
``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from xmtpu_torch.bench import config3_inputs, median_ms
    from xmtpu_torch.graph import fx as tfx
    from xmtpu_torch.kernels import envelope, eq_env, fftconv
    from xmtpu_torch.ops import limiter

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)

    def replay_ms(fn):
        fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return median_ms(graph.replay)

    def both(fn):
        return {"card": replay_ms(fn), "host": median_ms(fn)}

    def recorded(call):
        """The one-pass launches ``call(run)`` makes, by their arguments."""
        got = []

        def run(*args, **kw):
            got.append((args, kw))
            return envelope.envelope_pass(*args, **kw)

        call(run)
        return got

    def launches(got):
        return [both(lambda a=a, kw=kw: envelope.envelope_pass(*a, **kw))
                for a, kw in got]

    out = {"tree": tree}
    # K3 at the unfused step's shape: the 16 kHz limiter's coefficients
    k16, c16 = limiter._release_coeff(100.0, 16000), limiter._attack_coeff(
        1.0, 16000)
    d = torch.from_numpy(np.abs(0.3 * rng.standard_normal((32, 160000)))
                         .astype(np.float32)).to(dev)
    got = recorded(lambda run: envelope.envelope(d, k16, c16, run=run))
    out["k3"] = {"rows": list(got[0][0][0].shape), "launches": launches(got),
                 "call": both(lambda: envelope.envelope(d, k16, c16))}
    # K2's pass A and K6's pass B over 256 x 160000 at their own rules' S
    x = torch.from_numpy((0.3 * rng.standard_normal((256, 160000)))
                         .astype(np.float32)).to(dev)
    S2 = envelope.limiter_segments(256, 160000, c16, dev)
    xs = x.reshape(256 * S2, 160000 // S2)
    z2 = torch.zeros((2, xs.shape[0]), device=dev)
    out["k2_pass_a"] = {"rows": list(xs.shape), **both(
        lambda: envelope.envelope_pass(xs, k16, 1.0, z2, abs_detector=True))}
    S6 = eq_env.eq_env_segments(256, 160000, c16, dev, 5)
    env0 = x.abs().reshape(256 * S6, 160000 // S6)
    z6 = torch.zeros((2, env0.shape[0]), device=dev)
    ktab = torch.from_numpy(envelope.seg_ktab(k16, env0.shape[1])).to(dev)
    e_in = torch.from_numpy(rng.uniform(0.0, 1.0, env0.shape[0]).astype(
        np.float32)).to(dev)
    out["k6_pass_b"] = {"rows": list(env0.shape), **both(
        lambda: envelope.envelope_pass(env0, 0.0, c16, z6, ktab, e_in))}
    del x, xs, env0
    # config 3: linked_limiter() on the folded EQ + reverb output
    x3, chain3 = config3_inputs()
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
    got = recorded(lambda run: envelope.linked_limiter(w3, k48, c48, thr,
                                                       run=run))
    out["config3"] = {
        "rows": list(got[0][0][0].shape), "launches": launches(got),
        "call": both(lambda: envelope.linked_limiter(w3, k48, c48, thr))}
    return out


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return
    trees = sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_envelope_ab: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"torch_envelope_ab: {tree} failed:\n"
                             f"{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)

    def fmt(t):
        return f"{t['card']:.4f} ({t['host']:.4f})"

    lines = ["ms on the card as graph replays (from the host):"]
    for r in runs:
        k3, c3 = r["k3"], r["config3"]
        lines.append(
            f"{r['tree']}: K3 x {len(k3['launches'])} at {k3['rows']} "
            + " + ".join(fmt(t) for t in k3["launches"])
            + f", envelope() {fmt(k3['call'])}; K2 pass A at "
            f"{r['k2_pass_a']['rows']} {fmt(r['k2_pass_a'])}; K6 pass B at "
            f"{r['k6_pass_b']['rows']} {fmt(r['k6_pass_b'])}; config 3 at "
            f"{c3['rows']}: pass A {fmt(c3['launches'][0])}, K4' pass B "
            f"{fmt(c3['launches'][1])}, linked_limiter() {fmt(c3['call'])}")
    print(" | ".join(lines))


if __name__ == "__main__":
    main()
