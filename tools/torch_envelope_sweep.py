"""S sweep of the segmented envelope (``kernels/envelope.envelope``) on
one NVIDIA GPU, at any shape and over any segment counts, for the
PyTorch port.

    python3 tools/torch_envelope_sweep.py [--shape 32x2646000] [--sr 44100]
        [--S 4,105,126,525] [--waves 2]

For each S (default: every S that divides n into segments of at least
2048 samples, a multiple of 4, whose blocks of 32 rows fit ``--waves``
waves of the card's resident slots) it prints the two core launches and
the whole ``envelope()`` call as CUDA-graph replays, the glue between
them (the call less the launches), the call from the host, and its
output against the first S's in dB (RMS error over the signal's power).
The detector is |0.3 x Gaussian| from a fixed seed; the limiter's
coefficients are the default 1 ms attack and 100 ms release at ``--sr``.
The card's name and power limit lead the output, and the last line is
the rule's pick (``envelope.envelope_segments``). Imports neither ``jax``
nor ``xmtpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from xmtpu_torch.bench import median_ms, replay_ms  # noqa: E402
from xmtpu_torch.kernels import _seg, envelope  # noqa: E402
from xmtpu_torch.ops.limiter import _attack_coeff, _release_coeff  # noqa: E402


def candidates(R: int, n: int, slots: int, waves: int) -> list[int]:
    """Every S the envelope rule may consider, up to ``waves`` waves."""
    return [s for s in range(1, n // 2048 + 1)
            if n % s == 0 and (s == 1 or (n // s) % 4 == 0)
            and -(-R * s // 32) <= waves * slots]


def sweep(R: int, n: int, sr: int, S_list, waves: int) -> None:
    dev = torch.device("cuda")
    k_rel, c_att = _release_coeff(100.0, sr), _attack_coeff(1.0, sr)
    g = torch.Generator(device=dev).manual_seed(23)
    d = (0.3 * torch.randn((R, n), generator=g, device=dev)).abs()
    sms, per_sm = _seg.card_slots("xm_envelope_blocks_per_sm",
                                  torch.cuda.current_device(), 0)
    if not S_list:
        S_list = candidates(R, n, sms * per_sm, waves)
    print(f"envelope() at {R} x {n} ({sr} Hz: k_rel {k_rel:.9f}, c_att "
          f"{c_att:.9f}, decay window {envelope._decay_cut(1 - c_att, n)}); "
          f"{sms} SMs x {per_sm} blocks; {len(S_list)} values of S",
          flush=True)
    ref = None
    for S in S_list:
        got = []

        def recording(*args, **kw):
            got.append((args, kw))
            return envelope.envelope_pass(*args, **kw)

        out = envelope.envelope(d, k_rel, c_att, segments=S,
                                run=recording)[0]
        if ref is None:
            ref, db = out, float("-inf")
        else:
            err = (out.double() - ref.double()).pow(2).mean()
            db = float(10 * torch.log10(err / ref.double().pow(2).mean()))
        del out
        launches = [replay_ms(lambda a=a, k=k: envelope.envelope_pass(*a, **k))
                    for a, k in got]
        del got

        def call(S=S):
            return envelope.envelope(d, k_rel, c_att, segments=S)

        card, host = replay_ms(call), median_ms(call)
        print(f"S = {S:5d}: {-(-R * S // 32):5d} blocks, segments of "
              f"{n // S:7d}; launches "
              + " + ".join(f"{t:.4f}" for t in launches)
              + f" = {sum(launches):.4f} ms; call {card:.4f} ms on the card "
              f"(glue {card - sum(launches):.4f}), {host:.4f} from the host;"
              f" {db:.1f} dB against S = {S_list[0]}", flush=True)
        torch.cuda.empty_cache()
    print(f"the rule's S at {R} x {n}: "
          f"{envelope.envelope_segments(R, n, dev)}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="torch_envelope_sweep")
    p.add_argument("--shape", action="append", default=None,
                   help="RxN, repeatable (default 32x2646000)")
    p.add_argument("--sr", type=int, default=44100)
    p.add_argument("--S", default="", help="comma-separated segment counts")
    p.add_argument("--waves", type=int, default=2)
    a = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    S_list = [int(s) for s in a.S.split(",") if s]
    for shape in a.shape or ["32x2646000"]:
        R, n = (int(v) for v in shape.split("x"))
        sweep(R, n, a.sr, S_list, a.waves)


if __name__ == "__main__":
    main()
