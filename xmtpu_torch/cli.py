"""Command-line interface of the PyTorch port (counterpart of
``xmtpu.cli``; the same subcommands and arguments):

    xmtpu-torch resample in.wav out.wav --rate 16000
    xmtpu-torch mix config.json out.wav
    xmtpu-torch effects in.wav out.wav --chain fx.json
    xmtpu-torch generate config.json out.wav      # progress in percent
    xmtpu-torch batch manifest.json               # many clips (config 6)
    xmtpu-torch bench [--config N] [--profile DIR]

also as ``python -m xmtpu_torch.cli``. Every subcommand takes
``--device`` (default: the card, ``cuda``; ``--device cpu`` runs the
kernels' plain twins). Exit codes: 0 on success; 1 when a batch has a
failed clip; 2 on a typed error (bad input, a bad config, no card), a
missing file or invalid JSON, with a one-line diagnostic.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from xmtpu_torch.utils.errors import XmtpuError


def _cmd_resample(args) -> int:
    from xmtpu_torch import api
    from xmtpu_torch.io import read_wav, write_wav
    from xmtpu_torch.ops.resample import check_rates

    pcm, sr = read_wav(args.input)
    check_rates(sr, args.rate)
    t0 = time.perf_counter()
    out = api.resample(pcm, sr, args.rate, device=args.device)
    dt = time.perf_counter() - t0
    write_wav(args.output, out, args.rate)
    dur = pcm.shape[0] / sr
    print(f"resampled {dur:.2f}s {sr}->{args.rate} Hz in {dt*1e3:.1f} ms "
          f"({dur/dt:.0f}x realtime)")
    return 0


def _print_progress(pct: float) -> None:
    sys.stdout.write(f"\rprogress: {pct:5.1f}%")
    sys.stdout.flush()


def _cmd_mix(args) -> int:
    from xmtpu_torch import api
    from xmtpu_torch.config.schema import load_config

    cfg = load_config(args.config)
    api.process_file(None, cfg, args.output, progress=_print_progress,
                     device=args.device)
    print()
    return 0


def _cmd_effects(args) -> int:
    from xmtpu_torch import api
    from xmtpu_torch.config.schema import load_json_source
    from xmtpu_torch.io import read_wav, write_wav

    pcm, sr = read_wav(args.input)
    # a file path or a literal; the {"name", "params"} and flat
    # {"name", <param>...} entry forms both build
    chain = load_json_source(args.chain, what="chain")
    if isinstance(chain, dict):
        # the wrapped {"effects": [...]} form (the mixer config's)
        if "effects" not in chain:
            raise SystemExit(
                f"{args.chain}: expected a JSON list of effects or an "
                "object with an 'effects' key")
        chain = chain["effects"]
    if args.block_size < 0:
        raise SystemExit(
            f"--block-size must be > 0 (or 0 for whole-clip), got "
            f"{args.block_size}")
    bs = args.block_size if args.block_size > 0 else None
    out = api.effects(pcm, sr, chain, block_size=bs, device=args.device)
    write_wav(args.output, out, sr)
    return 0


def _cmd_bench(args) -> int:
    from xmtpu_torch import bench
    from xmtpu_torch.utils.profiling import trace

    if args.config is None:
        # one subprocess per config: each measures on a card no other
        # config has run on
        import subprocess

        rc = 0
        for k in bench.CONFIGS:
            cmd = [sys.executable, "-m", "xmtpu_torch.cli", "bench",
                   "--config", str(k)]
            if args.profile:
                cmd += ["--profile", f"{args.profile}/config{k}"]
            if args.device is not None:
                cmd += ["--device", args.device]
            rc |= subprocess.run(cmd).returncode
        return rc
    with trace(args.profile):
        res = bench.run_config(args.config, device=args.device)
    print(json.dumps(res))
    return 0


def _cmd_batch(args) -> int:
    """Batch runner: a manifest JSON [{voice, bgm?, out}, ...]."""
    from xmtpu_torch.runner import run_batch

    with open(args.manifest) as f:
        jobs = json.load(f)
    rep = run_batch(jobs, sr_in=args.sr_in, sr_bus=args.rate,
                    batch_size=args.batch_size, resume=not args.no_resume,
                    decode_threads=args.decode_threads, device=args.device)
    print(rep.to_json())
    # any failed job is a nonzero exit: 7 of 10 clips is not success
    return 1 if rep.failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="xmtpu-torch",
        description="GPU audio preprocessing (PyTorch + CUDA port of xmtpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_opt(sp):
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda; 'cpu' "
                             "runs the kernels' plain twins)")

    pr = sub.add_parser("resample", help="rate-convert a WAV file")
    pr.add_argument("input")
    pr.add_argument("output")
    pr.add_argument("--rate", type=int, required=True)
    pr.set_defaults(fn=_cmd_resample)

    pm = sub.add_parser("mix", help="mix tracks per a JSON config")
    pm.add_argument("config")
    pm.add_argument("output")
    pm.set_defaults(fn=_cmd_mix)

    pe = sub.add_parser("effects", help="apply an effect chain to a WAV")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--chain", required=True,
                    help="JSON effect chain (file path or literal JSON)")
    pe.add_argument(
        "--block-size", type=int, default=131072,
        help="process in carried-state blocks of this many samples "
             "(0 = whole clip)")
    pe.set_defaults(fn=_cmd_effects)

    pg = sub.add_parser("generate", help="one-shot: config -> mixed file")
    pg.add_argument("config")
    pg.add_argument("output")
    pg.set_defaults(fn=_cmd_mix)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("--config", type=int, default=None,
                    choices=(1, 2, 3, 4, 5, 6))
    pb.add_argument("--profile", default=None, metavar="TRACE_DIR",
                    help="write a torch.profiler Chrome trace here")
    pb.set_defaults(fn=_cmd_bench)

    pba = sub.add_parser("batch", help="run a clip manifest")
    pba.add_argument("manifest", help="JSON list of {voice, bgm?, out}")
    pba.add_argument("--sr-in", type=int, default=44100, dest="sr_in")
    pba.add_argument("--rate", type=int, default=16000)
    pba.add_argument("--batch-size", type=int, default=64, dest="batch_size")
    pba.add_argument("--no-resume", action="store_true", dest="no_resume")
    pba.add_argument("--decode-threads", type=int, default=1,
                     dest="decode_threads",
                     help="concurrent decode workers (results stay in "
                          "manifest order; outputs identical to 1)")
    pba.set_defaults(fn=_cmd_batch)

    for sp in (pr, pm, pe, pg, pb, pba):
        device_opt(sp)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except XmtpuError as e:
        # typed errors are bad input (a malformed config or chain, an
        # undecodable file) or a missing card: one line, no traceback
        print(f"xmtpu-torch: error: {e}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"xmtpu-torch: error: {e}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as e:
        fname = getattr(args, "chain", None) or getattr(
            args, "config", None) or getattr(args, "manifest", "<input>")
        print(f"xmtpu-torch: error: {fname}: invalid JSON: {e}",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
