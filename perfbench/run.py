"""Run one benchmark cell once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Without as many CUDA devices as the cell asks for, it exits with code 2
and prints no result; it never falls back to the CPU. The last lines of
standard error name each compared number with its limit; the last line
of standard output is the result's JSON object.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness

    return harness.cli(args, START)


if __name__ == "__main__":
    sys.exit(main())
