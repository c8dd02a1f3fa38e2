"""A/B of the IIR kernel's staging depth (``csrc/iir.cu``,
``Lanes::kAhead``: time chunks of x in flight ahead of the ticks) on
one NVIDIA GPU, for the PyTorch port.

    python3 tools/torch_k5_staging_ab.py [--ahead 2,3] [--rounds 4]

Builds one copy of ``xmtpu_torch/csrc/iir.cu`` per depth, the source
unchanged but for ``kAhead`` (one section keeps 2: its 32 rows per
block leave no room for more x buffers in 48 KB of static shared
memory), into ``xmtpu_torch/_build/k5_ahead/``, one ``nvcc`` each, all
at once, and prints each build's ptxas line for the 5-section instance.
Then on the unfused step's real EQ input (32 clips of 10 s, as
``chip_smoke.py`` phase 6 makes it) cut into segment rows at the card's
rule (S = 64 on an H100) and at S = 4, each copy must equal the plain
twin (``iir.sosfilt_plain``) bit for bit at the rule's S and the first
copy at S = 4; each is then timed (CUDA events, median of 7 launches
after 2 warm-ups) in ``--rounds`` rounds whose order alternates (A B,
B A, ...), and the cycles per sample printed (ms x the card's maximum
SM clock / samples per segment row). The card's name and power limit
lead the output; the last line is a JSON summary. Imports neither
``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from xmtpu_torch import batch as tbatch  # noqa: E402
from xmtpu_torch.bench import make_inputs, median_ms  # noqa: E402
from xmtpu_torch.kernels import _build, iir  # noqa: E402

AHEAD_LINE = re.compile(r"static constexpr int kAhead = [^;]*;")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def build(aheads: list[int]) -> dict:
    """depth -> (ctypes library, ptxas line of the 5-section instance)."""
    src = (_build.SRC_DIR / "iir.cu").read_text()
    if len(AHEAD_LINE.findall(src)) != 1:
        raise SystemExit("kAhead is not defined in csrc/iir.cu once")
    out = _build.BUILD_DIR / "k5_ahead"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for a in aheads:
        cu = out / f"iir_ahead{a}.cu"
        cu.write_text(AHEAD_LINE.sub(
            f"static constexpr int kAhead = NS == 1 ? 2 : {a};", src))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-I", str(_build.SRC_DIR), "-o", str(out / f"iir_ahead{a}.so"),
               str(cu)]
        jobs[a] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
    libs = {}
    for a, proc in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed at kAhead = {a}:\n{log[-3000:]}")
        # the 5-section kernel's spill and register lines
        lines = log.splitlines()
        ptxas = next((lines[i + 2].strip() + "; "
                      + lines[i + 3].split("info    : ")[-1]
                      for i, ln in enumerate(lines)
                      if "Compiling entry function" in ln
                      and "LanesILi5E" in ln), "not found")
        lib = ctypes.CDLL(str(out / f"iir_ahead{a}.so"))
        lib.xm_sosfilt_f32.argtypes, lib.xm_sosfilt_f32.restype = (
            _build._SIGNATURES["xm_sosfilt_f32"])
        lib.xm_sosfilt_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.xm_sosfilt_blocks_per_sm.restype = ctypes.c_int
        libs[a] = (lib, ptxas)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ahead", default="2,3")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit").strip()
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    print(card)
    aheads = [int(a) for a in args.ahead.split(",")]
    libs = build(aheads)
    dev = torch.device("cuda")
    small = tbatch.make_flagship_step(device=dev)
    voice, bgm = make_inputs(32, 10.0)
    m, scale, ramp = small.front(torch.from_numpy(voice).to(dev),
                                 torch.from_numpy(bgm).to(dev))
    x_eq = m * ramp * scale[:, None]
    R, n = x_eq.shape
    sos32 = torch.as_tensor(small.sos, dtype=torch.float32, device=dev)
    ns = sos32.shape[0]
    S_rule = iir.sosfilt_segments(R, n, dev, ns)
    shapes = {S_: (x_eq.reshape(R * S_, n // S_).contiguous(),
                   torch.zeros((ns, 2, R * S_), dtype=torch.float32,
                               device=dev)) for S_ in (S_rule, 4)}

    def run(a, S_):
        xs, zi = shapes[S_]
        y = torch.empty_like(xs)
        zf = torch.empty_like(zi)
        rc = libs[a][0].xm_sosfilt_f32(
            xs.data_ptr(), sos32.data_ptr(), zi.data_ptr(), y.data_ptr(),
            zf.data_ptr(), xs.shape[0], xs.shape[1], ns,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed at kAhead = {a}: CUDA error "
                             f"{rc}")
        return y, zf

    ref = {S_rule: iir.sosfilt_plain(shapes[S_rule][0], sos32,
                                     shapes[S_rule][1]),
           4: run(aheads[0], 4)}
    for a in aheads:
        for S_, (y_r, zf_r) in ref.items():
            y, zf = run(a, S_)
            torch.cuda.synchronize()
            if not (torch.equal(y, y_r) and torch.equal(zf, zf_r)):
                raise SystemExit(f"kAhead = {a} differs at S = {S_}")
    times = {(a, S_): [] for a in aheads for S_ in shapes}
    for r in range(args.rounds):
        order = aheads if r % 2 == 0 else aheads[::-1]
        for a in order:
            for S_ in shapes:
                times[a, S_].append(median_ms(lambda a=a, S_=S_: run(a,
                                                                     S_)))
    summary = {"card": card, "sections": ns, "rows": R, "n": n,
               "variants": []}
    for a in aheads:
        lib, ptxas = libs[a]
        v = {"ahead": a, "ptxas": ptxas,
             "blocks_per_sm": lib.xm_sosfilt_blocks_per_sm(ns)}
        for S_ in shapes:
            ts = times[a, S_]
            med = float(np.median(ts))
            v[f"S{S_}_ms"] = ts
            v[f"S{S_}_cycles"] = med * 1e-3 * clock_hz / (n // S_)
        summary["variants"].append(v)
        print(f"kAhead = {a} ({v['blocks_per_sm']} blocks per SM; ptxas "
              f"{ptxas}): "
              + "; ".join(f"S = {S_} ({R * S_} x {n // S_}): "
                          + ", ".join(f"{t:.4f}" for t in times[a, S_])
                          + f" ms, {v[f'S{S_}_cycles']:.1f} cycles per "
                          "sample (median)" for S_ in shapes)
              + f" [{card}]")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
