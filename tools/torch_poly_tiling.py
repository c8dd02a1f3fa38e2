"""Sweep of the polyphase resample kernels' tiling (``csrc/polyphase.cuh``:
K7 ``xm_resample_f32``, K8 ``xm_rsmix_i16``) on one NVIDIA GPU, for the
PyTorch port.

    python3 tools/torch_poly_tiling.py [--rounds 2]

For each kernel and rate pair of ``chip_smoke.py`` phases 10-11 (K7 on
512 x 441000 float32 rows at 44.1k -> 16k and 48k -> 44.1k; K8 on two
256 x 441000 int16 tracks at 44.1k -> 16k and on a 256 x 440320 prefix
at 48k -> 44.1k), launches the built kernel with each candidate tiling
(G phases a group, F frames a lane; the pitches and shared bytes from
``kernels.resample``'s own formulas), holds every output against the
plain twin (max abs printed; a tiling that disagrees by more than
1e-4 relative fails the run) and times it back to back (CUDA events
around 10 calls after one warm-up, per call) in ``--rounds`` rounds. The
tiling ``poly_geometry`` picks is marked ``*``. The card's name and
power limit lead the output; the last line is a JSON summary. Imports
neither ``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from xmtpu_torch.kernels import _build, _seg  # noqa: E402
from xmtpu_torch.kernels import resample as kres  # noqa: E402
from xmtpu_torch.kernels import rsmix  # noqa: E402
from xmtpu_torch.ops import resample as tres  # noqa: E402

CANDIDATES = {  # (kernel, L, M) -> [(G, F), ...]
    ("K7", 160, 441): [(80, 2), (54, 4), (32, 4), (32, 2), (16, 8)],
    ("K7", 147, 160): [(147, 2), (74, 4), (74, 2), (49, 4)],
    ("K8", 160, 441): [(80, 2), (54, 2), (40, 2), (32, 4)],
    ("K8", 147, 160): [(147, 2), (74, 4), (74, 2), (49, 4)],
}


def tiling(plan, G: int, F: int, tracks: int) -> dict:
    """kernels.resample's pitch and shared bytes for a given (G, F)."""
    s = plan.col_start
    r0 = np.arange(0, plan.L, G)
    r1 = np.minimum(r0 + G, plan.L) - 1
    P = kres._pitch(int((s[r1] - s[r0]).max()) + plan.K2, plan.M, tracks)
    TP = G | 1
    return dict(G=G, F=F, P=P, TP=TP,
                smem=kres.poly_smem(G, F, P, TP, plan.K2, tracks),
                skew=kres.pair_skew(plan, G), groups=-(-plan.L // G))


def per_call_ms(fn, calls: int = 10) -> float:
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_poly_tiling: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    print(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    x = 0.3 * torch.randn(512, 441000, device=dev, generator=g)
    v = (torch.randn(256, 441000, device=dev, generator=g) * 9000).to(
        torch.int16)
    b = (torch.randn(256, 441000, device=dev, generator=g) * 7000).to(
        torch.int16)
    summary = []
    for (kern, L, M), cands in CANDIDATES.items():
        plan = tres.make_plan(L, M, 24, 9.0)
        tabs = kres.device_tables(plan, dev)
        tracks = 1 if kern == "K7" else 2
        if kern == "K7":
            R, n = x.shape
            out_len = tres.resample_output_len(n, L, M)
            ins = (x,)
            ref = tres.polyphase_resample(x, M * 100, L * 100)
        else:
            n = (441000 // M) * M if M == 441 else 160 * 2752
            vv, bb = v[:, :n].contiguous(), b[:, :n].contiguous()
            R, out_len = v.shape[0], (n // M) * L
            ins = (vv, bb)
            ref = rsmix.resample_mix_plain(vv, bb, plan, 0.4, 11025)
        nj = -(-out_len // L)
        chosen = kres.poly_geometry(plan, nj, tracks)
        y = torch.empty((R, out_len), dtype=torch.float32, device=dev)
        scale = float(ref.abs().max())
        for G, F in cands:
            t = tiling(plan, G, F, tracks)
            if t["smem"] > kres.BLOCK_BYTES:
                print(f"{kern} L={L} M={M} G={G} F={F}: {t['smem']} shared "
                      "bytes, past the budget")
                continue
            query = ("xm_resample_blocks_per_sm" if tracks == 1
                     else "xm_rsmix_blocks_per_sm")
            per_sm = _seg.card_slots(query, 0, t["smem"])[1]
            tiles = -(-nj // (32 * F))
            blocks = t["groups"] * min(R * tiles,
                                       max(1, sms * per_sm // t["groups"]))
            geo = (plan.K2, G, F, t["P"], t["TP"], t["skew"], blocks)
            if tracks == 1:
                def call(geo=geo):
                    return lib.xm_resample_f32(
                        x.data_ptr(), tabs["hsel"].data_ptr(),
                        tabs["soff"].data_ptr(), y.data_ptr(), R, n, out_len,
                        L, M, *geo, stream)
            else:
                def call(geo=geo):
                    return lib.xm_rsmix_i16(
                        ins[0].data_ptr(), ins[1].data_ptr(),
                        tabs["hsel"].data_ptr(), tabs["soff"].data_ptr(),
                        y.data_ptr(), R, n, out_len, L, M, *geo, 0.4, 11025,
                        stream)
            _build.check(call(), kern)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            if err > 1e-4 * scale:
                raise SystemExit(f"{kern} G={G} F={F}: max abs {err} against "
                                 "the twin")
            times = [per_call_ms(call) for _ in range(args.rounds)]
            mark = "*" if (G, 32 * F) == (chosen.G, chosen.frames) else " "
            print(f"{mark}{kern} L={L} M={M} G={G} F={F} pitch {t['P']} "
                  f"shared {t['smem']} blocks {blocks} paired "
                  f"{t['skew'] <= kres.PAIR_SKEW}: "
                  + ", ".join(f"{ms:.3f}" for ms in times)
                  + f" ms a call (max abs {err:.3g}) [{card}]")
            summary.append(dict(kernel=kern, L=L, M=M, G=G, F=F,
                                chosen=mark == "*", ms=times))
    print(json.dumps({"tilings": summary, "device": card}))


if __name__ == "__main__":
    main()
