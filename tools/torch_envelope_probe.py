"""Cycle probes of the envelope core (``xmtpu_torch/csrc/envelope.cu``,
the envelope-only and gain forms) on one NVIDIA GPU, for the PyTorch
port.

    python3 tools/torch_envelope_probe.py

1. The chain alone: one warp steps the envelope recurrences, every
   operation rounded alone as the core's ``LaneChain`` does (a multiply
   and ``max.NaN`` on env, two multiplies and an add on e2), on
   registers for 100,000 samples, timed with ``clock64``: the floor of a
   pass's cycles per sample, whatever the staging.
2. The core's iteration: a copy of ``envelope.cu`` with ``clock64``
   reads around each role's work in the main loop (the chain warp's
   wait for its chunk, its steps and its fence; the TMA thread's stores,
   its wait for them to read shared memory and its loads; a curve
   thread's curve), summed over block 0's iterations and printed per
   chunk, at the main paths' shapes (the 32-clip step's 2,048 x 2,500,
   K2's pass A and K6's pass B at 8,192 x 5,000, config 3's 1,024 x
   7,500), each beside its pass's time as a CUDA-graph replay.

Builds under ``xmtpu_torch/_build/probe/`` (one ``nvcc`` each, at once).
The card's name and power limit lead the output. Imports neither ``jax``
nor ``xmtpu``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from xmtpu_torch.bench import median_ms  # noqa: E402
from xmtpu_torch.kernels import _build, envelope  # noqa: E402

CHAIN_CU = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include "row_chain.cuh"
__global__ void chain(const float* d, float* out, long long* cyc, int n,
                      float k, float c) {
  float env = 0.f, e2 = 0.f;
  const float a = 1.f - c, x = d[threadIdx.x];
  const long long t0 = clock64();
#pragma unroll 8
  for (int t = 0; t < n; ++t) {
    const float dd = x + t * 1e-7f;  // off the chain
    env = xm::max_nan(dd, __fmul_rn(k, env));
    e2 = __fadd_rn(__fmul_rn(a, e2), __fmul_rn(c, env));
  }
  const long long t1 = clock64();
  out[threadIdx.x] = env + e2;
  if (threadIdx.x == 0) *cyc = t1 - t0;
}
int main() {
  float *d, *o;
  long long *cy, h = 0;
  cudaMalloc(&d, 128); cudaMalloc(&o, 128); cudaMalloc(&cy, 8);
  cudaMemset(d, 0, 128);
  const int n = 100000;
  for (int rep = 0; rep < 3; ++rep) {
    chain<<<1, 32>>>(d, o, cy, n, 0.999f, 0.02f);
    cudaMemcpy(&h, cy, 8, cudaMemcpyDeviceToHost);
  }
  printf("%.2f\n", double(h) / n);
  return cudaGetLastError() != cudaSuccess;
}
"""

# the main loop's roles, timed: (text in envelope.cu, text with clock64)
LOOP = [
    ("""    if (j < 0) {
      if (c < nch) {
        if (bulk) xm::mbar_wait(bar(c), (c / C::kBufs) & 1);
        if (live) ch.template run<C>(buf(c), ktb(c), lane, clen(c));
        // the e2 writes before the tensor store that reads them
        if (bulk) xm::fence_proxy_async();
      }""",
     """    if (j < 0) {
      if (c < nch) {
        const long long t0 = clock64();
        if (bulk) xm::mbar_wait(bar(c), (c / C::kBufs) & 1);
        const long long t1 = clock64();
        if (live) ch.template run<C>(buf(c), ktb(c), lane, clen(c));
        const long long t2 = clock64();
        // the e2 writes before the tensor store that reads them
        if (bulk) xm::fence_proxy_async();
        acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += clock64() - t2;
      }"""),
    ("""        if (c >= C::kLag) store_chunk(c - C::kLag);
        if (c + C::kAhead < nch) {
          xm::bulk_wait_read<0>();
          stage_chunk(c + C::kAhead);
        }""",
     """        const long long t0 = clock64();
        if (c >= C::kLag) store_chunk(c - C::kLag);
        const long long t1 = clock64();
        long long t2 = t1;
        if (c + C::kAhead < nch) {
          xm::bulk_wait_read<0>();
          t2 = clock64();
          stage_chunk(c + C::kAhead);
        }
        acc[3] += t1 - t0; acc[4] += t2 - t1; acc[5] += clock64() - t2;"""),
    ("""          curve_chunk(c - 1, j - 32);""",
     """          const long long t0 = clock64();
          curve_chunk(c - 1, j - 32);
          acc[6] += clock64() - t0;"""),
    ("""  for (int c = 0; c < nch + C::kLag; ++c) {""",
     """  long long acc[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int c = 0; c < nch + C::kLag; ++c) {"""),
    ("""  if (bulk && j == 0) xm::bulk_wait_all();""",
     """  if (blockIdx.x == 0 && (j == -32 || j == 0 || j == 32)) {
    const int o = j < 0 ? 0 : j == 0 ? 3 : 6;
    for (int k = o; k < (j < 0 ? 3 : j == 0 ? 6 : 7); ++k)
      g_probe[k] = acc[k] / nch;
  }
  if (bulk && j == 0) xm::bulk_wait_all();"""),
    ("""namespace {

using xm::cp_async4;""",
     """__device__ long long g_probe[7];
extern "C" void xm_probe(long long* out) {
  cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
namespace {

using xm::cp_async4;"""),
]
ROLES = ("chain: wait", "steps", "fence", "TMA: stores", "read wait",
         "loads", "curve")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def build() -> tuple[str, ctypes.CDLL]:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.SRC_DIR / "envelope.cu").read_text()
    for old, new in LOOP:
        if src.count(old) != 1:
            raise SystemExit(f"torch_envelope_probe: envelope.cu changed; "
                             f"not found once:\n{old}")
        src = src.replace(old, new)
    (out / "envelope_probe.cu").write_text(src)
    (out / "chain.cu").write_text(CHAIN_CU)
    nvcc, inc = _build._nvcc(), ["-I", str(_build.SRC_DIR)]
    jobs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in ([nvcc, *_build.NVCC_FLAGS, *inc, "-o",
                         str(out / "chain"), str(out / "chain.cu")],
                        [nvcc, *_build.NVCC_FLAGS, *inc, "-shared", "-o",
                         str(out / "envelope_probe.so"),
                         str(out / "envelope_probe.cu")])]
    for proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"torch_envelope_probe: nvcc failed:\n"
                             f"{log[-3000:]}")
    lib = ctypes.CDLL(str(out / "envelope_probe.so"))
    for name in ("xm_envelope_f32", "xm_envelope_gain_f32"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    lib.xm_probe.argtypes, lib.xm_probe.restype = [ctypes.c_void_p], None
    chain = subprocess.run([str(out / "chain")], capture_output=True,
                           text=True, check=True).stdout.strip()
    return chain, lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_envelope_probe: no CUDA device")
    print(smi("name,power.limit"), flush=True)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    chain, lib = build()
    print(f"the chain alone (one warp, registers, clock64): {chain} cycles "
          "per sample", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    k_rel, c_att = 0.99979, 0.0206
    consts = envelope.curve_consts(envelope.curve_of(-3.0))
    for R, n, form in ((2048, 2500, "plain"), (2048, 2500, "corrected"),
                       (8192, 5000, "|x|"), (8192, 5000, "corrected"),
                       (1024, 7500, "plain"), (1024, 7500, "gain")):
        x = torch.from_numpy((0.6 * rng.standard_normal((R, n))).astype(
            np.float32)).to(dev)
        d = x if form == "|x|" else x.abs()
        z = torch.zeros((2, R), device=dev)
        kt = torch.from_numpy(envelope.seg_ktab(k_rel, n)).to(dev)
        e_in = torch.from_numpy(rng.uniform(0.0, 1.0, R).astype(
            np.float32)).to(dev)
        out = torch.empty_like(d)
        zf = torch.empty_like(z)
        corr = form in ("corrected", "gain")
        ptrs = (d.data_ptr(), z.data_ptr(), kt.data_ptr() if corr else None,
                e_in.data_ptr() if corr else None, out.data_ptr(),
                zf.data_ptr())

        def launch():
            s = torch.cuda.current_stream().cuda_stream
            if form == "gain":
                return lib.xm_envelope_gain_f32(*ptrs, R, n, 0.0, c_att,
                                                *consts, s)
            return lib.xm_envelope_f32(*ptrs, R, n, 0.0 if corr else k_rel,
                                       1.0 if form == "|x|" else c_att,
                                       int(form == "|x|"), s)

        if launch() != 0:
            raise SystemExit(f"torch_envelope_probe: launch failed ({form})")
        torch.cuda.synchronize()
        acc = (ctypes.c_longlong * 7)()
        lib.xm_probe(acc)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launch()
        ms = median_ms(graph.replay)
        roles = [f"{r} {v}" for r, v in zip(ROLES, acc)
                 if form == "gain" or r != "curve"]
        print(f"{form} pass {R} x {n}: {ms:.4f} ms as a graph replay "
              f"({ms * 1e-3 * clock_hz / n:.1f} cycles per sample); per "
              f"chunk of block 0, cycles: " + ", ".join(roles), flush=True)


if __name__ == "__main__":
    main()
