// Polyphase sample-rate conversion of float32 rows as a direct banded
// FIR (csrc/polyphase.cuh): out[c*L + r] = sum_k hsel[r, k] *
// x[c*M + s[r] + k], zero outside the row, at any row length and K2.
//
// Replaces the TPU kernel xmtpu/kernels/resample.py:_resample_kernel
// (reached through _resample_pallas_2d and resample_pallas), which forms
// each frame tile in VMEM and multiplies it by the dense (width, L) band
// in two float32 dots. The band holds 24-25 non-zero taps per output
// column of its 463 rows (44.1k -> 16k), so on the card the dense form
// does about 19 times the arithmetic the function needs; the direct form
// does 2*K2 flops per output. What bounds it: bytes, the input read once
// and the output written once (1.23 GB for the two-track front's 512 x
// 441000 -> 512 x 160000, 0.37 ms at 3.35 TB/s). The window is staged
// in shared memory and read by lanes on frames at an odd pitch
// (polyphase.cuh). Measured there (700 W; PERF.md): about 1.8x that
// bound back to back.
//
// Non-finite samples: the outputs they reach are the banded twin's,
// whole frames (polyphase.cuh's header): the kernel flags the frames,
// xm_resample_nan_fixup writes the NaN.

#include <cuda_runtime.h>

#include "polyphase.cuh"

namespace {

struct Plain {
  __device__ __forceinline__ float operator()(long long,
                                              const float* acc) const {
    return acc[0];
  }
};

// NaN over the outputs the polyphase kernel's flags poison, one thread a
// (row, frame): where the twin takes its aligned branch (aligned != 0;
// n % M == 0), the frame's own samples poison all its outputs, the
// samples before it (the previous frame's tail) the phases r < r0, the
// samples after it (the next frame's head) the phases r >= r2; in the
// windowed branch any flagged sample poisons the whole frame.
__global__ void nan_fixup_kernel(const unsigned* __restrict__ flags,
                                 float* __restrict__ y, int rows, int nj,
                                 int L, int out_len, int r0, int r2,
                                 int aligned) {
  if (__ldg(flags) == 0u) return;
  const long long f = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (f >= static_cast<long long>(rows) * nj) return;
  const unsigned bits = __ldg(flags + 1 + f);
  if (bits == 0u) return;
  const int row = static_cast<int>(f / nj), c = static_cast<int>(f % nj);
  float* yr = y + static_cast<size_t>(row) * out_len;
  for (int r = 0; r < L; ++r) {
    const long long j = static_cast<long long>(c) * L + r;
    if (j >= out_len) break;
    const bool hit = !aligned || (bits & xm::kInFrame) ||
                     ((bits & xm::kBeforeFrame) && r < r0) ||
                     ((bits & xm::kAfterFrame) && r >= r2);
    if (hit) yr[j] = __int_as_float(0x7fc00000);
  }
}

}  // namespace

// x: (rows, n) float32; y: (rows, out_len) float32; hsel: (L, K2p) taps,
// K2p = K2 rounded up to a multiple of 4 (zeros past K2); soff: (L,)
// int32 window starts relative to c*M (non-decreasing); G, F, P, TP,
// pair_skew: the phase group, frames per lane, window pitch, tile pitch
// and paired phases' most window skew (kernels/resample.py
// poly_geometry); blocks: the persistent grid, a multiple of ceil(L / G);
// flags: 1 + rows * ceil(out_len / L) zeroed words, the non-finite bits
// for xm_resample_nan_fixup. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int xm_resample_f32(const float* x, const float* hsel,
                               const int* soff, float* y, int rows, int n,
                               int out_len, int L, int M, int K2, int G,
                               int F, int P, int TP, int pair_skew,
                               int blocks, unsigned* flags, void* stream) {
  const xm::PolyGeom g{rows, n, out_len, L, M, K2, G, F, P, TP, pair_skew};
  return xm::poly_launch(xm::F32Track{x}, hsel, soff, y, g, Plain{}, blocks,
                         static_cast<cudaStream_t>(stream), flags);
}

// NaN over the outputs that xm_resample_f32's flags poison (y (rows,
// out_len), nj = ceil(out_len / L) frames a row): aligned != 0 for the
// twin's aligned branch with its r0 and r2 (ops/resample.py
// aligned_tables), 0 for its windowed branch. A no-op when flags[0] is 0.
extern "C" int xm_resample_nan_fixup(const unsigned* flags, float* y,
                                     int rows, int out_len, int L, int r0,
                                     int r2, int aligned, void* stream) {
  const int nj = (out_len + L - 1) / L;
  const long long frames = static_cast<long long>(rows) * nj;
  const int threads = 256;
  const int blocks = static_cast<int>((frames + threads - 1) / threads);
  nan_fixup_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      flags, y, rows, nj, L, out_len, r0, r2, aligned);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of xm_resample_f32's kernel at `smem` bytes of
// shared memory (the persistent grid's size), 0 if the query fails.
extern "C" int xm_resample_blocks_per_sm(int smem) {
  return xm::poly_blocks_per_sm<xm::F32Track, Plain>(smem);
}
