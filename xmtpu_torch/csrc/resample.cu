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

#include <cuda_runtime.h>

#include "polyphase.cuh"

namespace {

struct Plain {
  __device__ __forceinline__ float operator()(long long,
                                              const float* acc) const {
    return acc[0];
  }
};

}  // namespace

// x: (rows, n) float32; y: (rows, out_len) float32; hsel: (L, K2p) taps,
// K2p = K2 rounded up to a multiple of 4 (zeros past K2); soff: (L,)
// int32 window starts relative to c*M (non-decreasing); G, F, P, TP,
// pair_skew: the phase group, frames per lane, window pitch, tile pitch
// and paired phases' most window skew (kernels/resample.py
// poly_geometry); blocks: the persistent grid, a multiple of ceil(L / G).
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int xm_resample_f32(const float* x, const float* hsel,
                               const int* soff, float* y, int rows, int n,
                               int out_len, int L, int M, int K2, int G,
                               int F, int P, int TP, int pair_skew,
                               int blocks, void* stream) {
  const xm::PolyGeom g{rows, n, out_len, L, M, K2, G, F, P, TP, pair_skew};
  return xm::poly_launch(xm::F32Track{x}, hsel, soff, y, g, Plain{}, blocks,
                         static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of xm_resample_f32's kernel at `smem` bytes of
// shared memory (the persistent grid's size), 0 if the query fails.
extern "C" int xm_resample_blocks_per_sm(int smem) {
  return xm::poly_blocks_per_sm<xm::F32Track, Plain>(smem);
}
