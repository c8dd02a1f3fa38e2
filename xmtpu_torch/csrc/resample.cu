// Polyphase sample-rate conversion of float32 rows as a direct banded
// FIR (csrc/polyphase.cuh): out[c*L + r] = sum_k hsel[r, k] *
// x[c*M + s[r] + k], zero outside the row, at any row length.
//
// Replaces the TPU kernel xmtpu/kernels/resample.py:_resample_kernel
// (reached through _resample_pallas_2d and resample_pallas), which forms
// each frame tile in VMEM and multiplies it by the dense (width, L) band
// in two float32 dots. The band holds 24-25 non-zero taps per output
// column of its 463 rows (44.1k -> 16k), so on the card the dense form
// does about 19 times the arithmetic the function needs; the direct form
// does 2*K2 flops per output and is bound by bytes: the input read once
// and the output written once (1.23 GB for the two-track front's 512 x
// 441000 -> 512 x 160000, 0.37 ms at 3.35 TB/s). Measured there (700 W):
// 1.32-1.48 ms.

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

// x: (rows, n) float32; y: (rows, out_len) float32; hsel: (L, K2) taps;
// soff: (L,) int32 window starts relative to c*M (non-decreasing); tc:
// output frames per block; win_max: (tc-1)*M + the plan's width.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int xm_resample_f32(const float* x, const float* hsel,
                               const int* soff, float* y, int rows, int n,
                               int out_len, int L, int M, int K2, int tc,
                               int win_max, void* stream) {
  const xm::PolyGeom g{rows, n, out_len, L, M, K2, tc,
                       (L + xm::kPhaseTile - 1) / xm::kPhaseTile, win_max};
  return xm::poly_launch<float, 1>(x, nullptr, hsel, soff, y, g, Plain{},
                                   static_cast<cudaStream_t>(stream));
}
