// Fused front of the flagship chain: two int16 tracks (voice, BGM) in,
// each resampled by the direct banded FIR of csrc/polyphase.cuh (read as
// int16, converted in registers), then mixed with the fade ramp and the
// BGM gain:
//
//   out[j] = ramp(j) * (v[j] + bgm_gain * b[j])
//   ramp(j) = min((j+1)/fade, 1) * clip((out_n - j)/fade, 0, 1)
//
// in int16 scale (the caller multiplies by 1/32768). The ramp is computed
// in float32 from the absolute output index, operation for operation as
// the TPU kernel computes it (the index is exact in float32 below 2^24,
// which resample_mix_supported guarantees); each multiply and add of the
// epilogue rounds on its own.
//
// Replaces the TPU kernel xmtpu/kernels/rsmix.py:_rsmix_kernel (reached
// through _rsmix_call and resample_mix_pallas). That kernel resamples
// with the frame-aligned banded tables in 3-pass bf16 matmuls, masking
// the neighbour frames at the row's ends; the direct FIR reads zeros
// outside the row, which is that masking, and sums in float32. What
// bounds it on the H100: bytes, the int16 tracks read once and the
// float32 mix written once (0.62 GB at 2 x 256 x 441000 -> 256 x 160000,
// 0.18 ms at 3.35 TB/s); the arithmetic is 4*K2 flops per output. The
// two tracks are staged as one 32-bit word per sample and decoded to
// float without I2F (polyphase.cuh), so one shared load feeds both FIRs.
// Measured there (700 W; PERF.md): about 3.7x that bound back to back.

#include <cuda_runtime.h>

#include <cstdint>

#include "polyphase.cuh"

namespace {

struct FadeMix {
  float gain;
  float fade;   // fade length in samples; 0 = no ramp
  float out_n;  // output samples per row

  __device__ __forceinline__ float operator()(long long j,
                                              const float* acc) const {
    float ramp = 1.f;
    if (fade > 0.f) {
      const float i = static_cast<float>(j);
      ramp = fminf(__fdiv_rn(__fadd_rn(i, 1.f), fade), 1.f);
      const float out = __fdiv_rn(__fsub_rn(out_n, i), fade);
      ramp = __fmul_rn(ramp, fminf(fmaxf(out, 0.f), 1.f));
    }
    return __fmul_rn(ramp, __fadd_rn(acc[0], __fmul_rn(gain, acc[1])));
  }
};

}  // namespace

// v, b: (rows, n) int16, 4-byte aligned; y: (rows, out_len) float32;
// hsel, soff, G, F, P, TP, pair_skew, blocks as for xm_resample_f32.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int xm_rsmix_i16(const int16_t* v, const int16_t* b,
                            const float* hsel, const int* soff, float* y,
                            int rows, int n, int out_len, int L, int M,
                            int K2, int G, int F, int P, int TP,
                            int pair_skew, int blocks, float bgm_gain,
                            int fade, void* stream) {
  const xm::PolyGeom g{rows, n, out_len, L, M, K2, G,
                       F, P, TP, pair_skew};
  const FadeMix ep{bgm_gain, static_cast<float>(fade),
                   static_cast<float>(out_len)};
  return xm::poly_launch(xm::I16PairTracks{v, b}, hsel, soff, y, g, ep,
                         blocks, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of xm_rsmix_i16's kernel at `smem` bytes of
// shared memory (the persistent grid's size), 0 if the query fails.
extern "C" int xm_rsmix_blocks_per_sm(int smem) {
  return xm::poly_blocks_per_sm<xm::I16PairTracks, FadeMix>(smem);
}
