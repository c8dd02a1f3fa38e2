// Biquad cascade (IIR) over rows of a signal, one dependent chain per
// row. Per section s, within one sample (v = the previous section's
// output, the input for s = 0):
//
//   y   = b0*v + z1
//   z1' = b1*v - a1*y + z2
//   z2' = b2*v - a2*y
//
// from the state zi and back to zf, both (ns, 2, R), the JAX kernel's
// own layout. Replaces the TPU kernel xmtpu/kernels/iir.py:_iir_kernel
// (reached through _sosfilt_pallas_2d, and per segment through
// _sosfilt_seg for small batches).
//
// Arithmetic: every multiply, add and subtract is a separately rounded
// __fmul_rn / __fadd_rn / __fsub_rn, in the order of the JAX kernel's
// `cascade`. nvcc would otherwise contract b0*v + z1 and its kin into
// FMAs, which round once instead of twice; without contraction the
// kernel computes bit for bit what the plain torch twin (one elementwise
// op per operation) computes, so a difference on the card is a fault,
// not rounding.
//
// What bounds it on the H100: not bytes (x in, y out: 41 MB for the
// small-batch chain's 128 x 40000 segment rows, 12 us at 3.35 TB/s)
// and not operations (9 per section per sample), but the chain. The
// loop-carried path through one section (y -> a1*y -> sub -> +z2 -> next
// y) is four operations, about 16 cycles per sample; but one thread
// issues all 9*ns operations of a sample, a warp issues at most one
// instruction per cycle, and within a sample the sections form a
// dependent path of 2*ns operations. With ns = 5 that is ~47
// instructions per sample (with the shared loads and stores); measured
// on an H100: ~70-74 cycles per sample. A row costs n times that,
// however many SMs are free; at that shape only 128 chains exist (4
// warps on a 132-SM card). The small-batch segmentation outside this
// kernel (S segments of a row run as S rows) is what shortens the
// chain; a GPU rule for S is later work.
//
// Design: one block per 32 rows, on the staging pipeline of
// csrc/row_chain.cuh (RowChain<64, 1>): warp 0 runs the cascade, one row
// per lane, every section's coefficients and states in registers (ns is
// a template parameter up to kMaxSections), on 64-sample time chunks
// that four copy warps stage with cp.async and store back, coalesced
// along time, while the cascade runs.

#include <cuda_runtime.h>

#include "row_chain.cuh"

namespace {

using Pipe = xm::RowChain<64, 1>;
constexpr int kMaxSections = 8;

template <int NS>
struct Cascade {
  float b0[NS], b1[NS], b2[NS], a1[NS], a2[NS];
  float z1[NS], z2[NS];

  __device__ __forceinline__ float step(float v) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float y = __fadd_rn(__fmul_rn(b0[s], v), z1[s]);
      z1[s] = __fadd_rn(__fsub_rn(__fmul_rn(b1[s], v), __fmul_rn(a1[s], y)),
                        z2[s]);
      z2[s] = __fsub_rn(__fmul_rn(b2[s], v), __fmul_rn(a2[s], y));
      v = y;
    }
    return v;
  }

  __device__ __forceinline__ float4 step4(float4 x) {
    float4 o;
    o.x = step(x.x);
    o.y = step(x.y);
    o.z = step(x.z);
    o.w = step(x.w);
    return o;
  }

  // One staged chunk of one row: xr -> yr.
  __device__ __forceinline__ void run(const float* __restrict__ xr,
                                      float* __restrict__ yr, int len) {
    constexpr int kChunk = Pipe::kChunk;
    if (len < kChunk) {  // the ragged last chunk
      for (int t = 0; t < len; ++t) yr[t] = step(xr[t]);
      return;
    }
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    constexpr int kQ = kChunk / 4;
    float4 a0 = x4[0], a1v = x4[1];
#pragma unroll 2
    for (int q = 0; q < kQ; q += 2) {
      const int qn = q + 2 < kQ ? q + 2 : q;  // last pair reloads itself
      const float4 n0 = x4[qn], n1 = x4[qn + 1];
      y4[q] = step4(a0);
      y4[q + 1] = step4(a1v);
      a0 = n0;
      a1v = n1;
    }
  }
};

template <int NS>
__global__ void __launch_bounds__(Pipe::kThreads)
sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
               const float* __restrict__ zi, float* __restrict__ y,
               float* __restrict__ zf, int R, int n) {
  const int r0 = blockIdx.x * Pipe::kRows;
  const int rows = min(Pipe::kRows, R - r0);
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const bool mine = warp0 && lane < rows;
  Cascade<NS> cs;
  if (warp0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {  // sos row: b0 b1 b2 a0 a1 a2
      cs.b0[s] = sos[6 * s + 0];
      cs.b1[s] = sos[6 * s + 1];
      cs.b2[s] = sos[6 * s + 2];
      cs.a1[s] = sos[6 * s + 4];
      cs.a2[s] = sos[6 * s + 5];
      cs.z1[s] = mine ? zi[static_cast<size_t>(2 * s) * R + r0 + lane] : 0.f;
      cs.z2[s] =
          mine ? zi[static_cast<size_t>(2 * s + 1) * R + r0 + lane] : 0.f;
    }
  }
  float* const out[1] = {y};
  Pipe::run(x, out, r0, rows, n, cs);
  if (mine) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      zf[static_cast<size_t>(2 * s) * R + r0 + lane] = cs.z1[s];
      zf[static_cast<size_t>(2 * s + 1) * R + r0 + lane] = cs.z2[s];
    }
  }
}

template <int NS>
int launch(const float* x, const float* sos, const float* zi, float* y,
           float* zf, int R, int n, cudaStream_t stream) {
  const int blocks = (R + Pipe::kRows - 1) / Pipe::kRows;
  sosfilt_kernel<NS><<<blocks, Pipe::kThreads, 0, stream>>>(x, sos, zi, y,
                                                            zf, R, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, n) row-major float32; sos: (ns, 6) float32 rows
// [b0 b1 b2 1 a1 a2]; zi, zf: (ns, 2, rows) state in / out. 1 <= ns <=
// kMaxSections. Launches on `stream` and returns cudaGetLastError() of
// the launch (cudaErrorInvalidValue for an ns it has no instance for).
extern "C" int xm_sosfilt_f32(const float* x, const float* sos,
                              const float* zi, float* y, float* zf, int rows,
                              int n, int ns, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxSections == 8, "one case per section count");
  switch (ns) {
    case 1: return launch<1>(x, sos, zi, y, zf, rows, n, s);
    case 2: return launch<2>(x, sos, zi, y, zf, rows, n, s);
    case 3: return launch<3>(x, sos, zi, y, zf, rows, n, s);
    case 4: return launch<4>(x, sos, zi, y, zf, rows, n, s);
    case 5: return launch<5>(x, sos, zi, y, zf, rows, n, s);
    case 6: return launch<6>(x, sos, zi, y, zf, rows, n, s);
    case 7: return launch<7>(x, sos, zi, y, zf, rows, n, s);
    case 8: return launch<8>(x, sos, zi, y, zf, rows, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
