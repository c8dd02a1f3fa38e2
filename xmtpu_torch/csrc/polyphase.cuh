// Direct polyphase FIR over rows of a signal, shared by the resample
// kernel (csrc/resample.cu, float32 in) and the fused int16 resample-mix
// kernel (csrc/rsmix.cu, two int16 tracks in). Output sample j = c*L + r
// of a row is the K2-tap dot
//
//   out[j] = sum_k hsel[r, k] * x[c*M + s[r] + k],   x = 0 outside [0, n)
//
// (the banded plan of ops/resample.py: s[r] = col_start[r] + base -
// pad_left, non-decreasing in r). The TPU kernels multiply frames by the
// dense (width, L) band, mostly zeros, on the MXU; here each output reads
// only its own K2 taps, so the arithmetic is the function's own (2*K2
// flops per output) and the least time is the bytes': the input read
// once and the output written once. Measured on an H100 (700 W) the two
// kernels run at 3.6-5.8x that bound; the likely limit is the shared-
// memory window loads (consecutive phases start ~M/L samples apart, about
// 3-way bank conflicts) and the taps re-read per output. Not profiled.
//
// Design: a block owns kRowsPerBlock rows, a tile of `tc` output frames
// and a tile of up to kPhaseTile phases. It stages its phases' taps
// transposed, (K2, rl), and their relative window starts in shared
// memory once, then per row stages the input window the tile needs
// ((tc-1)*M + the phases' span + K2 samples, zero-filled outside the row)
// with coalesced loads, and computes the outputs, consecutive threads on
// consecutive phases (conflict-free tap reads, coalesced stores).
// Accumulation is float32 (fmaf). Neighbouring frame tiles overlap by
// about K2 input samples, which are read twice.
#pragma once

#include <cuda_runtime.h>

namespace xm {

constexpr int kPolyThreads = 256;
constexpr int kPhaseTile = 256;   // phases per block, at most
constexpr int kRowsPerBlock = 8;  // rows a block walks with one tap table

struct PolyGeom {
  int R, n, out_len, L, M, K2;
  int tc;        // output frames per block
  int ptiles;    // phase tiles: ceil(L / kPhaseTile)
  int win_max;   // window elements per track, at most
};

// Shared memory of one block: taps (K2 x rl floats), starts (rl ints),
// then kTracks windows of win_max elements of T.
template <typename T, int kTracks>
inline size_t poly_smem_bytes(const PolyGeom& g) {
  const int rl = g.L < kPhaseTile ? g.L : kPhaseTile;
  return sizeof(float) * g.K2 * rl + sizeof(int) * rl +
         sizeof(T) * kTracks * static_cast<size_t>(g.win_max);
}

// Epilogue(j, acc) -> the stored value; acc holds kTracks sums.
template <typename T, int kTracks, typename Epilogue>
__global__ void __launch_bounds__(kPolyThreads)
polyphase_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                 const float* __restrict__ hsel, const int* __restrict__ soff,
                 float* __restrict__ out, PolyGeom g, Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rl_max = g.L < kPhaseTile ? g.L : kPhaseTile;
  float* taps = reinterpret_cast<float*>(smem);
  int* starts = reinterpret_cast<int*>(taps + g.K2 * rl_max);
  T* win = reinterpret_cast<T*>(starts + rl_max);

  const int pt = blockIdx.x % g.ptiles;
  const int ft = blockIdx.x / g.ptiles;
  const int r0 = pt * kPhaseTile;
  const int rl = min(kPhaseTile, g.L - r0);
  const int nj = (g.out_len + g.L - 1) / g.L;
  const int c0 = ft * g.tc;
  const int tc = min(g.tc, nj - c0);
  const int s0 = soff[r0];
  for (int i = threadIdx.x; i < rl * g.K2; i += blockDim.x) {
    const int rr = i / g.K2, k = i % g.K2;
    taps[k * rl + rr] = hsel[static_cast<size_t>(r0 + rr) * g.K2 + k];
  }
  for (int i = threadIdx.x; i < rl; i += blockDim.x)
    starts[i] = soff[r0 + i] - s0;
  const int span = soff[r0 + rl - 1] - s0;
  const int wlen = (tc - 1) * g.M + span + g.K2;
  const long long start = static_cast<long long>(c0) * g.M + s0;

  const int row_end = min(g.R, (blockIdx.y + 1) * kRowsPerBlock);
  for (int row = blockIdx.y * kRowsPerBlock; row < row_end; ++row) {
    __syncthreads();  // the previous row's window is consumed
    const size_t rbase = static_cast<size_t>(row) * g.n;
    for (int i = threadIdx.x; i < wlen; i += blockDim.x) {
      const long long t = start + i;
      const bool in = t >= 0 && t < g.n;
      win[i] = in ? x0[rbase + t] : T(0);
      if constexpr (kTracks == 2) win[g.win_max + i] = in ? x1[rbase + t] : T(0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tc * rl; i += blockDim.x) {
      const int cc = i / rl, rr = i % rl;
      const long long j = static_cast<long long>(c0 + cc) * g.L + r0 + rr;
      if (j >= g.out_len) continue;
      const T* w = win + cc * g.M + starts[rr];
      float acc[kTracks];
#pragma unroll
      for (int tr = 0; tr < kTracks; ++tr) acc[tr] = 0.f;
      for (int k = 0; k < g.K2; ++k) {
        const float h = taps[k * rl + rr];
#pragma unroll
        for (int tr = 0; tr < kTracks; ++tr)
          acc[tr] = fmaf(h, static_cast<float>(w[tr * g.win_max + k]),
                         acc[tr]);
      }
      out[static_cast<size_t>(row) * g.out_len + j] = ep(j, acc);
    }
  }
}

// Launch over all rows on `stream`; returns cudaGetLastError().
template <typename T, int kTracks, typename Epilogue>
int poly_launch(const T* x0, const T* x1, const float* hsel,
                const int* soff, float* out, const PolyGeom& g,
                Epilogue ep, cudaStream_t stream) {
  auto kern = polyphase_kernel<T, kTracks, Epilogue>;
  const size_t smem = poly_smem_bytes<T, kTracks>(g);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nj = (g.out_len + g.L - 1) / g.L;
  const dim3 grid(((nj + g.tc - 1) / g.tc) * g.ptiles,
                  (g.R + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kPolyThreads, smem, stream>>>(x0, x1, hsel, soff, out, g, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xm
