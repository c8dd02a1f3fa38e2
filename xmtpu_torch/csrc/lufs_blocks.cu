// BS.1770's block powers over the K-weighted bus (ops/loudness.py, step
// 2), in one launch:
//
//   power[j] = sum_ch sum_{t in [j*hop, j*hop + block)} x[ch, t]^2 / block
//
// for j = 0 .. nblk-1, each square and every sum in float64 (a float32
// square of a float32 sample is exact in float64). It ports no Pallas
// kernel: the JAX package takes the powers from a float64 cumulative sum
// and a strided gather in XLA (xmtpu/ops/loudness.py), as the port did
// with torch.cumsum. That scan runs along a row, and the bus has one or
// two rows, so the card got a block or two walking 28.8 M steps each:
// 52.6 ms a call at the mix cell's 2 x 28.8 M, against 0.07 ms of bytes.
//
// What bounds it: bytes. The float32 bus is read once from device memory,
// 230.4 MB at the mix cell's shape, 0.069 ms at 3.35 TB/s; the output is
// nblk doubles. The arithmetic is a conversion and an FMA a sample.
// Design: one block of threads per 400 ms block (5,997 at the cell, about
// six waves on 132 SMs), all of its channels summed there. The blocks
// overlap by 75%, and neighbouring blockIdx run at about the same time,
// so three of a sample's four reads should come from L2. Threads read
// 16-byte vectors (a scalar head up to the row's first 16-byte boundary,
// then float4, then a scalar tail: a 100 ms hop is 4,410 samples at 44.1
// kHz, so a block may start off a boundary), four in flight a thread,
// then reduce in registers, across the warp by shuffles and across the
// warps in shared memory. Every block sums its samples in one fixed
// order and nothing is added across blocks, so the powers repeat bit for
// bit from run to run. A NaN or inf reaches only the blocks that hold
// it, where a running sum reaches every later block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double sq(float v) {
  const double d = static_cast<double>(v);
  return d * d;
}

// This thread's share of the squares of p[0 .. len-1].
__device__ __forceinline__ double row_sum(const float* __restrict__ p,
                                          int len) {
  const int head = min(
      len,
      static_cast<int>((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) /
          4);
  const int vecs = (len - head) / 4;
  const float4* pv = reinterpret_cast<const float4*>(p + head);
  double acc = 0.0;
  if (static_cast<int>(threadIdx.x) < head) acc += sq(__ldg(p + threadIdx.x));
#pragma unroll 4
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const float4 v = __ldg(pv + i);
    acc += sq(v.x);
    acc += sq(v.y);
    acc += sq(v.z);
    acc += sq(v.w);
  }
  const int tail = head + 4 * vecs;
  if (tail + static_cast<int>(threadIdx.x) < len)
    acc += sq(__ldg(p + tail + threadIdx.x));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
block_powers_kernel(const float* __restrict__ x, double* __restrict__ power,
                    int ch, long long n, int block, int hop) {
  const long long start = static_cast<long long>(blockIdx.x) * hop;
  double acc = 0.0;
  for (int c = 0; c < ch; ++c) acc += row_sum(x + c * n + start, block);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ double part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : 0.0;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) power[blockIdx.x] = acc / block;
  }
}

}  // namespace

// x: (ch, n) float32, contiguous; power: nblk float64. Block j covers
// samples [j * hop, j * hop + block) of every channel, which must lie
// inside n, with block >= 1. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int xm_lufs_blocks_f32(const float* x, double* power, int ch,
                                  long long n, int block, int hop, int nblk,
                                  void* stream) {
  if (nblk <= 0) return 0;
  block_powers_kernel<<<nblk, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, power, ch, n,
                                                             block, hop);
  return static_cast<int>(cudaGetLastError());
}
