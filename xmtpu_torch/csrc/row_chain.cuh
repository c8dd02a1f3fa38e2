// Shared pieces of the kernels that run one dependent chain per row of a
// row-major signal (csrc/iir.cu, csrc/eq_env.cu, csrc/envelope.cu).
//
// RowChain<kChunk, kOuts> is the staging pipeline of the IIR and eq_env
// kernels: one block per kRows rows; warp 0 runs the chain, one row per
// lane, on time chunks of kChunk samples staged in shared memory. The
// other kCopyWarps warps keep device memory off that chain: in iteration
// c, while warp 0 filters chunk c, they start the asynchronous copy
// (cp.async) of chunk c+kAhead and store the kOuts outputs of chunk c-1.
// With kOuts = 0 (a chain whose final states are all it returns) nothing
// is staged out or stored.
// Both directions are coalesced along time, so no lane walks device
// memory with a stride of n. Rows are padded to kChunk+4 floats, so a
// row stays 16-byte aligned and the float4s of 8 consecutive lanes cover
// all 32 banks (conflict-free in each quarter-warp phase): warp 0 moves
// four samples per shared-memory instruction.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace xm {

// max(a, b) that returns NaN when either operand is NaN, as torch.maximum
// and jnp.maximum do (fmaxf returns the other operand): one max.NaN.f32.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// min(a, b) that returns NaN when either operand is NaN, as torch.minimum
// and jnp.minimum do (fminf returns the other operand): one min.NaN.f32.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int kChunk_, int kOuts>
struct RowChain {
  static constexpr int kChunk = kChunk_;  // time samples per chunk
  static constexpr int kRows = 32;        // rows per block (lanes of warp 0)
  static constexpr int kLd = kChunk + 4;  // row stride: 16-byte rows
  static constexpr int kCopyWarps = 4;    // warps that copy in and store out
  static constexpr int kThreads = 32 * (1 + kCopyWarps);
  static constexpr int kRowsPerPass = 32 * kCopyWarps / kChunk;
  static constexpr int kAhead = 2;        // chunks in flight ahead
  static constexpr int kXBufs = kAhead + 1;  // + chunk c (filtered)
  static constexpr int kOutBufs = 2;      // outputs of chunks c and c-1
  // floats from one output's staged row to the next output's
  static constexpr int kBuf = kRows * kLd;
  static_assert(32 * kCopyWarps % kChunk == 0, "copy threads tile a row");
  static_assert(kRows % kRowsPerPass == 0, "copy passes tile the rows");
  static_assert(kLd % 32 == 4, "float4 rows of 8 lanes hit all banks");
  static_assert(kChunk % 8 == 0, "warp 0 steps 8 samples per iteration");
  static_assert((kXBufs + kOuts * kOutBufs) * kBuf * 4 <= 48 * 1024,
                "static shared memory");

  // Copy thread j (of 32*kCopyWarps) owns column j % kChunk of rows
  // j / kChunk, + kRowsPerPass, ... of one chunk.
  static __device__ __forceinline__ void stage(const float* __restrict__ x,
                                               float* buf, int r0, int rows,
                                               int n, int t0, int len,
                                               int j) {
    const int t = j % kChunk;
    if (t >= len) return;
    for (int r = j / kChunk; r < rows; r += kRowsPerPass)
      cp_async4(buf + r * kLd + t,
                x + static_cast<size_t>(r0 + r) * n + t0 + t);
  }

  // The block's rows r0 .. r0+rows-1 of x (R, n) through the chain:
  // warp 0's lanes below `rows` call ch.run(xr, yr, len) per chunk, with
  // xr the row's staged input and yr its first staged output (output k at
  // yr + k*kBuf), and the copy warps store output k into out[k] (R, n).
  // With kOuts = 0 they call ch.run(xr, len), and `out` is one unused
  // pointer. The chain's states are the caller's, before and after.
  template <class Chain>
  static __device__ __forceinline__ void run(
      const float* __restrict__ x, float* const (&out)[kOuts > 0 ? kOuts : 1],
      int r0, int rows, int n, Chain& ch) {
    __shared__ __align__(16) float xs[kXBufs * kBuf];
    __shared__ __align__(16) float ys[kOuts > 0 ? kOutBufs * kOuts * kBuf
                                                : 1];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int j = threadIdx.x - 32;  // copy-thread index
    const int nch = (n + kChunk - 1) / kChunk;
    auto xbuf = [&](int c) { return xs + (c % kXBufs) * kBuf; };
    auto ybuf = [&](int c) { return ys + (c % kOutBufs) * kOuts * kBuf; };
    auto clen = [&](int c) { return min(kChunk, n - c * kChunk); };

    if (warp > 0) {  // prologue: chunks 0 .. kAhead-1 landed
      for (int c = 0; c < min(kAhead, nch); ++c)
        stage(x, xbuf(c), r0, rows, n, c * kChunk, clen(c), j);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int c = 0; c <= nch; ++c) {
      if (warp == 0) {
        if (c < nch && lane < rows) {
          if constexpr (kOuts > 0)
            ch.run(xbuf(c) + lane * kLd, ybuf(c) + lane * kLd, clen(c));
          else
            ch.run(xbuf(c) + lane * kLd, clen(c));
        }
      } else {
        // chunk c+kAhead reuses the buffer of chunk c-1, filtered in the
        // previous iteration
        if (c + kAhead < nch)
          stage(x, xbuf(c + kAhead), r0, rows, n, (c + kAhead) * kChunk,
                clen(c + kAhead), j);
        cp_async_commit();  // one group per iteration, possibly empty
        if (kOuts > 0 && c >= 1) {
          const int t = j % kChunk;
          const int tp = (c - 1) * kChunk;
          if (t < clen(c - 1)) {
            const float* yb = ybuf(c - 1);
            for (int r = j / kChunk; r < rows; r += kRowsPerPass) {
              const size_t o = static_cast<size_t>(r0 + r) * n + tp + t;
#pragma unroll
              for (int k = 0; k < kOuts; ++k)
                out[k][o] = yb[k * kBuf + r * kLd + t];
            }
          }
        }
        // all but the newest kAhead-1 groups done: chunk c+1 has landed
        cp_async_wait<kAhead - 1>();
      }
      __syncthreads();
    }
  }
};

}  // namespace xm
