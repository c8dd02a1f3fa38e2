// The noise suppressor's PSD smoothing and Wiener gain over the spectra
// (ops/ns.py's items 3 and 4 and the product X*G) for the frozen or a
// caller's noise estimate, in two launches. It ports no Pallas kernel:
// the JAX package runs the suppressor in XLA (xmtpu/ops/ns.py, the
// smoothing as lax.associative_scan). It was added because the port's
// torch form of these steps (a log-depth scan of 14 levels of strided
// slices and concatenations, then eight elementwise passes, 166 launches
// at the voice cell's 32 x 10,337 x 257 spectra) was the largest excess
// over a bound in the benchmark.
//
// Per chain (row r, bin f) of X, (R, T, F) complex64, frames along t:
//
//   psd = re^2 + im^2;  P[t] = a P[t-1] + (1-a) psd,  P[-1] = 0
//   snr = max(P / max(noise, 1e-20) - 1, 0);  G = max(snr / (1 + snr), floor)
//   Y[t] = X[t] * G
//
// in float32 with IEEE division, the maxima propagating NaN as
// torch.clamp_min does. Y may be X itself: each element is read, then
// written by the same thread, and the suppressor overwrites its spectra
// in place (ops/ns.py), so no intermediate of the spectra's size exists.
//
// What bounds it: bytes. The spectra are read and written once: 2 x 680
// MB at the voice cell's shape, 0.41 ms at 3.35 TB/s; the arithmetic is
// about 25 operations a bin. The R*F = 8,224 chains there are far too
// few threads to keep that many bytes in flight (62 an SM), so the
// frames split into S segments of L = ceil(T / S) frames (the last one
// shorter; T = 10,337 is prime) and R*F*S threads fill the card. The
// smoothing coefficient is a constant, so the carry is exact for any
// split: with fin[s] the P reached at the end of segment s from zero,
//
//   carry[0] = 0;  carry[s] = a^L carry[s-1] + fin[s-1]
//
// Pass A (finals_kernel, S - 1 segments) reads X once and writes fin;
// pass B (wiener_kernel) runs each thread's carry over the finals before
// it (S - 1 loads and FMAs, from L2), then the segment from its carry,
// and writes Y: 3 x 680 MB in all. Bins go across threads, so a warp's
// 8-byte loads of one frame are neighbours and coalesce; frames run in a
// loop in the thread, kAhead frames' loads in flight ahead of the chain
// (one FMA a step), so the loads, not the chain, set the time. On an
// H100 at the voice cell's shape (kernels/ns.py picks about four waves
// of blocks) pass A reads at about 2.7 TB/s and pass B moves its bytes
// at about 2.4 TB/s; four frames ahead (38 registers) took 0.92 ms in
// all, sixteen 0.82, and a shared-memory ring of cp.async copies in
// place of the registers was no faster.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // chains a block, all in one segment
constexpr int kAhead = 16;     // frames a thread loads ahead of its chain

// torch.clamp_min: a NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// op(t, X[t]) for t = 0 .. len-1 in order, frame t at p[t * stride]; the
// next kAhead frames are loaded while the current ones are used.
template <class Op>
__device__ __forceinline__ void for_frames(const float2* p, int stride,
                                           int len, Op op) {
  float2 cur[kAhead], nxt[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    cur[u] = u < len ? p[u * stride] : make_float2(0.f, 0.f);
  for (int t0 = 0; t0 < len; t0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = t0 + kAhead + u;
      nxt[u] = t < len ? p[t * stride] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (t0 + u < len) op(t0 + u, cur[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
}

__device__ __forceinline__ float psd_of(float2 v) {
  return fmaf(v.x, v.x, v.y * v.y);
}

// Chain c = r * F + f of segment s starts at frame s * L of row r.
__device__ __forceinline__ size_t chain_base(int c, int s, int T, int F,
                                             int L) {
  const int r = c / F;
  return (static_cast<size_t>(r) * T + static_cast<size_t>(s) * L) * F +
         (c - r * F);
}

// Pass A: fin[s * C + c] = P at the end of segment s, from P = 0.
__global__ void __launch_bounds__(kThreads)
finals_kernel(const float2* x, float* __restrict__ fin, int C, int T, int F,
              int L, float a, float b) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int s = blockIdx.y;
  float P = 0.f;
  for_frames(x + chain_base(c, s, T, F, L), F, L,
             [&](int, float2 v) { P = fmaf(a, P, b * psd_of(v)); });
  fin[static_cast<size_t>(s) * C + c] = P;
}

// Pass B: the carry into segment s, then the segment's P, G and Y.
__global__ void __launch_bounds__(kThreads)
wiener_kernel(const float2* x, float2* y, const float* __restrict__ noise,
              const float* __restrict__ fin, int C, int T, int F, int S,
              int L, float a, float b, float aL, float gfloor) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int s = blockIdx.y;
  float P = 0.f;
#pragma unroll 8
  for (int j = 0; j < s; ++j)
    P = fmaf(aL, P, fin[static_cast<size_t>(j) * C + c]);
  const float nz = clamp_min(noise[c], 1e-20f);
  const int len = s == S - 1 ? T - s * L : L;
  const size_t base = chain_base(c, s, T, F, L);
  float2* out = y + base;
  for_frames(x + base, F, len, [&](int t, float2 v) {
    P = fmaf(a, P, b * psd_of(v));
    const float snr = clamp_min(P / nz - 1.f, 0.f);
    const float g = clamp_min(snr / (1.f + snr), gfloor);
    out[t * F] = make_float2(v.x * g, v.y * g);
  });
}

}  // namespace

// x, y: (rows, T, F) complex64 as float2, contiguous, y == x allowed (in
// place); noise: (rows, F) float32; fin: ((S - 1), rows * F) float32
// scratch (unused when S == 1); S segments of L frames, the last
// T - (S - 1) * L in [1, L]; a and b = 1 - a the smoothing, aL = a^L;
// gfloor the gain's floor; T * F < 2^31. Launches pass A (when S > 1)
// and pass B on `stream`; returns cudaGetLastError() after them.
extern "C" int xm_ns_wiener_f32(const void* x, void* y, const float* noise,
                                float* fin, int rows, int T, int F, int S,
                                int L, float a, float b, float aL,
                                float gfloor, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int C = rows * F;
  const unsigned cols = static_cast<unsigned>((C + kThreads - 1) / kThreads);
  const float2* xs = static_cast<const float2*>(x);
  if (S > 1) {
    finals_kernel<<<dim3(cols, S - 1), kThreads, 0, st>>>(xs, fin, C, T, F,
                                                          L, a, b);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wiener_kernel<<<dim3(cols, S), kThreads, 0, st>>>(
      xs, static_cast<float2*>(y), noise, fin, C, T, F, S, L, a, b, aL,
      gfloor);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of pass B on one SM (the segment rule's slots).
extern "C" int xm_ns_wiener_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wiener_kernel,
                                                    kThreads, 0) !=
      cudaSuccess)
    return 0;
  return n;
}
