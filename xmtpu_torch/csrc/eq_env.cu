// Fused biquad cascade (EQ) and limiter envelope over rows of a signal,
// one dependent chain per row. Per sample (v = the input):
//
//   per section s:  y = b0*v + z1;  z1' = b1*v - a1*y + z2;
//                   z2' = b2*v - a2*y;  v = y
//   env = max(|v|, k_rel * env)
//   e2  = (1 - c_att) * e2 + c_att * env
//
// emitting y (the cascade's output) and e2, from the states zi (ns, 2, R)
// and ei (2, R) = (env, e2) and back to zf and ef, the JAX kernel's own
// layouts. Replaces the TPU kernel xmtpu/kernels/eq_env.py:_eq_env_kernel
// (reached through _eq_env_2d and eq_env_pallas), which the flagship
// chain's fused branch runs when the EQ does not fold into the reverb.
//
// Arithmetic: every multiply, add and subtract is a separately rounded
// __fmul_rn / __fadd_rn / __fsub_rn, in the order of the JAX kernel's
// `fused_step`, so the kernel computes bit for bit what the plain torch
// twin (one elementwise op per operation) computes.
//
// What bounds it on the H100: the chain, as for the IIR kernel
// (csrc/iir.cu, whose design this follows). Bytes are small (x in, y and
// e2 out: 0.49 GB at 256 x 160000, 0.15 ms at 3.35 TB/s) and so are the
// operations (about 49 per sample). The JAX kernel has no time
// segmentation, so one pass over whole rows is one chain of n samples
// per row: at 256 rows, 8 warps on 8 of 132 SMs, each paying the
// per-sample issue cost (measured on an H100 at 700 W: 82-86 cycles per
// sample, the IIR kernel's 70-74 plus the envelope) for 160000 samples,
// 6.6-7.1 ms against a 1.3 ms chain bound. So kernels/eq_env.py
// segments time by the card's rule: S segments of a row run as S rows,
// which fills the card with S times shorter chains, in three launches
// of this kernel's two instances and one of the envelope kernel's:
//   pass 0, the finals-only instance (xm_eq_env_finals_f32: no envelope,
//     nothing stored but the cascade's final state): each segment's
//     zero-state final cascade state, from which the exact entering
//     states follow in float64 outside the kernel;
//   pass A, the full instance from those states with the envelope at
//     zero state and c_att = 1: y is the cascade's exact output, e2 the
//     segment's zero-state decaying max of |y|;
//   pass B, the envelope kernel's envelope-only form (csrc/envelope.cu)
//     over that max with the inline segment correction.
// xm_eq_env_blocks_per_sm gives the segment rule the full instance's
// resident blocks per SM at the section count that runs (5 at 5
// sections, so S = 32 at 256 x 160000: 256 blocks of 5000-sample
// chains). Measured there on an H100 (700 W; chip_smoke.py): pass 0
// 0.19-0.22 ms, pass A 0.31-0.34, pass B 0.30-0.33, against 6.9-7.1 ms
// for one pass over whole rows. A chain warp slows a little with a
// second block on its SM (pass A 0.30-0.33 ms at 1 block per SM,
// 0.33-0.39 at 2) and much with four (0.51-0.57), so more, narrower
// chain warps per SM would not shorten a pass.
//
// Design: K5's (csrc/iir.cu), on the same staging pipeline
// (csrc/row_chain.cuh) with two outputs: warp 0 runs the chain, one row
// per lane, every section's coefficients and states and the two envelope
// states in registers (ns is a template parameter up to kMaxSections),
// on time chunks that four copy warps stage with cp.async, storing y and
// e2 back, coalesced along time, while the chain runs. The chunk is half
// the IIR kernel's so that x, y and e2 buffers fit in 48 KB of static
// shared memory. ptxas gives it 72 registers and a 12-byte spill at 5
// sections here; a private copy of the pipeline compiled to 96 registers
// and ran a few percent faster. The finals-only instance stages x alone
// (no output buffers), so it takes the IIR kernel's 64-sample chunk.
//
// NaN: the envelope's max propagates NaN (max.NaN.f32), as the twin's
// torch.maximum and the JAX kernel's jnp.maximum do, so kernel and twin
// agree on any input, NaN included.

#include <cuda_runtime.h>

#include "row_chain.cuh"

namespace {

using Pipe = xm::RowChain<32, 2>;        // y and e2 out
using FinalsPipe = xm::RowChain<64, 0>;  // the final states only
static_assert(Pipe::kThreads == FinalsPipe::kThreads &&
                  Pipe::kRows == FinalsPipe::kRows,
              "one block shape for both instances");
constexpr int kMaxSections = 8;

// kEnv: the cascade and the envelope, emitting y and e2; otherwise the
// cascade alone, emitting nothing (its final state is the result).
template <int NS, bool kEnv>
struct EqEnv {
  float b0[NS], b1[NS], b2[NS], a1[NS], a2[NS];
  float z1[NS], z2[NS];
  float env, e2;
  float k_rel, a_att, c_att;

  // One sample: returns y, leaves the new e2 in e2.
  __device__ __forceinline__ float step(float v) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float y = __fadd_rn(__fmul_rn(b0[s], v), z1[s]);
      z1[s] = __fadd_rn(__fsub_rn(__fmul_rn(b1[s], v), __fmul_rn(a1[s], y)),
                        z2[s]);
      z2[s] = __fsub_rn(__fmul_rn(b2[s], v), __fmul_rn(a2[s], y));
      v = y;
    }
    if constexpr (kEnv) {
      env = xm::max_nan(fabsf(v), __fmul_rn(k_rel, env));
      e2 = __fadd_rn(__fmul_rn(a_att, e2), __fmul_rn(c_att, env));
    }
    return v;
  }

  __device__ __forceinline__ void step4(float4 x, float4& y, float4& e) {
    y.x = step(x.x);
    e.x = e2;
    y.y = step(x.y);
    e.y = e2;
    y.z = step(x.z);
    e.z = e2;
    y.w = step(x.w);
    e.w = e2;
  }

  // One staged chunk of one row: xr -> yr and its e2 at yr + Pipe::kBuf.
  __device__ __forceinline__ void run(const float* __restrict__ xr,
                                      float* __restrict__ yr, int len) {
    constexpr int kChunk = Pipe::kChunk;
    float* __restrict__ er = yr + Pipe::kBuf;
    if (len < kChunk) {  // the ragged last chunk
      for (int t = 0; t < len; ++t) {
        yr[t] = step(xr[t]);
        er[t] = e2;
      }
      return;
    }
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* y4 = reinterpret_cast<float4*>(yr);
    float4* e4 = reinterpret_cast<float4*>(er);
    constexpr int kQ = kChunk / 4;
    float4 p0 = x4[0], p1 = x4[1];
#pragma unroll 2
    for (int q = 0; q < kQ; q += 2) {
      const int qn = q + 2 < kQ ? q + 2 : q;  // last pair reloads itself
      const float4 n0 = x4[qn], n1 = x4[qn + 1];
      float4 ya, ea, yb, eb;  // one float4 store each
      step4(p0, ya, ea);
      step4(p1, yb, eb);
      y4[q] = ya;
      e4[q] = ea;
      y4[q + 1] = yb;
      e4[q + 1] = eb;
      p0 = n0;
      p1 = n1;
    }
  }

  // One staged chunk of one row through the cascade alone (kEnv false).
  __device__ __forceinline__ void run(const float* __restrict__ xr,
                                      int len) {
    constexpr int kChunk = FinalsPipe::kChunk;
    if (len < kChunk) {  // the ragged last chunk
      for (int t = 0; t < len; ++t) step(xr[t]);
      return;
    }
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    constexpr int kQ = kChunk / 4;
    float4 p = x4[0];
#pragma unroll 4
    for (int q = 0; q < kQ; ++q) {
      const float4 nx = x4[q + 1 < kQ ? q + 1 : q];
      step(p.x);
      step(p.y);
      step(p.z);
      step(p.w);
      p = nx;
    }
  }
};

// kEnv: y, e2 and ef from the envelope state ei (the full instance);
// otherwise only zf (the finals-only instance: y, e2, ei and ef unused).
template <int NS, bool kEnv>
__global__ void __launch_bounds__(Pipe::kThreads)
eq_env_kernel(const float* __restrict__ x, const float* __restrict__ sos,
              const float* __restrict__ zi, const float* __restrict__ ei,
              float* __restrict__ y, float* __restrict__ e2,
              float* __restrict__ zf, float* __restrict__ ef, int R, int n,
              float k_rel, float c_att) {
  const int r0 = blockIdx.x * Pipe::kRows;
  const int rows = min(Pipe::kRows, R - r0);
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const bool mine = warp0 && lane < rows;
  EqEnv<NS, kEnv> ch;
  if (warp0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {  // sos row: b0 b1 b2 a0 a1 a2
      ch.b0[s] = sos[6 * s + 0];
      ch.b1[s] = sos[6 * s + 1];
      ch.b2[s] = sos[6 * s + 2];
      ch.a1[s] = sos[6 * s + 4];
      ch.a2[s] = sos[6 * s + 5];
      ch.z1[s] = mine ? zi[static_cast<size_t>(2 * s) * R + r0 + lane] : 0.f;
      ch.z2[s] =
          mine ? zi[static_cast<size_t>(2 * s + 1) * R + r0 + lane] : 0.f;
    }
    if constexpr (kEnv) {
      ch.env = mine ? ei[r0 + lane] : 0.f;
      ch.e2 = mine ? ei[R + r0 + lane] : 0.f;
      ch.k_rel = k_rel;
      ch.a_att = 1.f - c_att;
      ch.c_att = c_att;
    }
  }
  if constexpr (kEnv) {
    float* const out[2] = {y, e2};
    Pipe::run(x, out, r0, rows, n, ch);
  } else {
    float* const none[1] = {nullptr};
    FinalsPipe::run(x, none, r0, rows, n, ch);
  }
  if (mine) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      zf[static_cast<size_t>(2 * s) * R + r0 + lane] = ch.z1[s];
      zf[static_cast<size_t>(2 * s + 1) * R + r0 + lane] = ch.z2[s];
    }
    if constexpr (kEnv) {
      ef[r0 + lane] = ch.env;
      ef[R + r0 + lane] = ch.e2;
    }
  }
}

template <int NS, bool kEnv>
int launch(const float* x, const float* sos, const float* zi,
           const float* ei, float* y, float* e2, float* zf, float* ef, int R,
           int n, float k_rel, float c_att, cudaStream_t stream) {
  const int blocks = (R + Pipe::kRows - 1) / Pipe::kRows;
  eq_env_kernel<NS, kEnv><<<blocks, Pipe::kThreads, 0, stream>>>(
      x, sos, zi, ei, y, e2, zf, ef, R, n, k_rel, c_att);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, eq_env_kernel<NS, true>, Pipe::kThreads, 0) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// One launch of the instance for ns sections.
template <bool kEnv>
int dispatch(const float* x, const float* sos, const float* zi,
             const float* ei, float* y, float* e2, float* zf, float* ef,
             int rows, int n, int ns, float k_rel, float c_att,
             cudaStream_t s) {
  static_assert(kMaxSections == 8, "one case per section count");
#define XM_EQ_ENV_CASE(k)                                                  \
  case k:                                                                  \
    return launch<k, kEnv>(x, sos, zi, ei, y, e2, zf, ef, rows, n, k_rel, \
                           c_att, s)
  switch (ns) {
    XM_EQ_ENV_CASE(1);
    XM_EQ_ENV_CASE(2);
    XM_EQ_ENV_CASE(3);
    XM_EQ_ENV_CASE(4);
    XM_EQ_ENV_CASE(5);
    XM_EQ_ENV_CASE(6);
    XM_EQ_ENV_CASE(7);
    XM_EQ_ENV_CASE(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XM_EQ_ENV_CASE
}

}  // namespace

// x, y, e2: (rows, n) row-major float32; sos: (ns, 6) float32 rows
// [b0 b1 b2 1 a1 a2]; zi, zf: (ns, 2, rows) cascade state in / out; ei,
// ef: (2, rows) = (env, e2) in / out. 1 <= ns <= kMaxSections. Launches
// on `stream` and returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for an ns it has no instance for).
extern "C" int xm_eq_env_f32(const float* x, const float* sos,
                             const float* zi, const float* ei, float* y,
                             float* e2, float* zf, float* ef, int rows, int n,
                             int ns, float k_rel, float c_att, void* stream) {
  return dispatch<true>(x, sos, zi, ei, y, e2, zf, ef, rows, n, ns, k_rel,
                        c_att, static_cast<cudaStream_t>(stream));
}

// The cascade alone, storing only its final state: x (rows, n), sos, zi
// and zf as xm_eq_env_f32's. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int xm_eq_env_finals_f32(const float* x, const float* sos,
                                    const float* zi, float* zf, int rows,
                                    int n, int ns, void* stream) {
  return dispatch<false>(x, sos, zi, nullptr, nullptr, nullptr, zf, nullptr,
                         rows, n, ns, 0.f, 0.f,
                         static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the full instance for ns sections (the
// segment rule's input), or 0 if ns has no instance or the query fails.
extern "C" int xm_eq_env_blocks_per_sm(int ns) {
  switch (ns) {
    case 1: return blocks_per_sm<1>();
    case 2: return blocks_per_sm<2>();
    case 3: return blocks_per_sm<3>();
    case 4: return blocks_per_sm<4>();
    case 5: return blocks_per_sm<5>();
    case 6: return blocks_per_sm<6>();
    case 7: return blocks_per_sm<7>();
    case 8: return blocks_per_sm<8>();
    default: return 0;
  }
}
