// Limiter envelope over rows of a signal, in three forms that share one
// kernel template:
//
//   env[t] = max(d[t], k_rel * env[t-1])
//   e2[t]  = (1 - c_att) * e2[t-1] + c_att * env[t]
//
// 1. The fused soft-knee limiter (xm_limiter_f32): detector d = |x|, the
//    recurrences, then y[t] = clip(x[t] * gain(e2[t]), -ceil, ceil).
//    Replaces the TPU kernel xmtpu/kernels/envelope.py:_env_blk_kernel
//    with its in-kernel curve (_curve_gain / _curve_apply), reached
//    through limiter_pallas on its unsegmented path. The gain follows
//    _curve_gain operation for operation: level_db = (20/ln10) *
//    log(max(e2, eps)), the knee branch, exp((makeup - red) * ln10/20).
// 2. The envelope alone (xm_envelope_f32): writes e2, with an optional
//    inline segment correction d[t] -> max(d[t], E[r] * ktab[t]).
//    Replaces xmtpu/kernels/envelope.py:_env_kernel and _env_blk_kernel
//    with curve=None, as the time-segmented passes _seg_pass_a (c_att =
//    1, no correction) and _envelope_seg (k_rel = 0, corrected) drive
//    them, and the unsegmented envelope_pallas call. With abs_detector
//    the chain warp takes d = |x| of the signed input as it steps (pass
//    A of the segmented fused limiter, below), so |x| is never written
//    to device memory; |x| is exact, so this is bit for bit the pass
//    over a stored |x|. Its arithmetic is
//    not contracted: __fmul_rn/__fadd_rn in the order of the JAX
//    kernel's `update`, so it computes bit for bit what the plain torch
//    twin (separate elementwise ops) computes. Form 1 keeps the FMA nvcc
//    contracts a_att*e2 + c_att*env into, as it was measured: it matches
//    its twin to a gate, not bit for bit. Every form propagates NaN as
//    the JAX kernel (jnp.maximum, jnp.clip) and the twins (torch.maximum,
//    clamp_min, clamp) do: the detector's max, the level meter's floor
//    and form 1's ceiling clamp are max.NaN.f32 / min.NaN.f32, so a NaN
//    sample or state gives NaN where the twin gives NaN (fmaxf / fminf
//    would return the other operand: a NaN product clamped to -ceiling).
// 3. The gain form (xm_envelope_gain_f32): form 2's recurrences, inline
//    correction and caller-given init, with the copy warps writing the
//    soft-knee gain g = exp((makeup - red) * ln10/20) of each e2 instead
//    of e2 (_curve_gain operation for operation, as form 1; no clamp, no
//    e2 out). Replaces _env_kernel / _env_blk_kernel with
//    curve_mode="gain", as the channel-linked limiter drives them
//    (xmtpu/kernels/envelope.py:_linked_seg_gain, pass B with the exact
//    carried init, and the unsegmented call of linked_limiter_pallas).
//
// What bounds it on the H100: the recurrence is sequential in time, one
// dependent chain per row (a multiply and a max per sample, about 160000
// steps per row at the flagship shape), so a row costs 160000 times the
// time of one step however many SMs are free. The bytes (x and y,
// 0.33 GB at 256 rows) are not the limit, and neither should be the
// exp/log of the curve, which is independent per sample. The segmented
// forms shorten the chain: S segments of a row run as S rows from zero
// state, and exact cross-segment corrections (outside this kernel and
// in its corrected pass) restore the unsegmented result. The fused
// limiter segments so too (kernels/envelope.py:limiter): pass A is the
// envelope form with c_att = 1 and the |x| detector over the R*S
// segment rows, the exact segment states (e_in, s_in) follow in torch,
// and pass B is form 1 over the same segment rows from those states,
// which is the unsegmented recurrence in exact arithmetic. S comes from
// the row count, the SM count and this kernel's resident blocks per SM
// (xm_limiter_blocks_per_sm; kernels/_seg.py:gpu_segments), so that the
// R*S/kRows blocks fill the card: at 256 rows the unsegmented grid is 32
// blocks on 132 SMs.
//
// Design: one block per kRows rows. Warp 0 runs the recurrence, one row
// per lane, on time chunks staged in shared memory. The other warps keep
// everything else off that chain: in iteration c, while warp 0 computes
// e2 for chunk c, they start the asynchronous copy (cp.async) of chunk
// c+kAhead, apply the curve to chunk c-1 (or copy its e2 out) and store
// it, and in the corrected form apply the correction to chunk c+1 as it
// lands (each copy thread to the elements it copied itself, so its own
// cp.async wait orders the two). Copies run kAhead chunks ahead, so a
// device-memory round trip (about a microsecond) overlaps several
// iterations instead of stalling one. Both directions move the
// row-major signal with coalesced accesses, so the TPU's time-major
// transpose is not needed.
//
// A single warp is issue-bound long before its chain is latency-bound
// (measured: a loop with one 4-byte shared load and store per sample ran
// 27 cycles per sample). So warp 0 moves four samples per shared-memory
// instruction: rows are padded to kChunk+4 floats, which keeps each row
// 16-byte aligned and puts the float4 of lane r in banks 4r..4r+3, so
// the 8 lanes' loads and stores are conflict-free; the next 8 samples
// are loaded before the current 8 steps run. kRows is 8 for that reason,
// and it keeps the copy warps' curve work per chunk below the chain's
// time; at 256 rows the blocks fill 32 SMs. The TPU kernel's block-8
// lookahead is not used: it shortened the chain per vector op on the
// TPU; here the recurrence steps per sample, the same function in exact
// arithmetic.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "row_chain.cuh"

namespace {

using xm::cp_async4;
using xm::cp_async_commit;
using xm::cp_async_wait;

constexpr int kRows = 8;          // rows per block (lanes of warp 0)
constexpr int kChunk = 128;       // time samples per chunk
constexpr int kLd = kChunk + 4;   // row stride: 16-byte rows, float4 banks
constexpr int kCopyWarps = 16;    // warps that copy and apply
constexpr int kThreads = 32 * (1 + kCopyWarps);
constexpr int kRowsPerPass = 32 * kCopyWarps / kChunk;  // 4
constexpr int kAhead = 3;         // chunks in flight ahead of the recurrence
constexpr int kXBufs = kAhead + 2;  // + chunk c (recur) and c-1 (apply)
constexpr int kEBufs = 2;         // e2 of chunks c (written), c-1 (applied)
static_assert(32 * kCopyWarps % kChunk == 0, "copy threads tile a row");
static_assert(kRows % kRowsPerPass == 0, "copy passes tile the rows");
static_assert(kRows * 4 == 32 && kLd % 4 == 0, "float4 rows hit all banks");
static_assert(kChunk % 8 == 0, "warp 0 steps 8 samples per iteration");

struct Curve {
  float lvl_scale;  // 20 / ln 10
  float eps;        // level floor
  float thr;        // threshold_db
  float half_w;     // knee_db / 2
  float two_w;      // 2 * knee_db
  float slope;      // reduction slope from the ratio
  float makeup;     // makeup_db
  float exp_scale;  // ln 10 / 20
  float ceil_amp;   // ceiling amplitude
};

// The level meter's floor propagates NaN, as jnp.maximum does.
__device__ __forceinline__ float curve_gain(float e2, const Curve& c) {
  const float level = c.lvl_scale * logf(xm::max_nan(e2, c.eps));
  const float over = level - c.thr;
  float red;
  if (over <= -c.half_w) {
    red = 0.f;
  } else if (over >= c.half_w) {
    red = c.slope * over;
  } else {
    const float s = over + c.half_w;
    red = c.slope * (s * s) / c.two_w;
  }
  return expf((c.makeup - red) * c.exp_scale);
}

__device__ __forceinline__ float curve_apply(float x, float e2,
                                             const Curve& c) {
  // the clamp propagates NaN, as jnp.clip and torch.clamp do
  return xm::min_nan(xm::max_nan(x * curve_gain(e2, c), -c.ceil_amp),
                     c.ceil_amp);
}

// Copy thread j (of 32*kCopyWarps) owns column j % kChunk of rows
// j / kChunk, + kRowsPerPass, ... of one chunk.
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      float* buf, int r0, int rows, int n,
                                      int t0, int len, int j) {
  const int t = j % kChunk;
  if (t >= len) return;
  for (int r = j / kChunk; r < rows; r += kRowsPerPass)
    cp_async4(buf + r * kLd + t,
              x + static_cast<size_t>(r0 + r) * n + t0 + t);
}

// The inline segment correction on the elements copy thread j staged.
__device__ __forceinline__ void correct(float* buf,
                                        const float* __restrict__ ecorr,
                                        const float* __restrict__ ktab,
                                        int r0, int rows, int t0, int len,
                                        int j) {
  const int t = j % kChunk;
  if (t >= len) return;
  const float kt = ktab[t0 + t];
  for (int r = j / kChunk; r < rows; r += kRowsPerPass) {
    float* p = buf + r * kLd + t;
    *p = xm::max_nan(*p, __fmul_rn(ecorr[r0 + r], kt));
  }
}

// kFused: detector |x| and contracted arithmetic (the fused limiter);
// otherwise every operation rounds alone, and the detector is the input
// (kAbs: its magnitude).
template <bool kFused, bool kAbs = false>
struct Chain {
  float env, e2;
  float k_rel, a_att, c_att;

  __device__ __forceinline__ float step(float x) {
    if constexpr (kFused) {
      env = xm::max_nan(fabsf(x), k_rel * env);
      e2 = a_att * e2 + c_att * env;
    } else {
      env = xm::max_nan(kAbs ? fabsf(x) : x, __fmul_rn(k_rel, env));
      e2 = __fadd_rn(__fmul_rn(a_att, e2), __fmul_rn(c_att, env));
    }
    return e2;
  }

  __device__ __forceinline__ float4 step4(float4 x) {
    float4 o;
    o.x = step(x.x);
    o.y = step(x.y);
    o.z = step(x.z);
    o.w = step(x.w);
    return o;
  }

  // One staged chunk of one row: xr -> e2 into er.
  __device__ __forceinline__ void run(const float* __restrict__ xr,
                                      float* __restrict__ er, int len) {
    if (len < kChunk) {  // the ragged last chunk
      for (int t = 0; t < len; ++t) er[t] = step(xr[t]);
      return;
    }
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* e4 = reinterpret_cast<float4*>(er);
    constexpr int kQ = kChunk / 4;
    float4 a0 = x4[0], a1 = x4[1];
#pragma unroll 4
    for (int q = 0; q < kQ; q += 2) {
      const int qn = q + 2 < kQ ? q + 2 : q;  // last pair reloads itself
      const float4 b0 = x4[qn], b1 = x4[qn + 1];
      e4[q] = step4(a0);
      e4[q + 1] = step4(a1);
      a0 = b0;
      a1 = b1;
    }
  }
};

// The template's three forms: what y holds.
enum Form { kEnvelope, kApply, kGain };

// kApply: the fused limiter (y = curve(x, e2)); kGain: y = gain(e2);
// kEnvelope: y = e2. kCorr (not with kApply): the inline correction from
// ecorr (R,) and ktab (n,). kAbs (kEnvelope only): detector |x|.
template <int kForm, bool kCorr, bool kAbs = false>
__global__ void __launch_bounds__(kThreads)
envelope_kernel(const float* __restrict__ x, const float* __restrict__ init,
                const float* __restrict__ ktab,
                const float* __restrict__ ecorr, float* __restrict__ y,
                float* __restrict__ zf, int R, int n, float k_rel,
                float c_att, Curve cv) {
  static_assert(!(kForm == kApply && kCorr),
                "the fused curve reads the raw signal");
  static_assert(!kAbs || (kForm == kEnvelope && !kCorr),
                "the |x| detector is pass A's: no curve, no correction");
  __shared__ __align__(16) float xs[kXBufs * kRows * kLd];
  __shared__ __align__(16) float es[kEBufs * kRows * kLd];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x - 32;  // copy-thread index
  const int nch = (n + kChunk - 1) / kChunk;
  auto xbuf = [&](int c) { return xs + (c % kXBufs) * kRows * kLd; };
  auto ebuf = [&](int c) { return es + (c % kEBufs) * kRows * kLd; };
  auto clen = [&](int c) { return min(kChunk, n - c * kChunk); };

  Chain<kForm == kApply, kAbs> ch{0.f, 0.f, k_rel, 1.f - c_att, c_att};
  if (warp == 0 && lane < rows) {
    ch.env = init[r0 + lane];
    ch.e2 = init[R + r0 + lane];
  }
  if (warp > 0) {  // prologue: chunks 0 .. kAhead-1 landed
    for (int c = 0; c < min(kAhead, nch); ++c)
      stage(x, xbuf(c), r0, rows, n, c * kChunk, clen(c), j);
    cp_async_commit();
    cp_async_wait<0>();
    if constexpr (kCorr)
      correct(xbuf(0), ecorr, ktab, r0, rows, 0, clen(0), j);
  }
  __syncthreads();

  for (int c = 0; c <= nch; ++c) {
    if (warp == 0) {
      if (c < nch && lane < rows)
        ch.run(xbuf(c) + lane * kLd, ebuf(c) + lane * kLd, clen(c));
    } else {
      if (c + kAhead < nch)
        stage(x, xbuf(c + kAhead), r0, rows, n, (c + kAhead) * kChunk,
              clen(c + kAhead), j);
      cp_async_commit();  // one group per iteration, possibly empty
      if (c >= 1) {
        const int t = j % kChunk;
        const int tp = (c - 1) * kChunk;
        if (t < clen(c - 1)) {
          const float* xb = xbuf(c - 1);
          const float* eb = ebuf(c - 1);
          for (int r = j / kChunk; r < rows; r += kRowsPerPass) {
            float* yp = y + static_cast<size_t>(r0 + r) * n + tp + t;
            if constexpr (kForm == kApply)
              *yp = curve_apply(xb[r * kLd + t], eb[r * kLd + t], cv);
            else if constexpr (kForm == kGain)
              *yp = curve_gain(eb[r * kLd + t], cv);
            else
              *yp = eb[r * kLd + t];
          }
        }
      }
      // all but the newest kAhead-1 groups done: chunk c+1 has landed
      cp_async_wait<kAhead - 1>();
      if constexpr (kCorr) {
        if (c + 1 < nch)
          correct(xbuf(c + 1), ecorr, ktab, r0, rows, (c + 1) * kChunk,
                  clen(c + 1), j);
      }
    }
    __syncthreads();
  }
  if (warp == 0 && lane < rows) {
    zf[r0 + lane] = ch.env;
    zf[R + r0 + lane] = ch.e2;
  }
}

}  // namespace

// x, y: (R, n) row-major; init, zf: (2, R) = (env, e2) state in / out.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int xm_limiter_f32(const float* x, const float* init, float* y,
                              float* zf, int R, int n, float k_rel,
                              float c_att, float lvl_scale, float eps,
                              float thr, float half_w, float two_w,
                              float slope, float makeup, float exp_scale,
                              float ceil_amp, void* stream) {
  const Curve cv{lvl_scale, eps, thr, half_w, two_w,
                 slope, makeup, exp_scale, ceil_amp};
  const int blocks = (R + kRows - 1) / kRows;
  envelope_kernel<kApply, false><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, init, nullptr, nullptr, y, zf, R, n, k_rel, c_att, cv);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the fused form (the segment rule's input),
// or 0 if the query fails.
extern "C" int xm_limiter_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, envelope_kernel<kApply, false>, kThreads, 0) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// d, e2: (R, n) row-major detector in, smoothed envelope out; init, zf:
// (2, R). ktab (n,) and ecorr (R,) both null (no correction) or both
// set. abs_detector (no correction): d is a signed signal, the detector
// |d|. Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int xm_envelope_f32(const float* d, const float* init,
                               const float* ktab, const float* ecorr,
                               float* e2, float* zf, int R, int n,
                               float k_rel, float c_att, int abs_detector,
                               void* stream) {
  const int blocks = (R + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (abs_detector && (ktab != nullptr || ecorr != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (abs_detector)
    envelope_kernel<kEnvelope, false, true><<<blocks, kThreads, 0, s>>>(
        d, init, nullptr, nullptr, e2, zf, R, n, k_rel, c_att, Curve{});
  else if (ktab != nullptr && ecorr != nullptr)
    envelope_kernel<kEnvelope, true><<<blocks, kThreads, 0, s>>>(
        d, init, ktab, ecorr, e2, zf, R, n, k_rel, c_att, Curve{});
  else if (ktab == nullptr && ecorr == nullptr)
    envelope_kernel<kEnvelope, false><<<blocks, kThreads, 0, s>>>(
        d, init, nullptr, nullptr, e2, zf, R, n, k_rel, c_att, Curve{});
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The gain form: d, init, ktab, ecorr, zf as xm_envelope_f32; g (R, n)
// the soft-knee gain of each smoothed envelope sample; the curve's
// constants as xm_limiter_f32's (ceil_amp unused). Launches on `stream`
// and returns cudaGetLastError() of the launch.
extern "C" int xm_envelope_gain_f32(const float* d, const float* init,
                                    const float* ktab, const float* ecorr,
                                    float* g, float* zf, int R, int n,
                                    float k_rel, float c_att,
                                    float lvl_scale, float eps, float thr,
                                    float half_w, float two_w, float slope,
                                    float makeup, float exp_scale,
                                    float ceil_amp, void* stream) {
  const Curve cv{lvl_scale, eps, thr, half_w, two_w,
                 slope, makeup, exp_scale, ceil_amp};
  const int blocks = (R + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ktab != nullptr && ecorr != nullptr)
    envelope_kernel<kGain, true><<<blocks, kThreads, 0, s>>>(
        d, init, ktab, ecorr, g, zf, R, n, k_rel, c_att, cv);
  else if (ktab == nullptr && ecorr == nullptr)
    envelope_kernel<kGain, false><<<blocks, kThreads, 0, s>>>(
        d, init, nullptr, nullptr, g, zf, R, n, k_rel, c_att, cv);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
