// Limiter envelope over rows of a signal, in three forms:
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
//    the chain takes d = |x| of the signed input as it steps (pass A of
//    the segmented fused limiter), so |x| is never written to device
//    memory; |x| is exact, so this is bit for bit the pass over a stored
//    |x|. Its arithmetic is not contracted: __fmul_rn/__fadd_rn in the
//    order of the JAX kernel's `update`, so it computes bit for bit what
//    the plain torch twin (separate elementwise ops) computes. Form 1
//    keeps the FMA nvcc contracts a_att*e2 + c_att*env into, as it was
//    measured: it matches its twin to a gate, not bit for bit. Every form
//    propagates NaN as the JAX kernel (jnp.maximum, jnp.clip) and the
//    twins (torch.maximum, clamp_min, clamp) do: the detector's max, the
//    correction's max, the level meter's floor and form 1's ceiling
//    clamp are max.NaN.f32 / min.NaN.f32, so a NaN sample or state gives
//    NaN where the twin gives NaN (fmaxf / fminf would return the other
//    operand: a NaN product clamped to -ceiling).
// 3. The gain form (xm_envelope_gain_f32): form 2's recurrences, inline
//    correction and caller-given init, writing the soft-knee gain g =
//    exp((makeup - red) * ln10/20) of each e2 instead of e2 (_curve_gain
//    operation for operation, as form 1; no clamp, no e2 out). Replaces
//    _env_kernel / _env_blk_kernel with curve_mode="gain", as the
//    channel-linked limiter drives them
//    (xmtpu/kernels/envelope.py:_linked_seg_gain, pass B with the exact
//    carried init, and the unsegmented call of linked_limiter_pallas).
//
// What bounds it on the H100: the recurrence is sequential in time, one
// dependent chain per row, so a row costs its length times the time of
// one step however many SMs are free. A step's loop-carried path is two
// dependent operations (k_rel * env, then the max; a_att * e2, then the
// add): 8 cycles at 4 an operation; the loop alone measures 13.5 on an
// H100 (tools/torch_envelope_probe.py). The bytes (d in, e2 or g out)
// bind only when the rows fill the card. The callers shorten the chain by time
// segmentation: S segments of a row run as S rows from zero state, and
// exact cross-segment corrections (outside this kernel and in its
// corrected pass) restore the unsegmented result. S comes from the
// card's rule (kernels/_seg.py:gpu_segments) fed the SM count, the
// form's resident blocks per SM and its rows per block: the fused
// limiter by xm_limiter_blocks_per_sm and 8 rows a block (S = 32 at 256
// x 160000), the envelope() and linked_limiter() drivers by
// xm_envelope_blocks_per_sm and 32 rows a block, segments a multiple of
// 4 samples (S = 64 at 32 x 160000 and at config 3's 16 x 480000).
//
// Form 1's design: one block per kFusedRows = 8 rows. Warp 0 runs the
// recurrence, one row per lane, on time chunks staged in shared memory;
// 16 copy warps start the cp.async of chunk c+3, apply the curve to
// chunk c-1 and store it while warp 0 steps chunk c. Eight rows keep the
// copy warps' exp/log per chunk below the chain's time.
//
// Forms 2 and 3 share one core (RowCore below), designed for this card:
// - All 32 lanes of the chain warp carry rows: one block serves 32 rows,
//   so one issue slot of the chain warp advances 32 rows (form 1's
//   advances 8). The chain warp loads a staged row four samples at a
//   time (float4), applies the inline correction max(d, E * ktab[t]) in
//   registers with the chunk's ktab staged once beside the rows (all
//   lanes read the same word: a broadcast), steps, and writes e2 back in
//   place over the detector. The next 8 samples load before the current
//   8 step.
// - One thread of a TMA warp moves each time chunk in and out as 2-D
//   tensor-map boxes of 32 rows x 32 samples (cp.async.bulk.tensor, the
//   maps encoded on the host per launch), completing on one mbarrier a
//   buffer: a handful of instructions a chunk. Copies by the threads (4-
//   or 16-byte cp.async and stores by four warps) took longer a chunk
//   than the chain, and 1-D bulk copies of a row a lane serialize over
//   the lanes (PERF.md §6). The boxes land in the 128-byte
//   swizzle (16-byte unit u of row r at u ^ (r % 8)), so the float4s of
//   8 consecutive lanes cover all 32 banks. Rows past R and samples past
//   n read as zero and are not stored, so the grid's last block and the
//   ragged last chunk need no guard. Two chunks are in flight ahead of
//   the chain; a chunk's buffer takes the next load once its store has
//   read it. n % 4 != 0 or a signal off a 16-byte boundary takes 4-byte
//   cp.async by every copy thread into the same layout instead.
// - The gain form's curve warps evaluate the curve on the chunk the
//   chain has just finished while it steps the next, and the TMA thread
//   stores it one iteration later. Its logf / expf per sample outweighed
//   the chain's issue on the SM, so it takes the card's approximate
//   log2 / exp2 (FastCurve below).
// - Resident blocks per SM: four (shared memory and __launch_bounds__),
//   so every scheduler of an SM holds a chain warp when the rows fill
//   the card.
// The TPU kernel's block-8 lookahead is not used: it shortened the chain
// per vector op on the TPU; here the recurrence steps per sample, the
// same function in exact arithmetic.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "cp_async.cuh"
#include "row_chain.cuh"

namespace {

using xm::cp_async4;
using xm::cp_async_commit;
using xm::cp_async_wait;

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

// ------------------------------------------------ form 1, the fused limiter

constexpr int kFusedRows = 8;     // rows per block (lanes of warp 0)
constexpr int kChunk = 128;       // time samples per chunk
constexpr int kLd = kChunk + 4;   // row stride: 16-byte rows, float4 banks
constexpr int kCopyWarps = 16;    // warps that copy and apply
constexpr int kThreads = 32 * (1 + kCopyWarps);
constexpr int kRowsPerPass = 32 * kCopyWarps / kChunk;  // 4
constexpr int kAhead = 3;         // chunks in flight ahead of the recurrence
constexpr int kXBufs = kAhead + 2;  // + chunk c (recur) and c-1 (apply)
constexpr int kEBufs = 2;         // e2 of chunks c (written), c-1 (applied)
static_assert(32 * kCopyWarps % kChunk == 0, "copy threads tile a row");
static_assert(kFusedRows % kRowsPerPass == 0, "copy passes tile the rows");
static_assert(kFusedRows * 4 == 32 && kLd % 4 == 0,
              "float4 rows hit all banks");
static_assert(kChunk % 8 == 0, "warp 0 steps 8 samples per iteration");

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

// Detector |x| and contracted arithmetic.
struct FusedChain {
  float env, e2;
  float k_rel, a_att, c_att;

  __device__ __forceinline__ float step(float x) {
    env = xm::max_nan(fabsf(x), k_rel * env);
    e2 = a_att * e2 + c_att * env;
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

__global__ void __launch_bounds__(kThreads)
limiter_kernel(const float* __restrict__ x, const float* __restrict__ init,
               float* __restrict__ y, float* __restrict__ zf, int R, int n,
               float k_rel, float c_att, Curve cv) {
  __shared__ __align__(16) float xs[kXBufs * kFusedRows * kLd];
  __shared__ __align__(16) float es[kEBufs * kFusedRows * kLd];
  const int r0 = blockIdx.x * kFusedRows;
  const int rows = min(kFusedRows, R - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x - 32;  // copy-thread index
  const int nch = (n + kChunk - 1) / kChunk;
  auto xbuf = [&](int c) { return xs + (c % kXBufs) * kFusedRows * kLd; };
  auto ebuf = [&](int c) { return es + (c % kEBufs) * kFusedRows * kLd; };
  auto clen = [&](int c) { return min(kChunk, n - c * kChunk); };

  FusedChain ch{0.f, 0.f, k_rel, 1.f - c_att, c_att};
  if (warp == 0 && lane < rows) {
    ch.env = init[r0 + lane];
    ch.e2 = init[R + r0 + lane];
  }
  if (warp > 0) {  // prologue: chunks 0 .. kAhead-1 landed
    for (int c = 0; c < min(kAhead, nch); ++c)
      stage(x, xbuf(c), r0, rows, n, c * kChunk, clen(c), j);
    cp_async_commit();
    cp_async_wait<0>();
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
          for (int r = j / kChunk; r < rows; r += kRowsPerPass)
            y[static_cast<size_t>(r0 + r) * n + tp + t] =
                curve_apply(xb[r * kLd + t], eb[r * kLd + t], cv);
        }
      }
      // all but the newest kAhead-1 groups done: chunk c+1 has landed
      cp_async_wait<kAhead - 1>();
    }
    __syncthreads();
  }
  if (warp == 0 && lane < rows) {
    zf[r0 + lane] = ch.env;
    zf[R + r0 + lane] = ch.e2;
  }
}

// ------------------------------- forms 2 and 3: the envelope-only core

// The shape of the core's block, by the number of copy warps. A chunk's
// rows lie in kBoxes boxes of kRows rows x 32 floats (128 bytes), each
// 1024-byte aligned and laid out as the tensor maps' 128-byte swizzle
// lays them: the 16-byte unit u of row r sits at unit u ^ (r % 8), so
// the float4s of 8 consecutive lanes (rows) at one time cover all 32
// banks.
template <int kCurveWarps_, int kBoxes_>
struct RowCore {
  static constexpr int kRows = 32;          // rows per block: lanes of warp 0
  static constexpr int kBoxW = 32;          // floats per box row (128 B)
  static constexpr int kBoxes = kBoxes_;    // boxes per chunk
  static constexpr int kChunk = kBoxW * kBoxes;  // time samples per chunk
  static constexpr int kQ = kChunk / 4;     // float4s of a chunk row
  static constexpr int kBox = kRows * kBoxW;     // floats per box
  static constexpr int kBuf = kBoxes * kBox;     // floats per chunk buffer
  static constexpr int kAhead = 2;          // chunks in flight ahead
  // chunks from the chain's to the one stored: 1, or 2 when the curve
  // warps take a chunk between
  static constexpr int kLag = kCurveWarps_ > 0 ? 2 : 1;
  static constexpr int kBufs = kAhead + kLag;  // + the chain's chunk
  static constexpr int kCurve = 32 * kCurveWarps_;  // curve threads
  static constexpr int kCopy = 32 + kCurve;  // the TMA warp, curve warps
  static constexpr int kThreads = 32 + kCopy;
  // dynamic, bytes: 1024 of alignment slack, the chunk buffers, a ktab
  // chunk and an mbarrier each
  static constexpr int kSmem = 1024 + kBufs * (kBuf + kChunk) * 4 + kBufs * 8;
  static constexpr int kMinBlocks = 4;  // a chain warp per scheduler
  static_assert(kBoxW * 4 == 128 && kBox * 4 % 1024 == 0,
                "128-byte swizzled boxes on 1024-byte boundaries");
  static_assert(kQ % 2 == 0, "the chain steps 8 samples per iteration");

  // float offset of element t of row r in a chunk buffer
  static __device__ __forceinline__ int at(int r, int t) {
    return (t / kBoxW) * kBox + r * kBoxW +
           ((((t % kBoxW) >> 2) ^ (r & 7)) << 2) + (t & 3);
  }
};
// the envelope form: the TMA warp alone, chunks of 128; the gain form:
// 6 curve warps (the registers of 4 blocks per SM, unspilled), chunks
// of 96 (its fourth buffer within their shared memory)
template <bool kGain>
using CoreOf = RowCore<kGain ? 6 : 0, kGain ? 3 : 4>;

// One row's chain on the core. kCorr: the inline correction max(d,
// e_corr * kt) before the step; kAbs: the detector |d|. Every operation
// rounds alone, in the JAX kernel's order.
template <bool kCorr, bool kAbs>
struct LaneChain {
  float env, e2;
  float k_rel, a_att, c_att, e_corr;

  __device__ __forceinline__ float step(float d, float kt) {
    if constexpr (kAbs) d = fabsf(d);
    if constexpr (kCorr) d = xm::max_nan(d, __fmul_rn(e_corr, kt));
    env = xm::max_nan(d, __fmul_rn(k_rel, env));
    e2 = __fadd_rn(__fmul_rn(a_att, e2), __fmul_rn(c_att, env));
    return e2;
  }

  __device__ __forceinline__ float4 step4(float4 d, float4 kt) {
    float4 o;
    o.x = step(d.x, kt.x);
    o.y = step(d.y, kt.y);
    o.z = step(d.z, kt.z);
    o.w = step(d.w, kt.w);
    return o;
  }

  // One staged chunk of row r (this lane's) of buffer b, e2 over the
  // detector in place; kt the chunk's ktab (read with kCorr only).
  template <class C>
  __device__ __forceinline__ void run(float* b, const float* kt, int r,
                                      int len) {
    if (len < C::kChunk) {  // the ragged last chunk
      for (int t = 0; t < len; ++t) {
        float* p = b + C::at(r, t);
        *p = step(*p, kCorr ? kt[t] : 0.f);
      }
      return;
    }
    // float4 q of the row: box q / 8, unit q % 8, swizzled by r % 8
    float* row = b + r * C::kBoxW;
    const int sw = r & 7;
    auto x4 = [&](int q) {
      return reinterpret_cast<float4*>(row + (q / 8) * C::kBox +
                                       (((q % 8) ^ sw) << 2));
    };
    const float4* k4 = reinterpret_cast<const float4*>(kt);
    const float4 zero{0.f, 0.f, 0.f, 0.f};
    float4 a0 = *x4(0), a1 = *x4(1);
    float4 c0 = kCorr ? k4[0] : zero, c1 = kCorr ? k4[1] : zero;
#pragma unroll
    for (int q = 0; q < C::kQ; q += 2) {
      // the next 8 samples load before these 8 step and store
      float4 b0 = a0, b1 = a1, d0 = c0, d1 = c1;
      if (q + 2 < C::kQ) {
        b0 = *x4(q + 2);
        b1 = *x4(q + 3);
        if constexpr (kCorr) {
          d0 = k4[q + 2];
          d1 = k4[q + 3];
        }
      }
      *x4(q) = step4(a0, c0);
      *x4(q + 1) = step4(a1, c1);
      a0 = b0;
      a1 = b1;
      c0 = d0;
      c1 = d1;
    }
  }
};

// The gain form's curve: curve_gain's operations in its order, with the
// hardware's approximate log2 and exp2 (lg2.approx, ex2.approx) for
// logf / expf and a reciprocal for the knee's divide, a fraction of the
// instructions: logf / expf per sample outweighed the chain's issue on
// an SM. The approximations' relative error (~2^-22) keeps the gain far
// inside the gain form's gate against its twin (-100 dB); NaN still
// propagates through the level meter's floor.
struct FastCurve {
  float lvl2;      // 20 / ln 10 * ln 2: dB per octave of e2
  float eps, thr, half_w, slope, makeup;
  float inv_two_w;  // 1 / (2 knee_db)
  float exp2_scale;  // ln 10 / 20 / ln 2

  __device__ explicit FastCurve(const Curve& c)
      : lvl2(c.lvl_scale * 0.6931471805599453f), eps(c.eps), thr(c.thr),
        half_w(c.half_w), slope(c.slope), makeup(c.makeup),
        inv_two_w(1.f / c.two_w),
        exp2_scale(c.exp_scale * 1.4426950408889634f) {}

  // the knee's three cases as selects, so that a thread's curves
  // interleave (a NaN level takes the knee's, as curve_gain's does)
  __device__ __forceinline__ float gain(float e2) const {
    const float over = lvl2 * __log2f(xm::max_nan(e2, eps)) - thr;
    const float s = over + half_w;
    const float knee = slope * (s * s) * inv_two_w;
    const float red = over <= -half_w ? 0.f
                      : over >= half_w ? slope * over
                                       : knee;
    return exp2f((makeup - red) * exp2_scale);
  }

  __device__ __forceinline__ float4 gain4(float4 e) const {
    return float4{gain(e.x), gain(e.y), gain(e.z), gain(e.w)};
  }
};

// kGain: y = gain(e2) (form 3), else y = e2 (form 2). kCorr: the inline
// correction from ecorr (R,) and ktab (n,). kAbs (form 2, no
// correction): detector |x|. bulk: the tensor maps tx / ty of x and y
// (boxes of kRows x kBoxW, 128-byte swizzle) stage and store the
// chunks, and ktab's chunks come in one bulk copy; else (n % 4 != 0 or a
// signal off a 16-byte boundary) 4-byte cp.async per element, the same
// layout.
template <bool kGain, bool kCorr, bool kAbs>
__global__ void __launch_bounds__(CoreOf<kGain>::kThreads,
                                  CoreOf<kGain>::kMinBlocks)
row_envelope_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap ty, int bulk,
                    const float* __restrict__ x,
                    const float* __restrict__ init,
                    const float* __restrict__ ktab,
                    const float* __restrict__ ecorr, float* __restrict__ y,
                    float* __restrict__ zf, int R, int n, float k_rel,
                    float c_att, Curve cv) {
  using C = CoreOf<kGain>;
  static_assert(!kAbs || (!kGain && !kCorr),
                "the |x| detector is pass A's: no curve, no correction");
  extern __shared__ __align__(16) float smem_raw[];
  // the boxes' 1024-byte boundaries
  float* smem =
      smem_raw + ((1024 - (xm::smem_addr(smem_raw) & 1023)) & 1023) / 4;
  float* kts = smem + C::kBufs * C::kBuf;
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(kts + C::kBufs * C::kChunk);
  const int r0 = blockIdx.x * C::kRows;
  const int rows = min(C::kRows, R - r0);
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x - 32;  // copy-thread index; < 0 on warp 0
  const int nch = (n + C::kChunk - 1) / C::kChunk;
  const float* xb = x + static_cast<size_t>(r0) * n;
  float* yb = y + static_cast<size_t>(r0) * n;
  auto buf = [&](int c) { return smem + (c % C::kBufs) * C::kBuf; };
  auto ktb = [&](int c) { return kts + (c % C::kBufs) * C::kChunk; };
  auto bar = [&](int c) { return bars + c % C::kBufs; };
  auto clen = [&](int c) { return min(C::kChunk, n - c * C::kChunk); };
  auto boxes = [&](int c) { return (clen(c) + C::kBoxW - 1) / C::kBoxW; };
  const FastCurve fc(cv);

  // chunk c of the block's rows (and of ktab) into its buffer: by copy
  // thread 0, a tensor-map load a box (and one bulk copy of ktab),
  // completing on the buffer's mbarrier; else 4 bytes a copy thread
  auto stage_chunk = [&](int c) {
    float* b = buf(c);
    const int t0 = c * C::kChunk;
    const int len = clen(c);
    if (bulk) {
      xm::mbar_expect_tx(bar(c), 4u * (boxes(c) * C::kBox + kCorr * len));
      for (int k = 0; k < boxes(c); ++k)
        xm::tensor_load_2d(b + k * C::kBox, &tx, t0 + k * C::kBoxW, r0,
                           bar(c));
      if (kCorr) xm::bulk_load(ktb(c), ktab + t0, 4u * len, bar(c));
      return;
    }
    for (int i = j; i < rows * C::kChunk; i += C::kCopy) {
      const int r = i / C::kChunk, t = i % C::kChunk;
      if (t < len)
        cp_async4(b + C::at(r, t), xb + static_cast<size_t>(r) * n + t0 + t);
    }
    if constexpr (kCorr)
      for (int t = j; t < len; t += C::kCopy)
        cp_async4(ktb(c) + t, ktab + t0 + t);
  };

  // chunk c's e2 (form 3: its gain) from its buffer to y: by copy thread
  // 0, a tensor-map store a box, in one bulk group; else 4 bytes a copy
  // thread, the gain on the way
  auto store_chunk = [&](int c) {
    float* b = buf(c);
    const int t0 = c * C::kChunk;
    if (bulk) {
      for (int k = 0; k < boxes(c); ++k)
        xm::tensor_store_2d(&ty, t0 + k * C::kBoxW, r0, b + k * C::kBox);
      xm::bulk_commit();
      return;
    }
    const int len = clen(c);
    for (int i = j; i < rows * C::kChunk; i += C::kCopy) {
      const int r = i / C::kChunk, t = i % C::kChunk;
      if (t < len) {
        const float v = b[C::at(r, t)];
        yb[static_cast<size_t>(r) * n + t0 + t] = kGain ? fc.gain(v) : v;
      }
    }
  };

  // form 3, bulk: the gain of chunk c in place, by the curve threads
  // (index jc), over every slot of its boxes (a row or time outside the
  // signal holds zeros or stale values, which the store drops); a
  // thread's float4s all load before its curves, for their independence
  auto curve_chunk = [&](int c, int jc) {
    constexpr int kStep = C::kCurve > 0 ? C::kCurve : 1;
    constexpr int kPer = (C::kBuf / 4 + kStep - 1) / kStep;
    float4* p = reinterpret_cast<float4*>(buf(c)) + jc;
    const int nq = boxes(c) * C::kBox / 4 - jc;  // float4s from p on
    float4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k * kStep < nq) v[k] = p[k * kStep];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k * kStep < nq) p[k * kStep] = fc.gain4(v[k]);
  };

  LaneChain<kCorr, kAbs> ch{0.f, 0.f, k_rel, 1.f - c_att, c_att, 0.f};
  const bool live = j < 0 && lane < rows;
  if (live) {
    ch.env = init[r0 + lane];
    ch.e2 = init[R + r0 + lane];
    if constexpr (kCorr) ch.e_corr = ecorr[r0 + lane];
  }
  if (bulk && j == 0) {
    for (int c = 0; c < C::kBufs; ++c) xm::mbar_init(bars + c, 1);
    xm::mbar_init_fence();
  }
  __syncthreads();
  // prologue: chunks 0 .. kAhead-1 in flight
  if (bulk ? j == 0 : j >= 0) {
    for (int c = 0; c < C::kAhead; ++c) {
      if (c < nch) stage_chunk(c);
      if (!bulk) cp_async_commit();  // one group each
    }
    if (!bulk) cp_async_wait<C::kAhead - 1>();  // chunk 0 has landed
  }
  __syncthreads();

  // Iteration c: the chain steps chunk c; the gain form's curve warps
  // take chunk c-1; chunk c-kLag is stored and its buffer takes chunk
  // c+kAhead once the store has read it.
  for (int c = 0; c < nch + C::kLag; ++c) {
    if (j < 0) {
      if (c < nch) {
        if (bulk) xm::mbar_wait(bar(c), (c / C::kBufs) & 1);
        if (live) ch.template run<C>(buf(c), ktb(c), lane, clen(c));
        // the e2 writes before the tensor store that reads them
        if (bulk) xm::fence_proxy_async();
      }
    } else if (bulk) {
      if (j == 0) {  // the TMA warp's one thread
        if (c >= C::kLag) store_chunk(c - C::kLag);
        if (c + C::kAhead < nch) {
          xm::bulk_wait_read<0>();
          stage_chunk(c + C::kAhead);
        }
      } else if constexpr (kGain) {
        if (j >= 32 && c >= 1 && c <= nch) {  // the curve warps
          curve_chunk(c - 1, j - 32);
          // the gain writes before the tensor store that reads them
          xm::fence_proxy_async();
        }
      }
    } else {
      if (c >= C::kLag && c - C::kLag < nch) store_chunk(c - C::kLag);
      if (c + C::kAhead < nch) {
        // every copy thread's reads of the buffer done
        asm volatile("bar.sync 1, %0;" ::"n"(C::kCopy) : "memory");
        stage_chunk(c + C::kAhead);
      }
      cp_async_commit();  // one group per iteration
      // all but the newest kAhead-1 groups done: chunk c+1 has landed
      cp_async_wait<C::kAhead - 1>();
    }
    __syncthreads();
  }
  if (bulk && j == 0) xm::bulk_wait_all();
  if (live) {
    zf[r0 + lane] = ch.env;
    zf[R + r0 + lane] = ch.e2;
  }
}

// cuTensorMapEncodeTiled from the driver (no link against libcuda), or
// null.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of a row-major (R, n) float32 signal in boxes of C's
// kRows rows x kBoxW samples, 128-byte swizzle; false if it fails.
template <class C>
bool row_map(CUtensorMap* map, const float* p, int R, int n) {
  const auto encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(n),
                             static_cast<cuuint64_t>(R)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t box[2] = {C::kBoxW, C::kRows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(p), dim, stride, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kGain, bool kCorr, bool kAbs>
int launch_rows(const float* d, const float* init, const float* ktab,
                const float* ecorr, float* out, float* zf, int R, int n,
                float k_rel, float c_att, const Curve& cv,
                cudaStream_t stream) {
  using C = CoreOf<kGain>;
  auto kern = row_envelope_kernel<kGain, kCorr, kAbs>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tx{}, ty{};
  const bool bulk =
      n % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(ktab)) & 15) == 0;
  if (bulk && !(row_map<C>(&tx, d, R, n) && row_map<C>(&ty, out, R, n)))
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<(R + C::kRows - 1) / C::kRows, C::kThreads, C::kSmem, stream>>>(
      tx, ty, bulk, d, init, ktab, ecorr, out, zf, R, n, k_rel, c_att, cv);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of one instance of the core, or 0.
template <bool kGain, bool kCorr, bool kAbs>
int rows_blocks_per_sm() {
  using C = CoreOf<kGain>;
  auto kern = row_envelope_kernel<kGain, kCorr, kAbs>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, C::kThreads, C::kSmem) != cudaSuccess)
    return 0;
  return blocks;
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
  const int blocks = (R + kFusedRows - 1) / kFusedRows;
  limiter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, init, y, zf, R, n, k_rel, c_att, cv);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the fused form (the segment rule's input),
// or 0 if the query fails.
extern "C" int xm_limiter_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, limiter_kernel, kThreads, 0) != cudaSuccess)
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool corr = ktab != nullptr && ecorr != nullptr;
  if ((ktab != nullptr) != (ecorr != nullptr) || (abs_detector && corr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (abs_detector)
    return launch_rows<false, false, true>(d, init, nullptr, nullptr, e2, zf,
                                           R, n, k_rel, c_att, Curve{}, s);
  if (corr)
    return launch_rows<false, true, false>(d, init, ktab, ecorr, e2, zf, R,
                                           n, k_rel, c_att, Curve{}, s);
  return launch_rows<false, false, false>(d, init, nullptr, nullptr, e2, zf,
                                          R, n, k_rel, c_att, Curve{}, s);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ktab != nullptr && ecorr != nullptr)
    return launch_rows<true, true, false>(d, init, ktab, ecorr, g, zf, R, n,
                                          k_rel, c_att, cv, s);
  if (ktab == nullptr && ecorr == nullptr)
    return launch_rows<true, false, false>(d, init, nullptr, nullptr, g, zf,
                                           R, n, k_rel, c_att, cv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the core's form (the segment rule's input):
// form 0 the envelope-only instances, 1 the gain form's; the least over
// the form's instances, or 0 if a query fails.
extern "C" int xm_envelope_blocks_per_sm(int form) {
  if (form == 0)
    return std::min({rows_blocks_per_sm<false, false, false>(),
                     rows_blocks_per_sm<false, true, false>(),
                     rows_blocks_per_sm<false, false, true>()});
  if (form == 1)
    return std::min(rows_blocks_per_sm<true, false, false>(),
                    rows_blocks_per_sm<true, true, false>());
  return 0;
}
