// The mixer's side-chain duck (ops/mix.py duck_gain_block and duck_apply)
// in float64, over (R, n) float32 rows s of the side chain:
//
//   env[t] = max(|s[t]|, k env[t-1])            (the release's decaying max)
//   e2[t]  = (1 - c) e2[t-1] + c env[t]         (the attack's one-pole)
//   x      = clamp((20 log10(max(e2, 1e-12)) - threshold)/knee + 0.5, 0, 1)
//   g      = 10^(-depth x / 20)
//
// from a state (env[-1], e2[-1]) a row (zeros when none is given), with
// c = 1 the identity e2 = env. The gain form writes g as float64 and the
// final state; the mix form writes out[t] = s[t] + bed[t] * float32(g[t])
// (the product and the sum each rounded to float32, as torch rounds
// ducked * g.to(float32) and then the sum), so g never reaches device
// memory; out may be s itself. The state, the knee and the gain stay in
// float64, as the scans did. The maxima propagate NaN as torch.maximum
// does, and the clamps as torch.clamp_min and torch.clamp do.
//
// It ports no Pallas kernel: the JAX package runs the duck's recurrences
// as XLA's associative scans (xmtpu/ops/mix.py duck_gain_block), which the
// port had copied into eager torch: two float64 log-depth scans of about
// 25 levels, each level a handful of strided launches, 608 launches and
// 23.7 ms a call at the mix cell's 2 x 28.8 M, where the host spent most
// of its issue time on those launches.
//
// What bounds it: bytes. A sample takes a few dozen float64 operations
// (the two recurrences, and only inside the knee's band the log and the
// power), against 67 TFLOP/s; its bytes are 4 read of s a pass, 4 of bed
// and 4 of out. The recurrences have exact carries (the coefficients are
// constants), so a row splits into tiles of kTile samples, one block a
// tile, and a tile into kThreads segments of kSeg samples, one thread a
// segment, all composed as pairs:
//
//   max:      f(E) = max(v, p E);
//             (v1, p1) then (v2, p2) = (max(v2, p2 v1), p1 p2)
//   one-pole: f(S) = u + q S;
//             (u1, q1) then (u2, q2) = (q2 u1 + u2, q1 q2)
//
// with (v, p) a segment's decaying max from zero and k to the power of
// its length, (u, q) its one-pole from zero over the true env and (1 - c)
// to the power of its length. The segments of a tile compose by a block
// scan (warp shuffles, then the warps' totals); the tiles of a row by a
// small chain launch. The one-pole's input is env, which needs the max's
// carry, so three passes read s:
//   pass A  each tile's (v, p) from zero;
//   chain   each tile's entering env, from the row's state;
//   pass B  each tile's env replayed from its carry, its (u, q) from zero;
//   chain   each tile's entering e2;
//   pass C  both carries, env and e2 replayed, the knee and the gain, and
//           g or out written, and the row's final state.
// s is read three times because a tile's one-pole needs the max's carry of
// every earlier tile, and that is known only once every tile has been
// read: 20 bytes a sample and channel in all (12 in pass C), 0.34 ms at
// 3.35 TB/s at the cell's shape. A row of one tile (a 20 ms frame) runs
// pass C alone from the given state: one launch.
//
// Each block stages its tile coalesced (a warp reads 32 neighbouring
// samples) into shared memory as float64 |s|, a thread's segment at a
// pitch of kSeg + 1 doubles so the threads' reads along their segments hit
// distinct banks; each thread then walks its segment from there. The
// ragged last tile of a row takes its own powers: a segment's power is
// the coefficient to the power of its own length, by squaring. Inside the
// knee's band g comes from log10 and exp10; outside it (e2 past bounds
// the host sets with a 1e-9 margin, NaN when the margin cannot be proven)
// x clamps to exactly 0 or 1, so g is exp10 of the same argument
// evaluated once a thread: bit for bit what the band's path gives there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // segments a block: one tile
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;                 // samples a thread runs in order
constexpr int kTile = kThreads * kSeg;   // samples a block takes of a row
constexpr int kPitch = kSeg + 1;         // staged doubles a segment

struct Pair {
  double v, p;
};

struct Params {
  double k;          // the decaying max's coefficient a sample
  double a, c;       // the one-pole: e2 = a e2 + c env
  double thr, knee;  // threshold_db, knee_db
  double neg_depth;  // -depth_db
  double e_lo, e_hi; // x is 0 for e2 <= e_lo and 1 for e2 >= e_hi
  int ident;         // c >= 1: e2 = env
};

// torch.maximum: NaN when either operand is
__device__ __forceinline__ double max_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}

struct MaxOp {
  static __device__ __forceinline__ Pair identity() { return {0.0, 1.0}; }
  // `early` then `late`
  static __device__ __forceinline__ Pair compose(Pair early, Pair late) {
    return {max_nan(late.v, late.p * early.v), early.p * late.p};
  }
  static __device__ __forceinline__ double apply(Pair f, double x) {
    return max_nan(f.v, f.p * x);
  }
};

struct SumOp {
  static __device__ __forceinline__ Pair identity() { return {0.0, 1.0}; }
  static __device__ __forceinline__ Pair compose(Pair early, Pair late) {
    return {fma(late.p, early.v, late.v), early.p * late.p};
  }
  static __device__ __forceinline__ double apply(Pair f, double x) {
    return fma(f.p, x, f.v);
  }
};

// The composition of the pairs of the threads before this one (exclusive)
// and of all of them (`total`), threads in order: within each warp by
// shuffles, then warp 0 scans the warps' totals the same way. Every
// thread calls it; wsum holds kWarps + 1 pairs.
template <class Op>
__device__ __forceinline__ Pair warp_scan(Pair x, int lane, int width) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= width) break;
    const Pair o = {__shfl_up_sync(0xffffffffu, x.v, d),
                    __shfl_up_sync(0xffffffffu, x.p, d)};
    if (lane >= d) x = Op::compose(o, x);
  }
  return x;
}

template <class Op>
__device__ __forceinline__ Pair block_scan(Pair x, Pair* wsum, Pair& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Pair inc = warp_scan<Op>(x, lane, 32);
  Pair ex = {__shfl_up_sync(0xffffffffu, inc.v, 1),
             __shfl_up_sync(0xffffffffu, inc.p, 1)};
  if (lane == 0) ex = Op::identity();
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' exclusive prefixes over wsum, and the total
    const Pair w = warp_scan<Op>(lane < kWarps ? wsum[lane] : Op::identity(),
                                 lane, kWarps);
    Pair wex = {__shfl_up_sync(0xffffffffu, w.v, 1),
                __shfl_up_sync(0xffffffffu, w.p, 1)};
    if (lane == 0) wex = Op::identity();
    if (lane < kWarps) wsum[lane] = wex;
    if (lane == kWarps - 1) wsum[kWarps] = w;
  }
  __syncthreads();
  ex = Op::compose(wsum[warp], ex);
  total = wsum[kWarps];
  __syncthreads();  // wsum is free for the next scan
  return ex;
}

// x^e for 0 <= e <= kSeg, by squaring.
__device__ __forceinline__ double ipow(double x, int e) {
  double r = 1.0;
#pragma unroll
  for (int b = 1; b <= kSeg; b <<= 1) {
    if (e & b) r *= x;
    x *= x;
  }
  return r;
}

// Staged index of tile sample e: thread e / kSeg's segment, position
// e % kSeg.
__device__ __forceinline__ int slot(int e) {
  return (e / kSeg) * kPitch + e % kSeg;
}

// |s| of the tile's `len` samples at `s` into ds as float64; sv[m] keeps
// sample threadIdx.x + m * kThreads (0 past len).
__device__ __forceinline__ void stage(const float* s, int len, double* ds,
                                      float (&sv)[kSeg]) {
#pragma unroll
  for (int m = 0; m < kSeg; ++m) {
    const int e = threadIdx.x + m * kThreads;
    sv[m] = e < len ? s[e] : 0.f;
  }
#pragma unroll
  for (int m = 0; m < kSeg; ++m)
    ds[slot(threadIdx.x + m * kThreads)] = fabs(static_cast<double>(sv[m]));
  __syncthreads();
}

// The decaying max over a segment from zero: (v, k^len).
__device__ __forceinline__ Pair seg_max(const double* d, int len,
                                        const Params& q) {
  double v = 0.0;
#pragma unroll
  for (int t = 0; t < kSeg; ++t)
    if (t < len) v = max_nan(d[t], q.k * v);
  return {v, ipow(q.k, len)};
}

// env from E over a segment, the one-pole from zero: (u, a^len).
__device__ __forceinline__ Pair seg_onepole(const double* d, int len,
                                            double env, const Params& q) {
  double u = 0.0;
#pragma unroll
  for (int t = 0; t < kSeg; ++t)
    if (t < len) {
      env = max_nan(d[t], q.k * env);
      u = fma(q.a, u, q.c * env);
    }
  return {u, ipow(q.a, len)};
}

// The knee and the gain of one e2 (ops/mix.py's order of operations).
__device__ __forceinline__ double knee_gain(double e2, const Params& q) {
  const double lv = e2 < 1e-12 ? 1e-12 : e2;  // NaN stays NaN
  double x = (20.0 * log10(lv) - q.thr) / q.knee + 0.5;
  x = x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
  return exp10(q.neg_depth * x / 20.0);
}

// The tile this block takes: row blockIdx.y, samples [t0, t0 + len).
struct Tile {
  size_t base;
  int len;
  __device__ Tile(long long n) {
    const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
    base = static_cast<size_t>(blockIdx.y) * n + t0;
    len = static_cast<int>(min(static_cast<long long>(kTile), n - t0));
  }
  __device__ int seg_len() const {
    return max(0, min(kSeg, len - static_cast<int>(threadIdx.x) * kSeg));
  }
};

// Pass A: (tv, tp)[r, j] = tile j of row r's decaying max from zero and
// its power.
__global__ void __launch_bounds__(kThreads)
max_tiles_kernel(const float* s, double* tv, double* tp, long long n, int S,
                 Params q) {
  __shared__ double ds[kThreads * kPitch];
  __shared__ Pair wsum[kWarps + 1];
  const Tile tl(n);
  float sv[kSeg];
  stage(s + tl.base, tl.len, ds, sv);
  Pair tot;
  block_scan<MaxOp>(seg_max(ds + threadIdx.x * kPitch, tl.seg_len(), q),
                    wsum, tot);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(blockIdx.y) * S + blockIdx.x;
    tv[o] = tot.v;
    tp[o] = tot.p;
  }
}

// Pass B: (tv, tp)[r, j] = tile j's one-pole from zero over its true env
// (from the entering env ec[r, j]) and its power.
__global__ void __launch_bounds__(kThreads)
onepole_tiles_kernel(const float* s, const double* ec, double* tv, double* tp,
                     long long n, int S, Params q) {
  __shared__ double ds[kThreads * kPitch];
  __shared__ Pair wsum[kWarps + 1];
  const Tile tl(n);
  float sv[kSeg];
  stage(s + tl.base, tl.len, ds, sv);
  const double* d = ds + threadIdx.x * kPitch;
  const int len = tl.seg_len();
  const size_t o = static_cast<size_t>(blockIdx.y) * S + blockIdx.x;
  Pair tot;
  const Pair ex = block_scan<MaxOp>(seg_max(d, len, q), wsum, tot);
  const double env = MaxOp::apply(ex, ec[o]);
  block_scan<SumOp>(seg_onepole(d, len, env, q), wsum, tot);
  if (threadIdx.x == 0) {
    tv[o] = tot.v;
    tp[o] = tot.p;
  }
}

// The tiles of row blockIdx.x in order: carry[r, j] = the state entering
// tile j, from init[r] (0 when init is null) through the pairs of tiles
// 0 .. j-1.
template <class Op>
__global__ void __launch_bounds__(kThreads)
duck_chain_kernel(const double* tv, const double* tp, const double* init,
             double* carry, int S) {
  __shared__ Pair wsum[kWarps + 1];
  const size_t row = static_cast<size_t>(blockIdx.x) * S;
  const int per = (S + kThreads - 1) / kThreads;
  const int j0 = min(S, static_cast<int>(threadIdx.x) * per);
  const int j1 = min(S, j0 + per);
  Pair acc = Op::identity();
  for (int j = j0; j < j1; ++j)
    acc = Op::compose(acc, {tv[row + j], tp[row + j]});
  Pair tot;
  const Pair ex = block_scan<Op>(acc, wsum, tot);
  double c = Op::apply(ex, init ? init[blockIdx.x] : 0.0);
  for (int j = j0; j < j1; ++j) {
    carry[row + j] = c;
    c = Op::apply({tv[row + j], tp[row + j]}, c);
  }
}

// Pass C: env and e2 from the carries (ec, sc)[r, j] (0 when null), the
// knee and the gain; g (the gain form) or out = s + bed * float32(g) (the
// mix form, kMix) written; the row's final state into (env_last,
// e2_last)[r] by the thread that holds its last sample, when given.
template <bool kMix>
__global__ void __launch_bounds__(kThreads)
duck_kernel(const float* s, const float* bed, float* out, double* g,
            const double* ec, const double* sc, double* env_last,
            double* e2_last, long long n, int S, Params q) {
  __shared__ double ds[kThreads * kPitch];
  __shared__ Pair wsum[kWarps + 1];
  const Tile tl(n);
  float sv[kSeg];
  stage(s + tl.base, tl.len, ds, sv);
  double* d = ds + threadIdx.x * kPitch;
  const int len = tl.seg_len();
  const size_t o = static_cast<size_t>(blockIdx.y) * S + blockIdx.x;
  Pair tot;
  const Pair ex = block_scan<MaxOp>(seg_max(d, len, q), wsum, tot);
  double env = MaxOp::apply(ex, ec ? ec[o] : 0.0);
  const Pair ex2 =
      block_scan<SumOp>(seg_onepole(d, len, env, q), wsum, tot);
  double e2 = SumOp::apply(ex2, sc ? sc[o] : 0.0);
  // the knee's clamped ends, as knee_gain evaluates them
  const double g_lo = exp10(q.neg_depth * 0.0 / 20.0);
  const double g_hi = exp10(q.neg_depth * 1.0 / 20.0);
#pragma unroll
  for (int t = 0; t < kSeg; ++t)
    if (t < len) {
      env = max_nan(d[t], q.k * env);
      e2 = q.ident ? env : fma(q.a, e2, q.c * env);
      d[t] = e2 >= q.e_hi ? g_hi : (e2 <= q.e_lo ? g_lo : knee_gain(e2, q));
    }
  if (env_last && blockIdx.x == S - 1 && len > 0 &&
      static_cast<int>(threadIdx.x) * kSeg + len == tl.len) {
    env_last[blockIdx.y] = env;
    e2_last[blockIdx.y] = e2;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kSeg; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < tl.len) {
      const double gv = ds[slot(e)];
      if constexpr (kMix)
        out[tl.base + e] = __fadd_rn(
            sv[m], __fmul_rn(bed[tl.base + e], __double2float_rn(gv)));
      else
        g[tl.base + e] = gv;
    }
  }
}

}  // namespace

// s: (rows, n) float32, contiguous. The mix form when bed is given (bed
// of s's shape; out of s's shape, out == s allowed), else the gain form
// (g: (rows, n) float64). env0, e2_0: (rows,) float64 states, or null for
// zeros; env_last, e2_last: (rows,) float64 for the final state, or null.
// S = ceil(n / kTile) tiles a row (the caller's count, checked); scratch:
// 4 * rows * S doubles when S > 1. k, a = 1 - c and c the recurrences'
// coefficients, ident = 1 when c >= 1; thr, knee, neg_depth the knee and
// -depth in dB; e_lo, e_hi the bounds outside which x clamps (NaN: none).
// Launches passes A, B and their chains (S > 1) and pass C on `stream`;
// returns cudaGetLastError() after them.
extern "C" int xm_duck_f32(const float* s, const float* bed, float* out,
                           double* g, const double* env0, const double* e2_0,
                           double* env_last, double* e2_last, double* scratch,
                           int rows, long long n, int S, double k, double a,
                           double c, int ident, double thr, double knee,
                           double neg_depth, double e_lo, double e_hi,
                           void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (S != (n + kTile - 1) / kTile || rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params q{k, a, c, thr, knee, neg_depth, e_lo, e_hi, ident};
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(rows));
  const double* ec = env0;
  const double* sc = e2_0;
  if (S > 1) {
    double* tv = scratch;
    double* tp = scratch + static_cast<size_t>(rows) * S;
    double* ecar = tp + static_cast<size_t>(rows) * S;
    double* scar = ecar + static_cast<size_t>(rows) * S;
    max_tiles_kernel<<<grid, kThreads, 0, st>>>(s, tv, tp, n, S, q);
    duck_chain_kernel<MaxOp><<<rows, kThreads, 0, st>>>(tv, tp, env0, ecar,
                                                        S);
    onepole_tiles_kernel<<<grid, kThreads, 0, st>>>(s, ecar, tv, tp, n, S,
                                                    q);
    duck_chain_kernel<SumOp><<<rows, kThreads, 0, st>>>(tv, tp, e2_0, scar,
                                                        S);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ec = ecar;
    sc = scar;
  }
  if (bed)
    duck_kernel<true><<<grid, kThreads, 0, st>>>(s, bed, out, nullptr, ec, sc,
                                                 env_last, e2_last, n, S, q);
  else
    duck_kernel<false><<<grid, kThreads, 0, st>>>(s, nullptr, nullptr, g, ec,
                                                  sc, env_last, e2_last, n, S,
                                                  q);
  return static_cast<int>(cudaGetLastError());
}
