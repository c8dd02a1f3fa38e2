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
// flops per track and output) and the least time is the bytes': the
// input read once and the output written once. Inside the kernel the
// window is read from shared memory, one 32-bit load per sample: K2 per
// output, (K2 + kPairSkew) / 2 in the paired form below.
//
// Design. One persistent block per SM (the grid a multiple of the group
// count); a block owns a group of G consecutive phases and walks work
// items of them: a row and a tile of 32*F output frames. G and F come
// from the host (kernels/resample.py poly_geometry), from the shared
// budget.
// - Warp-specialized ring of window stages (named barriers: a stage
//   full, a stage empty): producer warps stage the next items' windows
//   while consumer warps compute the current one (float32: 8 + 8 warps,
//   3 stages; int16: 8 + 4, 2 stages). Float32 rows: at odd M, away
//   from a row's ends, as the aligned 16-byte chunks (cp.async.cg, past
//   L1) that cover each row, the pitch P = M (mod 4) so that every row's
//   chunks land aligned; else sample by sample by 4-byte cp.async,
//   zero-filled outside the row. Int16 tracks: 4-byte cp.async of aligned
//   sample pairs into a raw area, interleaved by the producers into the
//   rows.
// - Lanes on frames, taps in registers: a consumer warp computes frames
//   32f + lane of its phases, so a phase's taps are the same on every
//   lane and sit in registers, loaded once for the item's F frames
//   (for the whole run when the warp owns a single pair of phases).
//   The default filter (K2 = 25, its own instance) takes phases in pairs
//   (r, r + 1) whose windows start at most kPairSkew apart: both come
//   from one window of K2 + kPairSkew words, each phase's taps shifted to
//   its offset (zeros around them), so a staged word is loaded, and for
//   K8 decoded, once for two outputs; two frames at a time. Any other K2
//   or skew runs one phase at a time, kTapBlock taps to an unrolled
//   block. Sums in k order (the shifted zeros add exact zeros).
// - The window as one row per frame (x[c*M + s[r0] + i], i < W = s[r0 +
//   G - 1] - s[r0] + K2, then kPairSkew more: zeros, or row samples where
//   copied as chunks) at an odd pitch P in 32-bit words, so the 32 lanes'
//   loads fall in 32 distinct banks at any M. Neighbouring frames share
//   samples, staged once per frame (about W / (G*M/L)).
// - Outputs through a (32F, TP) shared tile, TP odd (conflict-free stores
//   by frame), read back in output order and stored coalesced.
// - Two int16 tracks are staged as one 32-bit word per sample (voice low,
//   BGM high, in offset binary), so one load feeds both FIRs. They are
//   read from device memory as aligned 32-bit pairs of samples, so a row
//   is staged from the even sample at or before its start (`shift`).
//   Each half becomes a float exactly by one byte permute and one float
//   subtract (I2F runs at a quarter of the FMA rate here).
// Accumulation is float32 fmaf in k order per track.
// - Non-finite input (float32 rows only; Src::kCheckFinite): an output is
//   non-finite exactly where the banded twin's is (ops/resample.py: whole
//   frames times the dense band, so a NaN or inf reaches every output of
//   the frames whose band rows hold it). Each consumer folds its sums
//   into fmaf(0, sum, chk), which stays 0 unless a sum is non-finite;
//   the tile barrier ORs that over the consumers (bar.red.or). Only an
//   item with a non-finite sum takes the slow path: the consumers scan
//   its staged window, set per-frame bits in `flags` by where each
//   non-finite sample sits relative to the frame (1: in the frame's own
//   M samples, 2: before them, 4: after them), zero it, and compute the
//   item again, so that no sum reads a non-finite sample through a zero
//   tap. A second kernel (nan_fixup) then writes NaN over the outputs the
//   bits poison: every group's window of a frame together is the frame's
//   whole band, which no one block sees.
//
// Measured on an H100 (700 W; PERF.md): the staging and the consumers'
// shared loads share the SM's load path and add up more than they
// overlap; G, F, the ring depth and the warp roles were swept there.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace xm {

constexpr int kDefaultK2 = 25;  // taps_per_phase = 24: its own instance
// that instance takes phases in pairs (r, r + 1) whose windows start at
// most kPairSkew apart, both from one window of kDefaultK2 + kPairSkew
constexpr int kPairSkew = 3;
constexpr int kTapRegs = 32;    // taps a warp holds in registers (any K2)
constexpr int kTapBlock = 8;    // taps summed per unrolled block (any K2)
// named barriers (0 is __syncthreads): a stage full / empty (kMaxRing
// each), the tile, the producers
constexpr int kMaxRing = 4;
constexpr int kBarFull = 1, kBarEmpty = 1 + kMaxRing,
              kBarTile = 1 + 2 * kMaxRing, kBarProducers = 2 + 2 * kMaxRing,
              kBarCheck = 3 + 2 * kMaxRing;

struct PolyGeom {
  int R, n, out_len, L, M, K2;
  int G;   // phases per group
  int F;   // frames per lane: a work item is 32*F output frames
  int P;   // window row pitch, 32-bit words, odd, >= W + kPairSkew + 4;
           // for float32 rows and odd M, P = M (mod 4) and >= W + 9
  int TP;  // output tile row pitch, floats, odd, >= G
  int pair_skew;  // the most two paired phases' windows start apart
};

// taps per phase in the padded table: K2 rounded up to 16 bytes
__host__ __device__ inline int poly_k2p(int K2) { return (K2 + 3) & ~3; }

// Shared memory of one block: the group's taps ((G + 1) x K2p), `ring`
// window stages (32F x P + 4, rounded to 16 bytes), the tile (32F x TP)
// and, for two int16 tracks, their raw sample pairs (2 x 32F x (P + 1) /
// 2).
inline size_t poly_smem_bytes(const PolyGeom& g, int tracks, int ring) {
  const int raw = tracks == 2 ? 2 * ((g.P + 1) / 2) : 0;
  return 4 * (static_cast<size_t>(g.G + 1) * poly_k2p(g.K2) +
              static_cast<size_t>(ring) * ((32 * g.F * g.P + 7) & ~3) +
              static_cast<size_t>(32 * g.F) * (g.TP + raw));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// bar.sync over `threads` that also returns the OR of their `v`
__device__ __forceinline__ bool bar_red_or(int id, int threads, bool v) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 q, %3, 0;\n\t"
      "bar.red.or.pred p, %1, %2, q;\n\t"
      "selp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(id), "r"(threads), "r"(static_cast<int>(v))
      : "memory");
  return r != 0;
}

// the bits of nan_fixup's flags: where a non-finite sample of a frame's
// window sits relative to the frame c (its samples c*M .. c*M + M - 1)
constexpr unsigned kInFrame = 1u, kBeforeFrame = 2u, kAfterFrame = 4u;

__device__ __forceinline__ bool not_finite(uint32_t w) {
  return !(fabsf(__uint_as_float(w)) <= 3.402823466e38f);
}

// A work item: a row and its frames [c0, c0 + cnt); window row cc starts
// at sample x0 + cc*M of the row.
struct PolyItem {
  int row, c0, cnt;
  long long x0;
  __device__ __forceinline__ PolyItem(long long t, int tiles, int nj,
                                      int s0, const PolyGeom& g) {
    row = static_cast<int>(t / tiles);
    c0 = static_cast<int>(t - static_cast<long long>(row) * tiles) * 32 *
         g.F;
    cnt = min(32 * g.F, nj - c0);
    x0 = static_cast<long long>(c0) * g.M + s0;
  }
};

// Elements e = e0 + step*s of a (rows, W) block as (row cc, column i) and
// pos = cc*A + i for a row stride A: one division, then a carry per step.
struct RowWalk {
  int cc, i, pos, W, dq, dr, inc, wrap;
  __device__ __forceinline__ RowWalk(int e0, int step, int W_, int A)
      : W(W_) {
    cc = e0 / W;
    i = e0 - cc * W;
    pos = cc * A + i;
    dq = step / W;
    dr = step - dq * W;
    inc = dq * A + dr;
    wrap = A - W;
  }
  __device__ __forceinline__ void next() {
    cc += dq;
    i += dr;
    pos += inc;
    if (i >= W) {
      i -= W;
      ++cc;
      pos += wrap;
    }
  }
};

// One float32 track, staged by cp.async: 16-byte chunks or sample by
// sample. The track's base address is 16-byte aligned (the wrapper's
// check).
struct F32Track {
  static constexpr int kTracks = 1;
  static constexpr bool kCheckFinite = true;  // see the header
  // warps a block: consumers (compute) and producers (staging)
  static constexpr int kConsumerWarps = 8, kProducerWarps = 8;
  static constexpr int kRing = 3;  // window stages
  static constexpr int kProducers = 32 * kProducerWarps;
  static constexpr int kThreads = 32 * kConsumerWarps + kProducers;
  static constexpr bool kAsync = true;  // fill returns with copies in flight
  const float* x;

  // window sample 0 of row 0 sits at this word of a stage: the row's
  // global index mod 4, so that with P = M (mod 4) every row's 16-byte
  // source chunks land on 16-byte aligned words
  __device__ __forceinline__ static int origin(const PolyItem& t,
                                               const PolyGeom& g) {
    return static_cast<int>((static_cast<long long>(t.row) * g.n + t.x0) & 3);
  }
  // producer thread p starts item t's window (W samples a frame, then
  // kPairSkew zeros) into win: for odd M away from the row's ends, as the
  // 16-byte chunks (cp.async.cg, past L1) that cover each row, with a
  // few real samples around it; else sample by sample (4-byte cp.async,
  // zero outside the row and past W)
  __device__ __forceinline__ void fill(uint32_t* win, uint32_t*,
                                       const PolyItem& t, int W,
                                       const PolyGeom& g, int p) const {
    const int Wst = W + kPairSkew, o = origin(t, g);
    const long long last = t.x0 + static_cast<long long>(t.cnt - 1) * g.M;
    if ((g.M & 1) && t.x0 >= 3 && last + Wst + 3 <= g.n) {
      const long long gb = static_cast<long long>(t.row) * g.n + t.x0;
      const int per_row = (Wst + 6) / 4;
      RowWalk w(p, kProducers, per_row, 0);
      for (int e = p; e < t.cnt * per_row; e += kProducers) {
        const long long gs = gb + static_cast<long long>(w.cc) * g.M;
        const int sh = static_cast<int>(gs & 3);
        if (w.i < (sh + Wst + 3) / 4)
          cp_async16(win + o + w.cc * g.P - sh + 4 * w.i,
                     x + (gs - sh) + 4 * w.i);
        w.next();
      }
    } else {
      const float* xr = x + static_cast<size_t>(t.row) * g.n;
      RowWalk w(p, kProducers, Wst, g.M);
      for (int e = p; e < t.cnt * Wst; e += kProducers) {
        const long long s = t.x0 + w.pos;
        const bool in = w.i < W && s >= 0 && s < g.n;
        cp_async4_zfill(win + o + w.cc * g.P + w.i, xr + (in ? s : 0),
                        in ? 4 : 0);
        w.next();
      }
    }
    cp_async_commit();
  }
  __device__ __forceinline__ static void decode(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
};

// Two int16 tracks in one word: low half the first track, high half the
// second, each in offset binary (the sample + 32768), so that
// float(0x4B400000 | u) - 2^23 - 32768 is the sample, exactly. The
// producers copy each track's aligned sample pairs by 4-byte cp.async
// into a raw area (a pair's half outside the tensor is not read), then
// interleave them into the window rows, zeroing the halves outside the
// row. The tracks' base addresses are 4-byte aligned (the wrapper
// aligns them to 16).
struct I16PairTracks {
  static constexpr int kTracks = 2;
  static constexpr bool kCheckFinite = false;  // int16 is always finite
  static constexpr int kConsumerWarps = 8, kProducerWarps = 4;
  static constexpr int kRing = 2;
  static constexpr int kProducers = 32 * kProducerWarps;
  static constexpr int kThreads = 32 * kConsumerWarps + kProducers;
  static constexpr bool kAsync = false;
  const int16_t* a;
  const int16_t* b;

  // window sample 0 of row 0 sits at word 1 of a stage; row cc of item t
  // is staged from the even global sample at or before its window start,
  // `shift` (0 or 1) samples before it, `shift` words early
  __device__ __forceinline__ static int origin(const PolyItem&,
                                               const PolyGeom&) {
    return 1;
  }
  // row cc of item t begins at the even global sample at or before its
  // window start: `shift` (0 or 1) samples before it
  __device__ __forceinline__ static int shift(const PolyItem& t, int cc,
                                              const PolyGeom& g) {
    return static_cast<int>((static_cast<long long>(t.row) * g.n + t.x0 +
                             static_cast<long long>(cc) * g.M) & 1);
  }
  // pair q of row cc: samples lo = x0 + cc*M - shift + 2q and lo + 1,
  // each in the row or not
  __device__ __forceinline__ static long long pair(const PolyItem& t, int cc,
                                                   int q, const PolyGeom& g,
                                                   int& sh, bool& in_lo,
                                                   bool& in_hi) {
    sh = shift(t, cc, g);
    const long long lo = t.x0 + static_cast<long long>(cc) * g.M - sh + 2 * q;
    in_lo = lo >= 0 && lo < g.n;
    in_hi = lo + 1 >= 0 && lo + 1 < g.n;
    return lo;
  }
  // the producers stage item t's window: raw pairs (two tracks of
  // (cnt, RW) words) by cp.async, then the interleaved rows
  __device__ __forceinline__ void fill(uint32_t* win, uint32_t* raw,
                                       const PolyItem& t, int W,
                                       const PolyGeom& g, int p) const {
    const int nw = (W + kPairSkew + 2) / 2, total = t.cnt * nw;
    const int rw = (g.P + 1) / 2;
    uint32_t* raw_b = raw + 32 * g.F * rw;
    const size_t rbase = static_cast<size_t>(t.row) * g.n;
    {
      RowWalk w(p, kProducers, nw, rw);
      for (int e = p; e < total; e += kProducers) {
        int sh;
        bool in_lo, in_hi;
        const long long lo = pair(t, w.cc, w.i, g, sh, in_lo, in_hi);
        const int bytes = in_hi ? 4 : (in_lo ? 2 : 0);
        const size_t i = bytes ? rbase + lo : 0;
        cp_async4_zfill(raw + w.pos, a + i, bytes);
        cp_async4_zfill(raw_b + w.pos, b + i, bytes);
        w.next();
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(kBarProducers, kProducers);  // the raw pairs are in
    RowWalk w(p, kProducers, nw, rw);
    for (int e = p; e < total; e += kProducers) {
      int sh;
      bool in_lo, in_hi;
      pair(t, w.cc, w.i, g, sh, in_lo, in_hi);
      const uint32_t keep = (in_lo ? 0xFFFFu : 0u) | (in_hi ? 0xFFFF0000u : 0u);
      const uint32_t va = raw[w.pos] & keep, vb = raw_b[w.pos] & keep;
      // the row starts `shift` words early, so that its window sample i
      // sits at word 1 + cc*P + i whatever the shift
      uint32_t* row = win + 1 + w.cc * g.P - sh + 2 * w.i;
      row[0] = __byte_perm(va, vb, 0x5410) ^ 0x80008000u;
      row[1] = __byte_perm(va, vb, 0x7632) ^ 0x80008000u;
      w.next();
    }
    bar_sync(kBarProducers, kProducers);  // the raw area is free again
  }
  __device__ __forceinline__ static void decode(uint32_t w, float* v) {
    constexpr float kBias = 12615680.f;  // 2^23 + 32768
    v[0] = __uint_as_float(__byte_perm(w, 0x4B40u, 0x5410)) - kBias;
    v[1] = __uint_as_float(__byte_perm(w, 0x4B40u, 0x5432)) - kBias;
  }
};

// acc[tr] += h * the word's sample of track tr, for each track
template <class Src>
__device__ __forceinline__ void fma_word(uint32_t w, float h, float* acc) {
  float v[Src::kTracks];
  Src::decode(w, v);
#pragma unroll
  for (int tr = 0; tr < Src::kTracks; ++tr) acc[tr] = fmaf(h, v[tr], acc[tr]);
}

// Epilogue(j, acc) -> the stored value; acc holds Src::kTracks sums.
// kK: K2 as a compile-time constant (the default filter's), or 0 for
// any K2 (g.K2). gridDim.x is a multiple of the group count ceil(L / G).
// flags (Src::kCheckFinite only): 1 + rows * nj words, zero on entry;
// word 0 is set where any frame's bits are (see the header).
template <class Src, class Epilogue, int kK>
__global__ void __launch_bounds__(Src::kThreads, 1)
polyphase_kernel(Src src, const float* __restrict__ hsel,
                 const int* __restrict__ soff, float* __restrict__ out,
                 PolyGeom g, Epilogue ep, unsigned* __restrict__ flags) {
  constexpr int kConsumerWarps = Src::kConsumerWarps;
  constexpr int kConsumers = 32 * kConsumerWarps;
  constexpr int kPolyThreads = Src::kThreads;
  constexpr int kRing = Src::kRing;
  static_assert(kRing <= kMaxRing, "one full and one empty barrier a stage");
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kTracks = Src::kTracks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k2p = poly_k2p(g.K2);

  // this block's phase group and its (row, frame tile) items
  const int groups = (g.L + g.G - 1) / g.G;
  const int r0 = (blockIdx.x % groups) * g.G;
  const int gl = min(g.G, g.L - r0);
  const int nj = (g.out_len + g.L - 1) / g.L;
  const int frames = 32 * g.F;
  const int tiles = (nj + frames - 1) / frames;
  const long long items = static_cast<long long>(g.R) * tiles;
  const long long stride = gridDim.x / groups;
  const long long first = blockIdx.x / groups;
  if (first >= items) return;

  float* taps = reinterpret_cast<float*>(smem);  // (G + 1) x K2p floats
  uint32_t* win0 = reinterpret_cast<uint32_t*>(taps + (g.G + 1) * k2p);
  // a stage: the rows from word origin(item) (0..3), 16-byte aligned;
  // window sample i of row cc at word origin + cc*P + i
  const int stage_words = (frames * g.P + 4 + 3) & ~3;
  float* tile = reinterpret_cast<float*>(win0 + kRing * stage_words);
  uint32_t* raw = reinterpret_cast<uint32_t*>(tile + frames * g.TP);
  const int s0 = __ldg(soff + r0);
  const int W = __ldg(soff + r0 + gl - 1) - s0 + g.K2;
  constexpr int kKW = kK + kPairSkew, kKWp = (kKW + 3) & ~3;
  if constexpr (kK > 0) {
    // pair q (phases r0 + 2q and r0 + 2q + 1, the second absent at the end
    // of an odd group): each phase's taps shifted to its window's offset
    // from the pair's first, zero elsewhere, kKWp floats a phase
    for (int i = tid; i < (gl + 1) / 2 * 2 * kKWp; i += kPolyThreads) {
      const int m = i % kKWp, j = i / kKWp, r = r0 + j;
      const bool in = r < r0 + gl;
      const int d = in && (j & 1) ? __ldg(soff + r) - __ldg(soff + r - 1) : 0;
      taps[i] = in && m >= d && m - d < kK
                    ? __ldg(hsel + static_cast<size_t>(r) * k2p + m - d)
                    : 0.f;
    }
  } else {
    for (int i = tid; i < gl * k2p; i += kPolyThreads)
      taps[i] = __ldg(hsel + static_cast<size_t>(r0) * k2p + i);
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // producers: item i into stage i % kRing once item i - kRing is
    // consumed
    const int p = tid - kConsumers;
    int i = 0;
    for (long long it = first; it < items; it += stride, ++i) {
      const int s = i % kRing;
      if (i >= kRing) bar_sync(kBarEmpty + s, kPolyThreads);
      src.fill(win0 + s * stage_words, raw, PolyItem(it, tiles, nj, s0, g),
               W, g, p);
      if constexpr (Src::kAsync) {
        if (i >= 1) {
          cp_async_wait<1>();
          bar_arrive(kBarFull + (i - 1) % kRing, kPolyThreads);
        }
      } else {
        bar_arrive(kBarFull + s, kPolyThreads);
      }
    }
    if constexpr (Src::kAsync) {
      cp_async_wait<0>();
      bar_arrive(kBarFull + (i - 1) % kRing, kPolyThreads);
    }
    return;
  }

  // consumers: the item's frames 32f + lane of the group's phases, taps
  // in registers
  const int tp = g.TP;
  // the paired instance's taps of pair q, in registers
  float ha[kK > 0 ? kKW : 1], hb[kK > 0 ? kKW : 1];
  auto load_pair = [&](int q) {
    if constexpr (kK > 0) {
      const float* hp = taps + q * 2 * kKWp;
#pragma unroll
      for (int m = 0; m < kKW; ++m) {
        ha[m] = hp[m];
        hb[m] = hp[kKWp + m];
      }
    }
  };
  const bool resident = (gl + 1) / 2 <= kConsumerWarps;
  int i = 0;
  for (long long it = first; it < items; it += stride, ++i) {
    const int s = i % kRing;
    const PolyItem t(it, tiles, nj, s0, g);
    uint32_t* const win = win0 + s * stage_words;
    const int o = Src::origin(t, g);
    bar_sync(kBarFull + s, kPolyThreads);
    // the item's outputs into the tile; chk stays 0 unless one of them
    // is non-finite (kCheckFinite)
    auto compute = [&](float& chk) {
    if constexpr (kK > 0) {
      // warp c takes pairs c, c + kConsumerWarps, ...: both phases of a
      // pair from one window of kKW words (a word decoded once for both),
      // two frames (cc, cc + 32) at a time; a warp's one pair keeps its
      // taps in registers across items
      for (int q = warp; q < (gl + 1) / 2; q += kConsumerWarps) {
        const int ra = 2 * q, rb = min(ra + 1, gl - 1);
        const int st = __ldg(soff + r0 + ra) - s0;
        if (!resident || i == 0) load_pair(q);
        for (int cc = lane; cc < t.cnt; cc += 64) {
          const int cc1 = min(cc + 32, t.cnt - 1);
          const uint32_t* w0 = win + o + cc * g.P + st;
          const uint32_t* w1 = win + o + cc1 * g.P + st;
          float a0[kTracks], b0[kTracks], a1[kTracks], b1[kTracks];
#pragma unroll
          for (int tr = 0; tr < kTracks; ++tr)
            a0[tr] = b0[tr] = a1[tr] = b1[tr] = 0.f;
#pragma unroll
          for (int m = 0; m < kKW; ++m) {
            float v0[kTracks], v1[kTracks];
            Src::decode(w0[m], v0);
            Src::decode(w1[m], v1);
#pragma unroll
            for (int tr = 0; tr < kTracks; ++tr) {
              a0[tr] = fmaf(ha[m], v0[tr], a0[tr]);
              b0[tr] = fmaf(hb[m], v0[tr], b0[tr]);
              a1[tr] = fmaf(ha[m], v1[tr], a1[tr]);
              b1[tr] = fmaf(hb[m], v1[tr], b1[tr]);
            }
          }
          if constexpr (Src::kCheckFinite) {
            chk = fmaf(0.f, a0[0], chk);
            chk = fmaf(0.f, b0[0], chk);
            chk = fmaf(0.f, a1[0], chk);
            chk = fmaf(0.f, b1[0], chk);
          }
          const long long ja = static_cast<long long>(t.c0) * g.L + r0 + ra;
          tile[cc * tp + ra] = ep(ja + static_cast<long long>(cc) * g.L, a0);
          if (rb != ra)
            tile[cc * tp + rb] =
                ep(ja + 1 + static_cast<long long>(cc) * g.L, b0);
          if (cc + 32 < t.cnt) {
            tile[cc1 * tp + ra] =
                ep(ja + static_cast<long long>(cc1) * g.L, a1);
            if (rb != ra)
              tile[cc1 * tp + rb] =
                  ep(ja + 1 + static_cast<long long>(cc1) * g.L, b1);
          }
        }
      }
    } else {
      for (int rr = warp; rr < gl; rr += kConsumerWarps) {
        const int st = __ldg(soff + r0 + rr) - s0;
        const float* h_row = taps + rr * k2p;
        const long long j0 = static_cast<long long>(t.c0) * g.L + r0 + rr;
        // any K2: kTapRegs taps at a time, kTapBlock to an unrolled block,
        // the K2 % kTapBlock left in hr
        float h[kTapRegs], hr[kTapBlock - 1];
        for (int cc = lane; cc < t.cnt; cc += 32) {
          const uint32_t* w = win + o + cc * g.P + st;
          float acc[kTracks];
#pragma unroll
          for (int tr = 0; tr < kTracks; ++tr) acc[tr] = 0.f;
          for (int kb = 0; kb < g.K2; kb += kTapRegs) {
            const int kn = min(kTapRegs, g.K2 - kb);
            const int nfull = kn - kn % kTapBlock;
#pragma unroll
            for (int q = 0; q < kTapRegs / 4; ++q) {
              if (4 * q < nfull) {
                const float4 v =
                    reinterpret_cast<const float4*>(h_row + kb)[q];
                h[4 * q] = v.x;
                h[4 * q + 1] = v.y;
                h[4 * q + 2] = v.z;
                h[4 * q + 3] = v.w;
              }
            }
#pragma unroll
            for (int kk = 0; kk < kTapBlock - 1; ++kk)
              hr[kk] = kk < kn - nfull ? h_row[kb + nfull + kk] : 0.f;
            const uint32_t* wk = w + kb;
#pragma unroll
            for (int b = 0; b < kTapRegs / kTapBlock; ++b) {
              if (b * kTapBlock < nfull) {
#pragma unroll
                for (int kk = 0; kk < kTapBlock; ++kk)
                  fma_word<Src>(wk[b * kTapBlock + kk],
                                h[b * kTapBlock + kk], acc);
              }
            }
#pragma unroll
            for (int kk = 0; kk < kTapBlock - 1; ++kk)
              if (kk < kn - nfull) fma_word<Src>(wk[nfull + kk], hr[kk], acc);
          }
          if constexpr (Src::kCheckFinite) chk = fmaf(0.f, acc[0], chk);
          tile[cc * tp + rr] = ep(j0 + static_cast<long long>(cc) * g.L, acc);
        }
      }
    }
    };
    float chk = 0.f;
    compute(chk);
    if constexpr (Src::kCheckFinite) {
      // the tile is written; did any consumer see a non-finite sum?
      if (bar_red_or(kBarCheck, kConsumers, !(chk == 0.f))) {
        // slow path: flag the frames' non-finite samples, zero every one
        // the item reads (zero taps included), compute it again
        const int Wst = W + kPairSkew;
        for (int cc = warp; cc < t.cnt; cc += kConsumerWarps) {
          uint32_t* row = win + o + cc * g.P;
          unsigned bits = 0;
          for (int u = lane; u < Wst; u += 32) {
            if (not_finite(row[u])) {
              row[u] = 0u;
              const int rel = s0 + u;
              if (u < W)
                bits |= rel < 0 ? kBeforeFrame
                                : (rel < g.M ? kInFrame : kAfterFrame);
            }
          }
          bits = __reduce_or_sync(0xffffffffu, bits);
          if (lane == 0 && bits) {
            atomicOr(flags + 1 + static_cast<size_t>(t.row) * nj + t.c0 + cc,
                     bits);
            atomicOr(flags, 1u);
          }
        }
        bar_sync(kBarTile, kConsumers);  // the window is clean
        compute(chk);
        bar_sync(kBarTile, kConsumers);  // the tile is written again
      }
      if (it + kRing * stride < items) bar_arrive(kBarEmpty + s, kPolyThreads);
    } else {
      if (it + kRing * stride < items) bar_arrive(kBarEmpty + s, kPolyThreads);
      bar_sync(kBarTile, kConsumers);  // the tile is written
    }
    // the tile in output order: each frame's gl outputs are contiguous
    const int total = t.cnt * gl;
    const long long j0 = static_cast<long long>(t.c0) * g.L + r0;
    float* orow = out + static_cast<size_t>(t.row) * g.out_len;
    RowWalk w(tid, kConsumers, gl, g.L);
    for (int e = tid; e < total; e += kConsumers) {
      const long long j = j0 + w.pos;
      if (j < g.out_len) orow[j] = tile[w.cc * tp + w.i];
      w.next();
    }
    bar_sync(kBarTile, kConsumers);  // the tile is read back
  }
}

// Resident blocks per SM of the instance at `smem` bytes of dynamic
// shared memory (0 if the query fails); sets the instance's dynamic
// shared-memory limit to the card's maximum first.
template <class Src, class Epilogue>
int poly_blocks_per_sm(int smem) {
  auto kern = polyphase_kernel<Src, Epilogue, 0>;
  int dev = 0, max_smem = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           max_smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, Src::kThreads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Launch `blocks` persistent blocks (a multiple of ceil(L / G)) on
// `stream`; returns cudaGetLastError().
template <class Src, class Epilogue>
int poly_launch(const Src& src, const float* hsel, const int* soff,
                float* out, const PolyGeom& g, Epilogue ep, int blocks,
                cudaStream_t stream, unsigned* flags = nullptr) {
  auto kern = g.K2 == kDefaultK2 && g.pair_skew <= kPairSkew
                  ? polyphase_kernel<Src, Epilogue, kDefaultK2>
                  : polyphase_kernel<Src, Epilogue, 0>;
  const size_t smem = poly_smem_bytes(g, Src::kTracks, Src::kRing);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<blocks, Src::kThreads, smem, stream>>>(src, hsel, soff, out, g, ep,
                                                 flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xm
