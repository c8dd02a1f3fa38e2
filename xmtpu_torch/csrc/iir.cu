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
// _sosfilt_seg). The segmented call (kernels/iir.py) runs the S time
// segments of a row as S rows of this kernel, S from the card's rule
// (xm_sosfilt_blocks_per_sm feeds kernels/_seg.py:gpu_segments).
//
// Arithmetic: every multiply, add and subtract is a separately rounded
// __fmul_rn / __fadd_rn / __fsub_rn, in the order of the JAX kernel's
// `cascade`. nvcc would otherwise contract b0*v + z1 and its kin into
// FMAs, which round once instead of twice; without contraction the
// kernel computes bit for bit what the plain torch twin (one elementwise
// op per operation) computes, so a difference on the card is a fault,
// not rounding. Each section sees the same inputs in the same order as
// in the twin, so the kernel equals the twin bit for bit.
//
// What bounds it on the H100: not bytes (x in, y out: 41 MB at 32 x
// 160000, 12 us at 3.35 TB/s) and not operations (9 per section per
// sample), but the chain: the loop-carried path through one section
// (z1 -> y -> a1*y -> sub -> +z2 -> z1') is four dependent operations,
// about 16 cycles per sample, and a row's samples are a chain however
// many SMs are free. The segmented call (kernels/iir.py) shortens the
// chain: the card's rule cuts the unfused step's 32 x 160000 into
// 2,048 rows of 2,500 samples. The earlier form of this kernel ran all
// ns sections of a sample in one thread (a dependent path of 2*ns
// operations, ~47 issued instructions per sample at ns = 5) on 32 rows
// per block: 70-74 cycles per sample on an H100, and 4 blocks at the
// JAX rule's S = 4.
//
// Design: the cascade is pipelined across the lanes of a warp as a
// wavefront. Lane g*ns + s owns section s of row g (32/ns rows per
// warp: 6 at ns = 5, 4 at ns = 8). At tick k, section s works on sample
// k - s*kSkew; its input is section s-1's output of kSkew ticks before,
// taken by __shfl_up_sync (section 0 reads the staged x), and section
// ns-1 writes y. A lane issues one section's 9 operations, a shuffle, a
// select and a predicated shared store per tick, and its loop-carried
// path is one section's four operations; the skew keeps a shuffle's
// latency off the next tick (the shuffle of tick k is read at tick k +
// kSkew). The pipeline fills once per row and drains once at its end
// (guarded ticks, in which a section whose sample lies outside the row
// keeps its state), across all time chunks, the ragged last one
// included. Measured on an H100 at ns = 5 (PERF.md; chip_smoke.py
// phase 6, tools/torch_k5_staging_ab.py): 46-48 cycles per sample at
// 1,024 rows of 5,000, 38-41 at 128 rows of 40,000, against the
// section's 16-cycle chain; the in-thread wavefront (one thread running
// every section, section s on sample k - s) measured 100-122 and was
// dropped.
//
// Staging: one warp per block; time chunks of kChunk samples of the
// warp's rows are copied into shared memory with cp.async (4 bytes
// each, so any n and any row offset work) Lanes::kAhead chunks ahead of
// the ticks, coalesced along time, and the outputs are stored back from
// a two-chunk ring, also coalesced. Rows are padded to kChunk + 1
// floats, so the scalar accesses of up to 32 rows in one column hit 32
// banks. The ticks read x into registers a loop step ahead (see
// steady). With one warp per block, the segment rows spread over every
// SM (at the unfused step's S = 64: 2,048 rows in 342 blocks at ns = 5).

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxSections = 8;
constexpr int kChunk = 64;       // time samples per staged chunk
constexpr int kLd = kChunk + 1;  // shared row stride: 32 rows, 32 banks
constexpr int kSkew = 4;         // ticks from one section to the next

// One section on one sample; the state advances only when `live`.
__device__ __forceinline__ float biquad(float v, float b0, float b1, float b2,
                                        float a1, float a2, float& z1,
                                        float& z2, bool live) {
  const float y = __fadd_rn(__fmul_rn(b0, v), z1);
  const float n1 =
      __fadd_rn(__fsub_rn(__fmul_rn(b1, v), __fmul_rn(a1, y)), z2);
  const float n2 = __fsub_rn(__fmul_rn(b2, v), __fmul_rn(a2, y));
  if (live) {
    z1 = n1;
    z2 = n2;
  }
  return y;
}

// The cascade pipelined across lanes: lane g*NS + s runs section s of row
// g. Lanes past kRows*NS run a copy of row kRows-1's first sections and
// store nothing.
template <int NS>
struct Lanes {
  static constexpr int kRows = 32 / NS;          // rows per warp
  static constexpr int kLag = (NS - 1) * kSkew;  // ticks from x[t] to y[t]
  static constexpr int kU = 16;                  // ticks per loop step
  // chunks of x in flight ahead of the ticks: 4 measured 3% faster than
  // 2 or 3 (tools/torch_k5_staging_ab.py); at one section the block's 32
  // rows leave room for 2 in 48 KB of static shared memory
  static constexpr int kAhead = NS == 1 ? 2 : 4;
  static_assert(kU % kSkew == 0, "a loop step keeps the history in place");
  float b0, b1, b2, a1, a2, z1, z2;
  float hist[kSkew];  // this lane's outputs of the last kSkew ticks
  int s, shift, row, g;
  bool writer;

  __device__ __forceinline__ void load(const float* __restrict__ sos,
                                       const float* __restrict__ zi, int R,
                                       int r0, int rows, int lane) {
    s = lane % NS;
    g = lane / NS;
    row = min(g, kRows - 1);
    shift = s * kSkew;
    writer = s == NS - 1;  // lane g*NS + NS-1 <= 31 implies g < kRows
    b0 = sos[6 * s + 0];
    b1 = sos[6 * s + 1];
    b2 = sos[6 * s + 2];
    a1 = sos[6 * s + 4];
    a2 = sos[6 * s + 5];
    const bool mine = g < rows;
    z1 = mine ? zi[static_cast<size_t>(2 * s) * R + r0 + g] : 0.f;
    z2 = mine ? zi[static_cast<size_t>(2 * s + 1) * R + r0 + g] : 0.f;
#pragma unroll
    for (int i = 0; i < kSkew; ++i) hist[i] = 0.f;
  }

  __device__ __forceinline__ void store(float* __restrict__ zf, int R,
                                        int r0, int rows) const {
    if (g < rows) {
      zf[static_cast<size_t>(2 * s) * R + r0 + g] = z1;
      zf[static_cast<size_t>(2 * s + 1) * R + r0 + g] = z2;
    }
  }

  // Tick k: section s on sample k - s*kSkew (state frozen outside the
  // row when kGuard); returns this lane's output.
  template <bool kGuard>
  __device__ __forceinline__ float tick(float xv, int k, int n) {
    const float up = __shfl_up_sync(0xffffffffu, hist[0], 1);
    const float v = s == 0 ? xv : up;
    const bool live =
        !kGuard || static_cast<unsigned>(k - shift) < static_cast<unsigned>(n);
    const float y = biquad(v, b0, b1, b2, a1, a2, z1, z2, live);
#pragma unroll
    for (int i = 0; i + 1 < kSkew; ++i) hist[i] = hist[i + 1];
    hist[kSkew - 1] = y;
    return y;
  }
};

// Ticks kFrom .. kTo-1 of a chunk in which every section's sample lies
// inside the row: the output of tick t goes to yw[t - kShift]. Groups
// of Pipe::kU ticks run in a loop that is not unrolled further, so the
// loop body stays small in the instruction cache (kU is a multiple of
// the skew, so the output history stays in the same registers).
// Each group's x is loaded into registers one group ahead, before the
// previous group's outputs are stored: a load issued after a store
// waits for the stored value, which would put the shared load's latency
// on every tick's path.
template <int kFrom, int kTo, int kShift, class Pipe>
__device__ __forceinline__ void steady(Pipe& f, const float* xr, float* yw,
                                       int t0, int n) {
  constexpr int kU = Pipe::kU;
  constexpr int kGroups = (kTo - kFrom) / kU;
  constexpr int kRest = kTo - kFrom - kGroups * kU;
  float xc[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) xc[u] = xr[kFrom + u];
#pragma unroll 1
  for (int g = 0; g < kGroups; ++g) {
    const int tb = kFrom + g * kU;
    float xn[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) xn[u] = xr[tb + kU + u];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float yv = f.template tick<false>(xc[u], t0 + tb + u, n);
      if (f.writer) yw[tb + u - kShift] = yv;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) xc[u] = xn[u];
  }
#pragma unroll
  for (int u = 0; u < kRest; ++u) {
    constexpr int tr = kFrom + kGroups * kU;
    const float yv = f.template tick<false>(xc[u], t0 + tr + u, n);
    if (f.writer) yw[tr + u - kShift] = yv;
  }
}

// One warp per block: rows r0 .. r0+rows-1 of x (R, n) through the
// cascade, kChunk samples at a time.
template <class Pipe>
__global__ void __launch_bounds__(32)
sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ sos,
               const float* __restrict__ zi, float* __restrict__ y,
               float* __restrict__ zf, int R, int n) {
  constexpr int kRows = Pipe::kRows;
  constexpr int kLag = Pipe::kLag;
  constexpr int kCopies = kRows * kChunk / 32;  // per lane and chunk
  static_assert(kLag < kChunk, "a chunk's y is complete one chunk later");
  static_assert(kChunk % 32 == 0, "copies tile a chunk");
  constexpr int kAhead = Pipe::kAhead;
  constexpr int kXBufs = kAhead + 1;
  // + kU: the look-ahead load of a chunk's last group reads past its row
  __shared__ float xs[kXBufs][kRows * kLd + Pipe::kU];
  __shared__ float ys[2][kRows * kLd];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const int nch = (n + kChunk - 1) / kChunk;
  Pipe f;
  f.load(sos, zi, R, r0, rows, lane);

  // copy j of a lane: row j*32/kChunk, column lane + (j*32) % kChunk
  auto stage = [&](int c) {
    const int t0 = c * kChunk;
    const int len = min(kChunk, n - t0);
    float* buf = xs[c % kXBufs];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int r = j * 32 / kChunk;
      const int t = lane + (j * 32) % kChunk;
      if (r < rows && t < len)
        xm::cp_async4(buf + r * kLd + t,
                      x + static_cast<size_t>(r0 + r) * n + t0 + t);
    }
    xm::cp_async_commit();
  };
  auto flush = [&](int c) {  // y chunk c from the ring to device memory
    const int t0 = c * kChunk;
    const int len = min(kChunk, n - t0);
    const float* buf = ys[c & 1];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int r = j * 32 / kChunk;
      const int t = lane + (j * 32) % kChunk;
      if (r < rows && t < len)
        y[static_cast<size_t>(r0 + r) * n + t0 + t] = buf[r * kLd + t];
    }
  };

  for (int c = 0; c < kAhead; ++c) {
    if (c < nch)
      stage(c);
    else
      xm::cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    if (c + kAhead < nch)
      stage(c + kAhead);
    else
      xm::cp_async_commit();     // an empty group keeps the count uniform
    xm::cp_async_wait<kAhead>();  // chunk c has landed
    __syncwarp();
    const int t0 = c * kChunk;
    const int len = min(kChunk, n - t0);
    const float* xr = xs[c % kXBufs] + f.row * kLd;
    float* yr = ys[c & 1] + f.row * kLd;        // y of this chunk
    float* yp = ys[(c + 1) & 1] + f.row * kLd;  // y of the chunk before
    if (c > 0 && c + 1 < nch) {  // every section inside the row
      steady<0, kLag, kLag - kChunk>(f, xr, yp, t0, n);
      steady<kLag, kChunk, kLag>(f, xr, yr, t0, n);
    } else {  // the pipeline fills (c = 0) or the row ends (ragged)
#pragma unroll 4
      for (int t = 0; t < len; ++t) {
        const int k = t0 + t;
        const float yv = f.template tick<true>(xr[t], k, n);
        if (f.writer && k >= kLag) {
          if (t >= kLag)
            yr[t - kLag] = yv;
          else
            yp[kChunk + t - kLag] = yv;
        }
      }
    }
    __syncwarp();
    // y is complete through sample t0 + len - 1 - kLag, so chunk c-1 is;
    // the last chunk's drain may still write the one before it
    if (c > 0 && c + 1 < nch) flush(c - 1);
    __syncwarp();
  }
  // drain: kLag ticks past the row's end finish its last kLag samples
  {
    const int c = nch - 1;
    const int t0 = c * kChunk;
    const int len = n - t0;
    float* yr = ys[c & 1] + f.row * kLd;
    float* yp = ys[(c + 1) & 1] + f.row * kLd;
#pragma unroll 4
    for (int t = len; t < len + kLag; ++t) {
      const int k = t0 + t;
      const float yv = f.template tick<true>(0.f, k, n);
      if (f.writer && k >= kLag) {
        if (t >= kLag)
          yr[t - kLag] = yv;
        else
          yp[kChunk + t - kLag] = yv;
      }
    }
    __syncwarp();
    if (c > 0) flush(c - 1);
    flush(c);
  }
  f.store(zf, R, r0, rows);
}

template <int NS>
int launch(const float* x, const float* sos, const float* zi, float* y,
           float* zf, int R, int n, cudaStream_t stream) {
  const int blocks = (R + Lanes<NS>::kRows - 1) / Lanes<NS>::kRows;
  sosfilt_kernel<Lanes<NS>><<<blocks, 32, 0, stream>>>(x, sos, zi, y, zf, R,
                                                       n);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sosfilt_kernel<Lanes<NS>>, 32, 0) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace

// x, y: (rows, n) row-major float32; sos: (ns, 6) float32 rows
// [b0 b1 b2 1 a1 a2]; zi, zf: (ns, 2, rows) state in / out; 32/ns rows
// per block. 1 <= ns <= kMaxSections. Launches on `stream` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for an ns it
// has no instance for).
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

// Resident blocks per SM of the kernel at ns sections (the segment rule's
// input), or 0 if ns has no instance or the query fails.
extern "C" int xm_sosfilt_blocks_per_sm(int ns) {
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
