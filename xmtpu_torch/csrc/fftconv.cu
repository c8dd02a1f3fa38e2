// Same-length causal FIR convolution with per-row and per-sample input
// gains: the EQ+reverb stage of the flagship chain.
//
//   y[r, t] = sum_k ir[k] * (x[r, t-k] * pre_row[r] * pre_col[t-k]),
//   t in [0, n_out), x zero before t = 0 and from t = n on.
//
// n_out = n is the chain's same-length output; n_out > n is the JAX
// kernel's hop-padded trim=False output, whose samples [n, n_out) are
// the valid convolution tail of the zero-padded input. Both come from
// the same frames and the same stores: a frame's output at t < n does
// not depend on n_out, so the first n samples are bit-identical.
//
// Replaces the TPU kernel xmtpu/kernels/fftconv.py:_fftconv_kernel
// (reached through fir_convolve_os_pallas), and keeps its algorithm:
// overlap-save FFT convolution of one block between one input load and
// one output store, two real rows packed into one complex transform
// (conv(xa + i*xb, h) = conv(xa, h) + i*conv(xb, h) for a real IR), the
// gains applied as the tile loads, the inverse transform reusing the
// forward one through conjugation. What does not carry over is how the
// TPU computed its DFTs: as 3-pass bf16 matmuls, because its matrix
// unit has no float32 path. Here each block runs float32 FFTs with the
// frame held in registers.
//
// What bounds it on the H100: at the flagship shape (256 x 160000, 4093
// taps) the function's bytes (x and y once, 0.33 GB: 0.098 ms) bind,
// ahead of its arithmetic (3.9 GFLOP at its best frame size). A radix-2
// transform in shared memory moved the whole frame through shared
// memory and a barrier 2*log2(N) = 26 times per frame and ran 20x the
// bytes bound; this design runs about 8x (PERF.md).
//
// The transform core (Plan, dif, dit), which every kernel here uses:
// - Mixed radix, in registers. A transform of N = 2^LogN points (1024 to
//   16384, one template instance per size, so every loop unrolls and
//   every index is a shift or a mask) runs as S = ceil(LogN / 4) stages:
//   one of radix R0 = 2^(LogN - 4(S-1)) (2 to 16), then radix 16. Each
//   of T = min(N/16, 512) threads owns P = N/T points (16 or 32) and
//   runs P/R butterflies of radix R per stage, one at a time: its R
//   points in registers, the radix-R DFT as a radix-2 network there with
//   constant twiddles, read from and written back to the same places of
//   the shared frame (so only R points are live: the 32-point instances
//   spilled when a thread held all of its points). The frame crosses a
//   barrier only between two stages: S-1 exchanges per transform (3 at
//   N = 8192 and 16384, 2 below). The first stage of the forward
//   transform loads its points straight from device memory (16 loads
//   issued together), and the last stage of the inverse stores straight
//   to it.
// - Stage s works on sub-transforms of M_s points (M_0 = N, M_{s+1} =
//   M_s / R_s) at stride L_s = M_s / R_s: butterfly b = t + T*q of
//   thread t takes the points at (b / L) * M + b % L + L * k, k < R, and
//   writes its outputs back to the same places, so within a stage no two
//   threads touch one point.
// - Twiddles between stages, W_M^(j*k) = W_N^(j*k*N/M) with j = b % L,
//   come from one table of the N roots w[i] = exp(-2 pi i i / N), written
//   by sincospif (accurate to an ulp or two) and read through the
//   read-only cache; the last stage (L = 1) needs none.
// - Ordering, as before: the forward transform (dif: decimation in
//   frequency, twiddles after each butterfly) takes natural order and
//   leaves the spectrum in mixed-radix digit-reversed order; dit, its
//   transpose (the same stages in reverse order, twiddles before each
//   butterfly), takes that order back to natural. The DFT matrix is
//   symmetric, so dit computes the same forward DFT: the inverse is
//   conj(dit(conj(X * H / N))). The IR spectrum is written by dif, so it
//   lies in the same order, and the spectral product runs in registers
//   between the two transforms (the last stage of dif and the first of
//   dit own the same points). No permutation anywhere.
// - Padding: point p lives at p + p / 16 in shared memory. A warp's
//   float2 accesses are served per half-warp of 16 lanes, conflict-free
//   when their 16 indices differ modulo 16. Where L >= 16 a half-warp's
//   points are 16 consecutive ones; where L < 16 (radix 16, M = 16 L) its
//   lanes cover 16/L sub-transforms g at the same k, p = 16 L g + j + L k,
//   and the pad adds L g: p + p / 16 = j + L g + const (mod 16) over
//   j < L, g < 16/L, all different. As every L is 1 or a multiple of 16,
//   a butterfly's padded places are one base plus constant offsets.
//   (tests/test_torch_kernels.py checks every stage of every size.)
// - The tensor-core design of the TPU kernel (the DFT as matrix products,
//   here with a 3xTF32 split) stays the follow-up if the transform is
//   still the limit.
//
// Kernels:
// - twiddle_kernel writes the N roots to the workspace;
// - spectrum_kernel, one block per IR partition, writes H_p / N (dif
//   order, in the register-slot layout the conv kernels read back
//   coalesced: slot i of thread t at i * T + t);
// - fft_conv_kernel, one block per (frame, row pair): the frame's gained
//   input in natural order, dif, times H / N and conjugated, dit, and
//   the conjugate's valid samples [m-1, N) of each row stored: hop = N -
//   (m-1) outputs per frame. N is the smallest power of two >= 2*(m-1)
//   (and >= 1024), so at least half of every frame is output.
// Longer IRs (xm_fir_convolve_long_f32; the TPU kernel runs them at
// blocks of 32768 to 131072 points, e.g. the 24,082-tap folded EQ+reverb
// of the public effects chain at 48 kHz) would need a frame of up to 1 MB
// here. Instead the IR is uniformly partitioned and run as a
// frequency-domain delay line on the 16384-point transform: h_p =
// ir[p*Lp, (p+1)*Lp), Lp = N/2 = 8192, P = ceil(m / Lp) partitions with
// spectra H_p / N (spectrum_kernel); window j is the gained input
// [(j-1)*Lp, (j+1)*Lp), zero before t = 0 and from n on, with spectrum
// X_j; and output frame f, samples [f*Lp, (f+1)*Lp), is the points
// [Lp, N) of conj(dit(conj(sum_{p <= min(f, P-1)} X_{f-p} * H_p / N))).
// - window_spectrum_kernel, one block per (window, row pair): dif of the
//   window, X_j written to a workspace of spectra in dif order and in the
//   register-slot layout;
// - fdl_inverse_kernel, one block per (frame, row pair): each thread reads
//   its own slots of X_f .. X_{f-P+1} and of H_0 .. H_{P-1}, sums the
//   products in registers (no exchange: the slots a thread writes in one
//   kernel are the ones it reads in the other), conjugates, runs dit and
//   stores the points [Lp, N) (the first stage's points k >= R0/2).
// A frame costs one forward and one inverse transform whatever P is: each
// window's spectrum serves the P frames that read it, and the P products
// are summed before the inverse. The grid's x is the frame, so neighbouring
// frames of one pair run together and the P reads of a spectrum after its
// first mostly hit the L2. The workspace holds `slots` spectra a pair: all
// windows' when they fit under the wrapper's cap, else a ring (window j at
// slot j % slots, slots >= chunk + P - 1) with the frames run in chunks,
// each chunk's windows before its frames, so a chunk overwrites only
// windows that no later frame reads. What bounds it: the two transforms a
// frame, run at the core's rate (each block holds the whole frame, so one
// block an SM and its latencies unhidden). The spectra's traffic, 128 KB
// written and P x 128 KB of X and of H read a frame and pair (the H reads
// and all but the first X read from the L2), costs little beside them
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kMinLogN = 10;
constexpr int kMaxLogN = 14;
constexpr int kMaxThreads = 512;
constexpr int kTwiddleThreads = 256;

// The transform of 2^LogN points (see the note at the top).
template <int LogN>
struct Plan {
  static constexpr int N = 1 << LogN;
  static constexpr int T = N / 16 < kMaxThreads ? N / 16 : kMaxThreads;
  static constexpr int P = N / T;           // points per thread
  static constexpr int S = (LogN + 3) / 4;  // radix stages
  static constexpr int R0 = 1 << (LogN - 4 * (S - 1));
  static constexpr int kSmem =
      static_cast<int>(sizeof(float2)) * (N + N / 16);  // padded frame
  __host__ __device__ static constexpr int radix(int s) {
    return s == 0 ? R0 : 16;
  }
  __host__ __device__ static constexpr int span(int s) {  // M_s
    return s == 0 ? N : (N / R0) >> (4 * (s - 1));
  }
  __host__ __device__ static constexpr int stride(int s) {  // L_s
    return span(s) / radix(s);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * exp(-2 pi i e / 16), 0 <= e < 8. e is a constant once the
// butterfly loops unroll, so the branches fold away (straight-line code:
// a table indexed by e would put the register arrays in local memory).
__device__ __forceinline__ float2 w16(float2 a, int e) {
  constexpr float kC1 = 0.923879532511286756f;  // cos(pi/8)
  constexpr float kC2 = 0.707106781186547524f;  // cos(pi/4)
  constexpr float kC3 = 0.382683432365089772f;  // cos(3 pi/8)
  float c = 0.f, s = 1.f;  // cos, sin of pi e / 8
  if (e == 0) return a;
  if (e == 4) return make_float2(a.y, -a.x);
  if (e == 1) c = kC1, s = kC3;
  if (e == 2) c = kC2, s = kC2;
  if (e == 3) c = kC3, s = kC1;
  if (e == 5) c = -kC3, s = kC1;
  if (e == 6) c = -kC2, s = kC2;
  if (e == 7) c = -kC1, s = kC3;
  return make_float2(a.x * c + a.y * s, a.y * c - a.x * s);
}

// The bits-bit reversal of k, bits <= 4.
__host__ __device__ constexpr int bitrev(int k, int bits) {
  return (((k & 1) << 3) | ((k & 2) << 1) | ((k & 4) >> 1) |
          ((k & 8) >> 3)) >> (4 - bits);
}

// R-point DFT of x[0, R) in registers, natural order in and out: a
// radix-2 decimation-in-frequency network, then a relabelling of
// registers that costs no instruction.
template <int R>
__device__ __forceinline__ void dft(float2* x) {
  constexpr int kBits = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  // constant trip counts, so both loops unroll and every index folds
  // (a loop halving its counter does not unroll, and an array indexed
  // at run time lives in local memory)
#pragma unroll
  for (int lh = kBits - 1; lh >= 0; --lh) {
#pragma unroll
    for (int bf = 0; bf < R / 2; ++bf) {
      const int i = bf & ((1 << lh) - 1);
      const int a = ((bf >> lh) << (lh + 1)) + i;  // the pair a, a + h
      const float2 u = x[a];
      const float2 w = x[a + (1 << lh)];
      x[a] = make_float2(u.x + w.x, u.y + w.y);
      x[a + (1 << lh)] =
          w16(make_float2(u.x - w.x, u.y - w.y), i << (3 - lh));
    }
  }
  float2 y[R];
#pragma unroll
  for (int k = 0; k < R; ++k) y[k] = x[bitrev(k, kBits)];
#pragma unroll
  for (int k = 0; k < R; ++k) x[k] = y[k];
}

// Point k of butterfly q of this thread at stage s.
template <class Pl, int s>
__device__ __forceinline__ int position(int q, int k) {
  constexpr int L = Pl::stride(s);
  constexpr int M = Pl::span(s);
  const int b = static_cast<int>(threadIdx.x) + Pl::T * q;
  return (b / L) * M + (b % L) + L * k;
}

// Its place p + p / 16 in the padded shared frame. Every stride L is 1
// or a multiple of 16 and every span M a multiple of 16, so that is
// g*(M + M/16) + j + j/16 + k*(L + L/16) (g = b / L, j = b % L): one base
// per butterfly plus a constant offset per point.
template <class Pl, int s>
__device__ __forceinline__ int padded(int q, int k) {
  constexpr int L = Pl::stride(s);
  constexpr int M = Pl::span(s);
  static_assert(M % 16 == 0 && (L == 1 || L % 16 == 0), "pad arithmetic");
  const int b = static_cast<int>(threadIdx.x) + Pl::T * q;
  const int j = b % L;
  return (b / L) * (M + M / 16) + j + (j >> 4) + k * (L + L / 16);
}

// x[k] *= W_M^(j*k) = w[j * k * N/M], k = 1 .. R-1.
template <class Pl, int s>
__device__ __forceinline__ void twiddle(float2* x, int j,
                                        const float2* __restrict__ tw) {
  constexpr int R = Pl::radix(s);
  constexpr int kStep = Pl::N / Pl::span(s);
  if constexpr (Pl::stride(s) > 1) {
#pragma unroll
    for (int k = 1; k < R; ++k) x[k] = cmul(x[k], __ldg(tw + j * k * kStep));
  }
}

// Butterfly q of stage s on its R points x; kDit: the transposed stage
// (twiddles first).
template <class Pl, int s, bool kDit>
__device__ __forceinline__ void butterfly(float2* x, int q,
                                          const float2* __restrict__ tw) {
  constexpr int R = Pl::radix(s);
  const int j = (static_cast<int>(threadIdx.x) + Pl::T * q) % Pl::stride(s);
  if constexpr (kDit) twiddle<Pl, s>(x, j, tw);
  dft<R>(x);
  if constexpr (!kDit) twiddle<Pl, s>(x, j, tw);
}

// Stage s on the padded shared frame `a`, in place, one butterfly at a
// time: only its R points are live in registers.
template <class Pl, int s, bool kDit>
__device__ __forceinline__ void stage(float2* a,
                                      const float2* __restrict__ tw) {
  constexpr int R = Pl::radix(s);
#pragma unroll
  for (int q = 0; q < Pl::P / R; ++q) {
    float2 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = a[padded<Pl, s>(q, k)];
    butterfly<Pl, s, kDit>(x, q, tw);
#pragma unroll
    for (int k = 0; k < R; ++k) a[padded<Pl, s>(q, k)] = x[k];
  }
}

// Stages s, s+1, ... (dif) or s, s-1, ... (dit) up to kEnd (excluded),
// each after a barrier.
template <class Pl, int s, int kEnd, bool kDit>
__device__ __forceinline__ void stages(float2* a,
                                       const float2* __restrict__ tw) {
  if constexpr (s != kEnd) {
    __syncthreads();
    stage<Pl, s, kDit>(a, tw);
    stages<Pl, kDit ? s - 1 : s + 1, kEnd, kDit>(a, tw);
  }
}

// The forward transform up to its last stage: stage 0 takes its points
// from load(p) (natural order; 16 points of the thread's loads issued
// before their butterflies, so the latencies overlap without holding all
// P points) and writes them to the shared frame, stages 1 .. S-2 follow
// there. Ends with a barrier.
template <class Pl, class Load>
__device__ __forceinline__ void dif_head(float2* a,
                                         const float2* __restrict__ tw,
                                         Load load) {
  constexpr int R0 = Pl::R0;
  constexpr int kQ = 16 / R0;  // butterflies per 16 points
#pragma unroll
  for (int c = 0; c < Pl::P / 16; ++c) {
    float2 x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = load(position<Pl, 0>(c * kQ + i / R0, i % R0));
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int q = c * kQ + u;
      butterfly<Pl, 0, false>(x + u * R0, q, tw);
#pragma unroll
      for (int k = 0; k < R0; ++k) a[padded<Pl, 0>(q, k)] = x[u * R0 + k];
    }
  }
  stages<Pl, 1, Pl::S - 1, false>(a, tw);
  __syncthreads();
}

// The last stage of dif from the shared frame, its outputs (the spectrum
// in digit-reversed order) written to `out` in the register-slot layout:
// slot q*R + k of thread t at (q*R + k)*T + t.
template <class Pl>
__device__ __forceinline__ void dif_store(const float2* a,
                                          const float2* __restrict__ tw,
                                          float2* __restrict__ out) {
  constexpr int s = Pl::S - 1;
  constexpr int R = Pl::radix(s);
#pragma unroll
  for (int q = 0; q < Pl::P / R; ++q) {
    float2 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = a[padded<Pl, s>(q, k)];
    butterfly<Pl, s, false>(x, q, tw);
#pragma unroll
    for (int k = 0; k < R; ++k) out[(q * R + k) * Pl::T + threadIdx.x] = x[k];
  }
}

// The turn between the transforms, in registers: the last stage of dif
// (the spectrum in digit-reversed order), v -> conj(v * H) with H in the
// register-slot layout (slot q*16 + k of thread t at (q*16 + k)*T + t),
// and the first stage of dit on the same points.
template <class Pl>
__device__ __forceinline__ void turn(float2* a, const float2* __restrict__ h,
                                     const float2* __restrict__ tw) {
  constexpr int s = Pl::S - 1;
  constexpr int R = Pl::radix(s);
#pragma unroll
  for (int q = 0; q < Pl::P / R; ++q) {
    float2 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = a[padded<Pl, s>(q, k)];
    butterfly<Pl, s, false>(x, q, tw);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float2 p = cmul(x[k], __ldg(h + (q * R + k) * Pl::T + threadIdx.x));
      x[k] = make_float2(p.x, -p.y);
    }
    butterfly<Pl, s, true>(x, q, tw);
#pragma unroll
    for (int k = 0; k < R; ++k) a[padded<Pl, s>(q, k)] = x[k];
  }
}

// The inverse's remaining stages S-2 .. 0 (dit from the turn); stage 0
// gives its natural-order outputs to store(q, k, p, v) instead of the
// shared frame.
template <class Pl, class Store>
__device__ __forceinline__ void dit_tail(float2* a,
                                         const float2* __restrict__ tw,
                                         Store store) {
  constexpr int R0 = Pl::R0;
  stages<Pl, Pl::S - 2, 0, true>(a, tw);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Pl::P / R0; ++q) {
    float2 x[R0];
#pragma unroll
    for (int k = 0; k < R0; ++k) x[k] = a[padded<Pl, 0>(q, k)];
    butterfly<Pl, 0, true>(x, q, tw);
#pragma unroll
    for (int k = 0; k < R0; ++k) store(q, k, position<Pl, 0>(q, k), x[k]);
  }
}

// The gained input window x[g0 + p], zero outside [0, n); row b only if
// present.
struct Window {
  const float* xa;
  const float* xb;
  const float* pre_col;
  float ga, gb;
  bool has_b;
  int g0, n;
  __device__ __forceinline__ float2 operator()(int p) const {
    const int g = g0 + p;
    float2 w = make_float2(0.f, 0.f);
    if (g >= 0 && g < n) {
      const float c = __ldg(pre_col + g);
      w.x = __ldg(xa + g) * ga * c;
      if (has_b) w.y = __ldg(xb + g) * gb * c;
    }
    return w;
  }
};

__global__ void twiddle_kernel(float2* tw, int n_fft) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n_fft) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(k) / static_cast<float>(n_fft), &s,
              &c);
    tw[k] = make_float2(c, s);
  }
}

// Block p: H_p / N of ir[p*part, min(m, (p+1)*part)), zero-padded to N.
template <class Pl>
__global__ void __launch_bounds__(Pl::T)
spectrum_kernel(const float* __restrict__ ir, int m, int part,
                const float2* __restrict__ tw, float2* __restrict__ h) {
  extern __shared__ float2 smem[];
  const float* hp = ir + static_cast<size_t>(blockIdx.x) * part;
  const int len = min(part, m - static_cast<int>(blockIdx.x) * part);
  const float scale = 1.0f / static_cast<float>(Pl::N);  // exact: N = 2^k
  dif_head<Pl>(smem, tw, [&](int p) {
    return make_float2(p < len ? hp[p] * scale : 0.f, 0.f);
  });
  dif_store<Pl>(smem, tw, h + static_cast<size_t>(blockIdx.x) * Pl::N);
}

template <class Pl>
__global__ void __launch_bounds__(Pl::T, 1)
fft_conv_kernel(const float* __restrict__ x, const float* __restrict__ pre_row,
                const float* __restrict__ pre_col,
                const float2* __restrict__ h, const float2* __restrict__ tw,
                float* __restrict__ y, int rows, int n, int m, int n_out) {
  extern __shared__ float2 smem[];
  const int hop = Pl::N - (m - 1);
  const int ra = 2 * blockIdx.y;  // rows ra (real part), ra+1 (imaginary)
  const bool has_b = ra + 1 < rows;
  const float* xa = x + static_cast<size_t>(ra) * n;
  const float ga = pre_row[ra];
  const float gb = has_b ? pre_row[ra + 1] : 0.f;
  const int g0 = blockIdx.x * hop - (m - 1);  // input index of point 0

  float* ya = y + static_cast<size_t>(ra) * n_out;
  dif_head<Pl>(smem, tw, Window{xa, xa + n, pre_col, ga, gb, has_b, g0, n});
  turn<Pl>(smem, h, tw);
  // y = conj(v) over the frame's valid points [m-1, N)
  dit_tail<Pl>(smem, tw, [&](int, int, int p, float2 v) {
    const int t = g0 + p;
    if (p >= m - 1 && t < n_out) {
      ya[t] = v.x;
      if (has_b) ya[n_out + t] = -v.y;
    }
  });
}

// The frequency-domain delay line for long IRs (see the note at the top).
using LongPlan = Plan<kMaxLogN>;
constexpr int kPart = LongPlan::N / 2;            // taps per partition (Lp)
constexpr int kLongHop = LongPlan::N - kPart;     // outputs per frame
static_assert(LongPlan::R0 % 2 == 0,
              "the outputs [N/2, N) are stage 0's points k >= R0/2");

// Block (i, pair): X_j of window j = j0 + i, the pair's gained input
// [(j-1)*Lp, (j+1)*Lp), at slot j % slots of the pair's spectra.
template <class Pl>
__global__ void __launch_bounds__(Pl::T, 1)
window_spectrum_kernel(const float* __restrict__ x,
                       const float* __restrict__ pre_row,
                       const float* __restrict__ pre_col,
                       const float2* __restrict__ tw, float2* __restrict__ xs,
                       int rows, int n, int j0, int slots) {
  extern __shared__ float2 smem[];
  const int ra = 2 * blockIdx.y;  // rows ra (real part), ra+1 (imaginary)
  const bool has_b = ra + 1 < rows;
  const float* xa = x + static_cast<size_t>(ra) * n;
  const float ga = pre_row[ra];
  const float gb = has_b ? pre_row[ra + 1] : 0.f;
  const int j = j0 + blockIdx.x;
  dif_head<Pl>(smem, tw, Window{xa, xa + n, pre_col, ga, gb, has_b,
                                (j - 1) * kPart, n});
  dif_store<Pl>(smem, tw,
                xs + (static_cast<size_t>(blockIdx.y) * slots + j % slots) *
                         Pl::N);
}

// Block (i, pair): output frame f = f0 + i of the pair's rows, samples
// [f*Lp, (f+1)*Lp), from the sum of X_{f-p} * H_p / N over p <= min(f,
// P-1), conjugated, through dit.
template <class Pl>
__global__ void __launch_bounds__(Pl::T, 1)
fdl_inverse_kernel(const float2* __restrict__ xs,
                   const float2* __restrict__ h,
                   const float2* __restrict__ tw, float* __restrict__ y,
                   int rows, int parts, int n_out, int f0, int slots) {
  extern __shared__ float2 smem[];
  constexpr int s = Pl::S - 1;
  constexpr int R = Pl::radix(s);
  constexpr int kHalf = Pl::R0 / 2;
  const int ra = 2 * blockIdx.y;
  const bool has_b = ra + 1 < rows;
  const int f = f0 + blockIdx.x;
  const int used = min(parts, f + 1);  // X_j = 0 for j < 0
  const float2* xp = xs + static_cast<size_t>(blockIdx.y) * slots * Pl::N;
#pragma unroll
  for (int q = 0; q < Pl::P / R; ++q) {
    const int i0 = q * R * Pl::T + static_cast<int>(threadIdx.x);
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = make_float2(0.f, 0.f);
    for (int p = 0; p < used; ++p) {
      const float2* xw =
          xp + static_cast<size_t>((f - p) % slots) * Pl::N + i0;
      const float2* hw = h + static_cast<size_t>(p) * Pl::N + i0;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float2 u = cmul(__ldg(xw + k * Pl::T), __ldg(hw + k * Pl::T));
        v[k] = make_float2(v[k].x + u.x, v[k].y + u.y);
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) v[k].y = -v[k].y;
    butterfly<Pl, s, true>(v, q, tw);
#pragma unroll
    for (int k = 0; k < R; ++k) smem[padded<Pl, s>(q, k)] = v[k];
  }
  // point i of the frame is output f*Lp + i - Lp; y = conj(v) on [Lp, N)
  float* ya = y + static_cast<size_t>(ra) * n_out;
  const int t0 = f * kLongHop - kPart;
  dit_tail<Pl>(smem, tw, [&](int, int k, int p, float2 w) {
    const int t = t0 + p;
    if (k >= kHalf && t < n_out) {
      ya[t] = w.x;
      if (has_b) ya[n_out + t] = -w.y;
    }
  });
}

// work: [H_p / N for p < parts (parts*N) | twiddles (N)] float2.
template <class Pl>
cudaError_t launch_spectra(const float* ir, int m, int part, int parts,
                           float2* work, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      spectrum_kernel<Pl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Pl::kSmem);
  if (err != cudaSuccess) return err;
  float2* tw = work + static_cast<size_t>(parts) * Pl::N;
  twiddle_kernel<<<Pl::N / kTwiddleThreads, kTwiddleThreads, 0, st>>>(
      tw, Pl::N);
  spectrum_kernel<Pl><<<parts, Pl::T, Pl::kSmem, st>>>(ir, m, part, tw,
                                                       work);
  return cudaSuccess;
}

template <int LogN>
int run_short(const float* x, const float* pre_row, const float* pre_col,
              const float* ir, float2* work, float* y, int rows, int n,
              int m, int n_out, cudaStream_t st) {
  using Pl = Plan<LogN>;
  cudaError_t err = cudaFuncSetAttribute(
      fft_conv_kernel<Pl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Pl::kSmem);
  if (err == cudaSuccess) err = launch_spectra<Pl>(ir, m, m, 1, work, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hop = Pl::N - (m - 1);
  const dim3 grid((n_out + hop - 1) / hop, (rows + 1) / 2);
  fft_conv_kernel<Pl><<<grid, Pl::T, Pl::kSmem, st>>>(
      x, pre_row, pre_col, work, work + Pl::N, y, rows, n, m, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, n), y: (rows, n_out) row-major, n_out >= n; pre_row:
// (rows,); pre_col: (n,); ir: (m,); work: 2*N float2 scratch, N = 2^log_n
// >= 2*(m-1), 10 <= log_n <= 14.
// Launches the three kernels on `stream`; returns cudaGetLastError()
// after them.
extern "C" int xm_fir_convolve_f32(const float* x, const float* pre_row,
                                   const float* pre_col, const float* ir,
                                   float* work, float* y, int rows, int n,
                                   int m, int log_n, int n_out,
                                   void* stream) {
  if (log_n < kMinLogN || log_n > kMaxLogN) return cudaErrorInvalidValue;
  const int n_fft = 1 << log_n;
  if (m < 1 || 2 * (n_fft - (m - 1)) < n_fft) return cudaErrorInvalidValue;
  if (n_out < n) return cudaErrorInvalidValue;
  auto* w2 = reinterpret_cast<float2*>(work);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (log_n) {
    case 10: return run_short<10>(x, pre_row, pre_col, ir, w2, y, rows, n, m, n_out, st);
    case 11: return run_short<11>(x, pre_row, pre_col, ir, w2, y, rows, n, m, n_out, st);
    case 12: return run_short<12>(x, pre_row, pre_col, ir, w2, y, rows, n, m, n_out, st);
    case 13: return run_short<13>(x, pre_row, pre_col, ir, w2, y, rows, n, m, n_out, st);
    default: return run_short<14>(x, pre_row, pre_col, ir, w2, y, rows, n, m, n_out, st);
  }
}

// The frequency-domain delay line, any m >= 1: x, y, pre_row, pre_col,
// ir and n_out as above; F = ceil(n_out / 8192) frames, P = ceil(m /
// 8192) partitions, pairs = ceil(rows / 2); slots: window spectra kept a
// pair, chunk: frames run a launch pair, with 1 <= chunk <= F and slots ==
// F (no ring) or F > slots >= chunk + P - 1 (a ring); work: (P + 1 +
// pairs * slots) * N float2 scratch, N = 16384.
// Launches the twiddles, the IR spectra, then for each chunk its window
// spectra and its frames, on `stream`; returns cudaGetLastError() after
// them.
extern "C" int xm_fir_convolve_long_f32(const float* x, const float* pre_row,
                                        const float* pre_col, const float* ir,
                                        float* work, float* y, int rows,
                                        int n, int m, int n_out, int slots,
                                        int chunk, void* stream) {
  if (m < 1 || rows < 1 || n < 1 || n_out < n)
    return cudaErrorInvalidValue;
  using Pl = LongPlan;
  const int parts = (m - 1) / kPart + 1;
  const int frames = (n_out - 1) / kLongHop + 1;
  if (chunk < 1 || chunk > frames || slots > frames ||
      (slots < frames && slots < chunk + parts - 1))
    return cudaErrorInvalidValue;
  auto* h = reinterpret_cast<float2*>(work);
  float2* tw = h + static_cast<size_t>(parts) * Pl::N;
  float2* xs = tw + Pl::N;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      window_spectrum_kernel<Pl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Pl::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fdl_inverse_kernel<Pl>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Pl::kSmem);
  if (err == cudaSuccess)
    err = launch_spectra<Pl>(ir, m, kPart, parts, h, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = (rows + 1) / 2;
  for (int f0 = 0; f0 < frames; f0 += chunk) {
    const dim3 grid(frames - f0 < chunk ? frames - f0 : chunk, pairs);
    window_spectrum_kernel<Pl><<<grid, Pl::T, Pl::kSmem, st>>>(
        x, pre_row, pre_col, tw, xs, rows, n, f0, slots);
    fdl_inverse_kernel<Pl><<<grid, Pl::T, Pl::kSmem, st>>>(
        xs, h, tw, y, rows, parts, n_out, f0, slots);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
