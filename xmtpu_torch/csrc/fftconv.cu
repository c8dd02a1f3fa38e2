// Same-length causal FIR convolution with per-row and per-sample input
// gains: the EQ+reverb stage of the flagship chain.
//
//   y[r, t] = sum_k ir[k] * (x[r, t-k] * pre_row[r] * pre_col[t-k]),
//   t in [0, n), zero history before t = 0.
//
// Replaces the TPU kernel xmtpu/kernels/fftconv.py:_fftconv_kernel
// (reached through fir_convolve_os_pallas), and keeps its algorithm:
// overlap-save FFT convolution of one block between one input load and
// one output store, two real rows packed into one complex transform
// (conv(xa + i*xb, h) = conv(xa, h) + i*conv(xb, h) for a real IR), the
// gains applied as the tile loads, the inverse transform reusing the
// forward one through conjugation. What does not carry over is how the
// TPU computed its DFTs: as 3-pass bf16 matmuls, because its matrix
// unit has no float32 path. Here each block runs a float32 radix-2 FFT
// in shared memory.
//
// What bounds it on the H100: shared-memory bandwidth. A block moves its
// N-point complex frame (N = 8192 at the flagship's 4093 taps, 64 KB)
// through 2*log2(N) = 26 butterfly passes; the flops (about 5 N log2 N
// per transform, 5.5 GFLOP in all at 256 x 160000) and the device-memory
// bytes (x and y once, 0.33 GB; the IR spectrum and twiddles come from
// L2) are far below their peaks. A direct-form FIR of the same function
// was FP32-FMA-bound at 1.7e11 FMA (7.2 ms measured).
//
// Design:
// - spectrum_kernel (one block per call) writes the twiddles
//   w[k] = exp(-2 pi i k / N) (sincospif, accurate to an ulp or two)
//   and the IR spectrum H / N, in bit-reversed order, to a
//   caller-allocated workspace;
// - fft_conv_kernel, one block per (frame, row pair): stage the frame's
//   gained input in natural order, in-place decimation-in-frequency FFT
//   (natural in, bit-reversed out), multiply by H / N and conjugate,
//   in-place decimation-in-time FFT (bit-reversed in, natural out), and
//   store the conjugate's valid samples [m-1, N) of each row:
//   hop = N - (m-1) outputs per frame. Pairing the two orderings means
//   no bit-reversal permutation anywhere: a scattered bit-reversed
//   store puts 32 lanes on one shared-memory bank.
// N is the smallest power of two >= 2*(m-1) (and >= 1024), so at least
// half of every frame is output; the frame and the twiddles take 12*N
// bytes of shared memory, at most 192 KB (N = 16384, m <= 8193).
// The TPU kernel's DFT-on-matrix-units design (here: tensor cores with a
// 3xTF32 split) remains a possible follow-up.
//
// Longer IRs (xm_fir_convolve_long_f32; the TPU kernel runs them at
// blocks of 32768 to 131072 points, e.g. the 24,082-tap folded EQ+reverb
// of the public effects chain at 48 kHz) would need a frame of up to 1 MB
// here. Instead the IR is uniformly partitioned, in the same launch pair
// and with the same 16384-point transform: h_p = ir[p*Lp, (p+1)*Lp),
// Lp = 8192, P = ceil(m / Lp) partitions, and
//   y[t] = sum_p conv(x delayed by p*Lp, h_p)[t].
// - part_spectrum_kernel, one block per partition, writes the P spectra
//   H_p / N (bit-reversed) and the twiddles to the workspace;
// - fft_conv_long_kernel, one block per (frame of 8192 outputs, row
//   pair), loops over the partitions: stage the gained input window that
//   starts at t0 - p*Lp - (Lp-1) (zero before t = 0 and past n, the
//   gains applied to real samples only), forward FFT, multiply by H_p,
//   inverse FFT, and add the window's samples [Lp-1, Lp-1+8192) to 16
//   register accumulators per thread and row; one store at the end.
// Each partition costs a forward and an inverse transform, so the work
// per output is about P times the short form's: the frequency-domain
// delay line (one forward transform per frame, spectra accumulated before
// one inverse) is the known faster design, left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLogN = 14;  // N <= 16384: 192 KB of shared memory

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 FFTs of a[0, N), tw[k] = exp(-2 pi i k / N), k < N/2.
// Stage s combines a[i] and a[i + 2^(s-1)] with twiddle stride N / 2^s.
// Both end with a barrier.

// Decimation in frequency: natural order in, bit-reversed order out.
__device__ void fft_dif(float2* a, const float2* tw, int n_fft, int log_n) {
  for (int s = log_n; s >= 1; --s) {
    const int half = 1 << (s - 1);
    const int tstep = n_fft >> s;
    for (int b = threadIdx.x; b < n_fft / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i = ((b >> (s - 1)) << s) + pos;
      const float2 u = a[i];
      const float2 v = a[i + half];
      a[i] = make_float2(u.x + v.x, u.y + v.y);
      a[i + half] =
          cmul(tw[pos * tstep], make_float2(u.x - v.x, u.y - v.y));
    }
    __syncthreads();
  }
}

// Decimation in time: bit-reversed order in, natural order out.
__device__ void fft_dit(float2* a, const float2* tw, int n_fft, int log_n) {
  for (int s = 1; s <= log_n; ++s) {
    const int half = 1 << (s - 1);
    const int tstep = n_fft >> s;
    for (int b = threadIdx.x; b < n_fft / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i = ((b >> (s - 1)) << s) + pos;
      const float2 u = a[i];
      const float2 t = cmul(tw[pos * tstep], a[i + half]);
      a[i] = make_float2(u.x + t.x, u.y + t.y);
      a[i + half] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }
}

// work[0, N): H / N in bit-reversed order; work[N, N + N/2): twiddles.
__global__ void __launch_bounds__(kThreads)
spectrum_kernel(const float* __restrict__ ir, int m, float2* work,
                int n_fft, int log_n) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* tw = smem + n_fft;
  for (int k = threadIdx.x; k < n_fft / 2; k += blockDim.x) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(k) / static_cast<float>(n_fft), &s,
              &c);
    tw[k] = make_float2(c, s);
    work[n_fft + k] = tw[k];
  }
  const float scale = 1.0f / static_cast<float>(n_fft);  // exact: N = 2^k
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x)
    a[i] = make_float2(i < m ? ir[i] * scale : 0.f, 0.f);
  __syncthreads();
  fft_dif(a, tw, n_fft, log_n);
  for (int k = threadIdx.x; k < n_fft; k += blockDim.x) work[k] = a[k];
}

__global__ void __launch_bounds__(kThreads)
fft_conv_kernel(const float* __restrict__ x, const float* __restrict__ pre_row,
                const float* __restrict__ pre_col,
                const float2* __restrict__ work, float* __restrict__ y,
                int rows, int n, int m, int n_fft, int log_n) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* tw = smem + n_fft;
  const int hop = n_fft - (m - 1);
  const int ra = 2 * blockIdx.y;  // rows ra (real part), ra+1 (imaginary)
  const bool has_b = ra + 1 < rows;
  const float* xa = x + static_cast<size_t>(ra) * n;
  const float* xb = xa + n;
  const float ga = pre_row[ra];
  const float gb = has_b ? pre_row[ra + 1] : 0.f;
  const int g0 = blockIdx.x * hop - (m - 1);  // input index of a[0]

  for (int k = threadIdx.x; k < n_fft / 2; k += blockDim.x)
    tw[k] = work[n_fft + k];
  for (int i = threadIdx.x; i < n_fft; i += blockDim.x) {
    const int g = g0 + i;
    float2 v = make_float2(0.f, 0.f);
    if (g >= 0 && g < n) {
      const float c = pre_col[g];
      v.x = xa[g] * ga * c;
      if (has_b) v.y = xb[g] * gb * c;
    }
    a[i] = v;
  }
  __syncthreads();
  fft_dif(a, tw, n_fft, log_n);
  // spectral multiply and conjugate, both spectra in bit-reversed order;
  // the inverse is then conj(DIT(conj(X * H / N)))
  for (int k = threadIdx.x; k < n_fft; k += blockDim.x) {
    const float2 yk = cmul(a[k], work[k]);
    a[k] = make_float2(yk.x, -yk.y);
  }
  __syncthreads();
  fft_dit(a, tw, n_fft, log_n);
  // y = conj(a) over the frame's valid samples [m-1, N)
  float* ya = y + static_cast<size_t>(ra) * n;
  for (int i = (m - 1) + threadIdx.x; i < n_fft; i += blockDim.x) {
    const int t = g0 + i;
    if (t >= n) break;
    ya[t] = a[i].x;
    if (has_b) ya[n + t] = -a[i].y;
  }
}

// The partitioned form for long IRs (see the note at the top).
constexpr int kLongLogN = kMaxLogN;
constexpr int kLongN = 1 << kLongLogN;
constexpr int kPart = kLongN / 2;             // taps per partition (Lp)
constexpr int kLongHop = kLongN - kPart;      // outputs per frame
constexpr int kPerThread = kLongHop / kThreads;
static_assert(kLongHop % kThreads == 0, "threads tile a frame's outputs");

// work[p*N, (p+1)*N): H_p / N in bit-reversed order, p < parts;
// work[parts*N, parts*N + N/2): twiddles (written by block 0).
__global__ void __launch_bounds__(kThreads)
part_spectrum_kernel(const float* __restrict__ ir, int m, float2* work,
                     int parts) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* tw = smem + kLongN;
  const int p = blockIdx.x;
  for (int k = threadIdx.x; k < kLongN / 2; k += blockDim.x) {
    float s, c;
    sincospif(-2.0f * static_cast<float>(k) / static_cast<float>(kLongN), &s,
              &c);
    tw[k] = make_float2(c, s);
    if (p == 0) work[static_cast<size_t>(parts) * kLongN + k] = tw[k];
  }
  const float scale = 1.0f / static_cast<float>(kLongN);
  const float* h = ir + static_cast<size_t>(p) * kPart;
  const int len = min(kPart, m - p * kPart);  // the last one is shorter
  for (int i = threadIdx.x; i < kLongN; i += blockDim.x)
    a[i] = make_float2(i < len ? h[i] * scale : 0.f, 0.f);
  __syncthreads();
  fft_dif(a, tw, kLongN, kLongLogN);
  float2* w = work + static_cast<size_t>(p) * kLongN;
  for (int k = threadIdx.x; k < kLongN; k += blockDim.x) w[k] = a[k];
}

__global__ void __launch_bounds__(kThreads)
fft_conv_long_kernel(const float* __restrict__ x,
                     const float* __restrict__ pre_row,
                     const float* __restrict__ pre_col,
                     const float2* __restrict__ work, float* __restrict__ y,
                     int rows, int n, int parts) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* tw = smem + kLongN;
  const int ra = 2 * blockIdx.y;  // rows ra (real part), ra+1 (imaginary)
  const bool has_b = ra + 1 < rows;
  const float* xa = x + static_cast<size_t>(ra) * n;
  const float* xb = xa + n;
  const float ga = pre_row[ra];
  const float gb = has_b ? pre_row[ra + 1] : 0.f;
  const int t0 = blockIdx.x * kLongHop;  // the frame's first output

  for (int k = threadIdx.x; k < kLongN / 2; k += blockDim.x)
    tw[k] = work[static_cast<size_t>(parts) * kLongN + k];
  float acc_a[kPerThread], acc_b[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc_a[j] = acc_b[j] = 0.f;

  for (int p = 0; p < parts; ++p) {
    const int g0 = t0 - p * kPart - (kPart - 1);  // input index of a[0]
    for (int i = threadIdx.x; i < kLongN; i += blockDim.x) {
      const int g = g0 + i;
      float2 v = make_float2(0.f, 0.f);
      if (g >= 0 && g < n) {
        const float c = pre_col[g];
        v.x = xa[g] * ga * c;
        if (has_b) v.y = xb[g] * gb * c;
      }
      a[i] = v;
    }
    __syncthreads();
    fft_dif(a, tw, kLongN, kLongLogN);
    const float2* hp = work + static_cast<size_t>(p) * kLongN;
    for (int k = threadIdx.x; k < kLongN; k += blockDim.x) {
      const float2 yk = cmul(a[k], hp[k]);
      a[k] = make_float2(yk.x, -yk.y);
    }
    __syncthreads();
    fft_dit(a, tw, kLongN, kLongLogN);
    // output t0 + i - (Lp-1) is valid for i in [Lp-1, N); take the hop
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const float2 v = a[kPart - 1 + threadIdx.x + j * kThreads];
      acc_a[j] += v.x;
      acc_b[j] -= v.y;
    }
    __syncthreads();  // every read done before the next window lands
  }
  float* ya = y + static_cast<size_t>(ra) * n;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int t = t0 + threadIdx.x + j * kThreads;
    if (t < n) {
      ya[t] = acc_a[j];
      if (has_b) ya[n + t] = acc_b[j];
    }
  }
}

}  // namespace

// x, y: (rows, n) row-major; pre_row: (rows,); pre_col: (n,); ir: (m,);
// work: (3*N/2) float2 scratch, N = 2^log_n >= 2*(m-1). Launches both
// kernels on `stream`; returns cudaGetLastError() after them.
extern "C" int xm_fir_convolve_f32(const float* x, const float* pre_row,
                                   const float* pre_col, const float* ir,
                                   float* work, float* y, int rows, int n,
                                   int m, int log_n, void* stream) {
  if (log_n < 10 || log_n > kMaxLogN) return cudaErrorInvalidValue;
  const int n_fft = 1 << log_n;
  const int hop = n_fft - (m - 1);
  if (m < 1 || 2 * hop < n_fft) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float2) * (n_fft + n_fft / 2);
  const int max_smem = static_cast<int>(sizeof(float2) * 3 << (kMaxLogN - 1));
  cudaError_t err = cudaFuncSetAttribute(
      spectrum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fft_conv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* w2 = reinterpret_cast<float2*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  spectrum_kernel<<<1, kThreads, smem, st>>>(ir, m, w2, n_fft, log_n);
  const dim3 grid((n + hop - 1) / hop, (rows + 1) / 2);
  fft_conv_kernel<<<grid, kThreads, smem, st>>>(x, pre_row, pre_col, w2, y,
                                                rows, n, m, n_fft, log_n);
  return static_cast<int>(cudaGetLastError());
}

// The partitioned form, any m >= 1: x, y, pre_row, pre_col, ir as above;
// work: (parts*N + N/2) float2 scratch, N = 16384, parts = ceil(m/8192).
// Launches both kernels on `stream`; returns cudaGetLastError() after
// them.
extern "C" int xm_fir_convolve_long_f32(const float* x, const float* pre_row,
                                        const float* pre_col, const float* ir,
                                        float* work, float* y, int rows,
                                        int n, int m, void* stream) {
  if (m < 1 || rows < 1 || n < 1) return cudaErrorInvalidValue;
  const int parts = (m + kPart - 1) / kPart;
  const int smem = static_cast<int>(sizeof(float2) * (kLongN + kLongN / 2));
  cudaError_t err = cudaFuncSetAttribute(
      part_spectrum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fft_conv_long_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* w2 = reinterpret_cast<float2*>(work);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  part_spectrum_kernel<<<parts, kThreads, smem, st>>>(ir, m, w2, parts);
  const dim3 grid((n + kLongHop - 1) / kLongHop, (rows + 1) / 2);
  fft_conv_long_kernel<<<grid, kThreads, smem, st>>>(
      x, pre_row, pre_col, w2, y, rows, n, parts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
