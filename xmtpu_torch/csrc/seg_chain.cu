// The exact cascade state entering each time segment of a segmented
// biquad cascade, in float64, in one launch: the chain the segmented IIR
// (kernels/iir.py:_sosfilt_seg) and the segmented EQ + envelope
// (kernels/eq_env.py:_eq_env_seg) run between their passes. It ports no
// Pallas kernel: it replaces the JAX package's XLA lax.scan chain
// (xmtpu/kernels/iir.py:_sosfilt_seg, `chain`), which the port had run
// as a host loop of S steps with two launches each.
//
// Row r*S + k of a pass is segment k of row r. With v_k the zero-state
// final state of segment k (the pass's zf, in float32) and z_0 the state
// entering the row (zi), in the probe order d = 2*s + c of
// kernels/iir.py:_seg_consts:
//
//   zin_k = z_k;   z_{k+1} = z_k @ A_seg^T + v_k
//
// for k = 0 .. S-1, then z_S is the state after the row. The loop over
// the segments is sequential, so a NaN final reaches only the later
// segments of its row, as in the scan. The dot runs j = 0 .. D-1 in
// float64 FMAs; a BLAS product may sum in another order.
//
// What bounds it: nothing on this card at these sizes (1,024 segment
// rows of D <= 16 states: 0.1 MB, 2*D*D*S operations per row); the S
// steps of a row form the chain (D dependent FMAs each), a few
// microseconds. Design: a half-warp per row, lane i holding state i and
// row i of A_seg in registers (D is a template parameter); a step takes
// the row's D states by __shfl_sync and runs lane i's dot in FMAs, j =
// 0 .. D-1, while the next kAhead segments' final states are in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 8;
constexpr int kThreads = 128;  // 8 rows of 16 lanes
constexpr int kAhead = 8;      // segments whose finals load ahead

template <int NS>
__global__ void __launch_bounds__(kThreads)
state_chain_kernel(const float* __restrict__ zf0, const float* __restrict__ zi,
                   const double* __restrict__ a_t, long long sa0,
                   long long sa1, double* __restrict__ zin,
                   double* __restrict__ zlast, int R, int S) {
  constexpr int D = 2 * NS;
  static_assert(D <= 16, "a row's states fit a half-warp");
  const int i = threadIdx.x & 15;  // this lane's state
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 4;
  const bool on = i < D && r < R;
  const int rr = min(r, R - 1);  // lanes past R shuffle along, store nothing
  const size_t rs = static_cast<size_t>(R) * S;
  double a[D];  // a[j] = A_seg[i][j] = a_t[j][i]
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = i < D ? a_t[j * sa0 + i * sa1] : 0.0;
  double z = i < D ? static_cast<double>(zi[static_cast<size_t>(i) * R + rr])
                   : 0.0;
  const float* v_col = zf0 + static_cast<size_t>(i < D ? i : 0) * rs +
                       static_cast<size_t>(rr) * S;
  // the finals of kAhead segments in flight ahead of the chain: a step
  // is ~D dependent FMAs, far shorter than a load from device memory
  float vc[kAhead], vn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) vc[u] = u < S ? v_col[u] : 0.f;
  for (int k0 = 0; k0 < S; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      vn[u] = k0 + kAhead + u < S ? v_col[k0 + kAhead + u] : 0.f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (k0 + u >= S) break;
      double acc = __shfl_sync(0xffffffffu, z, 0, 16) * a[0];
#pragma unroll
      for (int j = 1; j < D; ++j)
        acc = fma(__shfl_sync(0xffffffffu, z, j, 16), a[j], acc);
      if (on) zin[(static_cast<size_t>(rr) * S + k0 + u) * D + i] = z;
      z = acc + static_cast<double>(vc[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) vc[u] = vn[u];
  }
  if (on) zlast[static_cast<size_t>(rr) * D + i] = z;
}

template <int NS>
int launch(const float* zf0, const float* zi, const double* a_t,
           long long sa0, long long sa1, double* zin, double* zlast, int R,
           int S, cudaStream_t stream) {
  const int blocks = (R * 16 + kThreads - 1) / kThreads;
  state_chain_kernel<NS><<<blocks, kThreads, 0, stream>>>(
      zf0, zi, a_t, sa0, sa1, zin, zlast, R, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// zf0: (ns, 2, rows*S) float32, the segments' zero-state final states
// (row r*S + k is segment k of row r); zi: (ns, 2, rows) float32, the
// state entering each row; a_t: the (D, D) float64 A_seg^T, D = 2*ns,
// element (j, i) at a_t[j*sa0 + i*sa1] -> zin: (rows*S, D) float64, the
// state entering each segment; zlast: (rows, D) float64, the state after
// each row. 1 <= ns <= kMaxSections. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int xm_state_chain_f64(const float* zf0, const float* zi,
                                  const double* a_t, long long sa0,
                                  long long sa1, double* zin, double* zlast,
                                  int rows, int S, int ns, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxSections == 8, "one case per section count");
#define XM_CHAIN_CASE(k) \
  case k:                \
    return launch<k>(zf0, zi, a_t, sa0, sa1, zin, zlast, rows, S, s)
  switch (ns) {
    XM_CHAIN_CASE(1);
    XM_CHAIN_CASE(2);
    XM_CHAIN_CASE(3);
    XM_CHAIN_CASE(4);
    XM_CHAIN_CASE(5);
    XM_CHAIN_CASE(6);
    XM_CHAIN_CASE(7);
    XM_CHAIN_CASE(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef XM_CHAIN_CASE
}
