// The noise suppressor with the adaptive noise estimate, over the
// spectra (ops/ns.py's items 2 to 4 and the product X*G for
// noise_update="adaptive"), in two launches. It ports no Pallas kernel:
// the JAX package runs the tracker as a lax.scan over frames. It was
// added because the port ran the tracker as a loop over frames on the
// host, about nine launches a frame (about 100,000 for a batch of the
// voice cell's 32 x 10,337 x 257 spectra), so the host paced the card.
//
// Per chain (row r, bin f) of X, (R, T, F) complex128, frames along t,
// with the noise seeded by the lead-in median (ops/ns.py):
//
//   psd = re^2 + im^2
//   for t >= lead:  noise = psd / max(noise, 1e-20) < thresh
//                           ? a_n noise + (1 - a_n) psd : noise * up_leak
//   P[t] = a P[t-1] + (1-a) psd,  P[-1] = 0
//   snr = max(P / max(noise, 1e-20) - 1, 0);  G = max(snr / (1 + snr), floor)
//   Y[t] = X[t] * G, rounded to complex64
//
// all in float64, every operation rounded once as the plain twin
// (kernels/ns.py track_plain) rounds it: no contraction into FMAs, IEEE
// division, the maxima propagating NaN as torch.clamp_min does. The twin
// and this kernel give the same Y bit for bit on the same spectra.
//
// Why float64: the tracker's two branches differ by some 12% at the
// threshold, so a branch decision that flips moves the estimate of that
// bin for hundreds of frames. From float32 spectra, two of three batches
// of 32 minute-long tracks on an H100 held a track that flipped decisions
// against the float64 definition and read -67 to -69 dB; float64 spectra
// and state make the definition's decisions.
//
// The decision needs no division where psd is clear of thresh * d (d the
// clamped noise): with tlo and thi thresh * (1 -/+ 2^-40) rounded,
// psd < d * tlo implies fl(psd / d) < thresh, and psd > d * thi the
// opposite, since tlo, thi and the products each carry one rounding of
// 2^-53 (or the product overflows to inf, which decides rightly too); in
// between, and for NaN or inf, the division decides. That holds for d in
// [1e-20, inf] and thresh in (2^-900, 2^900), where nothing underflows;
// for other thresholds the host passes tlo = -inf and thi = inf, so the
// division always decides. A NaN estimate stays NaN on either branch.
//
// The recursion cannot be split along frames by a closed form: its map
// jumps at the threshold. But a split replayed from the exact state is
// exact. Pass A (checkpoints_kernel, one thread a chain: R*F threads)
// walks each chain through the frames of its first S - 1 segments of L
// frames with the estimate and the smoothing alone, and writes the state
// (noise, P) at each segment's start. Pass B (track_kernel, R*F*S
// threads) enters segment s with that state, replays the same recursion
// over the segment's frames, and computes G and writes Y. Pass A's chain
// is the longest one (8,224 threads at the voice cell's shape, two warps
// an SM), so it keeps only what the next frame's state needs (a chain of
// a product, a compare and a select a frame), with kGroupsA groups
// of kGroupA frames in flight in a ring in shared memory (cp.async, one
// 16-byte copy a thread and frame, each thread reading back only its
// own): a thread waits once a group, takes the group's PSDs at once and
// then runs the chain through them. Pass B works by groups of kAheadB
// frames too (PSDs, then the chain, then the gains), with the next group
// loaded in registers; its many threads hide the gain's latency. What
// bounds the work: the spectra read twice (16 bytes a bin and frame each
// time) and Y written once (8), and pass A's chain. On an H100 at the
// voice44k_adaptive cell's shape (32 x 10,337 x 257, S = 48) pass A took
// 0.81 ms (0.49 with the estimate left out: the reads alone), pass B
// 0.83; one thread walking each whole chain with the gain took 5.4 ms,
// and a branch to the division in every frame's decision 1.47 for pass A.
// Four frames ahead in pass B (80 registers, six blocks an SM) beat
// eight (140, three) by 0.17 ms; pass A's ring depth (32 to 64 frames)
// and group size (4 to 16) moved it by 0.1 ms at most.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreadsA = 64;   // chains a block of pass A
constexpr int kGroupA = 8;      // frames pass A waits for at once
constexpr int kGroupsA = 4;     // groups in its ring, a power of 2
constexpr int kRingA = kGroupA * kGroupsA;
constexpr int kSmemA = kRingA * kThreadsA * 16;  // bytes of the ring
constexpr int kThreadsB = 128;  // chains a block of pass B, one segment
constexpr int kAheadB = 4;      // frames pass B loads ahead of its chain

// torch.clamp_min: a NaN stays NaN (fmax would drop it)
__device__ __forceinline__ double clamp_min(double v, double lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ double psd_of(double2 v) {
  return __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y));
}

struct Params {
  int C, T, F, S, L, lead;
  double a, b, an, bn, thresh, tlo, thi, leak, gfloor;
  double clo, chi;  // 1e-20 * tlo, 1e-20 * thi: the clamped noise's bounds
};

// The estimate after a frame of PSD psd (header): the update where
// psd / max(nz, 1e-20) < thresh, else the leak; the division only where
// psd lies within 2^-40 of thresh * d.
__device__ __forceinline__ double track_step(double nz, double psd,
                                             const Params& q) {
  const double d = fmax(nz, 1e-20);  // clamp_min but for a NaN estimate
  bool below = psd < __dmul_rn(d, q.tlo);
  if (!below && !(psd > __dmul_rn(d, q.thi)))
    below = __ddiv_rn(psd, clamp_min(nz, 1e-20)) < q.thresh;
  return below ? __dadd_rn(__dmul_rn(q.an, nz), __dmul_rn(q.bn, psd))
               : __dmul_rn(nz, q.leak);
}

// The estimate through the N frames t0 .. t0+N-1 of PSDs psd (header),
// each frame's estimate into est. Past the lead-in each frame is decided
// without a division: max(nz, 1e-20) * tlo is max(nz * tlo, clo), as the
// rounding is monotone, so the chain from one estimate to the next is a
// product, a compare and a select, with no branch. Where a frame of the
// group falls within the margin (or is NaN), the group is replayed from
// its first estimate with track_step, whose division decides; so is a
// group the lead-in ends in.
template <int N>
__device__ __forceinline__ double track_group(double nz,
                                              const double (&psd)[N], int t0,
                                              const Params& q,
                                              double (&est)[N]) {
  if (t0 >= q.lead) {
    const double nz0 = nz;
    bool unsure = false;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool below = psd[u] < __dmul_rn(nz, q.tlo) || psd[u] < q.clo;
      unsure |= !below && !(psd[u] > __dmul_rn(nz, q.thi) && psd[u] > q.chi);
      nz = below ? __dadd_rn(__dmul_rn(q.an, nz), __dmul_rn(q.bn, psd[u]))
                 : __dmul_rn(nz, q.leak);
      est[u] = nz;
    }
    if (!unsure) return nz;
    nz = nz0;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (t0 + u >= q.lead) nz = track_step(nz, psd[u], q);
    est[u] = nz;
  }
  return nz;
}

// Chain c = r * F + f at frame t0 of row r.
__device__ __forceinline__ size_t chain_base(int c, int t0, const Params& q) {
  const int r = c / q.F;
  return (static_cast<size_t>(r) * q.T + t0) * q.F + (c - r * q.F);
}

// Pass A: ck[(s - 1) * C + c] = the noise and ck[(S - 1 + s - 1) * C + c]
// = P at the start of segment s, s = 1 .. S-1.
__global__ void __launch_bounds__(kThreadsA)
checkpoints_kernel(const double2* __restrict__ x, double* __restrict__ ck,
                   const double* __restrict__ seed, Params q) {
  extern __shared__ double2 ring[];  // [kRingA][kThreadsA]
  const int c = blockIdx.x * kThreadsA + threadIdx.x;
  if (c >= q.C) return;
  const double2* p = x + chain_base(c, 0, q);
  const int len = (q.S - 1) * q.L;
  // group g's frames into ring slots (g % kGroupsA) * kGroupA + u
  auto issue = [&](int g) {
    double2* slot = ring + (g & (kGroupsA - 1)) * kGroupA * kThreadsA +
                    threadIdx.x;
#pragma unroll
    for (int u = 0; u < kGroupA; ++u) {
      const int t = g * kGroupA + u;
      if (t < len) xm::cp_async16(slot + u * kThreadsA, p + t * q.F);
    }
    xm::cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kGroupsA; ++g) issue(g);
  double nz = seed[c];
  double P = 0.0;
  double* ck_nz = ck + c;
  double* ck_p = ck + static_cast<size_t>(q.S - 1) * q.C + c;
  int left = q.L;
  for (int g = 0; g * kGroupA < len; ++g) {  // L is a multiple of kGroupA
    xm::cp_async_wait<kGroupsA - 1>();  // group g is in
    const double2* slot = ring + (g & (kGroupsA - 1)) * kGroupA * kThreadsA +
                          threadIdx.x;
    double psd[kGroupA], est[kGroupA];
#pragma unroll
    for (int u = 0; u < kGroupA; ++u) psd[u] = psd_of(slot[u * kThreadsA]);
    nz = track_group(nz, psd, g * kGroupA, q, est);
#pragma unroll
    for (int u = 0; u < kGroupA; ++u)
      P = __dadd_rn(__dmul_rn(q.a, P), __dmul_rn(q.b, psd[u]));
    if ((left -= kGroupA) == 0) {
      left = q.L;
      *ck_nz = nz;
      *ck_p = P;
      ck_nz += q.C;
      ck_p += q.C;
    }
    issue(g + kGroupsA);  // into the slots just used: their PSDs are in
  }
}

// Pass B: segment s from its state, G and Y; each frame's estimate into
// noise_out when it is not null.
__global__ void __launch_bounds__(kThreadsB)
track_kernel(const double2* __restrict__ x, float2* __restrict__ y,
             const double* __restrict__ seed, const double* __restrict__ ck,
             double* __restrict__ noise_out, Params q) {
  const int c = blockIdx.x * kThreadsB + threadIdx.x;
  if (c >= q.C) return;
  const int s = blockIdx.y;
  const int t0 = s * q.L;
  double nz = s ? ck[static_cast<size_t>(s - 1) * q.C + c] : seed[c];
  double P = s ? ck[static_cast<size_t>(q.S - 1 + s - 1) * q.C + c] : 0.0;
  const size_t base = chain_base(c, t0, q);
  const double2* p = x + base;
  float2* out = y + base;
  double* nout = noise_out ? noise_out + base : nullptr;
  const int len = s == q.S - 1 ? q.T - t0 : q.L;
  double2 cur[kAheadB], nxt[kAheadB];
#pragma unroll
  for (int u = 0; u < kAheadB; ++u)
    cur[u] = u < len ? p[u * q.F] : make_double2(0.0, 0.0);
  for (int g0 = 0; g0 < len; g0 += kAheadB) {
#pragma unroll
    for (int u = 0; u < kAheadB; ++u) {
      const int t = g0 + kAheadB + u;
      nxt[u] = t < len ? p[t * q.F] : make_double2(0.0, 0.0);
    }
    double psd[kAheadB], nzs[kAheadB], ps[kAheadB];
#pragma unroll
    for (int u = 0; u < kAheadB; ++u) psd[u] = psd_of(cur[u]);
    nz = track_group(nz, psd, t0 + g0, q, nzs);
#pragma unroll
    for (int u = 0; u < kAheadB; ++u) {
      P = __dadd_rn(__dmul_rn(q.a, P), __dmul_rn(q.b, psd[u]));
      ps[u] = P;
    }
#pragma unroll
    for (int u = 0; u < kAheadB; ++u) {
      const int t = g0 + u;
      if (t >= len) break;
      const double snr = clamp_min(
          __dsub_rn(__ddiv_rn(ps[u], clamp_min(nzs[u], 1e-20)), 1.0), 0.0);
      const double g =
          clamp_min(__ddiv_rn(snr, __dadd_rn(1.0, snr)), q.gfloor);
      out[t * q.F] = make_float2(__double2float_rn(__dmul_rn(cur[u].x, g)),
                                 __double2float_rn(__dmul_rn(cur[u].y, g)));
      if (nout) nout[t * q.F] = nzs[u];
    }
#pragma unroll
    for (int u = 0; u < kAheadB; ++u) cur[u] = nxt[u];
  }
}

}  // namespace

// x: (rows, T, F) complex128 as double2, contiguous; y: (rows, T, F)
// complex64 as float2; seed: (rows, F) float64, the lead-in median;
// noise_out: (rows, T, F) float64 receiving each frame's estimate, or
// null; ck: 2 (S - 1) rows * F float64 scratch (unused when S == 1); S
// segments of L frames, the last T - (S - 1) * L in [1, L], L a multiple
// of kGroupA (8) when S > 1; lead: the
// frames that hold the seed; a and b = 1 - a the PSD smoothing; an and
// bn = 1 - an the estimate's; thresh the presence threshold and tlo, thi
// its fast decision's bounds (header), leak the upward leak, gfloor the
// gain's floor; T * F < 2^31. Launches pass A
// (when S > 1) and pass B on `stream`; returns cudaGetLastError() after
// them.
extern "C" int xm_ns_track_f64(const void* x, void* y, const double* seed,
                               double* noise_out, double* ck, int rows, int T,
                               int F, int S, int L, int lead, double a,
                               double b, double an, double bn, double thresh,
                               double tlo, double thi, double leak,
                               double gfloor, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params q{rows * F, T, F, S, L, lead, a, b, an, bn, thresh, tlo, thi,
                 leak, gfloor, 1e-20 * tlo, 1e-20 * thi};
  const double2* xs = static_cast<const double2*>(x);
  if (S > 1) {
    if (L % kGroupA) return static_cast<int>(cudaErrorInvalidValue);
    if (kSmemA > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          checkpoints_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemA);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    checkpoints_kernel<<<(q.C + kThreadsA - 1) / kThreadsA, kThreadsA,
                         kSmemA, st>>>(xs, ck, seed, q);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned cols = static_cast<unsigned>((q.C + kThreadsB - 1) /
                                              kThreadsB);
  track_kernel<<<dim3(cols, S), kThreadsB, 0, st>>>(
      xs, static_cast<float2*>(y), seed, ck, noise_out, q);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of pass B on one SM (the segment rule's slots).
extern "C" int xm_ns_track_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, track_kernel,
                                                    kThreadsB, 0) !=
      cudaSuccess)
    return 0;
  return n;
}
