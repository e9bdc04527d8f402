// Small profile-store kernels for Hopper (sm_90a) that serve the host-driven
// minimum-evolution loops (join bookkeeping, NNI quartets, SPR chains,
// up-profiles), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py).
//
// Store layout (veryfasttree_tpu_torch/engine/profiles.py): codes int8
// [n_rows, P] for every row; W float [n_float, P] and U float [n_float, P, C]
// for the float rows.  Rows below leaf_rows (the leaves of a two-tier store;
// 0 for a dense store) exist only as codes and are expanded on the fly:
// w = (code != NOCODE), u = code_freq[code] * w.  A float row's physical index
// is row - leaf_rows.
//
// The row indices of a call travel by value in the kernel's parameters
// (kDistCap pairs or kAvgCap targets per launch; the C entry launches once per
// chunk), so a call needs no host-to-device copy and no synchronisation.  The
// C entries check every index against the store's rows before the first
// launch and return kBadRow, launching nothing, if one is out of range.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kNoCode = 127;
constexpr int kDistThreads = 128;
constexpr int kDistWarps = kDistThreads / 32;
constexpr int kDistCap = 256;
constexpr int kAvgThreads = 128;
constexpr int kAvgCap = 128;
constexpr int kBadRow = -1;

bool rows_in(const int32_t* rows, int n, int64_t lo, int64_t hi) {
  for (int k = 0; k < n; ++k)
    if (rows[k] < lo || rows[k] >= hi) return false;
  return true;
}

struct StoreView {
  const int8_t* codes;      // [n_rows, P]
  const float* W;           // [n_float, P]
  const float* U;           // [n_float, P, C]
  const float* code_freq;   // [C, C]
  int64_t leaf_rows;
  int P;
};

struct PairBatch {
  int32_t a[kDistCap];  // -1: the query vectors (qU, qW)
  int32_t b[kDistCap];
};

struct AvgBatch {
  int32_t t[kAvgCap];
  int32_t i[kAvgCap];
  int32_t j[kAvgCap];
};

// weight and vector of one row at position p (row -1: the query)
template <int C>
__device__ __forceinline__ void load_pos(const StoreView& s, int64_t row, int p, const float* qU,
                                         const float* qW, float& w, float (&u)[C]) {
  if (row < 0) {
    w = qW[p];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = qU[(int64_t)p * C + c];
    return;
  }
  if (row < s.leaf_rows) {
    const int code = s.codes[row * s.P + p];
    const bool valid = code != kNoCode;
    w = valid ? 1.0f : 0.0f;
    const int safe = valid ? code : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __fmul_rn(s.code_freq[safe * C + c], w);
    return;
  }
  const int64_t phys = row - s.leaf_rows;
  w = s.W[phys * s.P + p];
  const float* up = s.U + (phys * s.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = up[c];
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Replaces the XLA-compiled store functions _dist_rows, _dist_gather and
// _refresh_and_pairs (veryfasttree_tpu/engine/profiles.py).
// Bound: launch and host round-trip latency.  A call moves a few rows
// (2 * P * (C + 1) * 4 bytes per pair, 20 KB at P=512, C=4); the host waits
// for the result before its next decision.
// Design: one 128-thread block per pair; threads stride the positions, each
// converting its floats to double before the products (the reference's CPU
// path upcasts the rows before the contraction), then a warp-shuffle and a
// fixed-order block sum.  One launch serves up to kDistCap pairs.
template <int C>
__global__ void __launch_bounds__(kDistThreads) me_pair_dist_kernel(
    StoreView s, const float* qU, const float* qW, const double* ev, PairBatch pb,
    double* __restrict__ dist, double* __restrict__ denom) {
  const int k = blockIdx.x;
  const int64_t ra = pb.a[k], rb = pb.b[k];
  double den = 0.0, dots = 0.0;
  for (int p = threadIdx.x; p < s.P; p += kDistThreads) {
    float wa, wb, ua[C], ub[C];
    load_pos<C>(s, ra, p, qU, qW, wa, ua);
    load_pos<C>(s, rb, p, qU, qW, wb, ub);
    den += (double)wa * (double)wb;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double t = (double)ua[c] * (double)ub[c];
      dots += ev != nullptr ? t * ev[c] : t;
    }
  }
  __shared__ double s_den[kDistWarps], s_dots[kDistWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  den = warp_sum(den);
  dots = warp_sum(dots);
  if (lane == 0) {
    s_den[warp] = den;
    s_dots[warp] = dots;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double d = s_den[0], t = s_dots[0];
    for (int w = 1; w < kDistWarps; ++w) {
      d += s_den[w];
      t += s_dots[w];
    }
    const double top = ev != nullptr ? t : d - t;
    dist[k] = d > 0.0 ? top / d : 1.0;
    denom[k] = d;
  }
}

// bw*x1 + (1-bw)*x2 rounded as the reference rounds it (ops/kernels.py _mix):
// at bw = 0.5 two exact halvings and one rounded sum; otherwise one rounding
// of the double x1*bw + round(x2*(1-bw)).  Explicit _rn intrinsics keep the
// compiler from contracting the float expressions into FMAs.
__device__ __forceinline__ float mix(float x1, float x2, float bw, float omb, bool half) {
  if (half) return __fadd_rn(__fmul_rn(0.5f, x1), __fmul_rn(0.5f, x2));
  const float t = __fmul_rn(x2, omb);
  return __double2float_rn(__dadd_rn(__dmul_rn((double)x1, (double)bw), (double)t));
}

// Replaces the XLA-compiled store functions _join_update and _avg_sweep_impl
// (veryfasttree_tpu/engine/profiles.py): averageProfile of rows (i, j)
// written into row t, in place (ref averageProfile tcc:2063-2135).
// Bound: launch latency (a call reads two rows and writes one, 30 KB at
// P=512, C=4), paid once per profile average, some hundred thousand times
// in a run at N=2000 (SPR chains and up-profiles).
// Design: one thread per position, blockIdx.y the target; every float
// operation is the reference's, in its order, so the %different mode result
// is bit-identical to the plain version.  Matrix mode's position total is a
// float dot product over the C codes, summed here left to right.
template <int C>
__global__ void __launch_bounds__(kAvgThreads) me_average_kernel(
    StoreView s, int8_t* codes_out, float* W_out, float* U_out, const float* eigentot,
    AvgBatch ab, float bw, float omb, int half, float tol, float fallback) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * kAvgThreads + threadIdx.x;
  if (p >= s.P) return;
  const int64_t ri = ab.i[k], rj = ab.j[k], rt = ab.t[k];
  float w1, w2, u1[C], u2[C];
  load_pos<C>(s, ri, p, nullptr, nullptr, w1, u1);
  load_pos<C>(s, rj, p, nullptr, nullptr, w2, u2);
  const int c1 = s.codes[ri * s.P + p], c2 = s.codes[rj * s.P + p];

  const float w_out = mix(w1, w2, bw, omb, half != 0);
  // keep a child's code where the children agree or the other is absent
  const bool take1 = (w1 > 0.0f) && (c1 != kNoCode) && ((w2 <= 0.0f) || (c1 == c2));
  const bool take2 = (w1 <= 0.0f) && (w2 > 0.0f) && (c2 != kNoCode);
  int c_out = take1 ? c1 : (take2 ? c2 : kNoCode);
  if (!(w_out > 0.0f)) c_out = kNoCode;

  float f[C];
#pragma unroll
  for (int c = 0; c < C; ++c) f[c] = mix(u1[c], u2[c], bw, omb, half != 0);
  float total;
  if (eigentot != nullptr) {
    total = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) total = __fadd_rn(total, __fmul_rn(f[c], eigentot[c]));
  } else {
    total = f[0];
#pragma unroll
    for (int c = 1; c < C; ++c) total = __fadd_rn(total, f[c]);
  }
  const bool ok = total > tol;
#pragma unroll
  for (int c = 0; c < C; ++c)
    f[c] = ok ? __fdiv_rn(f[c], total) : (eigentot != nullptr ? s.code_freq[c] : fallback);
  if (c_out != kNoCode) {
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = s.code_freq[c_out * C + c];
  }

  codes_out[rt * s.P + p] = (int8_t)c_out;
  const int64_t phys = rt - s.leaf_rows;
  W_out[phys * s.P + p] = w_out;
  float* uo = U_out + (phys * s.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) uo[c] = w_out > 0.0f ? __fmul_rn(w_out, f[c]) : 0.0f;
}

template <int C>
int pair_dists(const StoreView& s, const float* qU, const float* qW, const double* ev,
               const int32_t* a, const int32_t* b, int n, double* dist, double* denom,
               cudaStream_t st) {
  PairBatch pb;
  for (int off = 0; off < n; off += kDistCap) {
    const int m = n - off < kDistCap ? n - off : kDistCap;
    memcpy(pb.a, a + off, m * sizeof(int32_t));
    memcpy(pb.b, b + off, m * sizeof(int32_t));
    me_pair_dist_kernel<C><<<m, kDistThreads, 0, st>>>(s, qU, qW, ev, pb, dist + off,
                                                       denom + off);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int C>
int average_rows(const StoreView& s, int8_t* codes, float* W, float* U, const float* eigentot,
                 const int32_t* t, const int32_t* i, const int32_t* j, int n, float bw,
                 int half, float tol, cudaStream_t st) {
  AvgBatch ab;
  const float omb = 1.0f - bw;
  const float fallback = (float)(1.0 / C);
  for (int off = 0; off < n; off += kAvgCap) {
    const int m = n - off < kAvgCap ? n - off : kAvgCap;
    memcpy(ab.t, t + off, m * sizeof(int32_t));
    memcpy(ab.i, i + off, m * sizeof(int32_t));
    memcpy(ab.j, j + off, m * sizeof(int32_t));
    const dim3 grid((s.P + kAvgThreads - 1) / kAvgThreads, m);
    me_average_kernel<C><<<grid, kAvgThreads, 0, st>>>(s, codes, W, U, eigentot, ab, bw, omb,
                                                      half, tol, fallback);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// (dist, denom) of n pairs (rows[k], rows[n + k]) of an n_rows-row store;
// rows[k] = -1 takes the query (qU, qW).  ev: [C] eigenvalues in matrix mode,
// NULL in %different mode.
int vft_me_pair_dists_f32(const int8_t* codes, const float* W, const float* U,
                          const float* code_freq, int64_t n_rows, int64_t leaf_rows, int P,
                          int C, const float* qU, const float* qW, const double* ev,
                          const int32_t* rows, int n, double* dist, double* denom,
                          void* stream) {
  if (!rows_in(rows, n, qU != nullptr ? -1 : 0, n_rows) || !rows_in(rows + n, n, 0, n_rows))
    return kBadRow;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t *a = rows, *b = rows + n;
  if (C == 4) return pair_dists<4>(s, qU, qW, ev, a, b, n, dist, denom, st);
  if (C == 20) return pair_dists<20>(s, qU, qW, ev, a, b, n, dist, denom, st);
  return (int)cudaErrorInvalidValue;
}

// averageProfile of rows (rows[n + k], rows[2n + k]) into row rows[k] of an
// n_rows-row store, in place; targets must lie at or above leaf_rows.
// eigentot: [C] in matrix mode, NULL in %different mode.
int vft_me_average_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                       int64_t n_rows, int64_t leaf_rows, int P, int C, const float* eigentot,
                       const int32_t* rows, int n, float bw, int half, float tol,
                       void* stream) {
  if (!rows_in(rows, n, leaf_rows, n_rows) || !rows_in(rows + n, 2 * n, 0, n_rows))
    return kBadRow;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t *t = rows, *i = rows + n, *j = rows + 2 * n;
  if (C == 4) return average_rows<4>(s, codes, W, U, eigentot, t, i, j, n, bw, half, tol, st);
  if (C == 20) return average_rows<20>(s, codes, W, U, eigentot, t, i, j, n, bw, half, tol, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
