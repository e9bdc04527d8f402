// Small profile-store kernels for Hopper (sm_90a) that serve the host-driven
// minimum-evolution loops (join bookkeeping, NNI quartets, SPR chains,
// up-profiles), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py).
//
// Store layout and the kernels' per-pair and per-position bodies:
// me_store.cuh, which the SPR round kernel (me_spr.cu) shares.
//
// The row indices of a call travel by value in the kernel's parameters
// (kDistCap pairs or kAvgCap targets per launch; the C entry launches once per
// chunk), so a call needs no host-to-device copy and no synchronisation.  The
// C entries check every index against the store's rows before the first
// launch and return kBadRow, launching nothing, if one is out of range.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "me_store.cuh"

namespace {

constexpr int kDistCap = 256;
constexpr int kAvgThreads = 128;
constexpr int kAvgCap = 128;
constexpr int kBadRow = -1;

bool rows_in(const int32_t* rows, int n, int64_t lo, int64_t hi) {
  for (int k = 0; k < n; ++k)
    if (rows[k] < lo || rows[k] >= hi) return false;
  return true;
}

struct PairBatch {
  int32_t a[kDistCap];  // -1: the query vectors (qU, qW)
  int32_t b[kDistCap];
};

struct AvgBatch {
  int32_t t[kAvgCap];
  int32_t i[kAvgCap];
  int32_t j[kAvgCap];
};

// Replaces the XLA-compiled store functions _dist_rows, _dist_gather and
// _refresh_and_pairs (veryfasttree_tpu/engine/profiles.py).
// Bound: launch and host round-trip latency.  A call moves a few rows
// (2 * P * (C + 1) * 4 bytes per pair, 20 KB at P=512, C=4); the host waits
// for the result before its next decision.
// Design: one 128-thread block per pair (pair_partial, me_store.cuh), then
// the warps' sums in order.  One launch serves up to kDistCap pairs.
template <int C>
__global__ void __launch_bounds__(kDistThreads) me_pair_dist_kernel(
    StoreView s, const float* qU, const float* qW, const double* ev, PairBatch pb,
    double* __restrict__ dist, double* __restrict__ denom) {
  const int k = blockIdx.x;
  double den, dots;
  pair_partial<C>(s, pb.a[k], pb.b[k], qU, qW, ev, threadIdx.x, den, dots);
  __shared__ double s_den[kDistWarps], s_dots[kDistWarps];
  if ((threadIdx.x & 31) == 0) {
    s_den[threadIdx.x >> 5] = den;
    s_dots[threadIdx.x >> 5] = dots;
  }
  __syncthreads();
  if (threadIdx.x == 0) pair_finish(s_den, s_dots, ev, dist[k], denom[k]);
}

// Replaces the XLA-compiled store functions _join_update and _avg_sweep_impl
// (veryfasttree_tpu/engine/profiles.py): averageProfile of rows (i, j)
// written into row t, in place (average_pos, me_store.cuh).
// Bound: launch latency (a call reads two rows and writes one, 30 KB at
// P=512, C=4), paid once per profile average.
// Design: one thread per position, blockIdx.y the target; the %different
// mode result is bit-identical to the plain version.
template <int C>
__global__ void __launch_bounds__(kAvgThreads) me_average_kernel(
    StoreView s, int8_t* codes_out, float* W_out, float* U_out, const float* eigentot,
    AvgBatch ab, float bw, float omb, int half, float tol, float fallback) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * kAvgThreads + threadIdx.x;
  if (p >= s.P) return;
  average_pos<C>(s, codes_out, W_out, U_out, eigentot, ab.t[k], ab.i[k], ab.j[k], p, bw, omb,
                 half != 0, tol, fallback);
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
