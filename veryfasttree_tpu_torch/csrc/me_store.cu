// Profile-store kernels for Hopper (sm_90a) that serve the minimum-evolution
// loops (join bookkeeping, NNI quartets, SPR chains, up-profiles, branch
// lengths, the split test), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py; wrappers in
// veryfasttree_tpu_torch/ops/store_kernels.py).
//
// Store layout and the kernels' per-pair and per-position bodies:
// me_store.cuh, which the round kernels and the join epoch share.
//
// The single-call kernels (me_pair_dist_kernel, me_average_kernel) serve the
// host loops that still ask for a few rows at a time (-slow, -bionj, the
// unfused join loop): the row indices of a call travel by value in the
// kernel's parameters (kDistCap pairs or kAvgCap targets per launch; the C
// entry launches once per chunk), so a call needs no host-to-device copy and
// no synchronisation.  Their C entries check every index against the store's
// rows before the first launch and return kBadRow, launching nothing, if one
// is out of range.
//
// The whole-tree kernels (me_pair_list_kernel, me_average_sweep_kernel,
// me_pieces_list_kernel) take their tables in device memory, sent once by
// the wrapper, which checks the rows on the host before it sends them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dataflow.cuh"
#include "me_store.cuh"

namespace {

constexpr int kDistCap = 256;
constexpr int kListGroups = 4;  // pairs of a list launch's block
constexpr int kAvgThreads = 128;
constexpr int kPieceThreads = 128;  // positions of a pieces block
constexpr int kAvgCap = 128;
constexpr int kBadRow = -1;
constexpr int kFinishThreads = 256;

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
// kPartial (a rank's block of positions under a mesh): the pair's sums
// (pair_sums) go into dist (den) and denom (dots), unfinished, for
// me_pair_finish_kernel to finish once the ranks' sums are combined.
template <int C, bool kPartial = false>
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
  if (threadIdx.x == 0) {
    if (kPartial)
      pair_sums(s_den, s_dots, dist[k], denom[k]);
    else
      pair_finish(s_den, s_dots, ev, dist[k], denom[k]);
  }
}

// Replaces the XLA-compiled store function _join_update
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

// Replaces the XLA-compiled gather of every quartet's six distances in
// test_splits_min_evo_batched and update_branch_lengths_batched
// (veryfasttree_tpu/engine/supports.py:145, engine/batched.py:346, through
// profiles.py:244 _dist_rows): n pairs (rows[k], rows[n + k]) from a
// device list, in one launch at any n.
// Bound: bytes.  The split test at N=2000, P=512, C=4 asks 11,982 pairs of
// about 5,500 distinct rows, of which a distance reads W and U, not the
// codes (56 MB, 16.8 us at 3.35 TB/s); the list streams 245 MB of row
// reads, so what does not hit L2 costs.
// Design: each pair keeps me_pair_dist_kernel's thread map and sum order (a
// group of kDistThreads per pair, pair_partial then the warps' sums in
// order in pair_finish), so every pair's bits are a single call's and the
// round kernels'.  kListGroups pairs share a block; a position's C=4
// vector is one 16-byte load; the host orders the list quartet by
// quartet, so a quartet's four rows are read close in time and mostly
// from L2.
// kPartial: as me_pair_dist_kernel's, den into dist and dots into denom.
template <int C, bool kPartial = false>
__global__ void __launch_bounds__(kDistThreads * kListGroups) me_pair_list_kernel(
    StoreView s, const double* ev, const int32_t* __restrict__ rows, int64_t n,
    double* __restrict__ dist, double* __restrict__ denom) {
  const int g = threadIdx.x / kDistThreads, t = threadIdx.x % kDistThreads;
  const int64_t k = (int64_t)blockIdx.x * kListGroups + g;
  __shared__ double s_den[kListGroups][kDistWarps], s_dots[kListGroups][kDistWarps];
  double den = 0.0, dots = 0.0;
  if (k < n)  // a whole group, so every lane of its warps takes part in the sums
    pair_partial<C, true>(s, rows[k], rows[n + k], nullptr, nullptr, ev, t, den, dots);
  if ((t & 31) == 0) {
    s_den[g][t >> 5] = den;
    s_dots[g][t >> 5] = dots;
  }
  __syncthreads();
  if (t == 0 && k < n) {
    if (kPartial)
      pair_sums(s_den[g], s_dots[g], dist[k], denom[k]);
    else
      pair_finish(s_den[g], s_dots[g], ev, dist[k], denom[k]);
  }
}

// Replaces no TPU kernel: under a mesh (veryfasttree_tpu_torch/parallel/),
// where the JAX package's GSPMD adds a psum over 'sp' to each profile
// distance (veryfasttree_tpu/engine/profiles.py:525-536), each rank's
// partial kernels write the sums of its block of positions, the ranks
// exchange them, and this kernel finishes every pair: the k ranks' (den,
// dots) added in rank order, then pair_div.  parts [k, 2, n]: rank r's den
// at parts[2rn + i], dots at parts[(2r + 1)n + i]; out [2, n]: dist, then
// denom.  At k = 1 each pair's bits are the fused kernels' (pair_finish is
// pair_sums then pair_div).
// Bound: bytes, 16(k + 1) n (a list of 12,000 pairs at k = 2: 0.6 MB,
// 0.17 us at 3.35 TB/s); the launch dominates.
// Design: one thread per pair, the k loads of each sum in rank order.
__global__ void __launch_bounds__(kFinishThreads) me_pair_finish_kernel(
    const double* __restrict__ parts, int k, int64_t n, int use_matrix,
    double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kFinishThreads + threadIdx.x;
  if (i >= n) return;
  double d = parts[i], t = parts[n + i];
  for (int r = 1; r < k; ++r) {
    d = __dadd_rn(d, parts[2 * r * n + i]);
    t = __dadd_rn(t, parts[(2 * r + 1) * n + i]);
  }
  pair_div(d, t, use_matrix != 0, out[i], out[n + i]);
}

// Replaces the XLA-compiled _dist_pieces (veryfasttree_tpu/engine/
// profiles.py:293, through dist_pieces_pairs :718), which the JAX package's
// local bootstrap (reliability_nj, engine/supports.py:190-237) calls once
// per split: the per-position pieces and weights of n pairs (rows[k],
// rows[n + k]) from a device list, in one launch at any n, written as
// float32 [n, n_pos] each (pieces_pos, me_store.cuh, which rounds them as
// that CPU build does).
// Bound: bytes.  At N=2000, P=512, C=4 the split test's 11,982 pairs read
// about 5,500 distinct rows (56 MB, as me_pair_list_kernel) and write
// 2 x 11,982 x 500 floats (48 MB): 31 us at 3.35 TB/s.
// Design: one thread per (pair, position), blockIdx.x the pair, so a
// block's loads and stores are contiguous; the host orders the list quartet
// by quartet, so a quartet's rows are read close in time and mostly from L2.
template <int C>
__global__ void __launch_bounds__(kPieceThreads) me_pieces_list_kernel(
    StoreView s, int n_pos, const float* ev, const int32_t* __restrict__ rows, int64_t n,
    float* __restrict__ pieces, float* __restrict__ weights) {
  const int64_t k = blockIdx.x;
  const int p = blockIdx.y * kPieceThreads + threadIdx.x;
  if (p >= n_pos) return;
  float piece, weight;
  pieces_pos<C, true>(s, rows[k], rows[n + k], p, ev, piece, weight);
  pieces[k * n_pos + p] = piece;
  weights[k * n_pos + p] = weight;
}

// Replaces _avg_sweep_impl (veryfasttree_tpu/engine/profiles.py:375, a
// fori_loop over the level tables: the up-profiles of
// compute_up_profiles_levelwise, engine/batched.py:26, and the bottom-up
// recompute of recompute_profiles_levelwise): every
// balanced (0.5) average of a dependency-ordered table in one launch, in
// place.  The per-level launches of me_average made the split test and the
// ME lengths one launch per tree level or per up-profile, bound by the host.
// Bound: bytes.  At N=2000, P=512, C=4 a sweep reads about 2,000 rows that
// no item writes and writes about 2,000 (43 MB, 13 us at 3.35 TB/s); its
// critical path is the tree's depth times one chunk and its hand-off.
// Design: the scheduler of dataflow.cuh over units (item, chunk of
// kAvgThreads positions), item-major.  Unit (k, c) waits on the units
// (producer, c) of its two source rows, the items of earlier levels that
// write them (the host gives each item's producers, or -1): position p of
// an average reads only position p of its sources.  Each position runs
// average_pos with me_average_kernel's thread map, so every row is the
// per-level launches' bit for bit.
template <int C>
__global__ void __launch_bounds__(kAvgThreads) me_average_sweep_kernel(
    StoreView s, int8_t* codes_out, float* W_out, float* U_out, const float* eigentot,
    const int32_t* __restrict__ t, const int32_t* __restrict__ i, const int32_t* __restrict__ j,
    const int32_t* __restrict__ prod_i, const int32_t* __restrict__ prod_j, float tol,
    float fallback, int n_units, int n_chunks, int* ctrl, int* flags, int epoch) {
  __shared__ int slot;
  for (;;) {
    const int u = next_unit(ctrl, &slot);
    if (u >= n_units) break;
    const int k = u / n_chunks, c = u - k * n_chunks;
    if (threadIdx.x == 0) {
      if (prod_i[k] >= 0) wait_flag(flags + (int64_t)prod_i[k] * n_chunks + c, epoch);
      if (prod_j[k] >= 0) wait_flag(flags + (int64_t)prod_j[k] * n_chunks + c, epoch);
    }
    __syncthreads();
    const int p = c * kAvgThreads + threadIdx.x;
    if (p < s.P)
      average_pos<C>(s, codes_out, W_out, U_out, eigentot, t[k], i[k], j[k], p, 0.5f, 0.5f, true,
                     tol, fallback);
    publish(flags + u, epoch);
  }
  finish(ctrl);
}

template <int C>
int pair_dists(const StoreView& s, const float* qU, const float* qW, const double* ev,
               const int32_t* a, const int32_t* b, int n, double* dist, double* denom,
               bool partial, cudaStream_t st) {
  PairBatch pb;
  for (int off = 0; off < n; off += kDistCap) {
    const int m = n - off < kDistCap ? n - off : kDistCap;
    memcpy(pb.a, a + off, m * sizeof(int32_t));
    memcpy(pb.b, b + off, m * sizeof(int32_t));
    auto kernel = partial ? me_pair_dist_kernel<C, true> : me_pair_dist_kernel<C, false>;
    kernel<<<m, kDistThreads, 0, st>>>(s, qU, qW, ev, pb, dist + off, denom + off);
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

template <int C>
int pair_list(const StoreView& s, const double* ev, const int32_t* rows, int64_t n, double* out,
              bool partial, cudaStream_t st) {
  const int64_t blocks = (n + kListGroups - 1) / kListGroups;
  auto kernel = partial ? me_pair_list_kernel<C, true> : me_pair_list_kernel<C, false>;
  kernel<<<(unsigned)blocks, kDistThreads * kListGroups, 0, st>>>(s, ev, rows, n, out, out + n);
  return (int)cudaGetLastError();
}

template <int C>
int pieces_list(const StoreView& s, int n_pos, const float* ev, const int32_t* rows, int64_t n,
                float* pieces, float* weights, cudaStream_t st) {
  const dim3 grid((unsigned)n, (n_pos + kPieceThreads - 1) / kPieceThreads);
  me_pieces_list_kernel<C><<<grid, kPieceThreads, 0, st>>>(s, n_pos, ev, rows, n, pieces,
                                                          weights);
  return (int)cudaGetLastError();
}

template <int C>
int average_grid() {
  static int blocks = resident_blocks(me_average_sweep_kernel<C>, kAvgThreads);
  return blocks;
}

int64_t sweep_units(int64_t n, int P) { return n * ((P + kAvgThreads - 1) / kAvgThreads); }

template <int C>
int average_sweep(const StoreView& s, int8_t* codes, float* W, float* U, const float* eigentot,
                  const int32_t* rows, int64_t n, float tol, int* ctrl, int epoch,
                  cudaStream_t st) {
  const int resident = average_grid<C>();
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int n_units = (int)sweep_units(n, s.P);
  const int grid = n_units < resident ? n_units : resident;
  me_average_sweep_kernel<C><<<grid, kAvgThreads, 0, st>>>(
      s, codes, W, U, eigentot, rows, rows + n, rows + 2 * n, rows + 3 * n, rows + 4 * n, tol,
      (float)(1.0 / C), n_units, (s.P + kAvgThreads - 1) / kAvgThreads, ctrl, ctrl + kCtrlWords,
      epoch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vft_me_pair_dists_partial_f32(const int8_t* codes, const float* W, const float* U,
                                  const float* code_freq, int64_t n_rows, int64_t leaf_rows,
                                  int P, int C, const float* qU, const float* qW,
                                  const double* ev, const int32_t* rows, int n, int partial,
                                  double* dist, double* denom, void* stream);
int vft_me_pair_list_partial_f32(const int8_t* codes, const float* W, const float* U,
                                 const float* code_freq, int64_t leaf_rows, int P, int C,
                                 const double* ev, const int32_t* rows, int64_t n, int partial,
                                 double* out, void* stream);

// (dist, denom) of n pairs (rows[k], rows[n + k]) of an n_rows-row store;
// rows[k] = -1 takes the query (qU, qW).  ev: [C] eigenvalues in matrix mode,
// NULL in %different mode.
int vft_me_pair_dists_f32(const int8_t* codes, const float* W, const float* U,
                          const float* code_freq, int64_t n_rows, int64_t leaf_rows, int P,
                          int C, const float* qU, const float* qW, const double* ev,
                          const int32_t* rows, int n, double* dist, double* denom,
                          void* stream) {
  return vft_me_pair_dists_partial_f32(codes, W, U, code_freq, n_rows, leaf_rows, P, C, qU, qW,
                                       ev, rows, n, 0, dist, denom, stream);
}

// vft_me_pair_dists_f32, or with partial set each pair's sums over the
// store's positions unfinished: den into dist, dots into denom
// (me_pair_finish_kernel finishes them).
int vft_me_pair_dists_partial_f32(const int8_t* codes, const float* W, const float* U,
                                  const float* code_freq, int64_t n_rows, int64_t leaf_rows,
                                  int P, int C, const float* qU, const float* qW,
                                  const double* ev, const int32_t* rows, int n, int partial,
                                  double* dist, double* denom, void* stream) {
  if (!rows_in(rows, n, qU != nullptr ? -1 : 0, n_rows) || !rows_in(rows + n, n, 0, n_rows))
    return kBadRow;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t *a = rows, *b = rows + n;
  if (C == 4) return pair_dists<4>(s, qU, qW, ev, a, b, n, dist, denom, partial != 0, st);
  if (C == 20) return pair_dists<20>(s, qU, qW, ev, a, b, n, dist, denom, partial != 0, st);
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

// (dist, denom) of n pairs (rows[k], rows[n + k]), rows an int32 [2n] list
// in device memory whose rows the caller checked against the store's; out
// [2n] float64 in device memory: dist, then denom.  ev as for
// vft_me_pair_dists_f32.
int vft_me_pair_list_f32(const int8_t* codes, const float* W, const float* U,
                         const float* code_freq, int64_t leaf_rows, int P, int C,
                         const double* ev, const int32_t* rows, int64_t n, double* out,
                         void* stream) {
  return vft_me_pair_list_partial_f32(codes, W, U, code_freq, leaf_rows, P, C, ev, rows, n, 0,
                                      out, stream);
}

// vft_me_pair_list_f32, or with partial set each pair's sums unfinished:
// out [2n] = den, then dots.
int vft_me_pair_list_partial_f32(const int8_t* codes, const float* W, const float* U,
                                 const float* code_freq, int64_t leaf_rows, int P, int C,
                                 const double* ev, const int32_t* rows, int64_t n, int partial,
                                 double* out, void* stream) {
  if (n <= 0 || (n + kListGroups - 1) / kListGroups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4) return pair_list<4>(s, ev, rows, n, out, partial != 0, st);
  if (C == 20) return pair_list<20>(s, ev, rows, n, out, partial != 0, st);
  return (int)cudaErrorInvalidValue;
}

// (dist, denom) of n pairs from k ranks' unfinished sums (the partial
// entries' outputs, exchanged): parts [k, 2, n] float64 in device memory,
// out [2, n]; use_matrix: 1 in matrix mode (top = dots), 0 in %different
// mode (top = den - dots).
int vft_me_pair_finish_f64(const double* parts, int k, int64_t n, int use_matrix, double* out,
                           void* stream) {
  if (k < 1 || n <= 0 || (n + kFinishThreads - 1) / kFinishThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kFinishThreads - 1) / kFinishThreads;
  me_pair_finish_kernel<<<(unsigned)blocks, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      parts, k, n, use_matrix, out);
  return (int)cudaGetLastError();
}

// The local bootstrap's pieces and weights (pieces_pos) of n pairs
// (rows[k], rows[n + k]) at positions [0, n_pos), rows an int32 [2n] list
// in device memory whose rows the caller checked against the store's;
// pieces and weights float32 [n, n_pos] each in device memory.  ev: [C]
// float eigenvalues in matrix mode, NULL in %different mode.
int vft_me_pieces_list_f32(const int8_t* codes, const float* W, const float* U,
                           const float* code_freq, int64_t leaf_rows, int P, int n_pos, int C,
                           const float* ev, const int32_t* rows, int64_t n, float* pieces,
                           float* weights, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || n_pos <= 0 || n_pos > P) return (int)cudaErrorInvalidValue;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4) return pieces_list<4>(s, n_pos, ev, rows, n, pieces, weights, st);
  if (C == 20) return pieces_list<20>(s, n_pos, ev, rows, n, pieces, weights, st);
  return (int)cudaErrorInvalidValue;
}

// Work units (ready flags) of an up-profile sweep of n items at P positions.
int64_t vft_me_average_sweep_units(int64_t n, int P) { return sweep_units(n, P); }

// The balanced averages of n items in dependency order, in place: rows [5n]
// in device memory = targets, i, j and the producers of i and j (item
// indices, -1 for none; each in an earlier level than its reader), checked
// by the caller against the store's rows (targets at or above leaf_rows).
// eigentot: [C] in matrix mode, NULL in %different mode.  ctrl: kCtrlWords
// control words then n_flags ready flags (zeroed when first allocated);
// epoch differs from every earlier launch's on the same ctrl and is not 0.
int vft_me_average_sweep_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                             int64_t leaf_rows, int P, int C, const float* eigentot,
                             const int32_t* rows, int64_t n, float tol, int* ctrl,
                             int64_t n_flags, int epoch, void* stream) {
  if (n <= 0 || epoch == 0) return (int)cudaErrorInvalidValue;
  const int64_t units = sweep_units(n, P);
  if (units > n_flags || units > 0x7fff0000LL) return (int)cudaErrorInvalidValue;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4) return average_sweep<4>(s, codes, W, U, eigentot, rows, n, tol, ctrl, epoch, st);
  if (C == 20) return average_sweep<20>(s, codes, W, U, eigentot, rows, n, tol, ctrl, epoch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
