// Whole-tree kernels of the ML profile store for Hopper (sm_90a): a
// dependency-ordered posterior sweep and a tree's log-likelihood, each in
// one launch, with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py; wrappers ml_posterior_sweep and
// ml_tree_loglk in veryfasttree_tpu_torch/ops/ml_kernels.py).
//
// ml_posterior_sweep_kernel replaces _posterior_sweep_impl
// (veryfasttree_tpu/engine/ml_profiles.py:123-177: a fori_loop over the
// level tables with the store carried, one dispatch for a whole run of
// levels), and ml_tree_loglk_kernel the XLA calls of tree_loglk
// (veryfasttree_tpu/engine/ml.py:299).  One launch per tree level (ml_lk.cu's
// ml_posterior_kernel and ml_pair_loglk_kernel) made a CAT fit some 1,400
// launches of a few microseconds of device time each, bound by the host.
// Here each is one launch over tables that reach the device once.  Both
// need each row once and write each target once, so they are bound by
// bytes (a sweep at N=2000, P=512, C=4: 2,000 leaf rows in, 1,998 rows
// out, 43 MB, 12.8 us at 3.35 TB/s); a sweep's critical path is the tree's
// depth times the latency of one posterior chunk.
//
// Design: dataflow over work units (the scheduler of dataflow.cuh, which
// the ME up-profile sweep of me_store.cu shares).  A unit runs the
// body and thread map of the per-level kernels: posterior_site with its
// item's two rate tables from fill_table, one thread per position of a
// chunk of 128; pair_loglk_block on 128 threads.  So every row and every
// pair value is the per-level launches' bit for bit, whatever the grid.
//
// Sweep units: (item, chunk of 128 positions), item-major.  Unit (k, c)
// waits on the units (producer, c) of its two source rows, the items of
// earlier levels that write them (the host gives each item's producers,
// or -1): position p of a posterior reads only position p of its sources.
//
// Tree log-likelihood units, in order: the root's 3-way term (the posterior
// of its first two children into the scratch row S_AB, then the pair with
// the third: one block); each pair of the levels (one block: its
// log-likelihood, and its per-site logs log(max(lk, 1e-300)) in float64);
// each (level, chunk of 128 sites): the sums over the level's pairs in
// list order; each chunk of sites: the level sums added level by level,
// the root term last.  No float atomics: every sum has one order, whatever
// the grid.
//
// Compiled with -fmad=false (ml_lk.cuh's arithmetic).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dataflow.cuh"
#include "ml_lk.cuh"

namespace {

constexpr int kUnitThreads = 128;  // ml_lk.cu's kPostThreads and kLkThreads

// log(max(lk, 1e-300)) in float64, as torch.log(torch.clamp_min(lk.double(),
// 1e-300)) takes it (a NaN stays NaN).
__device__ __forceinline__ double site_log(float lk) {
  const double x = (double)lk;
  return log(x < 1e-300 ? 1e-300 : x);
}

// The posterior of rows r1 and r2 at position p, from the item's tables,
// into row `row` (ml_posterior_kernel's body).
template <int C>
__device__ __forceinline__ void posterior_into(const MLView& m, int8_t* codes_out, float* W_out,
                                               float* V_out, const RowRef& r1, const RowRef& r2,
                                               const float* tab1, const float* tab2, float tol,
                                               int64_t row, int p) {
  float w, out[C];
  const int rate = m.ratecat[p];
  posterior_site<C>(m, r1, r2, tab1 + rate * C, tab2 + rate * C, tol, p, w, out);
  codes_out[row * m.P + p] = (int8_t)kNoCode;
  W_out[row * m.P + p] = w;
  float* vo = V_out + (row * m.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) vo[c] = out[c];
}

// A dependency-ordered posterior sweep: item k writes the posterior of rows
// r1[k], r2[k] at len1[k], len2[k] into row t[k]; prod1[k], prod2[k] are the
// items that write its source rows (-1: none).  n_units = items * n_chunks.
template <int C>
__global__ void __launch_bounds__(kUnitThreads) ml_posterior_sweep_kernel(
    MLView m, int8_t* codes_out, float* W_out, float* V_out, const int32_t* __restrict__ t,
    const int32_t* __restrict__ r1, const int32_t* __restrict__ r2,
    const int32_t* __restrict__ prod1, const int32_t* __restrict__ prod2,
    const float* __restrict__ len1, const float* __restrict__ len2, float tol, int n_units,
    int n_chunks, int* ctrl, int* flags, int epoch) {
  __shared__ float tab1[kMaxRates * C];
  __shared__ float tab2[kMaxRates * C];
  __shared__ int slot;
  for (;;) {
    const int u = next_unit(ctrl, &slot);
    if (u >= n_units) break;
    const int k = u / n_chunks, c = u - k * n_chunks;
    fill_table<C>(m, len1[k], tab1);
    fill_table<C>(m, len2[k], tab2);
    if (threadIdx.x == 0) {
      if (prod1[k] >= 0) wait_flag(flags + (int64_t)prod1[k] * n_chunks + c, epoch);
      if (prod2[k] >= 0) wait_flag(flags + (int64_t)prod2[k] * n_chunks + c, epoch);
    }
    __syncthreads();
    const int p = c * kUnitThreads + threadIdx.x;
    if (p < m.P)
      posterior_into<C>(m, codes_out, W_out, V_out, store_row<C>(m, r1[k]), store_row<C>(m, r2[k]),
                        tab1, tab2, tol, t[k], p);
    publish(flags + u, epoch);
  }
  finish(ctrl);
}

// The tables and scratch of a tree log-likelihood.
struct TreeArgs {
  const int32_t* off;  // [L + 1] each level's first pair
  const int32_t* r1;   // [K]
  const int32_t* r2;   // [K]
  const float* len;    // [K]
  int K, L;            // pairs, levels
  int n_sc;            // chunks of sites a level unit or a final unit takes
  int root;            // 1: unit 0 is the root's 3-way term
  int s_ab, c0, c1, c2;
  float l0, l1, l2;    // the root term's lengths (l0, l1 clamped)
  int want_site;
  double* ll;          // [K + 1] the pairs' log-likelihoods, the root term's last
  double* slog;        // [K + 1, n_pos] their per-site logs
  double* lvl;         // [L] level sums
  double* lvl_site;    // [L, n_pos]
  float* lk;           // [grid, P] each block's per-site likelihoods
  double* out_ll;      // the total
  double* out_site;    // [n_pos], or null
};

template <int C>
__global__ void __launch_bounds__(kUnitThreads) ml_tree_loglk_kernel(
    MLView m, int8_t* codes_out, float* W_out, float* V_out, float tol, TreeArgs a, int* ctrl,
    int* flags, int epoch) {
  __shared__ float tab1[kMaxRates * C];
  __shared__ float tab2[kMaxRates * C];
  __shared__ double red_slot[2 * kRedSlots];
  __shared__ int slot;
  Red red{red_slot, 0};
  const int tid = threadIdx.x;
  const int n_pos = m.n_pos;
  float* lk_row = a.lk + (int64_t)blockIdx.x * m.P;
  const int pair0 = a.root, lvl0 = pair0 + a.K, fin0 = lvl0 + a.L * a.n_sc;
  const int n_units = fin0 + a.n_sc;

  // pair j (j == K: the root term's): its log-likelihood and per-site logs;
  // each thread logs the positions it wrote in pair_loglk_block
  auto pair = [&](int j, const RowRef& x, const RowRef& y, float len) {
    const double ll = pair_loglk_block<C, kUnitThreads>(m, x, y, len, red,
                                                        a.want_site ? lk_row : nullptr);
    if (tid == 0) a.ll[j] = ll;
    if (a.want_site)
      for (int p = tid; p < n_pos; p += kUnitThreads)
        a.slog[(int64_t)j * n_pos + p] = site_log(lk_row[p]);
  };

  for (;;) {
    const int u = next_unit(ctrl, &slot);
    if (u >= n_units) break;
    if (u < pair0) {  // the root's 3-way term
      fill_table<C>(m, a.l0, tab1);
      fill_table<C>(m, a.l1, tab2);
      __syncthreads();
      const RowRef A = store_row<C>(m, a.c0), B = store_row<C>(m, a.c1);
      for (int p = tid; p < m.P; p += kUnitThreads)
        posterior_into<C>(m, codes_out, W_out, V_out, A, B, tab1, tab2, tol, a.s_ab, p);
      pair(a.K, store_row<C>(m, a.s_ab), store_row<C>(m, a.c2), a.l2);
    } else if (u < lvl0) {
      const int j = u - pair0;
      pair(j, store_row<C>(m, a.r1[j]), store_row<C>(m, a.r2[j]), a.len[j]);
    } else if (u < fin0) {  // level lv's sums over its pairs, in list order
      const int lv = (u - lvl0) / a.n_sc, c = (u - lvl0) - lv * a.n_sc;
      const int j0 = a.off[lv], j1 = a.off[lv + 1];
      for (int j = j0 + tid; j < j1; j += kUnitThreads) wait_flag(flags + pair0 + j, epoch);
      __syncthreads();
      const int p = c * kUnitThreads + tid;
      // the adds in order, their loads issued 16 ahead (a level's sum is a
      // chain as long as its width)
      if (a.want_site && p < n_pos) {
        double s = 0.0;
#pragma unroll 16
        for (int j = j0; j < j1; ++j) s = s + a.slog[(int64_t)j * n_pos + p];
        a.lvl_site[(int64_t)lv * n_pos + p] = s;
      }
      if (c == 0 && tid == 0) {
        double s = 0.0;
#pragma unroll 16
        for (int j = j0; j < j1; ++j) s = s + a.ll[j];
        a.lvl[lv] = s;
      }
    } else {  // the level sums, level by level, the root term last
      const int c = u - fin0;
      for (int l = tid; l < a.L; l += kUnitThreads)
        wait_flag(flags + lvl0 + (int64_t)l * a.n_sc + c, epoch);
      if (a.root && tid == 0) wait_flag(flags, epoch);
      __syncthreads();
      const int p = c * kUnitThreads + tid;
      if (a.want_site && p < n_pos) {
        double s = 0.0;
#pragma unroll 16
        for (int l = 0; l < a.L; ++l) s = s + a.lvl_site[(int64_t)l * n_pos + p];
        if (a.root) s = s + a.slog[(int64_t)a.K * n_pos + p];
        a.out_site[p] = s;
      }
      if (c == 0 && tid == 0) {
        double s = 0.0;
#pragma unroll 16
        for (int l = 0; l < a.L; ++l) s = s + a.lvl[l];
        if (a.root) s = s + a.ll[a.K];
        *a.out_ll = s;
      }
    }
    publish(flags + u, epoch);
  }
  finish(ctrl);
}

// Blocks of one launch: as many as fit on the card at once.
template <int C>
int sweep_grid() {
  static int blocks = resident_blocks(ml_posterior_sweep_kernel<C>, kUnitThreads);
  return blocks;
}

template <int C>
int tree_grid() {
  static int blocks = resident_blocks(ml_tree_loglk_kernel<C>, kUnitThreads);
  return blocks;
}

int tree_grid_of(int C) { return C == 4 ? tree_grid<4>() : C == 20 ? tree_grid<20>() : 0; }

// The scratch of a tree log-likelihood in one buffer (16-byte aligned
// pieces); returns its bytes, and with base set the pointers.
size_t tree_scratch(TreeArgs& a, int64_t K, int L, int P, int n_pos, int grid, char* base) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base != nullptr ? base + at : nullptr;
    at += align16(bytes);
    return p;
  };
  const size_t sites = a.want_site ? (size_t)n_pos : 0;
  a.ll = reinterpret_cast<double*>(take(8 * (size_t)(K + 1)));
  a.slog = reinterpret_cast<double*>(take(8 * (size_t)(K + 1) * sites));
  a.lvl = reinterpret_cast<double*>(take(8 * (size_t)L));
  a.lvl_site = reinterpret_cast<double*>(take(8 * (size_t)L * sites));
  a.lk = reinterpret_cast<float*>(take(4 * (size_t)grid * P));
  return at;
}

int site_chunks(int n_pos, int want_site) {
  return want_site ? (n_pos + kUnitThreads - 1) / kUnitThreads : 1;
}

MLView make_view(const int8_t* codes, const float* W, const float* V, const float* code_freq,
                 const float* eigenval, const float* eigeninv, const float* statinv,
                 const float* rates, const int32_t* ratecat, int P, int n_pos, int n_rates, int jc,
                 float min_rel_len) {
  return MLView{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                P, n_pos, n_rates, jc, min_rel_len};
}

template <int C>
int posterior_sweep(const MLView& m, int8_t* codes, float* W, float* V, const int32_t* rows,
                    const float* lens, int64_t n, float tol, int* ctrl, int n_units, int n_chunks,
                    int epoch, cudaStream_t st) {
  const int resident = sweep_grid<C>();
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int grid = n_units < resident ? n_units : resident;
  ml_posterior_sweep_kernel<C><<<grid, kUnitThreads, 0, st>>>(
      m, codes, W, V, rows, rows + n, rows + 2 * n, rows + 3 * n, rows + 4 * n, lens, lens + n,
      tol, n_units, n_chunks, ctrl, ctrl + kCtrlWords, epoch);
  return (int)cudaGetLastError();
}

template <int C>
int tree_loglk(const MLView& m, int8_t* codes, float* W, float* V, float tol, const TreeArgs& a,
               int grid, int* ctrl, int epoch, cudaStream_t st) {
  ml_tree_loglk_kernel<C><<<grid, kUnitThreads, 0, st>>>(m, codes, W, V, tol, a, ctrl,
                                                         ctrl + kCtrlWords, epoch);
  return (int)cudaGetLastError();
}

}  // namespace

#define VFT_ML_STORE_ARGS                                                                 \
  const int8_t *codes, const float *W, const float *V, const float *code_freq,           \
      const float *eigenval, const float *eigeninv, const float *statinv,                 \
      const float *rates, const int32_t *ratecat, int64_t n_rows, int P, int C, int n_pos, \
      int n_rates, int jc, float min_rel_len

extern "C" {

// Blocks of a posterior sweep's launch with at least that many units at C
// codes (the blocks that fit on the card at once; 0 if it cannot be asked).
int vft_ml_posterior_sweep_grid(int C) {
  return C == 4 ? sweep_grid<4>() : C == 20 ? sweep_grid<20>() : 0;
}

// Work units (ready flags) of a sweep of n items at P positions, and of a
// tree log-likelihood of K pairs over L levels.
int64_t vft_ml_posterior_sweep_units(int64_t n, int P) {
  return n * ((P + kUnitThreads - 1) / kUnitThreads);
}

int64_t vft_ml_tree_loglk_units(int64_t K, int L, int n_pos, int root, int want_site) {
  const int n_sc = site_chunks(n_pos, want_site);
  return root + K + (int64_t)L * n_sc + n_sc;
}

// Bytes of device scratch one tree log-likelihood takes (0 when the card
// cannot be asked).
int64_t vft_ml_tree_loglk_scratch_bytes(int64_t K, int L, int P, int n_pos, int C,
                                        int want_site) {
  const int grid = tree_grid_of(C);
  if (grid <= 0) return 0;
  TreeArgs a{};
  a.want_site = want_site;
  return (int64_t)tree_scratch(a, K, L, P, n_pos, grid, nullptr);
}

// The posterior sweep of n items in dependency order: rows [5n] = targets,
// r1, r2 and the producers of r1 and r2 (item indices, -1 for none; each
// before its reader's level), lens [2n] = len1, len2 (clamped), both in
// device memory.  ctrl: kCtrlWords control words then n_flags ready flags
// (zeroed when first allocated); epoch differs from every earlier launch's
// on the same ctrl and is not 0.
int vft_ml_posterior_sweep_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows,
                               const float* lens, int64_t n, int* ctrl, int64_t n_flags,
                               int epoch, void* stream) {
  (void)n_rows;
  if (n <= 0 || epoch == 0) return (int)cudaErrorInvalidValue;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const int64_t units = vft_ml_posterior_sweep_units(n, P);
  if (units > n_flags || units > 0x7fff0000LL) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  const int n_chunks = (P + kUnitThreads - 1) / kUnitThreads;
  if (C == 4)
    return posterior_sweep<4>(m, c_out, w_out, v_out, rows, lens, n, tol, ctrl, (int)units,
                              n_chunks, epoch, st);
  if (C == 20)
    return posterior_sweep<20>(m, c_out, w_out, v_out, rows, lens, n, tol, ctrl, (int)units,
                               n_chunks, epoch, st);
  return (int)cudaErrorInvalidValue;
}

// The tree log-likelihood: the pairs (rows[k], rows[K + k]) at lens[k] of L
// levels, level l's pairs from off[l] to off[l + 1] (device memory); with
// c0 >= 0 the root term (the posterior of rows c0, c1 at l0, l1 into row
// s_ab, then the pair of s_ab and c2 at l2).  out_ll gets the total, and
// with want_site out_site [n_pos] the per-site sums, both float64 in device
// memory.  scratch holds vft_ml_tree_loglk_scratch_bytes; ctrl and epoch as
// for the sweep.
int vft_ml_tree_loglk_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* off, const int32_t* rows,
                          const float* lens, int64_t K, int L, int s_ab, int c0, int c1, int c2,
                          float l0, float l1, float l2, int want_site, double* out_ll,
                          double* out_site, void* scratch, int64_t scratch_bytes, int* ctrl,
                          int64_t n_flags, int epoch, void* stream) {
  (void)n_rows;
  if (L < 0 || K < 0 || epoch == 0 || (want_site && out_site == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const int root = c0 >= 0 ? 1 : 0;
  const int64_t units = vft_ml_tree_loglk_units(K, L, n_pos, root, want_site);
  if (units > n_flags || units > 0x7fff0000LL) return (int)cudaErrorInvalidValue;
  const int grid = tree_grid_of(C);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  TreeArgs a{};
  a.off = off;
  a.r1 = rows;
  a.r2 = rows + K;
  a.len = lens;
  a.K = (int)K;
  a.L = L;
  a.n_sc = site_chunks(n_pos, want_site);
  a.root = root;
  a.s_ab = s_ab;
  a.c0 = c0;
  a.c1 = c1;
  a.c2 = c2;
  a.l0 = l0;
  a.l1 = l1;
  a.l2 = l2;
  a.want_site = want_site;
  a.out_ll = out_ll;
  a.out_site = out_site;
  if ((int64_t)tree_scratch(a, K, L, P, n_pos, grid, static_cast<char*>(scratch)) >
      scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = units < grid ? (int)units : grid;
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  if (C == 4) return tree_loglk<4>(m, c_out, w_out, v_out, tol, a, g, ctrl, epoch, st);
  if (C == 20) return tree_loglk<20>(m, c_out, w_out, v_out, tol, a, g, ctrl, epoch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
