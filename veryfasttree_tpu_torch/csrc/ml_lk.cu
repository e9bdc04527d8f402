// Likelihood kernels of the ML profile store for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (veryfasttree_tpu_torch/ops/_build.py,
// wrappers in veryfasttree_tpu_torch/ops/ml_kernels.py).
//
// Store layout (veryfasttree_tpu_torch/engine/ml_profiles.py): codes int8
// [n_rows, P], W float [n_rows, P], V float [n_rows, P, C] raw (unmixed)
// rotated vectors; positions at or past n_pos are padding.  Model constants:
// code_freq [128, C] (rows 0..C-1 the rotated one-hots, row 127 the gap
// vector), eigenval [C], eigeninv [C, C], statinv [C], rates [n_rates],
// ratecat [P].  jc selects Jukes-Cantor (uniform 0.25 gap, pSame/pDiff).
//
// These kernels replace XLA computations, not Pallas kernels: the JAX
// package leaves its ML store to XLA (veryfasttree_tpu/engine/ml_profiles.py,
// veryfasttree_tpu/ops/kernels.py:214-363).  A call reads a few rows
// (P * (C + 2) * 4 bytes each, 12 KB at P=512, C=4), so one call alone is
// bound by its launch; what the kernels do about it is take whole lists.
// The row indices, lengths and targets of a pair, posterior or quartet
// list, of any length K, reach device memory in one copy (stage), and the
// grid runs over the list: every split of the SH-like supports pass
// (ops/ml_round.sh_pass: 3S pairs, 2S posteriors, 2S quartets in a launch
// each) fills the card's 132 SMs in one launch.  A whole tree's levels run
// in one launch of ml_sweep.cu's kernels, on these bodies.  Each item runs the body
// it ran alone, with the same thread map, so its bits do not depend on K.
// A whole branch-length line search runs inside one launch, and a whole
// quartet optimization (two posteriors, a line search, the star test, five
// more posteriors and four more line searches, the closing pair
// log-likelihoods) inside one block, its six temporary profiles in shared
// memory.
//
// Each piece is one __device__ function of ml_lk.cuh (pair_loglk_block,
// posterior_site, line_search, quartet_optimize) that the list kernels, the
// quartet kernel and the round kernels (ml_round.cu) call, so the quartet
// kernel gives the chain of single calls bit for bit.  This file is
// compiled with -fmad=false (ml_lk.cuh's arithmetic).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "ml_lk.cuh"

namespace {

constexpr int kBadRow = -1;
constexpr int kPostThreads = 128;

// One quartet's result; the host reads it as a numpy record
// (ops/ml_kernels.py QUARTET_RECORD).
struct QuartetOut {
  double parts[3];  // -negloglk of the last search and two pair log-likelihoods
  float len[5];     // searched lengths A, B, C, D, I (only I after a star)
  int32_t star;
  int32_t n_eval;
  int32_t pad[3];
};
static_assert(sizeof(QuartetOut) == 64, "QuartetOut is a 64-byte record");

bool rows_in(const int32_t* rows, int64_t n, int64_t hi) {
  for (int64_t k = 0; k < n; ++k)
    if (rows[k] < 0 || rows[k] >= hi) return false;
  return true;
}

// Copies the host arrays a (na bytes) and b (nb bytes) to dev and
// dev + align16(na) in one cudaMemcpyAsync, in stream order.  The copy's
// source is pageable memory (a per-thread buffer), which the driver has
// staged when the call returns, so the buffer is free again at once; the
// device buffer (one per store) is overwritten in stream order, after the
// launches before it.
int stage(const void* a, size_t na, const void* b, size_t nb, void* dev, cudaStream_t st) {
  thread_local std::vector<char> host;
  const size_t at = align16(na);
  host.resize(at + nb);
  memcpy(host.data(), a, na);
  if (nb > 0) memcpy(host.data() + at, b, nb);
  return (int)cudaMemcpyAsync(dev, host.data(), at + nb, cudaMemcpyHostToDevice, st);
}

// Replaces _pair_loglk_impl / _pair_loglk_rows (veryfasttree_tpu/engine/
// ml_profiles.py:52-74): one block per pair of the list (r1[k], r2[k],
// len[k]); threads stride the positions.
template <int C>
__global__ void __launch_bounds__(kLkThreads)
    ml_pair_loglk_kernel(MLView m, const int32_t* __restrict__ r1, const int32_t* __restrict__ r2,
                         const float* __restrict__ len, double* __restrict__ ll,
                         float* __restrict__ lk_out) {
  __shared__ double red_slot[2 * kRedSlots];
  const int64_t k = blockIdx.x;
  Red red{red_slot, 0};
  const double total = pair_loglk_block<C, kLkThreads>(
      m, store_row<C>(m, r1[k]), store_row<C>(m, r2[k]), len[k], red,
      lk_out != nullptr ? lk_out + k * m.P : nullptr);
  if (threadIdx.x == 0) ll[k] = total;
}

// Lengths of a list item: len[k], or where the list reads the branch
// lengths on the device (bl not NULL, the -threads > 1 lengths pass,
// engine/batched.py) max(bl[node[k]], lo), as the JAX package raises a
// gathered length to the minimum before its posterior or line search.
struct ListLens {
  const float* len;
  const int32_t* node;
  const float* bl;
  float lo;
  __device__ float at(int64_t k) const { return bl != nullptr ? fmaxf(bl[node[k]], lo) : len[k]; }
};

// Replaces _posterior_into_impl and _posterior_rows_impl
// (veryfasttree_tpu/engine/ml_profiles.py:77-111, 183-218), the single and
// list calls: the posterior parent profile of rows r1[k], r2[k] at
// lengths len1.at(k), len2.at(k) written into row t[k].  blockIdx.x the
// item, one thread per position of blockIdx.y's chunk; each block builds
// its item's two rate tables (the rate entries of every category).
// _posterior_sweep_impl (:123-177), a whole run of levels, is
// ml_sweep.cu's ml_posterior_sweep_kernel, which gives this kernel's rows
// bit for bit through chains of dependent items.
template <int C>
__global__ void __launch_bounds__(kPostThreads)
    ml_posterior_kernel(MLView m, int8_t* codes_out, float* W_out, float* V_out,
                        const int32_t* __restrict__ t, const int32_t* __restrict__ r1,
                        const int32_t* __restrict__ r2, ListLens len1, ListLens len2,
                        float tol) {
  __shared__ float tab1[kMaxRates * C];
  __shared__ float tab2[kMaxRates * C];
  const int64_t k = blockIdx.x;
  fill_table<C>(m, len1.at(k), tab1);
  fill_table<C>(m, len2.at(k), tab2);
  __syncthreads();
  const int p = blockIdx.y * kPostThreads + threadIdx.x;
  int kind = kCountNone;
  if (p < m.P) {
    float w;
    const int rate = m.ratecat[p];
    const int64_t row = t[k];
    kind = posterior_site<C>(m, store_row<C>(m, r1[k]), store_row<C>(m, r2[k]),
                             tab1 + rate * C, tab2 + rate * C, tol, p, w,
                             V_out + (row * m.P + p) * C);
    codes_out[row * m.P + p] = (int8_t)kNoCode;
    W_out[row * m.P + p] = w;
  }
  if constexpr (C == 20)
    count_kinds(kind == kCountRough ? 1u : 0u, kind == kCountExact ? 1u : 0u, m.counts);
}

// Shared memory of one line search: both effective vectors (unless they
// live in device memory), per-position rate (-1: contributes lk 1) and the
// reduction partials.
size_t opt_smem_bytes(int P, int C, bool vectors_in_smem) {
  size_t bytes = (vectors_in_smem ? 2 * (size_t)P * C * sizeof(float) : 0) + P;
  return align16(bytes) + 2 * kRedSlots * sizeof(double);
}

// Replaces _opt_branch_len_core with _onedimenmin_device (veryfasttree_tpu/
// engine/ml_profiles.py:641-759) and its list form _opt_branch_len_rows:
// the whole line search for the branch between rows r1[k] and r2[k] from
// guess.at(k) per block (line_search).  Where the guesses come from the
// device's branch lengths (guess.bl), the result is written back to
// bl[guess.node[k]] (the list's nodes are distinct).
template <int C>
__global__ void __launch_bounds__(kOptThreads) ml_opt_branch_kernel(
    MLView m, const int32_t* __restrict__ r1, const int32_t* __restrict__ r2, ListLens guess,
    SearchLimits lim, float* __restrict__ x_out, float* __restrict__ fx_out,
    int32_t* __restrict__ n_eval_out, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int P = m.P;
  float *eff1, *eff2;
  unsigned char* cur = smem;
  if (scratch != nullptr) {
    eff1 = scratch + (int64_t)k * 2 * P * C;
    eff2 = eff1 + (int64_t)P * C;
  } else {
    eff1 = reinterpret_cast<float*>(cur);
    eff2 = eff1 + P * C;
    cur += 2 * (size_t)P * C * sizeof(float);
  }
  int8_t* rate = reinterpret_cast<int8_t*>(cur);
  cur += align16((size_t)P);
  Red red{reinterpret_cast<double*>(cur), 0};

  float fx;
  int n_eval;
  bool stopped;
  const float x = line_search<C>(m, store_row<C>(m, r1[k]), store_row<C>(m, r2[k]),
                                 guess.at(k), lim, eff1, eff2, rate, red, fx, n_eval, NoStop{},
                                 stopped);
  if (threadIdx.x == 0) {
    x_out[k] = x;
    fx_out[k] = fx;
    n_eval_out[k] = n_eval;
    if (guess.bl != nullptr) const_cast<float*>(guess.bl)[guess.node[k]] = x;
  }
}

// Replaces the chain of XLA calls that the JAX package's ml_quartet_optimize
// makes (veryfasttree_tpu/engine/ml.py:146-209; ref MLQuartetOptimize
// tcc:1650-1788): one block per quartet of the list (quartet_optimize),
// rows[4k .. 4k + 3] = (A, B, C, D) and float64 lengths lens[5k .. 5k + 4]
// = (A, B, C, D, I) as the host loop holds them; the temporaries (S_AB ...
// S_ABC of the host loop) never leave the block.
template <int C>
__global__ void __launch_bounds__(kOptThreads) ml_quartet_opt_kernel(
    MLView m, const int32_t* __restrict__ rows, const double* __restrict__ lens,
    SearchLimits lim, float tol, int star_test, int temps_smem, int eff_smem,
    QuartetOut* __restrict__ out, float* __restrict__ site_lk, float* scratch,
    int64_t scratch_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long kinds[2];  // the posteriors' rough, exact positions
  const int64_t k = blockIdx.x;
  if (threadIdx.x < 2) kinds[threadIdx.x] = 0;
  __syncthreads();
  const QuartetScratch q = quartet_scratch<C>(
      smem, scratch != nullptr ? scratch + k * scratch_floats : nullptr, temps_smem,
      eff_smem, m.P);
  double len[5], parts[3];
#pragma unroll
  for (int i = 0; i < 5; ++i) len[i] = lens[5 * k + i];
  int n_eval;
  bool stopped;
  Red red{q.red, 0};
  const int32_t* r = rows + 4 * k;
  const bool star = quartet_optimize<C>(
      m, q, red, lim, tol, star_test != 0, store_row<C>(m, r[0]), store_row<C>(m, r[1]),
      store_row<C>(m, r[2]), store_row<C>(m, r[3]), len, parts, n_eval,
      site_lk != nullptr ? site_lk + k * 3 * m.P : nullptr, NoStop{}, stopped, kinds);
  if (threadIdx.x == 0) {
    if constexpr (C == 20) {
      if (kinds[0]) atomicAdd(m.counts, kinds[0]);
      if (kinds[1]) atomicAdd(m.counts + 1, kinds[1]);
    }
    QuartetOut& o = out[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) o.parts[i] = parts[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) o.len[i] = (float)len[i];
    o.star = star ? 1 : 0;
    o.n_eval = n_eval;
    o.pad[0] = o.pad[1] = o.pad[2] = 0;
  }
}

// Blocks of a list launch: K items, at most the grid's x limit.
bool list_fits(int64_t n) { return n > 0 && n <= 0x7fffffffLL; }

template <int C>
int pair_loglk(const MLView& m, const int32_t* r1, const int32_t* r2, const float* len, int64_t n,
               double* ll, float* lk, cudaStream_t st) {
  ml_pair_loglk_kernel<C><<<(unsigned)n, kLkThreads, 0, st>>>(m, r1, r2, len, ll, lk);
  return (int)cudaGetLastError();
}

template <int C>
int posterior(const MLView& m, int8_t* codes, float* W, float* V, const int32_t* t,
              const int32_t* r1, const int32_t* r2, const ListLens& len1, const ListLens& len2,
              int64_t n, float tol, cudaStream_t st) {
  const dim3 grid((unsigned)n, (m.P + kPostThreads - 1) / kPostThreads);
  ml_posterior_kernel<C><<<grid, kPostThreads, 0, st>>>(m, codes, W, V, t, r1, r2, len1, len2,
                                                        tol);
  return (int)cudaGetLastError();
}

template <int C>
int opt_branch(const MLView& m, const int32_t* r1, const int32_t* r2, const ListLens& guess,
               int64_t n, const SearchLimits& lim, float* x, float* fx, int32_t* n_eval,
               float* scratch, cudaStream_t st) {
  const size_t smem = opt_smem_bytes(m.P, C, scratch == nullptr);
  if (smem > (size_t)kOptSmemCap) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ml_opt_branch_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kOptSmemCap);
  if (err != cudaSuccess) return (int)err;
  ml_opt_branch_kernel<C><<<(unsigned)n, kOptThreads, smem, st>>>(m, r1, r2, guess, lim, x, fx,
                                                                  n_eval, scratch);
  return (int)cudaGetLastError();
}

template <int C>
int quartet_opt(const MLView& m, const int32_t* rows, const double* lens, int64_t n,
                const SearchLimits& lim, float tol, int star_test, QuartetOut* out,
                float* site_lk, float* scratch, cudaStream_t st) {
  const QuartetLayout L = quartet_layout(m.P, C);
  if (L.scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ml_quartet_opt_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kOptSmemCap);
  if (err != cudaSuccess) return (int)err;
  ml_quartet_opt_kernel<C><<<(unsigned)n, kOptThreads, L.smem, st>>>(
      m, rows, lens, lim, tol, star_test, L.temps_smem ? 1 : 0, L.eff_smem ? 1 : 0, out, site_lk,
      scratch, (int64_t)L.scratch_floats);
  return (int)cudaGetLastError();
}

MLView make_view(const int8_t* codes, const float* W, const float* V, const float* code_freq,
                 const float* eigenval, const float* eigeninv, const float* statinv,
                 const float* rates, const int32_t* ratecat, int P, int n_pos, int n_rates, int jc,
                 float min_rel_len, const float* near_p, const float* near_freq, int approx,
                 unsigned long long* counts) {
  return MLView{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, P,
                n_pos, n_rates, jc, min_rel_len, near_p, near_freq, approx, counts};
}

// The list entries' dispatch on C: a posterior list of n items, rows r =
// (targets, r1, r2), and a line-search list of n items, rows r = (r1, r2).
int posterior_list(const MLView& m, int C, const int8_t* codes, const float* W, const float* V,
                   const int32_t* r, int64_t n, const ListLens& l1, const ListLens& l2, float tol,
                   cudaStream_t st) {
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  if (C == 4)
    return posterior<4>(m, c_out, w_out, v_out, r, r + n, r + 2 * n, l1, l2, n, tol, st);
  if (C == 20)
    return posterior<20>(m, c_out, w_out, v_out, r, r + n, r + 2 * n, l1, l2, n, tol, st);
  return (int)cudaErrorInvalidValue;
}

int opt_branch_list(const MLView& m, int C, const int32_t* r, int64_t n, const ListLens& guess,
                    const SearchLimits& lim, float* x, float* fx, int32_t* n_eval, float* scratch,
                    cudaStream_t st) {
  if (C == 4) return opt_branch<4>(m, r, r + n, guess, n, lim, x, fx, n_eval, scratch, st);
  if (C == 20) return opt_branch<20>(m, r, r + n, guess, n, lim, x, fx, n_eval, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define VFT_ML_STORE_ARGS                                                                 \
  const int8_t *codes, const float *W, const float *V, const float *code_freq,           \
      const float *eigenval, const float *eigeninv, const float *statinv,                 \
      const float *rates, const int32_t *ratecat, int64_t n_rows, int P, int C, int n_pos, \
      int n_rates, int jc, float min_rel_len, const float *near_p, const float *near_freq, \
      int approx, unsigned long long *counts
#define VFT_ML_VIEW_PASS                                                                 \
  codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, P, n_pos, n_rates, jc, \
      min_rel_len, near_p, near_freq, approx, counts

extern "C" {

// 1 if a line search's effective vectors fit in shared memory at (P, C);
// otherwise the caller passes device scratch of [n, 2, P, C] floats.
int vft_ml_opt_branch_fits_smem(int P, int C) {
  return opt_smem_bytes(P, C, true) <= (size_t)kOptSmemCap;
}

// Floats of device scratch one quartet optimization needs at (P, C): 0 when
// its temporaries and effective vectors fit in shared memory.
int64_t vft_ml_quartet_scratch_floats(int P, int C) {
  return (int64_t)quartet_layout(P, C).scratch_floats;
}

// Pair log-likelihoods of rows (rows[k], rows[n + k]) at lens[k], k < n:
// ll[k] (double) and, when lk is not NULL, the per-site likelihoods lk[k, P].
// rows and lens are host arrays, checked against the store and copied to
// the device buffer lists (align16(8n) + 4n bytes) by stage.
int vft_ml_pair_loglk_f32(VFT_ML_STORE_ARGS, const int32_t* rows, const float* lens, int64_t n,
                          void* lists, double* ll, float* lk, void* stream) {
  if (!list_fits(n)) return (int)cudaErrorInvalidValue;
  if (!rows_in(rows, 2 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = stage(rows, 2 * n * sizeof(int32_t), lens, n * sizeof(float), lists, st);
  if (err != 0) return err;
  const int32_t* r = static_cast<const int32_t*>(lists);
  const float* len =
      reinterpret_cast<const float*>(static_cast<char*>(lists) + align16(2 * n * sizeof(int32_t)));
  if (C == 4) return pair_loglk<4>(m, r, r + n, len, n, ll, lk, st);
  if (C == 20) return pair_loglk<20>(m, r, r + n, len, n, ll, lk, st);
  return (int)cudaErrorInvalidValue;
}

// Posterior profiles of rows (rows[n + k], rows[2n + k]) written into row
// rows[k], in place, k < n; no target may be a source.  The lengths are
// host floats (lens[k], lens[n + k]) where bl is NULL; otherwise lens is
// NULL, rows holds two more lists of n indices below n_bl, and the lengths
// max(bl[rows[3n + k]], lo), max(bl[rows[4n + k]], lo) are read from the
// float32 device array bl (the -threads > 1 lengths pass).  rows (and
// lens) are checked against the store and copied to the device buffer
// lists (align16(12n) + 8n, or 20n, bytes) by stage.
int vft_ml_posterior_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows, const float* lens,
                         int64_t n, void* lists, const float* bl, int64_t n_bl, float lo,
                         void* stream) {
  if (!list_fits(n)) return (int)cudaErrorInvalidValue;
  if (!rows_in(rows, 3 * n, n_rows) || (bl != nullptr && !rows_in(rows + 3 * n, 2 * n, n_bl)))
    return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_idx = bl != nullptr ? 5 * n : 3 * n;
  const int err = stage(rows, n_idx * sizeof(int32_t), lens,
                        bl != nullptr ? 0 : 2 * n * sizeof(float), lists, st);
  if (err != 0) return err;
  const int32_t* r = static_cast<const int32_t*>(lists);
  const float* len =
      reinterpret_cast<const float*>(static_cast<char*>(lists) + align16(3 * n * sizeof(int32_t)));
  const ListLens l1 = bl != nullptr ? ListLens{nullptr, r + 3 * n, bl, lo}
                                    : ListLens{len, nullptr, nullptr, 0.0f};
  const ListLens l2 = bl != nullptr ? ListLens{nullptr, r + 4 * n, bl, lo}
                                    : ListLens{len + n, nullptr, nullptr, 0.0f};
  return posterior_list(m, C, codes, W, V, r, n, l1, l2, tol, st);
}

// Line search over the length of the branch between rows (rows[k],
// rows[n + k]): x[k], fx[k] = -loglk at x[k], n_eval[k].  The guesses are
// host floats guess[k] where bl is NULL; otherwise guess is NULL, rows
// holds a third list of n distinct indices below n_bl, the guesses are
// max(bl[rows[2n + k]], xmin) read from the float32 device array bl, and
// each x[k] is also written to bl[rows[2n + k]].  rows (and guess) are
// checked against the store and copied to the device buffer lists
// (align16(8n) + 4n, or 12n, bytes) by stage.
int vft_ml_opt_branch_f32(VFT_ML_STORE_ARGS, const int32_t* rows, const float* guess, int64_t n,
                          void* lists, float* bl, int64_t n_bl, float xmin, float xmax,
                          float ftol, float atol, float* x, float* fx, int32_t* n_eval,
                          float* scratch, void* stream) {
  if (!list_fits(n)) return (int)cudaErrorInvalidValue;
  if (!rows_in(rows, 2 * n, n_rows) || (bl != nullptr && !rows_in(rows + 2 * n, n, n_bl)))
    return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_idx = bl != nullptr ? 3 * n : 2 * n;
  const int err = stage(rows, n_idx * sizeof(int32_t), guess,
                        bl != nullptr ? 0 : n * sizeof(float), lists, st);
  if (err != 0) return err;
  const int32_t* r = static_cast<const int32_t*>(lists);
  const float* g =
      reinterpret_cast<const float*>(static_cast<char*>(lists) + align16(2 * n * sizeof(int32_t)));
  const ListLens gl = bl != nullptr ? ListLens{nullptr, r + 2 * n, bl, xmin}
                                    : ListLens{g, nullptr, nullptr, 0.0f};
  return opt_branch_list(m, C, r, n, gl, SearchLimits{xmin, xmax, ftol, atol}, x, fx, n_eval,
                         scratch, st);
}

// Quartet optimizations of rows (rows[4k] .. rows[4k + 3]) = (A, B, C, D)
// from float64 lengths lens[5k .. 5k + 4] = (A, B, C, D, I), k < n: out[k]
// (a QuartetOut) and, when site_lk is not NULL, the per-site likelihoods
// site_lk[k, 3, P] of the three closing pairs.  rows and lens are host
// arrays, checked against the store and copied to the device buffer lists
// (align16(16n) + 40n bytes) by stage.  scratch holds
// vft_ml_quartet_scratch_floats(P, C) floats per quartet, or is NULL when
// that is 0.
int vft_ml_quartet_opt_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows, const double* lens,
                           int64_t n, void* lists, float xmin, float xmax, float ftol,
                           float atol, int star_test, void* out, float* site_lk, float* scratch,
                           void* stream) {
  if (!list_fits(n)) return (int)cudaErrorInvalidValue;
  if (!rows_in(rows, 4 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = stage(rows, 4 * n * sizeof(int32_t), lens, 5 * n * sizeof(double), lists, st);
  if (err != 0) return err;
  const int32_t* r = static_cast<const int32_t*>(lists);
  const double* len = reinterpret_cast<const double*>(static_cast<char*>(lists) +
                                                      align16(4 * n * sizeof(int32_t)));
  const SearchLimits lim{xmin, xmax, ftol, atol};
  QuartetOut* o = static_cast<QuartetOut*>(out);
  if (C == 4) return quartet_opt<4>(m, r, len, n, lim, tol, star_test, o, site_lk, scratch, st);
  if (C == 20)
    return quartet_opt<20>(m, r, len, n, lim, tol, star_test, o, site_lk, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
