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
// veryfasttree_tpu/ops/kernels.py:214-363).  What bounds them here is launch
// and host round-trip latency: a call reads two rows (P * (C + 2) * 4 bytes
// each, 12 KB at P=512, C=4) and the host loop waits for the result before
// its next decision.  So row indices and lengths travel by value in the
// launch parameters (no host-to-device copy), a whole branch-length line
// search runs inside one launch, and a whole quartet optimization (two
// posteriors, a line search, the star test, five more posteriors and four
// more line searches, the closing pair log-likelihoods) runs inside one
// block, its six temporary profiles in shared memory.
//
// Each piece is one __device__ function (pair_loglk_block, posterior_site,
// line_search) that both the single-call kernels and the quartet kernel
// call, so the quartet kernel gives the chain of single calls bit for bit.
//
// Arithmetic: float32 per position with IEEE expf/logf and divisions; this
// file is compiled with -fmad=false, so every float expression rounds as it
// is written (as the plain PyTorch twins and the JAX package's float32 code
// do).  Sums over positions are taken in double in a fixed order: each
// thread strides the positions, then a warp-shuffle tree, then the warps in
// order; no atomics, the same order on every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kNoCode = 127;
constexpr int kBadRow = -1;
constexpr int kMaxRates = 32;
constexpr int kLkThreads = 128;
constexpr int kLkCap = 256;
constexpr int kPostThreads = 128;
constexpr int kPostCap = 128;
constexpr int kOptThreads = 256;
constexpr int kOptCap = 64;
constexpr int kQuartetCap = 32;
constexpr int kOptSmemCap = 200 * 1024;  // dynamic shared memory a block may take
constexpr float kCGold = 0.3819660f;
constexpr float kZeps = 1.0e-10f;
constexpr int kBrentItmax = 100;
constexpr double kCloseLogLkLimit = 5.0;  // constants.CLOSE_LOGLK_LIMIT

struct MLView {
  const int8_t* codes;      // [n_rows, P]
  const float* W;           // [n_rows, P]
  const float* V;           // [n_rows, P, C]
  const float* code_freq;   // [128, C]
  const float* eigenval;    // [C]
  const float* eigeninv;    // [C, C]
  const float* statinv;     // [C]
  const float* rates;       // [n_rates]
  const int32_t* ratecat;   // [P]
  int P;
  int n_pos;
  int n_rates;
  int jc;
  float min_rel_len;
};

// One profile row: a row of the store, or a quartet temporary (codes null:
// every position NOCODE, as a posterior writes it).
struct RowRef {
  const int8_t* codes;  // [P] or nullptr
  const float* W;       // [P]
  const float* V;       // [P, C]
};

struct SearchLimits {
  float xmin, xmax, ftol, atol;
};

struct LkBatch {
  int32_t r1[kLkCap];
  int32_t r2[kLkCap];
  float len[kLkCap];
};

struct PostBatch {
  int32_t t[kPostCap];
  int32_t r1[kPostCap];
  int32_t r2[kPostCap];
  float len1[kPostCap];
  float len2[kPostCap];
};

struct OptBatch {
  int32_t r1[kOptCap];
  int32_t r2[kOptCap];
  float guess[kOptCap];
};

// Quartet rows (A, B, C, D) and float64 lengths (A, B, C, D, I), as the
// host loop holds them.
struct QuartetBatch {
  int32_t rows[kQuartetCap][4];
  double len[kQuartetCap][5];
};

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

enum { kLenA, kLenB, kLenC, kLenD, kLenI };
enum { kAB, kCD, kBCD, kACD, kABD, kABC, kTemps };

bool rows_in(const int32_t* rows, int n, int64_t hi) {
  for (int k = 0; k < n; ++k)
    if (rows[k] < 0 || rows[k] >= hi) return false;
  return true;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

template <int C>
__device__ __forceinline__ RowRef store_row(const MLView& m, int64_t row) {
  return RowRef{m.codes + row * m.P, m.W + row * m.P, m.V + row * m.P * C};
}

// Effective vector of one row at position p under the reference's mixing
// rules (ops/kernels.py ml_effective): 0 < w < 1 positions are mixed with the
// gap vector; the pair log-likelihood in matrix mode mixes every such
// position, the posterior and Jukes-Cantor only code-derived ones.
template <int C>
__device__ __forceinline__ void effective(const MLView& m, const RowRef& r, int p, bool for_post,
                                          float& w, float (&f)[C]) {
  const int code = r.codes != nullptr ? r.codes[p] : kNoCode;
  w = r.W[p];
  const float* v = r.V + (int64_t)p * C;
  const bool stored = code == kNoCode && w > 0.0f;
  bool mix = w > 0.0f && w < 1.0f;
  if (m.jc || for_post) mix = mix && !stored;
  const float wm = mix ? w : 1.0f;
  const float om = 1.0f - wm;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float gap = m.jc ? 0.25f : m.code_freq[kNoCode * C + c];
    f[c] = wm * v[c] + om * gap;
  }
}

// Per-rate tables for a branch length (ops/kernels.py p_same_diff,
// exp_eigen_rates): Jukes-Cantor tab[r] = pSame, tab[kMaxRates + r] = pDiff;
// matrix tab[r * C + c] = exp(max(len * rate, minRel) * eigenval[c]).
// Filled by the block's threads; the caller synchronises.
template <int C>
__device__ __forceinline__ void fill_table(const MLView& m, float len, float* tab) {
  if (m.jc) {
    for (int r = threadIdx.x; r < m.n_rates; r += blockDim.x) {
      const float ps = 0.25f + 0.75f * expf((-4.0f / 3.0f) * fabsf(len * m.rates[r]));
      tab[r] = ps;
      tab[kMaxRates + r] = (1.0f - ps) / 3.0f;
    }
  } else {
    for (int i = threadIdx.x; i < m.n_rates * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const float rel = fmaxf(len * m.rates[r], m.min_rel_len);
      tab[i] = expf(rel * m.eigenval[c]);
    }
  }
}

// Per-site likelihood of two effective vectors (ops/kernels.py
// pair_loglk_jc, pair_loglk_matrix); the caller masks padding and, in
// matrix mode, both-gap positions to 1.
template <int C>
__device__ __forceinline__ float site_lk(const MLView& m, const float* tab, int rate,
                                         const float (&f1)[C], const float (&f2)[C]) {
  if (m.jc) {
    float dot = f1[0] * f2[0], sum2 = f2[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      dot = dot + f1[c] * f2[c];
      sum2 = sum2 + f2[c];
    }
    const float ps = tab[rate], pd = tab[kMaxRates + rate];
    return pd * sum2 + (ps - pd) * dot;
  }
  const float* ee = tab + rate * C;
  float lk = f1[0] * f2[0] * ee[0];
#pragma unroll
  for (int c = 1; c < C; ++c) lk = lk + f1[c] * f2[c] * ee[c];
  return lk;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block sum in a fixed order; every thread gets the total.  `red` holds one
// double per warp plus the total.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = red[0];
    for (int w = 1; w < n_warps; ++w) t += red[w];
    red[n_warps] = t;
  }
  __syncthreads();
  const double total = red[n_warps];
  __syncthreads();  // red may be reused right after
  return total;
}

// Pair log-likelihood of rows r1, r2 at len (ref pairLogLk tcc:1192-1447):
// the float64 sum of the float32 per-site logs, returned to every thread;
// lk_out [P], when not null, gets the per-site likelihoods.  Threads below
// NT stride the positions and the rest add nothing, so in a block of more
// than NT threads the sum keeps the order of an NT-thread block (warps past
// NT / 32 add exact zeros at the end).
template <int C, int NT>
__device__ double pair_loglk_block(const MLView& m, const RowRef& r1, const RowRef& r2, float len,
                                   float* tab, double* red, float* lk_out) {
  __syncthreads();  // earlier readers of tab are done
  fill_table<C>(m, len, tab);
  __syncthreads();
  double acc = 0.0;
  if (threadIdx.x < NT) {
    for (int p = threadIdx.x; p < m.P; p += NT) {
      float w1, w2, f1[C], f2[C];
      effective<C>(m, r1, p, false, w1, f1);
      effective<C>(m, r2, p, false, w2, f2);
      float lk = site_lk<C>(m, tab, m.ratecat[p], f1, f2);
      if (p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f)) lk = 1.0f;
      if (lk_out != nullptr) lk_out[p] = lk;
      acc += (double)logf(fmaxf(lk, 1e-37f));
    }
  }
  return block_sum(acc, red);
}

// Posterior parent profile of rows r1 and r2 at position p (ops/kernels.py
// posterior_jc, posterior_matrix, exact path) from their two rate tables:
// the weight (0 where both are gaps, else 1) and the vector.
template <int C>
__device__ __forceinline__ void posterior_site(const MLView& m, const RowRef& r1, const RowRef& r2,
                                               const float* tab1, const float* tab2, float tol,
                                               int p, float& w_out, float (&out)[C]) {
  float w1, w2, f1[C], f2[C];
  effective<C>(m, r1, p, true, w1, f1);
  effective<C>(m, r2, p, true, w2, f2);
  const int rate = m.ratecat[p];
  const bool both_gap = w1 == 0.0f && w2 == 0.0f;
  if (m.jc) {
    const float ps1 = tab1[rate], pd1 = tab1[kMaxRates + rate];
    const float ps2 = tab2[rate], pd2 = tab2[kMaxRates + rate];
    float tot = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t1 = f1[c] * ps1 + (1.0f - f1[c]) * pd1;
      const float t2 = f2[c] * ps2 + (1.0f - f2[c]) * pd2;
      out[c] = t1 * t2;
      tot = c == 0 ? out[c] : tot + out[c];
    }
    const float den = fmaxf(tot, 1e-37f);
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = both_gap ? 0.25f : out[c] / den;
  } else {
    const float* e1 = tab1 + rate * C;
    const float* e2 = tab2 + rate * C;
    float m1[C], m2[C], fpost[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m1[c] = f1[c] * e1[c];
      m2[c] = f2[c] * e2[c];
    }
    // rotate to character space, x[j] = code_freq[j] . m, and back,
    // out[c] = sum_j fpost[j] * eigeninv[c][j]: each a double sum rounded
    // once (probabilities near 0 are sums of large signed terms, which a
    // float sum would round by its order; ops/kernels.py _rotate)
    float tot = 0.0f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float* cf = m.code_freq + j * C;
      double x1 = 0.0, x2 = 0.0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x1 += (double)m1[c] * (double)cf[c];
        x2 += (double)m2[c] * (double)cf[c];
      }
      fpost[j] = fmaxf((float)x1 * (float)x2 * m.statinv[j], 0.0f);
      tot = j == 0 ? fpost[j] : tot + fpost[j];
    }
    if (tot > tol) {
#pragma unroll
      for (int j = 0; j < C; ++j) fpost[j] = fpost[j] / tot;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* ei = m.eigeninv + c * C;
      double v = 0.0;
#pragma unroll
      for (int j = 0; j < C; ++j) v += (double)fpost[j] * (double)ei[j];
      out[c] = both_gap ? m.code_freq[kNoCode * C + c] : (float)v;
    }
  }
  w_out = both_gap ? 0.0f : 1.0f;
}

// -log-likelihood of the block's branch at length x; called by every thread
// of the block with the same x, returns the same value to every thread.
template <int C>
__device__ float neg_loglk(const MLView& m, const float* eff1, const float* eff2,
                           const int8_t* rate, float* tab, double* red, float x) {
  __syncthreads();  // the previous evaluation is done with tab
  fill_table<C>(m, x, tab);
  __syncthreads();
  double acc = 0.0;
  for (int p = threadIdx.x; p < m.P; p += kOptThreads) {
    const int r = rate[p];
    if (r < 0) continue;  // lk 1: log 0
    float f1[C], f2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      f1[c] = eff1[p * C + c];
      f2[c] = eff2[p * C + c];
    }
    acc += (double)logf(fmaxf(site_lk<C>(m, tab, r, f1, f2), 1e-37f));
  }
  return -(float)block_sum(acc, red);
}

// The whole bracketing + Brent line search over the length of the branch
// between rows r1 and r2 from guess (ref onedimenmin/brent tcc:7024-7178,
// the JAX package's _onedimenmin_device), run by a block of kOptThreads
// threads.  The effective vectors are mixed once into eff1/eff2 [P, C];
// each evaluation is a rate table and a block reduction.  Every thread runs
// the (scalar) control flow on the same values, step for step the JAX
// package's, in float32.  Returns x; fx_out = -loglk at x.
template <int C>
__device__ float line_search(const MLView& m, const RowRef& r1, const RowRef& r2, float guess,
                             const SearchLimits& lim, float* eff1, float* eff2, int8_t* rate,
                             float* tab, double* red, float& fx_out, int& n_eval_out) {
  __syncthreads();  // earlier readers of eff1, eff2, rate are done
  for (int p = threadIdx.x; p < m.P; p += kOptThreads) {
    float w1, w2, f1[C], f2[C];
    effective<C>(m, r1, p, false, w1, f1);
    effective<C>(m, r2, p, false, w2, f2);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      eff1[p * C + c] = f1[c];
      eff2[p * C + c] = f2[c];
    }
    const bool skip = p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f);
    rate[p] = skip ? (int8_t)-1 : (int8_t)m.ratecat[p];
  }
  // (neg_loglk synchronises before it reads)
  int n_eval = 0;
  auto f = [&](float x) {
    ++n_eval;
    return neg_loglk<C>(m, eff1, eff2, rate, tab, red, x);
  };
  const float xmin = lim.xmin, xmax = lim.xmax;

  // bracketing (ref onedimenmin tcc:7027-7074)
  float ax, bx, cx;
  if (guess == xmin) {
    ax = xmin; bx = 2.0f * guess; cx = 10.0f * guess;
  } else if (guess <= 2.0f * xmin) {
    ax = xmin; bx = guess; cx = 5.0f * guess;
  } else {
    ax = 0.5f * guess; bx = guess; cx = 2.0f * guess;
  }
  cx = fminf(cx, xmax);
  if (bx >= cx) bx = 0.5f * (ax + cx);
  float fa = f(ax), fb = f(bx), fc = f(cx);
  while (fa < fb && ax > xmin) {
    ax = (ax + xmin) / 2.0f;
    if (ax < 2.0f * xmin) ax = xmin;
    fa = f(ax);
  }
  while (fc < fb && cx < xmax) {
    cx = (cx + xmax) / 2.0f;
    if (cx > xmax * 0.95f) cx = xmax;
    fc = f(cx);
  }

  // Brent (ref tcc:7098-7178)
  float a = fminf(ax, cx), bb = fmaxf(ax, cx);
  float x = bx, fx = fb;
  float w, fw, v, fv;
  if (fa < fc) {
    w = ax; fw = fa; v = cx; fv = fc;
  } else {
    w = cx; fw = fc; v = ax; fv = fa;
  }
  float d = 0.0f, e = 0.0f;
  for (int it = 0; it < kBrentItmax; ++it) {
    const float xm = 0.5f * (a + bb);
    const float tol1 = lim.ftol * fabsf(x);
    const float tol2 = 2.0f * (tol1 + kZeps);
    if (fabsf(x - xm) <= (tol2 - 0.5f * (bb - a)) || fabsf(a - bb) < lim.atol) break;
    const float r = (x - w) * (fx - fv);
    const float q = (x - v) * (fx - fw);
    float p = fmaf(x - v, q, -((x - w) * r));  // fused, as the JAX package's compiled search
    float q2 = 2.0f * (q - r);
    if (q2 > 0.0f) p = -p;
    q2 = fabsf(q2);
    const bool golden = fabsf(p) >= fabsf(0.5f * q2 * e) || p <= q2 * (a - x) ||
                        p >= q2 * (bb - x) || fabsf(e) <= tol1;
    const float e_gold = x >= xm ? a - x : bb - x;
    if (golden) {
      d = kCGold * e_gold;
      e = e_gold;
    } else {
      float d_par = p / (q2 != 0.0f ? q2 : 1.0f);
      const float u_par = x + d_par;
      if (u_par - a < tol2 || bb - u_par < tol2) d_par = xm - x >= 0.0f ? tol1 : -tol1;
      e = d;
      d = d_par;
    }
    const float u = fabsf(d) >= tol1 ? x + d : x + (d >= 0.0f ? tol1 : -tol1);
    const float fu = f(u);
    if (fu <= fx) {
      if (u >= x) a = x; else bb = x;
      v = w; fv = fw;
      w = x; fw = fx;
      x = u; fx = fu;
    } else {
      if (u < x) a = u; else bb = u;
      if (fu <= fw || w == x) {
        v = w; fv = fw;
        w = u; fw = fu;
      } else if (fu <= fv || v == x || v == w) {
        v = u; fv = fu;
      }
    }
  }
  fx_out = fx;
  n_eval_out = n_eval;
  return x;
}

// Replaces _pair_loglk_impl / _pair_loglk_rows (veryfasttree_tpu/engine/
// ml_profiles.py:52-74): one block per pair; threads stride the positions.
template <int C>
__global__ void __launch_bounds__(kLkThreads) ml_pair_loglk_kernel(MLView m, LkBatch b,
                                                                   double* __restrict__ ll,
                                                                   float* __restrict__ lk_out) {
  __shared__ float tab[kMaxRates * (C > 2 ? C : 2)];
  __shared__ double red[kLkThreads / 32 + 1];
  const int k = blockIdx.x;
  const double total = pair_loglk_block<C, kLkThreads>(
      m, store_row<C>(m, b.r1[k]), store_row<C>(m, b.r2[k]), b.len[k], tab, red,
      lk_out != nullptr ? lk_out + (int64_t)k * m.P : nullptr);
  if (threadIdx.x == 0) ll[k] = total;
}

// Replaces _posterior_into_impl, _posterior_rows_impl and
// _posterior_sweep_impl (veryfasttree_tpu/engine/ml_profiles.py:77-218): the
// posterior parent profile written into the target row.  One thread per
// position, blockIdx.y the item; each block builds its item's two rate
// tables.
template <int C>
__global__ void __launch_bounds__(kPostThreads) ml_posterior_kernel(MLView m, int8_t* codes_out,
                                                                    float* W_out, float* V_out,
                                                                    PostBatch b, float tol) {
  __shared__ float tab1[kMaxRates * (C > 2 ? C : 2)];
  __shared__ float tab2[kMaxRates * (C > 2 ? C : 2)];
  const int k = blockIdx.y;
  fill_table<C>(m, b.len1[k], tab1);
  fill_table<C>(m, b.len2[k], tab2);
  __syncthreads();
  const int p = blockIdx.x * kPostThreads + threadIdx.x;
  if (p >= m.P) return;
  float w, out[C];
  posterior_site<C>(m, store_row<C>(m, b.r1[k]), store_row<C>(m, b.r2[k]), tab1, tab2, tol, p,
                    w, out);
  const int64_t t = b.t[k];
  codes_out[t * m.P + p] = (int8_t)kNoCode;
  W_out[t * m.P + p] = w;
  float* vo = V_out + (t * m.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) vo[c] = out[c];
}

// Shared memory of one line search: both effective vectors (unless they
// live in device memory), per-position rate (-1: contributes lk 1), the
// rate table and the reduction scratch.
size_t opt_smem_bytes(int P, int C, bool vectors_in_smem) {
  size_t bytes = (vectors_in_smem ? 2 * (size_t)P * C * sizeof(float) : 0) + P;
  bytes = align16(bytes);
  bytes += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  bytes += (kOptThreads / 32 + 1) * sizeof(double);
  return bytes;
}

// Replaces _opt_branch_len_core with _onedimenmin_device (veryfasttree_tpu/
// engine/ml_profiles.py:641-759): the whole line search for one branch per
// block (line_search).
template <int C>
__global__ void __launch_bounds__(kOptThreads) ml_opt_branch_kernel(
    MLView m, OptBatch b, SearchLimits lim, float* __restrict__ x_out, float* __restrict__ fx_out,
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
  cur += ((size_t)P + 15) & ~(size_t)15;
  float* tab = reinterpret_cast<float*>(cur);
  cur += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  double* red = reinterpret_cast<double*>(cur);

  float fx;
  int n_eval;
  const float x = line_search<C>(m, store_row<C>(m, b.r1[k]), store_row<C>(m, b.r2[k]),
                                 b.guess[k], lim, eff1, eff2, rate, tab, red, fx, n_eval);
  if (threadIdx.x == 0) {
    x_out[k] = x;
    fx_out[k] = fx;
    n_eval_out[k] = n_eval;
  }
}

// Where a quartet block keeps its pieces: the six temporaries (W then V of
// each, P * (C + 1) floats) and the line search's two effective vectors in
// shared memory where they fit under kOptSmemCap, else in device scratch of
// scratch_floats per quartet; the rate bytes, two rate tables and the
// reduction scratch always in shared memory.
struct QuartetLayout {
  bool temps_smem, eff_smem;
  size_t smem, scratch_floats;
};

QuartetLayout quartet_layout(int P, int C) {
  const size_t temps = align16((size_t)kTemps * P * (C + 1) * sizeof(float));
  const size_t eff = align16(2 * (size_t)P * C * sizeof(float));
  const size_t rest = align16((size_t)P) + 2 * kMaxRates * (C > 2 ? C : 2) * sizeof(float) +
                      (kOptThreads / 32 + 1) * sizeof(double);
  if (temps + eff + rest <= (size_t)kOptSmemCap) return {true, true, temps + eff + rest, 0};
  if (eff + rest <= (size_t)kOptSmemCap) return {false, true, eff + rest, temps / sizeof(float)};
  return {false, false, rest, (temps + eff) / sizeof(float)};
}

// Replaces the chain of XLA calls that the JAX package's ml_quartet_optimize
// makes (veryfasttree_tpu/engine/ml.py:146-209; ref MLQuartetOptimize
// tcc:1650-1788): one block per quartet.  Lengths are float64 as the host
// loop holds them; each is rounded to float32 where the host's call would
// round it, sums of two lengths in float64 first, and the star test
// compares in float64 as Python does.  The pieces run in the chain's order
// with the same __device__ functions, so the results equal the chain's bit
// for bit; the temporaries (S_AB ... S_ABC of the host loop) never leave
// the block.
template <int C>
__global__ void __launch_bounds__(kOptThreads) ml_quartet_opt_kernel(
    MLView m, QuartetBatch b, SearchLimits lim, float tol, int star_test, int temps_smem,
    int eff_smem, QuartetOut* __restrict__ out, float* __restrict__ site_lk, float* scratch,
    int64_t scratch_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int P = m.P;
  const size_t row_floats = (size_t)P * (C + 1);
  unsigned char* cur = smem;
  float* glob = scratch != nullptr ? scratch + (int64_t)k * scratch_floats : nullptr;
  float* temps;
  if (temps_smem) {
    temps = reinterpret_cast<float*>(cur);
    cur += align16(kTemps * row_floats * sizeof(float));
  } else {
    temps = glob;
    glob += align16(kTemps * row_floats * sizeof(float)) / sizeof(float);
  }
  float* eff1;
  if (eff_smem) {
    eff1 = reinterpret_cast<float*>(cur);
    cur += align16(2 * (size_t)P * C * sizeof(float));
  } else {
    eff1 = glob;
  }
  float* eff2 = eff1 + (size_t)P * C;
  int8_t* rate = reinterpret_cast<int8_t*>(cur);
  cur += align16((size_t)P);
  float* tab1 = reinterpret_cast<float*>(cur);
  cur += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  float* tab2 = reinterpret_cast<float*>(cur);
  cur += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  double* red = reinterpret_cast<double*>(cur);

  RowRef T[kTemps];
  for (int i = 0; i < kTemps; ++i) {
    float* row = temps + i * row_floats;
    T[i] = RowRef{nullptr, row, row + P};
  }
  const RowRef A = store_row<C>(m, b.rows[k][0]), B = store_row<C>(m, b.rows[k][1]),
               Cr = store_row<C>(m, b.rows[k][2]), D = store_row<C>(m, b.rows[k][3]);
  double len[5];
  for (int i = 0; i < 5; ++i) len[i] = b.len[k][i];

  // posterior into temporary t, lengths clamped as the store clamps them
  auto post = [&](int t, const RowRef& r1, const RowRef& r2, double l1, double l2) {
    __syncthreads();  // earlier readers of the tables and of row t are done
    fill_table<C>(m, fmaxf((float)l1, lim.xmin), tab1);
    fill_table<C>(m, fmaxf((float)l2, lim.xmin), tab2);
    __syncthreads();
    float* w_row = const_cast<float*>(T[t].W);
    float* v_row = const_cast<float*>(T[t].V);
    for (int p = threadIdx.x; p < P; p += kOptThreads) {
      float w, o[C];
      posterior_site<C>(m, r1, r2, tab1, tab2, tol, p, w, o);
      w_row[p] = w;
#pragma unroll
      for (int c = 0; c < C; ++c) v_row[p * C + c] = o[c];
    }
    __syncthreads();  // row t is whole before anyone reads it
  };
  int n_eval = 0;
  float fx = 0.0f;
  auto search = [&](const RowRef& r1, const RowRef& r2, double guess) {
    int n;
    const float x = line_search<C>(m, r1, r2, (float)guess, lim, eff1, eff2, rate, tab1, red,
                                   fx, n);
    n_eval += n;
    return (double)x;
  };
  auto pair = [&](const RowRef& r1, const RowRef& r2, double length, float* lk) {
    return pair_loglk_block<C, kLkThreads>(m, r1, r2, (float)length, tab1, red, lk);
  };

  post(kAB, A, B, len[kLenA], len[kLenB]);
  post(kCD, Cr, D, len[kLenC], len[kLenD]);
  len[kLenI] = search(T[kAB], T[kCD], len[kLenI]);
  double parts[3];
  bool star = false;
  if (star_test) {
    const double ll_star = pair(T[kAB], T[kCD], (double)lim.xmin, nullptr);
    if (ll_star < -(double)fx - kCloseLogLkLimit) {
      star = true;
      parts[0] = -(double)fx;
      parts[1] = pair(A, B, len[kLenA] + len[kLenB], nullptr);
      parts[2] = pair(Cr, D, len[kLenC] + len[kLenD], nullptr);
    }
  }
  if (!star) {
    post(kBCD, B, T[kCD], len[kLenB], len[kLenI]);
    len[kLenA] = search(A, T[kBCD], len[kLenA]);
    post(kACD, A, T[kCD], len[kLenA], len[kLenI]);
    len[kLenB] = search(B, T[kACD], len[kLenB]);
    post(kAB, A, B, len[kLenA], len[kLenB]);
    post(kABD, T[kAB], D, len[kLenI], len[kLenD]);
    len[kLenC] = search(Cr, T[kABD], len[kLenC]);
    post(kABC, T[kAB], Cr, len[kLenI], len[kLenC]);
    len[kLenD] = search(D, T[kABC], len[kLenD]);
    parts[0] = -(double)fx;
    float* site = site_lk != nullptr ? site_lk + (int64_t)k * 3 * P : nullptr;
    if (site != nullptr) pair(T[kABC], D, len[kLenD], site);
    parts[1] = pair(T[kAB], Cr, len[kLenI] + len[kLenC], site != nullptr ? site + P : nullptr);
    parts[2] = pair(A, B, len[kLenA] + len[kLenB], site != nullptr ? site + 2 * P : nullptr);
  }
  if (threadIdx.x == 0) {
    QuartetOut& o = out[k];
    for (int i = 0; i < 3; ++i) o.parts[i] = parts[i];
    for (int i = 0; i < 5; ++i) o.len[i] = (float)len[i];
    o.star = star ? 1 : 0;
    o.n_eval = n_eval;
    o.pad[0] = o.pad[1] = o.pad[2] = 0;
  }
}

template <int C>
int pair_loglk(const MLView& m, const int32_t* r1, const int32_t* r2, const float* len, int n,
               double* ll, float* lk, cudaStream_t st) {
  LkBatch b;
  for (int off = 0; off < n; off += kLkCap) {
    const int cnt = n - off < kLkCap ? n - off : kLkCap;
    memcpy(b.r1, r1 + off, cnt * sizeof(int32_t));
    memcpy(b.r2, r2 + off, cnt * sizeof(int32_t));
    memcpy(b.len, len + off, cnt * sizeof(float));
    ml_pair_loglk_kernel<C><<<cnt, kLkThreads, 0, st>>>(
        m, b, ll + off, lk != nullptr ? lk + (int64_t)off * m.P : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int C>
int posterior(const MLView& m, int8_t* codes, float* W, float* V, const int32_t* rows,
              const float* lens, int n, float tol, cudaStream_t st) {
  PostBatch b;
  for (int off = 0; off < n; off += kPostCap) {
    const int cnt = n - off < kPostCap ? n - off : kPostCap;
    memcpy(b.t, rows + off, cnt * sizeof(int32_t));
    memcpy(b.r1, rows + n + off, cnt * sizeof(int32_t));
    memcpy(b.r2, rows + 2 * n + off, cnt * sizeof(int32_t));
    memcpy(b.len1, lens + off, cnt * sizeof(float));
    memcpy(b.len2, lens + n + off, cnt * sizeof(float));
    const dim3 grid((m.P + kPostThreads - 1) / kPostThreads, cnt);
    ml_posterior_kernel<C><<<grid, kPostThreads, 0, st>>>(m, codes, W, V, b, tol);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int C>
int opt_branch(const MLView& m, const int32_t* r1, const int32_t* r2, const float* guess, int n,
               const SearchLimits& lim, float* x, float* fx, int32_t* n_eval, float* scratch,
               cudaStream_t st) {
  const size_t smem = opt_smem_bytes(m.P, C, scratch == nullptr);
  if (smem > (size_t)kOptSmemCap) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ml_opt_branch_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kOptSmemCap);
  if (err != cudaSuccess) return (int)err;
  OptBatch b;
  for (int off = 0; off < n; off += kOptCap) {
    const int cnt = n - off < kOptCap ? n - off : kOptCap;
    memcpy(b.r1, r1 + off, cnt * sizeof(int32_t));
    memcpy(b.r2, r2 + off, cnt * sizeof(int32_t));
    memcpy(b.guess, guess + off, cnt * sizeof(float));
    ml_opt_branch_kernel<C><<<cnt, kOptThreads, smem, st>>>(
        m, b, lim, x + off, fx + off, n_eval + off,
        scratch != nullptr ? scratch + (int64_t)off * 2 * m.P * C : nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int C>
int quartet_opt(const MLView& m, const int32_t* rows, const double* lens, int n,
                const SearchLimits& lim, float tol, int star_test, QuartetOut* out,
                float* site_lk, float* scratch, cudaStream_t st) {
  const QuartetLayout L = quartet_layout(m.P, C);
  if (L.scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ml_quartet_opt_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kOptSmemCap);
  if (err != cudaSuccess) return (int)err;
  QuartetBatch b;
  for (int off = 0; off < n; off += kQuartetCap) {
    const int cnt = n - off < kQuartetCap ? n - off : kQuartetCap;
    memcpy(b.rows, rows + 4 * (size_t)off, cnt * 4 * sizeof(int32_t));
    memcpy(b.len, lens + 5 * (size_t)off, cnt * 5 * sizeof(double));
    ml_quartet_opt_kernel<C><<<cnt, kOptThreads, L.smem, st>>>(
        m, b, lim, tol, star_test, L.temps_smem ? 1 : 0, L.eff_smem ? 1 : 0, out + off,
        site_lk != nullptr ? site_lk + (int64_t)off * 3 * m.P : nullptr,
        scratch != nullptr ? scratch + (int64_t)off * L.scratch_floats : nullptr,
        (int64_t)L.scratch_floats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

MLView make_view(const int8_t* codes, const float* W, const float* V, const float* code_freq,
                 const float* eigenval, const float* eigeninv, const float* statinv,
                 const float* rates, const int32_t* ratecat, int P, int n_pos, int n_rates, int jc,
                 float min_rel_len) {
  return MLView{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                P, n_pos, n_rates, jc, min_rel_len};
}

}  // namespace

#define VFT_ML_STORE_ARGS                                                                 \
  const int8_t *codes, const float *W, const float *V, const float *code_freq,           \
      const float *eigenval, const float *eigeninv, const float *statinv,                 \
      const float *rates, const int32_t *ratecat, int64_t n_rows, int P, int C, int n_pos, \
      int n_rates, int jc, float min_rel_len

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

// Pair log-likelihoods of rows (rows[k], rows[n + k]) at lens[k]: ll[k]
// (double) and, when lk is not NULL, the per-site likelihoods lk[k, P].
int vft_ml_pair_loglk_f32(VFT_ML_STORE_ARGS, const int32_t* rows, const float* lens, int n,
                          double* ll, float* lk, void* stream) {
  if (!rows_in(rows, 2 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4) return pair_loglk<4>(m, rows, rows + n, lens, n, ll, lk, st);
  if (C == 20) return pair_loglk<20>(m, rows, rows + n, lens, n, ll, lk, st);
  return (int)cudaErrorInvalidValue;
}

// Posterior profiles of rows (rows[n + k], rows[2n + k]) across lengths
// (lens[k], lens[n + k]) written into row rows[k], in place.
int vft_ml_posterior_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows, const float* lens,
                         int n, void* stream) {
  if (!rows_in(rows, 3 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  if (C == 4) return posterior<4>(m, c_out, w_out, v_out, rows, lens, n, tol, st);
  if (C == 20) return posterior<20>(m, c_out, w_out, v_out, rows, lens, n, tol, st);
  return (int)cudaErrorInvalidValue;
}

// Line search over the length of the branch between rows (rows[k],
// rows[n + k]) from guess[k]: x[k], fx[k] = -loglk at x[k], n_eval[k].
int vft_ml_opt_branch_f32(VFT_ML_STORE_ARGS, const int32_t* rows, const float* guess, int n,
                          float xmin, float xmax, float ftol, float atol, float* x, float* fx,
                          int32_t* n_eval, float* scratch, void* stream) {
  if (!rows_in(rows, 2 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SearchLimits lim{xmin, xmax, ftol, atol};
  if (C == 4) return opt_branch<4>(m, rows, rows + n, guess, n, lim, x, fx, n_eval, scratch, st);
  if (C == 20)
    return opt_branch<20>(m, rows, rows + n, guess, n, lim, x, fx, n_eval, scratch, st);
  return (int)cudaErrorInvalidValue;
}

// Quartet optimizations of rows (rows[4k] .. rows[4k + 3]) = (A, B, C, D)
// from float64 lengths lens[5k .. 5k + 4] = (A, B, C, D, I): out[k] (a
// QuartetOut) and, when site_lk is not NULL, the per-site likelihoods
// site_lk[k, 3, P] of the three closing pairs.  scratch holds
// vft_ml_quartet_scratch_floats(P, C) floats per quartet, or is NULL when
// that is 0.
int vft_ml_quartet_opt_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows, const double* lens,
                           int n, float xmin, float xmax, float ftol, float atol, int star_test,
                           void* out, float* site_lk, float* scratch, void* stream) {
  if (!rows_in(rows, 4 * n, n_rows)) return kBadRow;
  if (n_rates < 1 || n_rates > kMaxRates) return (int)cudaErrorInvalidValue;
  const MLView m = make_view(codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                             P, n_pos, n_rates, jc, min_rel_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SearchLimits lim{xmin, xmax, ftol, atol};
  QuartetOut* o = static_cast<QuartetOut*>(out);
  if (C == 4)
    return quartet_opt<4>(m, rows, lens, n, lim, tol, star_test, o, site_lk, scratch, st);
  if (C == 20)
    return quartet_opt<20>(m, rows, lens, n, lim, tol, star_test, o, site_lk, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
