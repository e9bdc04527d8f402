// Device bodies of the ML store's likelihood kernels, shared by the
// single-call and quartet kernels (ml_lk.cu) and the ML round kernels
// (ml_round.cu), so that a whole round gives the chain of single calls bit
// for bit: the effective vectors under the reference's gap-mixing rules, the
// rate tables, the pair log-likelihood of a block (pair_loglk_block), the
// posterior of one position (posterior_site), the bracketing + Brent line
// search of a block (line_search) and a whole quartet optimization
// (quartet_optimize).
//
// Store layout (veryfasttree_tpu_torch/engine/ml_profiles.py): codes int8
// [n_rows, P], W float [n_rows, P], V float [n_rows, P, C] raw (unmixed)
// rotated vectors; positions at or past n_pos are padding.  Model constants:
// code_freq [128, C] (rows 0..C-1 the rotated one-hots, row 127 the gap
// vector), eigenval [C], eigeninv [C, C], statinv [C], rates [n_rates],
// ratecat [P].  jc selects Jukes-Cantor (uniform 0.25 gap, pSame/pDiff).
//
// Arithmetic: float32 per position with IEEE expf/logf and divisions; the
// files that include this one are compiled with -fmad=false, so every float
// expression rounds as it is written (as the plain PyTorch twins and the JAX
// package's float32 code do).  Sums over positions are taken in double in a
// fixed order: each thread strides the positions, then a warp-shuffle tree,
// then the warps in order; no atomics, the same order on every run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNoCode = 127;
constexpr int kMaxRates = 32;
constexpr int kLkThreads = 128;
constexpr int kOptThreads = 256;
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

// The threads that run one body, and their barrier: the whole block, or
// one of its groups of kOptThreads threads with a named barrier of its own
// (HalfBlock<1>: threads [0, 256), HalfBlock<2>: [256, 512)), as the round
// kernels run two quartet optimizations side by side.  A body computes the
// same values on any group of its thread count.  tid() and size() are
// unsigned, as threadIdx.x and blockDim.x are: with a signed stride nvcc
// unrolls the rate-table loops behind a computed trip count, which made the
// single-call kernels' code 1.7 times as long and ml_posterior 11% slower.
struct WholeBlock {
  __device__ __forceinline__ unsigned tid() const { return threadIdx.x; }
  __device__ __forceinline__ unsigned size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

template <int kBar>
struct HalfBlock {
  __device__ __forceinline__ unsigned tid() const {
    return threadIdx.x - (kBar - 1) * kOptThreads;
  }
  __device__ __forceinline__ unsigned size() const { return kOptThreads; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kOptThreads) : "memory");
  }
};

enum { kLenA, kLenB, kLenC, kLenD, kLenI };
enum { kAB, kCD, kBCD, kACD, kABD, kABC, kTemps };

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
// Filled by the group's threads; the caller synchronises.
template <int C, class G>
__device__ __forceinline__ void fill_table(const G& g, const MLView& m, float len, float* tab) {
  if (m.jc) {
    for (int r = g.tid(); r < m.n_rates; r += g.size()) {
      const float ps = 0.25f + 0.75f * expf((-4.0f / 3.0f) * fabsf(len * m.rates[r]));
      tab[r] = ps;
      tab[kMaxRates + r] = (1.0f - ps) / 3.0f;
    }
  } else {
    for (int i = g.tid(); i < m.n_rates * C; i += g.size()) {
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

// Sum over the group in a fixed order; every thread gets the total.  `red`
// holds one double per warp plus the total.
template <class G>
__device__ __forceinline__ double block_sum(const G& g, double v, double* red) {
  const int warp = g.tid() >> 5, lane = g.tid() & 31, n_warps = g.size() >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  g.sync();
  if (g.tid() == 0) {
    double t = red[0];
    for (int w = 1; w < n_warps; ++w) t += red[w];
    red[n_warps] = t;
  }
  g.sync();
  const double total = red[n_warps];
  g.sync();  // red may be reused right after
  return total;
}

// Pair log-likelihood of rows r1, r2 at len (ref pairLogLk tcc:1192-1447):
// the float64 sum of the float32 per-site logs, returned to every thread;
// lk_out [P], when not null, gets the per-site likelihoods.  Threads below
// NT stride the positions and the rest add nothing, so in a group of more
// than NT threads the sum keeps the order of an NT-thread group (warps past
// NT / 32 add exact zeros at the end).
template <int C, int NT, class G>
__device__ double pair_loglk_block(const G& g, const MLView& m, const RowRef& r1,
                                   const RowRef& r2, float len, float* tab, double* red,
                                   float* lk_out) {
  g.sync();  // earlier readers of tab are done
  fill_table<C>(g, m, len, tab);
  g.sync();
  double acc = 0.0;
  if (g.tid() < NT) {
    for (int p = g.tid(); p < m.P; p += NT) {
      float w1, w2, f1[C], f2[C];
      effective<C>(m, r1, p, false, w1, f1);
      effective<C>(m, r2, p, false, w2, f2);
      float lk = site_lk<C>(m, tab, m.ratecat[p], f1, f2);
      if (p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f)) lk = 1.0f;
      if (lk_out != nullptr) lk_out[p] = lk;
      acc += (double)logf(fmaxf(lk, 1e-37f));
    }
  }
  return block_sum(g, acc, red);
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

// -log-likelihood of the group's branch at length x; called by every
// thread of a kOptThreads group with the same x, returns the same value to
// every thread.
template <int C, class G>
__device__ float neg_loglk(const G& g, const MLView& m, const float* eff1, const float* eff2,
                           const int8_t* rate, float* tab, double* red, float x) {
  g.sync();  // the previous evaluation is done with tab
  fill_table<C>(g, m, x, tab);
  g.sync();
  double acc = 0.0;
  for (int p = g.tid(); p < m.P; p += kOptThreads) {
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
  return -(float)block_sum(g, acc, red);
}

// The whole bracketing + Brent line search over the length of the branch
// between rows r1 and r2 from guess (ref onedimenmin/brent tcc:7024-7178,
// the JAX package's _onedimenmin_device), run by a group of kOptThreads
// threads.  The effective vectors are mixed once into eff1/eff2 [P, C];
// each evaluation is a rate table and a group reduction.  Every thread runs
// the (scalar) control flow on the same values, step for step the JAX
// package's, in float32.  Returns x; fx_out = -loglk at x.
template <int C, class G>
__device__ float line_search(const G& g, const MLView& m, const RowRef& r1, const RowRef& r2,
                             float guess, const SearchLimits& lim, float* eff1, float* eff2,
                             int8_t* rate, float* tab, double* red, float& fx_out,
                             int& n_eval_out) {
  g.sync();  // earlier readers of eff1, eff2, rate are done
  for (int p = g.tid(); p < m.P; p += kOptThreads) {
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
    return neg_loglk<C>(g, m, eff1, eff2, rate, tab, red, x);
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

// Where a quartet optimization keeps its pieces: the six temporaries (W
// then V of each, P * (C + 1) floats) and the line search's two effective
// vectors in shared memory where they fit in `room` bytes, else in device
// scratch of scratch_floats per quartet; the rate bytes, two rate tables
// and the reduction scratch always in shared memory (smem bytes, a
// multiple of 16).
struct QuartetLayout {
  bool temps_smem, eff_smem;
  size_t smem, scratch_floats;
};

QuartetLayout quartet_layout(int P, int C, size_t room = kOptSmemCap) {
  const size_t temps = align16((size_t)kTemps * P * (C + 1) * sizeof(float));
  const size_t eff = align16(2 * (size_t)P * C * sizeof(float));
  const size_t rest = align16(align16((size_t)P) + 2 * kMaxRates * (C > 2 ? C : 2) * sizeof(float) +
                              (kOptThreads / 32 + 1) * sizeof(double));
  if (temps + eff + rest <= room) return {true, true, temps + eff + rest, 0};
  if (eff + rest <= room) return {false, true, eff + rest, temps / sizeof(float)};
  return {false, false, rest, (temps + eff) / sizeof(float)};
}

// The pieces of one quartet optimization: the six temporaries (W then V of
// each, P * (C + 1) floats; codes NOCODE, as a posterior writes them), the
// line search's two effective vectors and rate bytes, two rate tables and
// the reduction scratch.
struct QuartetScratch {
  float* temps;
  float* eff1;
  float* eff2;
  int8_t* rate;
  float* tab1;
  float* tab2;
  double* red;
};

// The pieces of quartet_layout(P, C) from smem (16-byte aligned) and, for
// what does not fit there, the device scratch glob (scratch_floats floats).
template <int C>
__device__ QuartetScratch quartet_scratch(unsigned char* smem, float* glob, bool temps_smem,
                                          bool eff_smem, int P) {
  const size_t row_floats = (size_t)P * (C + 1);
  unsigned char* cur = smem;
  QuartetScratch q;
  if (temps_smem) {
    q.temps = reinterpret_cast<float*>(cur);
    cur += align16(kTemps * row_floats * sizeof(float));
  } else {
    q.temps = glob;
    glob += align16(kTemps * row_floats * sizeof(float)) / sizeof(float);
  }
  if (eff_smem) {
    q.eff1 = reinterpret_cast<float*>(cur);
    cur += align16(2 * (size_t)P * C * sizeof(float));
  } else {
    q.eff1 = glob;
  }
  q.eff2 = q.eff1 + (size_t)P * C;
  q.rate = reinterpret_cast<int8_t*>(cur);
  cur += align16((size_t)P);
  q.tab1 = reinterpret_cast<float*>(cur);
  cur += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  q.tab2 = reinterpret_cast<float*>(cur);
  cur += kMaxRates * (C > 2 ? C : 2) * sizeof(float);
  q.red = reinterpret_cast<double*>(cur);
  return q;
}

// One whole quartet optimization (ref MLQuartetOptimize tcc:1650-1788;
// the JAX package's ml_quartet_optimize, veryfasttree_tpu/engine/ml.py:
// 146-209) of store rows A, B, C, D, by a group of kOptThreads threads.
// len (A, B, C, D, I) is float64 as the host loop holds it, each at least
// the minimum length; each is rounded to float32 where the host's call
// would round it, sums of two lengths in float64 first, and the star test
// compares in float64 as Python does.  The pieces run in the chain's order
// (ops/ml_kernels.quartet_chain) with the single-call kernels' bodies, so
// the results equal the chain's bit for bit.  On return, len holds the
// searched lengths (only I after a star), parts the -negloglk of the last
// search and two pair log-likelihoods (after a star, those of pairs AB and
// CD), n_eval the line searches' evaluations; site [3, P], when not null,
// the closing pairs' per-site likelihoods.  Returns whether the star test
// ended the optimization; every thread gets the same values.
template <int C, class G>
__device__ bool quartet_optimize(const G& g, const MLView& m, const QuartetScratch& q,
                                 const SearchLimits& lim, float tol, bool star_test,
                                 const RowRef& A, const RowRef& B, const RowRef& Cr,
                                 const RowRef& D, double len[5], double parts[3], int& n_eval,
                                 float* site) {
  const int P = m.P;
  const size_t row_floats = (size_t)P * (C + 1);
  RowRef T[kTemps];
  for (int i = 0; i < kTemps; ++i) {
    float* row = q.temps + i * row_floats;
    T[i] = RowRef{nullptr, row, row + P};
  }

  // posterior into temporary t, lengths clamped as the store clamps them
  auto post = [&](int t, const RowRef& r1, const RowRef& r2, double l1, double l2) {
    g.sync();  // earlier readers of the tables and of row t are done
    fill_table<C>(g, m, fmaxf((float)l1, lim.xmin), q.tab1);
    fill_table<C>(g, m, fmaxf((float)l2, lim.xmin), q.tab2);
    g.sync();
    float* w_row = const_cast<float*>(T[t].W);
    float* v_row = const_cast<float*>(T[t].V);
    for (int p = g.tid(); p < P; p += kOptThreads) {
      float w, o[C];
      posterior_site<C>(m, r1, r2, q.tab1, q.tab2, tol, p, w, o);
      w_row[p] = w;
#pragma unroll
      for (int c = 0; c < C; ++c) v_row[p * C + c] = o[c];
    }
    g.sync();  // row t is whole before anyone reads it
  };
  n_eval = 0;
  float fx = 0.0f;
  auto search = [&](const RowRef& r1, const RowRef& r2, double guess) {
    int n;
    const float x = line_search<C>(g, m, r1, r2, (float)guess, lim, q.eff1, q.eff2, q.rate,
                                   q.tab1, q.red, fx, n);
    n_eval += n;
    return (double)x;
  };
  auto pair = [&](const RowRef& r1, const RowRef& r2, double length, float* lk) {
    return pair_loglk_block<C, kLkThreads>(g, m, r1, r2, (float)length, q.tab1, q.red, lk);
  };

  post(kAB, A, B, len[kLenA], len[kLenB]);
  post(kCD, Cr, D, len[kLenC], len[kLenD]);
  len[kLenI] = search(T[kAB], T[kCD], len[kLenI]);
  if (star_test) {
    const double ll_star = pair(T[kAB], T[kCD], (double)lim.xmin, nullptr);
    if (ll_star < -(double)fx - kCloseLogLkLimit) {
      parts[0] = -(double)fx;
      parts[1] = pair(A, B, len[kLenA] + len[kLenB], nullptr);
      parts[2] = pair(Cr, D, len[kLenC] + len[kLenD], nullptr);
      return true;
    }
  }
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
  if (site != nullptr) pair(T[kABC], D, len[kLenD], site);
  parts[1] = pair(T[kAB], Cr, len[kLenI] + len[kLenC], site != nullptr ? site + P : nullptr);
  parts[2] = pair(A, B, len[kLenA] + len[kLenB], site != nullptr ? site + 2 * P : nullptr);
  return false;
}

}  // namespace
