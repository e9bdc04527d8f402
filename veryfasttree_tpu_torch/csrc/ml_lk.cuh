// Device bodies of the ML store's likelihood kernels, shared by the
// single-call and quartet kernels (ml_lk.cu) and the ML round kernels
// (ml_round.cu), so that a whole round gives the chain of single calls bit
// for bit: the effective vectors under the reference's gap-mixing rules, the
// rate entries, the pair log-likelihood of a block (pair_loglk_block), the
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
//
// Barriers.  Every body runs on a whole block of at most kOptThreads
// threads.  Position p belongs to thread p % kOptThreads in a posterior and
// a line search, so a posterior's row and a search's effective vectors and
// rate bytes are written and read by one thread and need no barrier; each
// thread computes the rate entries of its own positions (rate_entries, the
// expressions of the single-call kernels' tables: the same bits); and a
// reduction is one barrier (block_sum, its partials double-buffered).  So a
// line-search evaluation is one barrier, and the bracket's first three
// evaluations share one.  The pair log-likelihood strides by kLkThreads (the
// single-call kernel's map, which fixes its sum's order), so it reads
// positions another thread wrote and synchronises first.

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

// Probes of scripts/profile_ml_round.py.  Built with VFT_ML_ROUND_PROFILE
// (a second copy of ml_round.cu; never the library the port loads), the
// first thread of each group of kOptThreads adds the clock64() cycles
// between two of its marks to the phase it was in; without it a mark is
// nothing.
enum ProfPhase {
  kPhTable,    // rate tables (a block's, before each thread made its own)
  kPhSites,    // site sums
  kPhReduce,   // reductions
  kPhControl,  // the scalar Brent and bracket control
  kPhStage,    // effective-vector staging
  kPhQPost,    // quartet posteriors
  kPhWalk,     // the walk, setup_abcd and node posteriors
  kPhWait,     // waiting for the other group or blocks
  kProfPhases
};
constexpr int kProfSlots = 8;  // groups of kOptThreads: block * 2 + group

#ifdef VFT_ML_ROUND_PROFILE
__device__ unsigned long long prof_total[kProfSlots][kProfPhases];
__shared__ unsigned long long prof_acc[2][kProfPhases];
__shared__ long long prof_last[2];
__shared__ int prof_cur[2];

__device__ __forceinline__ void prof_mark(int phase) {
  if (threadIdx.x % kOptThreads != 0) return;
  const int s = threadIdx.x / kOptThreads;
  const long long now = clock64();
  prof_acc[s][prof_cur[s]] += (unsigned long long)(now - prof_last[s]);
  prof_last[s] = now;
  prof_cur[s] = phase;
}

__device__ __forceinline__ void prof_begin() {
  if (threadIdx.x % kOptThreads != 0) return;
  const int s = threadIdx.x / kOptThreads;
  for (int k = 0; k < kProfPhases; ++k) prof_acc[s][k] = 0;
  prof_cur[s] = kPhWalk;
  prof_last[s] = clock64();
}

__device__ __forceinline__ void prof_end() {
  prof_mark(kPhWalk);
  if (threadIdx.x % kOptThreads != 0) return;
  const int s = threadIdx.x / kOptThreads;
  const int slot = (int)blockIdx.x * 2 + s;
  if (slot < kProfSlots)
    for (int k = 0; k < kProfPhases; ++k) atomicAdd(&prof_total[slot][k], prof_acc[s][k]);
}
#else
__device__ __forceinline__ void prof_mark(int) {}
__device__ __forceinline__ void prof_begin() {}
__device__ __forceinline__ void prof_end() {}
#endif

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

// The rate entries of rate category r at branch length len (ops/kernels.py
// p_same_diff, exp_eigen_rates): Jukes-Cantor e[0] = pSame, e[1] = pDiff;
// matrix e[c] = exp(max(len * rate, minRel) * eigenval[c]).
template <int C>
__device__ __forceinline__ void rate_entries(const MLView& m, float len, int r, float (&e)[C]) {
  if (m.jc) {
    const float ps = 0.25f + 0.75f * expf((-4.0f / 3.0f) * fabsf(len * m.rates[r]));
    e[0] = ps;
    e[1] = (1.0f - ps) / 3.0f;
  } else {
    const float rel = fmaxf(len * m.rates[r], m.min_rel_len);
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = expf(rel * m.eigenval[c]);
  }
}

// The rate entries of every category into tab [kMaxRates * C] (category r
// at tab + r * C, rate_entries' values) by the block's threads, for the
// single-call posterior; the caller synchronises.
template <int C>
__device__ __forceinline__ void fill_table(const MLView& m, float len, float* tab) {
  if (m.jc) {
    for (int r = threadIdx.x; r < m.n_rates; r += blockDim.x) {
      float e[C];
      rate_entries<C>(m, len, r, e);
      tab[r * C] = e[0];
      tab[r * C + 1] = e[1];
    }
  } else {
    for (int i = threadIdx.x; i < m.n_rates * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const float rel = fmaxf(len * m.rates[r], m.min_rel_len);
      tab[i] = expf(rel * m.eigenval[c]);
    }
  }
}

// Per-site likelihood of two effective vectors under the rate entries e of
// their category (ops/kernels.py pair_loglk_jc, pair_loglk_matrix); the
// caller masks padding and, in matrix mode, both-gap positions to 1.
template <int C>
__device__ __forceinline__ float site_lk(const MLView& m, const float (&e)[C],
                                         const float (&f1)[C], const float (&f2)[C]) {
  if (m.jc) {
    float dot = f1[0] * f2[0], sum2 = f2[0];
#pragma unroll
    for (int c = 1; c < C; ++c) {
      dot = dot + f1[c] * f2[c];
      sum2 = sum2 + f2[c];
    }
    const float ps = e[0], pd = e[1];
    return pd * sum2 + (ps - pd) * dot;
  }
  float lk = f1[0] * f2[0] * e[0];
#pragma unroll
  for (int c = 1; c < C; ++c) lk = lk + f1[c] * f2[c] * e[c];
  return lk;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The partials of the block's reductions in shared memory: two buffers of
// kRedSlots doubles (up to three sums of eight warps, then a stop flag),
// and the buffer the next reduction takes.  Consecutive reductions of a
// block alternate buffers, so one barrier each is enough: a thread writes
// a buffer again only after the next reduction's barrier, which every
// thread reaches after it has read this one.  Every thread makes the same
// reductions in the same order, each on its own copy of `buf`.
constexpr int kRedSlots = 32;
struct Red {
  double* slot;  // [2 * kRedSlots]
  int buf;
};

// A body that runs to its end: every caller but a round's speculative
// optimizations (ml_round.cu AbandonFlag).
struct NoStop {
  static constexpr bool kPolls = false;
  __device__ bool operator()() const { return false; }
};

// K sums over the block, each in a fixed order (the warp's shuffle tree,
// then warps 0, 1, ... added in turn by every thread, as one thread used to
// add them), returned to every thread in v.  With a polling Stop, thread 0
// asks it before the barrier and every thread gets the same answer in
// `stopped`.  At most eight warps.
template <int K, class Stop>
__device__ __forceinline__ void block_sum(double (&v)[K], Red& red, const Stop& stop,
                                          bool& stopped) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  double* s = red.slot + red.buf * kRedSlots;
  red.buf ^= 1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const double w = warp_sum(v[k]);
    if (lane == 0) s[8 * k + warp] = w;
  }
  if (Stop::kPolls && threadIdx.x == 0) s[kRedSlots - 1] = stop() ? 1.0 : 0.0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double t = s[8 * k];
    for (int w = 1; w < n_warps; ++w) t += s[8 * k + w];
    v[k] = t;
  }
  if (Stop::kPolls) stopped = s[kRedSlots - 1] != 0.0;
}

// Pair log-likelihood of rows r1, r2 at len (ref pairLogLk tcc:1192-1447):
// the float64 sum of the float32 per-site logs, returned to every thread;
// lk_out [P], when not null, gets the per-site likelihoods.  Threads below
// NT stride the positions and the rest add nothing, so in a block of more
// than NT threads the sum keeps the order of an NT-thread block (warps past
// NT / 32 add exact zeros at the end).
template <int C, int NT>
__device__ __forceinline__ double pair_loglk_block(const MLView& m, const RowRef& r1,
                                                   const RowRef& r2, float len, Red& red,
                                                   float* lk_out) {
  prof_mark(kPhSites);
  __syncthreads();  // the rows' positions are other threads' in the other bodies
  double acc[1] = {0.0};
  if (threadIdx.x < NT) {
    for (int p = threadIdx.x; p < m.P; p += NT) {
      float w1, w2, f1[C], f2[C], e[C];
      effective<C>(m, r1, p, false, w1, f1);
      effective<C>(m, r2, p, false, w2, f2);
      rate_entries<C>(m, len, m.ratecat[p], e);
      float lk = site_lk<C>(m, e, f1, f2);
      if (p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f)) lk = 1.0f;
      if (lk_out != nullptr) lk_out[p] = lk;
      acc[0] += (double)logf(fmaxf(lk, 1e-37f));
    }
  }
  prof_mark(kPhReduce);
  bool stopped = false;
  block_sum<1>(acc, red, NoStop{}, stopped);
  prof_mark(kPhControl);
  return acc[0];
}

// Posterior parent profile of rows r1 and r2 at position p (ops/kernels.py
// posterior_jc, posterior_matrix, exact path) from the rate entries e1, e2
// of p's category at their two lengths: the weight (0 where both are gaps,
// else 1) and the vector.
template <int C>
__device__ __forceinline__ void posterior_site(const MLView& m, const RowRef& r1, const RowRef& r2,
                                               const float* e1, const float* e2, float tol, int p,
                                               float& w_out, float (&out)[C]) {
  float w1, w2, f1[C], f2[C];
  effective<C>(m, r1, p, true, w1, f1);
  effective<C>(m, r2, p, true, w2, f2);
  const bool both_gap = w1 == 0.0f && w2 == 0.0f;
  if (m.jc) {
    const float ps1 = e1[0], pd1 = e1[1];
    const float ps2 = e2[0], pd2 = e2[1];
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

// The posterior profile of rows r1 and r2 at lengths len1, len2 into a row
// (codes_out NOCODE where not null, w_out [P], v_out [P, C]), each position
// by the thread that owns it, from that thread's own rate entries: no
// barrier.
template <int C>
__device__ __forceinline__ void posterior_row(const MLView& m, const RowRef& r1, const RowRef& r2,
                                              float len1, float len2, float tol,
                                              int8_t* codes_out, float* w_out, float* v_out) {
  for (int p = threadIdx.x; p < m.P; p += kOptThreads) {
    const int rate = m.ratecat[p];
    float e1[C], e2[C], w, o[C];
    rate_entries<C>(m, len1, rate, e1);
    rate_entries<C>(m, len2, rate, e2);
    posterior_site<C>(m, r1, r2, e1, e2, tol, p, w, o);
    if (codes_out != nullptr) codes_out[p] = (int8_t)kNoCode;
    w_out[p] = w;
#pragma unroll
    for (int c = 0; c < C; ++c) v_out[(int64_t)p * C + c] = o[c];
  }
}

// -log-likelihood of the searched branch at K lengths x, in one sweep over
// the thread's positions and one reduction (each sum in its own order, the
// order of one evaluation alone); every thread of the block gets fx.
template <int C, int K, class Stop>
__device__ __forceinline__ void neg_loglk(const MLView& m, const float* eff1, const float* eff2,
                                          const int8_t* rate, Red& red, const float (&x)[K],
                                          float (&fx)[K], const Stop& stop, bool& stopped) {
  prof_mark(kPhSites);
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int p = threadIdx.x; p < m.P; p += kOptThreads) {
    const int r = rate[p];
    if (r < 0) continue;  // lk 1: log 0
    float f1[C], f2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      f1[c] = eff1[p * C + c];
      f2[c] = eff2[p * C + c];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float e[C];
      rate_entries<C>(m, x[k], r, e);
      acc[k] += (double)logf(fmaxf(site_lk<C>(m, e, f1, f2), 1e-37f));
    }
  }
  prof_mark(kPhReduce);
  block_sum<K>(acc, red, stop, stopped);
  prof_mark(kPhControl);
#pragma unroll
  for (int k = 0; k < K; ++k) fx[k] = -(float)acc[k];
}

template <int C, class Stop>
__device__ __forceinline__ float neg_loglk1(const MLView& m, const float* eff1, const float* eff2,
                                            const int8_t* rate, Red& red, float x,
                                            const Stop& stop, bool& stopped) {
  const float xs[1] = {x};
  float fs[1];
  neg_loglk<C, 1>(m, eff1, eff2, rate, red, xs, fs, stop, stopped);
  return fs[0];
}

// The whole bracketing + Brent line search over the length of the branch
// between rows r1 and r2 from guess (ref onedimenmin/brent tcc:7024-7178,
// the JAX package's _onedimenmin_device), run by a block of kOptThreads
// threads.  The effective vectors are mixed once into eff1/eff2 [P, C],
// each position by its own thread; each evaluation is that thread's
// positions and one reduction.  Every thread runs the (scalar) control flow
// on the same values, step for step the JAX package's, in float32.
// Returns x; fx_out = -loglk at x.  With a polling Stop the search ends at
// the first evaluation after stop() answers true, with `stopped` set and
// its results void.
template <int C, class Stop>
__device__ __forceinline__ float line_search(const MLView& m, const RowRef& r1, const RowRef& r2,
                                             float guess, const SearchLimits& lim, float* eff1,
                                             float* eff2, int8_t* rate, Red& red, float& fx_out,
                                             int& n_eval_out, const Stop& stop, bool& stopped) {
  prof_mark(kPhStage);
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
  prof_mark(kPhControl);
  stopped = false;
  int n_eval = 0;
  auto f = [&](float x) {
    ++n_eval;
    return neg_loglk1<C>(m, eff1, eff2, rate, red, x, stop, stopped);
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
  float fa, fb, fc;
  {
    const float xs[3] = {ax, bx, cx};
    float fs[3];
    n_eval += 3;
    neg_loglk<C, 3>(m, eff1, eff2, rate, red, xs, fs, stop, stopped);
    fa = fs[0];
    fb = fs[1];
    fc = fs[2];
  }
  while (!stopped && fa < fb && ax > xmin) {
    ax = (ax + xmin) / 2.0f;
    if (ax < 2.0f * xmin) ax = xmin;
    fa = f(ax);
  }
  while (!stopped && fc < fb && cx < xmax) {
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
  for (int it = 0; it < kBrentItmax && !stopped; ++it) {
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
// scratch of scratch_floats per quartet; the rate bytes and the reduction
// partials always in shared memory (smem bytes, a multiple of 16).
struct QuartetLayout {
  bool temps_smem, eff_smem;
  size_t smem, scratch_floats;
};

QuartetLayout quartet_layout(int P, int C, size_t room = kOptSmemCap) {
  const size_t temps = align16((size_t)kTemps * P * (C + 1) * sizeof(float));
  const size_t eff = align16(2 * (size_t)P * C * sizeof(float));
  const size_t rest = align16((size_t)P) + 2 * kRedSlots * sizeof(double);
  if (temps + eff + rest <= room) return {true, true, temps + eff + rest, 0};
  if (eff + rest <= room) return {false, true, eff + rest, temps / sizeof(float)};
  return {false, false, rest, (temps + eff) / sizeof(float)};
}

// The pieces of one quartet optimization: the six temporaries (W then V of
// each, P * (C + 1) floats; codes NOCODE, as a posterior writes them), the
// line search's two effective vectors and rate bytes, and the reduction
// partials.
struct QuartetScratch {
  float* temps;
  float* eff1;
  float* eff2;
  int8_t* rate;
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
  q.red = reinterpret_cast<double*>(cur);
  return q;
}

// One whole quartet optimization (ref MLQuartetOptimize tcc:1650-1788;
// the JAX package's ml_quartet_optimize, veryfasttree_tpu/engine/ml.py:
// 146-209) of store rows A, B, C, D, by a block of kOptThreads threads.
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
// ended the optimization; every thread gets the same values.  With a
// polling Stop it ends after the search in which stop() answered true,
// with `stopped` set and its results void.
template <int C, class Stop>
__device__ __forceinline__ bool quartet_optimize(const MLView& m, const QuartetScratch& q,
                                                 Red& red, const SearchLimits& lim, float tol,
                                                 bool star_test, const RowRef& A,
                                                 const RowRef& B, const RowRef& Cr,
                                                 const RowRef& D, double len[5], double parts[3],
                                                 int& n_eval, float* site, const Stop& stop,
                                                 bool& stopped) {
  const int P = m.P;
  const size_t row_floats = (size_t)P * (C + 1);
  auto T = [&](int t) {
    float* row = q.temps + t * row_floats;
    return RowRef{nullptr, row, row + P};
  };

  // posterior into temporary t, lengths clamped as the store clamps them
  auto post = [&](int t, const RowRef& r1, const RowRef& r2, double l1, double l2) {
    prof_mark(kPhQPost);
    float* row = q.temps + t * row_floats;
    posterior_row<C>(m, r1, r2, fmaxf((float)l1, lim.xmin), fmaxf((float)l2, lim.xmin), tol,
                     nullptr, row, row + P);
    prof_mark(kPhControl);
  };
  n_eval = 0;
  stopped = false;
  float fx = 0.0f;
  auto search = [&](const RowRef& r1, const RowRef& r2, double guess) {
    int n;
    const float x = line_search<C>(m, r1, r2, (float)guess, lim, q.eff1, q.eff2, q.rate, red, fx,
                                   n, stop, stopped);
    n_eval += n;
    return (double)x;
  };
  auto pair = [&](const RowRef& r1, const RowRef& r2, double length, float* lk) {
    return pair_loglk_block<C, kLkThreads>(m, r1, r2, (float)length, red, lk);
  };

  post(kAB, A, B, len[kLenA], len[kLenB]);
  post(kCD, Cr, D, len[kLenC], len[kLenD]);
  len[kLenI] = search(T(kAB), T(kCD), len[kLenI]);
  if (stopped) return false;
  if (star_test) {
    const double ll_star = pair(T(kAB), T(kCD), (double)lim.xmin, nullptr);
    if (ll_star < -(double)fx - kCloseLogLkLimit) {
      parts[0] = -(double)fx;
      parts[1] = pair(A, B, len[kLenA] + len[kLenB], nullptr);
      parts[2] = pair(Cr, D, len[kLenC] + len[kLenD], nullptr);
      return true;
    }
  }
  post(kBCD, B, T(kCD), len[kLenB], len[kLenI]);
  len[kLenA] = search(A, T(kBCD), len[kLenA]);
  if (stopped) return false;
  post(kACD, A, T(kCD), len[kLenA], len[kLenI]);
  len[kLenB] = search(B, T(kACD), len[kLenB]);
  if (stopped) return false;
  post(kAB, A, B, len[kLenA], len[kLenB]);
  post(kABD, T(kAB), D, len[kLenI], len[kLenD]);
  len[kLenC] = search(Cr, T(kABD), len[kLenC]);
  if (stopped) return false;
  post(kABC, T(kAB), Cr, len[kLenI], len[kLenC]);
  len[kLenD] = search(D, T(kABC), len[kLenD]);
  if (stopped) return false;
  parts[0] = -(double)fx;
  if (site != nullptr) pair(T(kABC), D, len[kLenD], site);
  parts[1] = pair(T(kAB), Cr, len[kLenI] + len[kLenC], site != nullptr ? site + P : nullptr);
  parts[2] = pair(A, B, len[kLenA] + len[kLenB], site != nullptr ? site + 2 * P : nullptr);
  return false;
}

}  // namespace
