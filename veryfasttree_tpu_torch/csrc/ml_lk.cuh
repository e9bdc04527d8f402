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
// approx turns on -approxml's rough posteriors (20 codes, matrix mode), from
// near_p and near_freq [C, C]; counts [2] (rough, exact) gets the positions
// of the posteriors that take each path at 20 codes (ref
// nAAPosteriorRough/Exact), integer sums that feed no decision.
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
constexpr float kApproxMinF = 0.95f;      // constants.APPROX_ML_MIN_F
constexpr float kApproxMinRatio = (float)(2.0 / 3.0);  // APPROX_ML_MIN_RATIO
constexpr int kRotJ = 2;   // a 20-code rotation's sums in flight per thread

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
  const float* near_p;           // [C, C] the rough posteriors' tables
  const float* near_freq;        // [C, C]
  int approx;                    // -approxml's rough-posterior gate
  unsigned long long* counts;    // [2] rough, exact positions (20 codes)
};

// What a posterior position adds to the rough/exact counts.
enum { kCountNone, kCountRough, kCountExact };

// A warp's rough and exact positions (each lane's counts), added n times to
// sink[0] and sink[1] by lane 0, atomically; every lane of the warp calls
// it.
__device__ __forceinline__ void count_kinds(unsigned rough, unsigned exact,
                                           unsigned long long* sink,
                                           unsigned long long n = 1) {
  rough = __reduce_add_sync(0xffffffffu, rough);
  exact = __reduce_add_sync(0xffffffffu, exact);
  if ((threadIdx.x & 31) == 0 && sink != nullptr) {
    if (rough) atomicAdd(sink, n * rough);
    if (exact) atomicAdd(sink + 1, n * exact);
  }
}

// One profile row: a row of the store, or a quartet temporary (codes null:
// every position NOCODE, as a posterior writes it).  Position p of the row
// is its entry p >> shift: a store row holds every position (shift 0), a
// temporary of a block of a Part only the block's own (shift log2 k).
struct RowRef {
  const int8_t* codes;  // [P] or nullptr
  const float* W;       // [P]
  const float* V;       // [P, C]
  int shift = 0;
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
  kPhRotate,   // a posterior's rotations to character space and back
  kProfPhases
};
constexpr int kProfSlots = 32;  // groups of kOptThreads: block * 2 + group

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

// the phase the group is in (the first thread's; -1 for the others)
__device__ __forceinline__ int prof_phase() {
  return threadIdx.x % kOptThreads == 0 ? prof_cur[threadIdx.x / kOptThreads] : -1;
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
__device__ __forceinline__ int prof_phase() { return -1; }
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
  const int i = p >> r.shift;
  const int code = r.codes != nullptr ? r.codes[i] : kNoCode;
  w = r.W[i];
  const float* v = r.V + (int64_t)i * C;
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
  unsigned buf2 = 0;  // a Part's combines so far (part_sum): its values' buffer
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

// Where a body's positions are.  Solo: the whole block's, position p by
// thread p % kOptThreads (every single-call kernel, the 4-code rounds).
// Part: one block of a group of k (a power of two, at most kMaxGroup)
// blocks of a cluster that run the same body on the same inputs, block j
// of the group owning the positions p = j + k l, l its local index (the
// 20-code round kernels, ml_round.cu); each sum then goes through part_sum,
// which adds the positions in Solo's order, so that every result is Solo's
// bit for bit.
constexpr int kMaxGroup = 4;

struct Solo {
  static constexpr bool kSplit = false;
  __device__ __forceinline__ int first() const { return threadIdx.x; }
  __device__ __forceinline__ int stride() const { return kOptThreads; }
  __device__ __forceinline__ int shift() const { return 0; }
};

// a Part's pointers, in its block's shared memory (so that the bodies do
// not hold them in registers)
struct PartLinks {
  // with the values in shared memory (async): one mbarrier a buffer, whose
  // phase completes when every value of a combine has landed
  alignas(8) unsigned long long full[2];
  double* vals;                       // this block's [2][3][P] per-position values, then 2 stop flags
  double* peer[kMaxGroup];            // each group block's vals (distributed shared memory)
  unsigned* peer_arrived[kMaxGroup];  // each group block's `arrived`
  unsigned arrived[kMaxGroup];        // the combines each group block has reached
  unsigned vals_cl[kMaxGroup];        // async: each group block's vals, shared::cluster
  unsigned full_cl[kMaxGroup];        // async: each group block's full[0], shared::cluster
  int async;                          // the values in shared memory: st.async and mbarriers
};

struct Part {
  static constexpr bool kSplit = true;
  int k, log2k, j;
  int L;              // local positions, ceil(P / k)
  PartLinks* links;
  // at most kOptThreads / 2 local positions: a 20-code posterior takes two
  // threads a position (posterior_row, posterior_site20)
  __device__ __forceinline__ bool pairs() const { return 2 * L <= kOptThreads; }
  __device__ __forceinline__ int first() const { return j + k * (int)threadIdx.x; }
  __device__ __forceinline__ int stride() const { return k * kOptThreads; }
  __device__ __forceinline__ int shift() const { return log2k; }
  // where this combine's K values go in every group block's vals: value k
  // of position p at buffer(red, P) + k P + p
  __device__ __forceinline__ int buffer(const Red& red, int P) const {
    return (int)(red.buf2 & 1) * 3 * P;
  }
  // a value into entry i of every group block's vals (this block's among
  // them) for the combine of buffer b: in shared memory by st.async, each
  // store counted in the receiver's mbarrier full[b]; else plain stores
  __device__ __forceinline__ void put(int b, int i, double v) const {
    const PartLinks* ln = links;
    if (ln->async) {
      for (int q = 0; q < k; ++q)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];" ::"r"(
                ln->vals_cl[q] + 8u * (unsigned)i),
            "l"(__double_as_longlong(v)), "r"(ln->full_cl[q] + 8u * (unsigned)b)
            : "memory");
    } else {
      for (int q = 0; q < k; ++q) ln->peer[q][i] = v;
    }
  }
};

// this block's mbarrier full[b] expects `bytes` more this phase (thread 0)
__device__ __forceinline__ void expect_bytes(unsigned long long* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          (unsigned)__cvta_generic_to_shared(bar)),
      "r"(bytes)
      : "memory");
}

// wait until this block's mbarrier completes the phase of parity `parity`
// (acquire at cluster scope: the values it counted are visible); a wait
// of about 10 s traps, so that a lost value fails the launch and cannot
// hang it
__device__ __forceinline__ void wait_full(unsigned long long* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void fence_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

__device__ __forceinline__ void store_cluster(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_cluster(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// K sums over the positions of a group each of whose blocks has put the
// values of its own positions into every group block's vals (Part::put, at
// g.buffer(red, P)): after a group barrier (values in shared memory: the
// block's mbarrier of the buffer counts the bytes that land; else the
// first thread of each block tells every other block of the group how many
// combines it has reached, and waits until they have all reached this
// one), thread t of every block
// adds the positions t, t + NT, ... in that order from its own shared
// memory as Solo's thread t does, then block_sum adds the threads as
// Solo's does: every block of the group gets Solo's sums.  With a polling Stop the group's first block asks it
// and every block gets its answer.  The values are double-buffered: a block
// writes a buffer again only after every other block has reached the next
// combine, when it has read this one.
template <int K, int NT, class Stop>
__device__ __forceinline__ void part_sum(double (&v)[K], Red& red, const Part& g, int P,
                                         const Stop& stop, bool& stopped) {
  const int buf = red.buf2 & 1;
  const unsigned n = ++red.buf2;
  prof_mark(kPhWait);
  PartLinks* ln = g.links;
  if (ln->async) {
    // the barrier is the data: every block's values (and the first
    // block's stop flag) land here by st.async, counted in full[buf],
    // whose phase this thread 0 opens with the bytes to expect
    if (threadIdx.x == 0) {
      if (Stop::kPolls && g.j == 0) g.put(buf, 6 * P + buf, stop() ? 1.0 : 0.0);
      expect_bytes(&ln->full[buf], 8u * (unsigned)(K * P + (Stop::kPolls ? 1 : 0)));
    }
    wait_full(&ln->full[buf], ((n - 1) >> 1) & 1u);
  } else {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (Stop::kPolls && g.j == 0) g.put(buf, 6 * P + buf, stop() ? 1.0 : 0.0);
      fence_cluster();
      for (int q = 0; q < g.k; ++q)
        if (q != g.j) store_cluster(ln->peer_arrived[q] + g.j, n);
      for (int q = 0; q < g.k; ++q)
        if (q != g.j)
          while (load_cluster(ln->arrived + q) < n) {
          }
      fence_cluster();
    }
    __syncthreads();
  }
  prof_mark(kPhReduce);
  const double* vals = ln->vals + buf * 3 * P;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double acc = 0.0;
    if (threadIdx.x < NT)
      for (int p = threadIdx.x; p < P; p += NT) acc += vals[k * P + p];
    v[k] = acc;
  }
  if (Stop::kPolls) stopped = ln->vals[6 * P + buf] != 0.0;
  bool unused = false;
  block_sum<K>(v, red, NoStop{}, unused);
  prof_mark(kPhControl);
}

// Pair log-likelihood of rows r1, r2 at len (ref pairLogLk tcc:1192-1447):
// the float64 sum of the float32 per-site logs, returned to every thread;
// lk_out [P], when not null, gets the per-site likelihoods.  Threads below
// NT stride the positions and the rest add nothing, so in a block of more
// than NT threads the sum keeps the order of an NT-thread block (warps past
// NT / 32 add exact zeros at the end).
template <int C, int NT, class G = Solo>
__device__ __forceinline__ double pair_loglk_block(const MLView& m, const RowRef& r1,
                                                   const RowRef& r2, float len, Red& red,
                                                   float* lk_out, const G& g = G{}) {
  prof_mark(kPhSites);
  double acc[1] = {0.0};
  if constexpr (G::kSplit) {
    // each position by its owner, its log into every group block's values
    const int at = g.buffer(red, m.P), b = red.buf2 & 1;
    for (int p = g.first(); p < m.P; p += g.stride()) {
      float w1, w2, f1[C], f2[C], e[C];
      effective<C>(m, r1, p, false, w1, f1);
      effective<C>(m, r2, p, false, w2, f2);
      rate_entries<C>(m, len, m.ratecat[p], e);
      float lk = site_lk<C>(m, e, f1, f2);
      if (p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f)) lk = 1.0f;
      if (lk_out != nullptr) lk_out[p] = lk;
      g.put(b, at + p, (double)logf(fmaxf(lk, 1e-37f)));
    }
    bool stopped = false;
    part_sum<1, NT>(acc, red, g, m.P, NoStop{}, stopped);
    return acc[0];
  }
  __syncthreads();  // the rows' positions are other threads' in the other bodies
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

// The 20-code matrix-mode posterior of position p (posterior_site's), its
// characters' rotations split over the threads that share the position:
// this thread rotates characters [jlo, jhi) to character space and back,
// kRotJ sums in flight, each sum over c in order from 0.0 as the 4-code
// loops sum it (a float product is exact in float64, so fma rounds each
// step as the product and the sum rounded it: the same bits in half the
// float64 instructions).  The unnormalized posterior of each character is
// staged in vo; where threads share the position (lanes of one warp, mask)
// they meet at __syncwarp before each reads all of it; every thread then
// normalizes and takes the gate alike.  Returns the position's kind.
template <int C>
__device__ __forceinline__ int posterior_site20(const MLView& m, const RowRef& r1,
                                                const RowRef& r2, const float* e1,
                                                const float* e2, float tol, int p, int jlo,
                                                int jhi, unsigned mask, float& w_out,
                                                float* vo) {
  float w1, w2, f1[C], f2[C];
  effective<C>(m, r1, p, true, w1, f1);
  effective<C>(m, r2, p, true, w2, f2);
  const bool both_gap = w1 == 0.0f && w2 == 0.0f;
  w_out = both_gap ? 0.0f : 1.0f;
  float m1[C], m2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    m1[c] = f1[c] * e1[c];
    m2[c] = f2[c] * e2[c];
  }
  const int phase = prof_phase();
  prof_mark(kPhRotate);
  // rotate to character space, x[j] = code_freq[j] . m, the unnormalized
  // posterior x1 x2 statinv into vo
#pragma unroll 1
  for (int j0 = jlo; j0 < jhi; j0 += kRotJ) {
    double x1[kRotJ], x2[kRotJ];
#pragma unroll
    for (int i = 0; i < kRotJ; ++i) x1[i] = x2[i] = 0.0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double a1 = (double)m1[c], a2 = (double)m2[c];
#pragma unroll
      for (int i = 0; i < kRotJ; ++i) {
        const double cf = (double)m.code_freq[(j0 + i) * C + c];
        x1[i] = fma(a1, cf, x1[i]);
        x2[i] = fma(a2, cf, x2[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRotJ; ++i) {
      const int j = j0 + i;
      vo[j] = fmaxf((float)x1[i] * (float)x2[i] * m.statinv[j], 0.0f);
    }
  }
  if (jhi - jlo < C) __syncwarp(mask);
  float fpost[C];
#pragma unroll
  for (int j = 0; j < C; ++j) fpost[j] = vo[j];
  if (jhi - jlo < C) __syncwarp(mask);  // every thread has read vo before any writes it
  float tot = fpost[0];
#pragma unroll
  for (int j = 1; j < C; ++j) tot = tot + fpost[j];
  if (tot > tol) {
#pragma unroll
    for (int j = 0; j < C; ++j) fpost[j] = fpost[j] / tot;
  }
  const float* gap = m.code_freq + kNoCode * C;
  bool rough = false;
  if (m.approx) {
    int ch = 0;
    float fmax = fpost[0];
#pragma unroll
    for (int j = 1; j < C; ++j) {
      if (fpost[j] > fmax) {
        fmax = fpost[j];
        ch = j;
      }
    }
    const float* np_ch = m.near_p + ch * C;
    const float npdiag = np_ch[ch];
    const float w = (fmax - npdiag) / (1.0f - npdiag);
    bool under = false;
#pragma unroll
    for (int j = 0; j < C; ++j)
      under = under || (j != ch && (1.0f - w) * np_ch[j] < fpost[j] * kApproxMinRatio);
    rough = fmax >= kApproxMinF && !under;
    if (rough) {
      const float wi = w * m.statinv[ch];
      const float* cf = m.code_freq + ch * C;
      const float* nf = m.near_freq + ch * C;
#pragma unroll 1
      for (int c = jlo; c < jhi; ++c) vo[c] = both_gap ? gap[c] : wi * cf[c] + (1.0f - w) * nf[c];
    }
  }
  if (!rough) {
    // rotate back, out[c] = sum_j fpost[j] * eigeninv[c][j]
#pragma unroll 1
    for (int c0 = jlo; c0 < jhi; c0 += kRotJ) {
      double v[kRotJ];
#pragma unroll
      for (int i = 0; i < kRotJ; ++i) v[i] = 0.0;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const double fj = (double)fpost[j];
#pragma unroll
        for (int i = 0; i < kRotJ; ++i) v[i] = fma(fj, (double)m.eigeninv[(c0 + i) * C + j], v[i]);
      }
#pragma unroll
      for (int i = 0; i < kRotJ; ++i) vo[c0 + i] = both_gap ? gap[c0 + i] : (float)v[i];
    }
  }
  prof_mark(phase);
  if (both_gap) return kCountNone;
  return rough ? kCountRough : kCountExact;
}

// Posterior parent profile of rows r1 and r2 at position p (ops/kernels.py
// posterior_jc, posterior_matrix) from the rate entries e1, e2 of p's
// category at their two lengths: the weight (0 where both are gaps, else
// 1) into w_out, the vector into vo[0 .. C-1] (position p of the target
// row, which no other thread touches).  At 20 codes in matrix mode, with
// m.approx, the rough gate of posterior_matrix: a position whose
// normalized posterior has one character ch (the lowest index of the
// maximum) at kApproxMinF or more, and whose mixture w onehot + (1 - w)
// near_p[ch] under-estimates no other character by more than
// kApproxMinRatio, takes w statinv[ch] code_freq[ch] + (1 - w)
// near_freq[ch] instead of the rotation back.  Returns what the position
// counts: kCountRough or kCountExact at 20 codes in matrix mode where not
// both are gaps, else kCountNone.
//
// At 20 codes in matrix mode it is posterior_site20 on one thread: the
// rotations kRotJ characters at a time (rolled loops over the chunks), the
// character-space values staged in vo itself, so that a thread holds one
// rotated vector and the posterior in registers, not 20 x 20 unrolled
// products (the round kernels, which inline it many times, spilled); the
// sums, their order and every rounding are those of 4 codes.
template <int C>
__device__ __forceinline__ int posterior_site(const MLView& m, const RowRef& r1, const RowRef& r2,
                                              const float* e1, const float* e2, float tol, int p,
                                              float& w_out, float* vo) {
  if constexpr (C == 20) {
    if (!m.jc) return posterior_site20<C>(m, r1, r2, e1, e2, tol, p, 0, C, 0u, w_out, vo);
  }
  float w1, w2, f1[C], f2[C];
  effective<C>(m, r1, p, true, w1, f1);
  effective<C>(m, r2, p, true, w2, f2);
  const bool both_gap = w1 == 0.0f && w2 == 0.0f;
  w_out = both_gap ? 0.0f : 1.0f;
  if (m.jc) {
    const float ps1 = e1[0], pd1 = e1[1];
    const float ps2 = e2[0], pd2 = e2[1];
    float out[C];
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
    for (int c = 0; c < C; ++c) vo[c] = both_gap ? 0.25f : out[c] / den;
    return kCountNone;
  }
  if constexpr (C != 20) {
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
    const int phase = prof_phase();
    prof_mark(kPhRotate);
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
    const float* gap = m.code_freq + kNoCode * C;
    float out[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* ei = m.eigeninv + c * C;
      double v = 0.0;
#pragma unroll
      for (int j = 0; j < C; ++j) v += (double)fpost[j] * (double)ei[j];
      out[c] = both_gap ? gap[c] : (float)v;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) vo[c] = out[c];
    prof_mark(phase);
  }
  return kCountNone;
}

// The posterior profile of rows r1 and r2 at lengths len1, len2 into a row
// (codes_out NOCODE where not null, w_out [P], v_out [P, C]), each position
// by the thread that owns it, from that thread's own rate entries: no
// barrier.  At 20 codes its rough and exact positions are added to sink[0]
// and sink[1] (shared memory, atomically, one add a warp); every thread of
// the block calls it.
template <int C, class G = Solo>
__device__ __forceinline__ void posterior_row(const MLView& m, const RowRef& r1, const RowRef& r2,
                                              float len1, float len2, float tol,
                                              int8_t* codes_out, float* w_out, float* v_out,
                                              unsigned long long* sink, const G& g = G{},
                                              int out_shift = 0) {
  unsigned n_rough = 0, n_exact = 0;
  if constexpr (G::kSplit && C == 20) {
    // one or two threads a position (lanes 2l, 2l + 1 of local position l,
    // each rotating half of the characters): one code path for both
    const int s2 = g.pairs() ? 1 : 0;
    const int h = threadIdx.x & s2, span = C >> s2;
    for (int l0 = 0; l0 < g.L; l0 += kOptThreads >> s2) {
      const int l = l0 + (threadIdx.x >> s2);
      const int p = g.j + g.k * l;
      const bool live = l < g.L && p < m.P;  // alike in both lanes of a pair
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int rate = m.ratecat[p];
        const int i = p >> out_shift;
        float e1[C], e2[C], w;
        rate_entries<C>(m, len1, rate, e1);
        rate_entries<C>(m, len2, rate, e2);
        const int kind = posterior_site20<C>(m, r1, r2, e1, e2, tol, p, h * span,
                                             (h + 1) * span, mask, w, v_out + (int64_t)i * C);
        if (h == 0) {
          n_rough += kind == kCountRough ? 1u : 0u;
          n_exact += kind == kCountExact ? 1u : 0u;
          if (codes_out != nullptr) codes_out[i] = (int8_t)kNoCode;
          w_out[i] = w;
        }
      }
    }
    count_kinds(n_rough, n_exact, sink);
    if (s2) __syncthreads();  // the other bodies read a position on one thread
    return;
  }
  for (int p = g.first(); p < m.P; p += g.stride()) {
    const int rate = m.ratecat[p];
    const int i = p >> out_shift;
    float e1[C], e2[C], w;
    rate_entries<C>(m, len1, rate, e1);
    rate_entries<C>(m, len2, rate, e2);
    const int kind = posterior_site<C>(m, r1, r2, e1, e2, tol, p, w, v_out + (int64_t)i * C);
    n_rough += kind == kCountRough ? 1u : 0u;
    n_exact += kind == kCountExact ? 1u : 0u;
    if (codes_out != nullptr) codes_out[i] = (int8_t)kNoCode;
    w_out[i] = w;
  }
  if constexpr (C == 20) count_kinds(n_rough, n_exact, sink);
}

// -log-likelihood of the searched branch at K lengths x, in one sweep over
// the thread's positions and one reduction (each sum in its own order, the
// order of one evaluation alone); every thread of the block gets fx.
template <int C, int K, class Stop, class G = Solo>
__device__ __forceinline__ void neg_loglk(const MLView& m, const float* eff1, const float* eff2,
                                          const int8_t* rate, Red& red, const float (&x)[K],
                                          float (&fx)[K], const Stop& stop, bool& stopped,
                                          const G& g = G{}) {
  prof_mark(kPhSites);
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  if constexpr (G::kSplit) {
    // each local position's K logs into every group block's values (0
    // where its likelihood is 1: Solo adds nothing there, and adding 0 to
    // a sum of logs that starts at +0 changes no bit)
    const int at = g.buffer(red, m.P), b = red.buf2 & 1;
    for (int p = g.first(); p < m.P; p += g.stride()) {
      const int l = p >> g.log2k;
      const int r = rate[l];
      float f1[C], f2[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        f1[c] = eff1[l * C + c];
        f2[c] = eff2[l * C + c];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        double val = 0.0;
        if (r >= 0) {
          float e[C];
          rate_entries<C>(m, x[k], r, e);
          val = (double)logf(fmaxf(site_lk<C>(m, e, f1, f2), 1e-37f));
        }
        g.put(b, at + k * m.P + p, val);
      }
    }
    part_sum<K, kOptThreads>(acc, red, g, m.P, stop, stopped);
#pragma unroll
    for (int k = 0; k < K; ++k) fx[k] = -(float)acc[k];
    return;
  }
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

template <int C, class Stop, class G = Solo>
__device__ __forceinline__ float neg_loglk1(const MLView& m, const float* eff1, const float* eff2,
                                            const int8_t* rate, Red& red, float x,
                                            const Stop& stop, bool& stopped, const G& g = G{}) {
  const float xs[1] = {x};
  float fs[1];
  neg_loglk<C, 1>(m, eff1, eff2, rate, red, xs, fs, stop, stopped, g);
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
template <int C, class Stop, class G = Solo>
__device__ __forceinline__ float line_search(const MLView& m, const RowRef& r1, const RowRef& r2,
                                             float guess, const SearchLimits& lim, float* eff1,
                                             float* eff2, int8_t* rate, Red& red, float& fx_out,
                                             int& n_eval_out, const Stop& stop, bool& stopped,
                                             const G& g = G{}) {
  prof_mark(kPhStage);
  for (int p = g.first(); p < m.P; p += g.stride()) {
    const int l = p >> g.shift();
    float w1, w2, f1[C], f2[C];
    effective<C>(m, r1, p, false, w1, f1);
    effective<C>(m, r2, p, false, w2, f2);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      eff1[l * C + c] = f1[c];
      eff2[l * C + c] = f2[c];
    }
    const bool skip = p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f);
    rate[l] = skip ? (int8_t)-1 : (int8_t)m.ratecat[p];
  }
  if constexpr (G::kSplit) __syncthreads();  // a pair's lanes read them (neg_loglk)
  prof_mark(kPhControl);
  stopped = false;
  int n_eval = 0;
  auto f = [&](float x) {
    ++n_eval;
    return neg_loglk1<C>(m, eff1, eff2, rate, red, x, stop, stopped, g);
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
    neg_loglk<C, 3>(m, eff1, eff2, rate, red, xs, fs, stop, stopped, g);
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
// with `stopped` set and its results void.  At 20 codes the posteriors'
// rough and exact positions are added to sink[0], sink[1] (shared memory),
// each before a barrier that every thread passes before the return.
template <int C, class Stop, class G = Solo>
__device__ __forceinline__ bool quartet_optimize(const MLView& m, const QuartetScratch& q,
                                                 Red& red, const SearchLimits& lim, float tol,
                                                 bool star_test, const RowRef& A,
                                                 const RowRef& B, const RowRef& Cr,
                                                 const RowRef& D, double len[5], double parts[3],
                                                 int& n_eval, float* site, const Stop& stop,
                                                 bool& stopped, unsigned long long* sink,
                                                 const G& g = G{}) {
  // a temporary holds the block's own positions: L of them at local index
  // p >> shift
  const int L = (m.P + (1 << g.shift()) - 1) >> g.shift();
  const size_t row_floats = (size_t)L * (C + 1);
  auto T = [&](int t) {
    float* row = q.temps + t * row_floats;
    return RowRef{nullptr, row, row + L, g.shift()};
  };

  // posterior into temporary t, lengths clamped as the store clamps them
  auto post = [&](int t, const RowRef& r1, const RowRef& r2, double l1, double l2) {
    prof_mark(kPhQPost);
    float* row = q.temps + t * row_floats;
    posterior_row<C>(m, r1, r2, fmaxf((float)l1, lim.xmin), fmaxf((float)l2, lim.xmin), tol,
                     nullptr, row, row + L, sink, g, g.shift());
    prof_mark(kPhControl);
  };
  n_eval = 0;
  stopped = false;
  float fx = 0.0f;
  auto search = [&](const RowRef& r1, const RowRef& r2, double guess) {
    int n;
    const float x = line_search<C>(m, r1, r2, (float)guess, lim, q.eff1, q.eff2, q.rate, red, fx,
                                   n, stop, stopped, g);
    n_eval += n;
    return (double)x;
  };
  auto pair = [&](const RowRef& r1, const RowRef& r2, double length, float* lk) {
    return pair_loglk_block<C, kLkThreads>(m, r1, r2, (float)length, red, lk, g);
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
  parts[1] = pair(T(kAB), Cr, len[kLenI] + len[kLenC], site != nullptr ? site + m.P : nullptr);
  parts[2] = pair(A, B, len[kLenA] + len[kLenB], site != nullptr ? site + 2 * m.P : nullptr);
  return false;
}

}  // namespace
