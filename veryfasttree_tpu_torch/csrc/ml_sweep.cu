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
// out, 43 MB, 12.8 us at 3.35 TB/s), at 20 codes the sweep by its float64
// rotations; a sweep's critical path is the tree's depth times the
// latency of one posterior.
//
// Both run on the scheduler of dataflow.cuh (which the ME up-profile sweep
// of me_store.cu shares): a grid of the blocks that fit at once takes work
// units in list order, and a unit waits only on units before it.
//
// The sweep: chains of dependent posteriors in one unit.  Position p of a
// posterior reads only position p of its two sources, so the threads that
// own p can carry it up a whole chain of items, each reading the previous
// item's target, with no other block.  The host (SweepTables,
// ops/dataflow.build_chains) splits the producer graph into chains along
// its longest paths, cuts a long chain into segments where the chains
// outnumber the card, and lists them by list scheduling on the critical
// path, every chain after the chains it reads.  A unit is (chain, chunk of
// positions): 128 positions at 4 codes (a thread each), 64 at 20 codes
// (two lanes each, each rotating half of the characters).  The unit walks
// its chain, each item's row going to the store and, at this block's
// positions, to shared memory, where the next item reads it: the chain's
// previous row is never reloaded.  A warp waits on a ready flag only where
// its chain reads another chain's item (flags per warp: the same 32 or 16
// positions in both units, so no block barrier), and publishes one only
// for items another chain reads.  The items' tables are staged in shared
// memory a window at a time; at 4 codes with each item's rate tables
// (fill_table's entries of every category at its two lengths, built by
// the whole block), and the rows an item reads from outside the chain that
// wait on nothing (leaves, finished subtrees) are loaded into registers
// while the item before it runs and staged in shared memory after it.  At
// 20 codes each position's rate entries come from its own category
// (rate_entries' expressions), the rotations' matrices are doubles in
// shared memory (each float converted once: the products posterior_site20
// forms), transposed so that a lane keeps all ten of its sums in flight,
// each over c in order from 0.0 as posterior_site20 sums it.  So every row
// and every rough/exact count is the per-level launches' bit for bit,
// whatever the grid.  A chain's items are a dependent sequence of
// posteriors, so its time is the chain's length times one posterior's
// latency on one warp: in-order instruction issue, each a few cycles.
//
// The tree log-likelihood: the pairs are independent and only the order of
// the sums is fixed (each level's pairs in list order from 0.0, the levels
// in order from 0.0, the root's 3-way term last, as a last level of one
// pair).  Units, in order: the root's term (the posterior of its first two
// children into the scratch row S_AB, then the pair with the third); the
// pairs, 4 (20 codes: 2) a unit with their loads in flight together
// (pair_loglk_block's arithmetic, thread map and block_sum, so each total
// is the per-level ml_pair_loglk launch's bit for bit), each writing its
// total and its per-site logs log(max(lk, 1e-300)) in float64 into one row
// of a scratch matrix (the logs are most of the work: here they spread
// over every pair unit); the level groups (runs of levels of at most
// kGroupRows pairs, or one wider level) by chunks of 32 columns, each
// column's level sums; and per chunk of 32 columns the levels' sums in
// order.  The last two stream their rows through a ring of cp.async tiles
// that the whole block loads while one warp adds, one column a lane.  The
// totals are one more column of the matrix, so they take the same adds.
// No float atomics: every sum has one order, whatever the grid.
//
// Compiled with -fmad=false (ml_lk.cuh's arithmetic).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "dataflow.cuh"
#include "ml_lk.cuh"

namespace {

constexpr int kUnitThreads = 128;  // ml_lk.cu's kPostThreads and kLkThreads
constexpr int kWarps = kUnitThreads / 32;

// Probes of scripts/profile_whole_tree.py: built with VFT_SWEEP_PROBE (a
// second build, never the library the port loads), thread 0 of each block
// adds the clock64() cycles between its marks to the phase it was in;
// without it a mark is nothing.
enum SweepPhase {
  kPrUnit,      // taking a unit, its setup
  kPrWindow,    // staging a window of item tables
  kPrPrefetch,  // prefetching the rows of items ahead
  kPrWait,      // waiting on other chains
  kPrEntries,   // the rate entries of an item's two lengths
  kPrPost,      // the posterior: the rows' loads, the arithmetic
  kPrStore,     // the row's stores
  kPrPublish,   // the flags of items other chains read
  kPrItems,     // (count) items
  kPrRoot,      // tree log-likelihood: the root's term
  kPrPairs,     // its pair units
  kPrGroupWait, // its level groups' waits
  kPrGroups,    // its level groups' sums
  kPrFinalWait, // its final units' waits
  kPrFinal,     // its final sums
  kPrPhases
};
#ifdef VFT_SWEEP_PROBE
__device__ unsigned long long sweep_probe[kPrPhases];
struct Probe {
  long long last = 0;
  int cur = kPrUnit;
  unsigned long long acc[kPrPhases] = {};
  __device__ void mark(int ph) {
    if (threadIdx.x != 0) return;
    const long long t = clock64();
    if (last) acc[cur] += (unsigned long long)(t - last);
    last = t;
    cur = ph;
  }
  __device__ void count(int ph) {
    if (threadIdx.x == 0) acc[ph] += 1;
  }
  __device__ void flush() {
    mark(kPrUnit);
    if (threadIdx.x != 0) return;
    for (int k = 0; k < kPrPhases; ++k)
      if (acc[k]) atomicAdd(&sweep_probe[k], acc[k]);
  }
};
#else
struct Probe {
  __device__ void mark(int) {}
  __device__ void count(int) {}
  __device__ void flush() {}
};
#endif

// ------------------------------------------------------------------ sweep
constexpr int kWin20 = 32;          // items whose tables a block stages at once
constexpr int kWin4 = 16;           // at 4 codes, with their rate tables
constexpr int kWinCap = kWin20 + 1; // and the next item's, whose rows it stages

// A sweep unit's shape at C codes: 4 codes a thread a position, 20 codes two
// lanes a position.
template <int C>
struct SweepShape {
  static constexpr int kLanes = C == 20 ? 2 : 1;        // threads a position
  static constexpr int kChunk = kUnitThreads / kLanes;  // positions a unit
  static constexpr int kBufs = C == 20 ? 2 : 1;         // chain row buffers
  static constexpr int kStage = C == 20 ? 1 : kChunk;   // staged source rows
  static constexpr int kWin = C == 20 ? kWin20 : kWin4;  // items a window
  // at 4 codes each window item's rate tables (fill_table's, per length)
  static constexpr int kETab = C == 20 ? 1 : kWin4 * 2 * kMaxRates * C;
};

// The item tables of a sweep in chain order (device memory, SweepTables):
// target, source rows, the flag slots of sources that other chains write
// (-1: none), the item's own flag slot (-1: no other chain reads it), which
// sources are the chain's previous target (bit 0: r1, bit 1: r2), the
// weight of its counts, its lengths; and each chain's first item.
struct SweepArgs {
  const int32_t* t;
  const int32_t* r1;
  const int32_t* r2;
  const int32_t* w1;
  const int32_t* w2;
  const int32_t* fslot;
  const int32_t* side;
  const int32_t* weight;
  const float* len1;
  const float* len2;
  const int32_t* chain;  // [n_chains + 1]
  int n_chains, n_chunks;
};

// One window of item tables in shared memory.
struct SweepWindow {
  int t[kWinCap], r1[kWinCap], r2[kWinCap], w1[kWinCap], w2[kWinCap];
  int fslot[kWinCap], side[kWinCap], weight[kWinCap];
  float len1[kWinCap], len2[kWinCap];
};

// The model tables of a sweep block: eigenval; at 20 codes the rotations'
// matrices as doubles, each transposed so that a lane's ten sums read
// contiguous pairs (cfT[c * C + j] = code_freq[j][c], eiT[j * C + c] =
// eigeninv[c][j]), statinv, and the gap vector code_freq[kNoCode].
template <int C>
struct SweepTabs {
  double cfT[C == 20 ? C * C : 1];
  double eiT[C == 20 ? C * C : 1];
  float eigenval[C];
  float statinv[C];
  float gap[C];
};

// rate_entries at the rate value rv of the position's category and the
// eigenvalues ev: its expressions, so its bits.
template <int C>
__device__ __forceinline__ void entries_at(const MLView& m, float len, float rv, const float* ev,
                                           float (&e)[C]) {
  if (m.jc) {
    const float ps = 0.25f + 0.75f * expf((-4.0f / 3.0f) * fabsf(len * rv));
    e[0] = ps;
    e[1] = (1.0f - ps) / 3.0f;
  } else {
    const float rel = fmaxf(len * rv, m.min_rel_len);
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = expf(rel * ev[c]);
  }
}

// posterior_site20 on the two lanes of a position with its tables from
// shared memory: this lane rotates characters [jlo, jlo + C / 2), all ten
// sums in flight, each over c in order from 0.0 with each product a float
// widened exactly (posterior_site20's sums, so its bits); the gate and the
// normalization are its expressions on its values.  The unnormalized
// posterior and the result are staged in vo.  Returns the position's kind.
template <int C>
__device__ __forceinline__ int sweep_site20(const MLView& m, const SweepTabs<C>& tb,
                                            const RowRef& r1, const RowRef& r2, const float* e1,
                                            const float* e2, float tol, int p, int jlo,
                                            unsigned mask, float& w_out, float* vo) {
  constexpr int kHalf = C / 2;
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
  {
    double x1[kHalf], x2[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) x1[i] = x2[i] = 0.0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double a1 = (double)m1[c], a2 = (double)m2[c];
      const double2* cf = reinterpret_cast<const double2*>(tb.cfT + c * C + jlo);
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) {
        const double2 v = cf[i];
        x1[2 * i] = fma(a1, v.x, x1[2 * i]);
        x2[2 * i] = fma(a2, v.x, x2[2 * i]);
        x1[2 * i + 1] = fma(a1, v.y, x1[2 * i + 1]);
        x2[2 * i + 1] = fma(a2, v.y, x2[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      vo[jlo + i] = fmaxf((float)x1[i] * (float)x2[i] * tb.statinv[jlo + i], 0.0f);
  }
  __syncwarp(mask);
  float fpost[C];
#pragma unroll
  for (int j = 0; j < C; ++j) fpost[j] = vo[j];
  __syncwarp(mask);  // every lane has read vo before any writes it
  float tot = fpost[0];
#pragma unroll
  for (int j = 1; j < C; ++j) tot = tot + fpost[j];
  if (tot > tol) {
#pragma unroll
    for (int j = 0; j < C; ++j) fpost[j] = fpost[j] / tot;
  }
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
      for (int c = jlo; c < jlo + kHalf; ++c)
        vo[c] = both_gap ? tb.gap[c] : wi * cf[c] + (1.0f - w) * nf[c];
    }
  }
  if (!rough) {
    double v[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) v[i] = 0.0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const double fj = (double)fpost[j];
      const double2* ei = reinterpret_cast<const double2*>(tb.eiT + j * C + jlo);
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) {
        const double2 x = ei[i];
        v[2 * i] = fma(fj, x.x, v[2 * i]);
        v[2 * i + 1] = fma(fj, x.y, v[2 * i + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) vo[jlo + i] = both_gap ? tb.gap[jlo + i] : (float)v[i];
  }
  if (both_gap) return kCountNone;
  return rough ? kCountRough : kCountExact;
}

// One item's fields, read from the window one item ahead.
struct SweepItem {
  int t, r1, r2, w1, w2, fslot, side;
  float len1, len2;
  unsigned long long weight;
  __device__ __forceinline__ void read(const SweepWindow& w, int k) {
    t = w.t[k];
    r1 = w.r1[k];
    r2 = w.r2[k];
    w1 = w.w1[k];
    w2 = w.w2[k];
    fslot = w.fslot[k];
    side = w.side[k];
    len1 = w.len1[k];
    len2 = w.len2[k];
    weight = (unsigned long long)w.weight[k];
  }
};

// The sweep of chains: unit u is chain u / n_chunks at the chunk of
// positions u % n_chunks; thread (lane h of) local position lp owns
// position p0 + lp.
template <int C>
__global__ void __launch_bounds__(kUnitThreads) ml_posterior_sweep_kernel(
    MLView m, int8_t* codes_out, float* W_out, float* V_out, SweepArgs a, float tol, int n_units,
    int* ctrl, int* flags, int epoch) {
  using S = SweepShape<C>;
  constexpr int kChunk = S::kChunk, kLanes = S::kLanes;
  // the chain's previous row at this block's positions (at 4 codes one
  // buffer: a thread reads its position's row before it writes it)
  __shared__ __align__(16) float chain_v[S::kBufs][kChunk * C];
  __shared__ float chain_w[S::kBufs][kChunk];
  // at 4 codes the next item's rows from outside the chain (its two
  // sources), staged by each thread at its own position
  __shared__ __align__(16) float stage_v[2][S::kStage * C];
  __shared__ float stage_w[2][S::kStage];
  __shared__ int8_t stage_c[2][S::kStage];
  __shared__ SweepWindow win;
  __shared__ __align__(16) float etab[S::kETab];
  __shared__ __align__(16) SweepTabs<C> tb;
  __shared__ int slot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lp = tid / kLanes;  // the local position
  const int h = tid % kLanes;   // its lane
  constexpr int kW = S::kWin;
  for (int i = tid; i < C; i += kUnitThreads) {
    tb.eigenval[i] = m.eigenval[i];
    tb.statinv[i] = m.statinv[i];
    tb.gap[i] = m.code_freq[kNoCode * C + i];
  }
  if constexpr (C == 20) {
    for (int i = tid; i < C * C; i += kUnitThreads) {
      const int x = i / C, y = i % C;
      tb.cfT[y * C + x] = (double)m.code_freq[i];
      tb.eiT[y * C + x] = (double)m.eigeninv[i];
    }
  }
  Probe pr;
  // next_unit's barrier orders the tables before their first read
  for (;;) {
    pr.mark(kPrUnit);
    const int u = next_unit(ctrl, &slot);
    if (u >= n_units) break;
    const int ch = u / a.n_chunks, c = u - ch * a.n_chunks;
    const int first = a.chain[ch], end = a.chain[ch + 1];
    const int p0 = c * kChunk, p = p0 + lp;
    const bool live = p < m.P;
    const int rate = live ? m.ratecat[p] : 0;
    const float rv = m.rates[rate];
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    int* wflags = flags + warp;
    auto flag_at = [&](int fs) { return wflags + ((int64_t)fs * a.n_chunks + c) * kWarps; };
    // the rows in shared memory at this block's positions
    const RowRef chain_row[2] = {
        {nullptr, chain_w[0] - p0, chain_v[0] - (int64_t)p0 * C, 0},
        {nullptr, chain_w[S::kBufs - 1] - p0, chain_v[S::kBufs - 1] - (int64_t)p0 * C, 0}};
    const RowRef stage_row[2] = {
        {stage_c[0] - p0, stage_w[0] - p0, stage_v[0] - (int64_t)p0 * C, 0},
        {stage_c[1] - p0, stage_w[1] - p0, stage_v[1] - (int64_t)p0 * C, 0}};
    // the next item's staged sources (4 codes): loaded into registers while
    // an item runs, into stage_* after it
    int nc[2] = {0, 0};
    float nw[2] = {0.0f, 0.0f};
    float4 nv[2];
    int staged = 0;  // bit s: item's source s comes from stage_*
    unsigned long long n_rough = 0, n_exact = 0;
    SweepItem it, nx;
    int base = first;
    for (int i = first; i < end; ++i) {
      pr.count(kPrItems);
      if (i == base + kW || i == first) {  // the next window of tables
        pr.mark(kPrWindow);
        base = i;
        __syncthreads();
        const int n = min(kW + 1, end - base);
        for (int k = tid; k < n; k += kUnitThreads) {
          const int at = base + k;
          win.t[k] = a.t[at];
          win.r1[k] = a.r1[at];
          win.r2[k] = a.r2[at];
          win.w1[k] = a.w1[at];
          win.w2[k] = a.w2[at];
          win.fslot[k] = a.fslot[at];
          win.side[k] = a.side[at];
          win.weight[k] = a.weight[at];
          win.len1[k] = a.len1[at];
          win.len2[k] = a.len2[at];
        }
        __syncthreads();
        if constexpr (C == 4) {
          // the window's rate tables: fill_table's entries of every category
          // at each item's two lengths
          const int n_items = min(kW, end - base), per = m.jc ? 1 : C;
          const int n_tab = n_items * 2 * m.n_rates * per;
          for (int x = tid; x < n_tab; x += kUnitThreads) {
            const int c = x % per, r = (x / per) % m.n_rates, ks = x / (per * m.n_rates);
            const float len = (ks & 1) ? win.len2[ks >> 1] : win.len1[ks >> 1];
            float* tab = etab + (ks * kMaxRates + r) * C;
            if (m.jc) {
              float e[C];
              rate_entries<C>(m, len, r, e);
              tab[0] = e[0];
              tab[1] = e[1];
            } else {
              const float rel = fmaxf(len * m.rates[r], m.min_rel_len);
              tab[c] = expf(rel * m.eigenval[c]);
            }
          }
          __syncthreads();
          if (i == first) it.read(win, 0);
        }
      }
      const int k = i - base;
      const bool more = i + 1 < end;
      if constexpr (C == 4) {
        if (more) nx.read(win, k + 1);
      } else {
        it.read(win, k);
      }
      pr.mark(kPrPrefetch);
      int next_staged = 0;
      if constexpr (C == 4) {
        // issue the loads of item i + 1's rows from outside the chain that
        // wait on no other chain (leaves, finished subtrees)
        if (more && live) {
          const int src[2] = {nx.r1, nx.r2};
          const int wt[2] = {nx.w1, nx.w2};
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if ((nx.side >> s) & 1 || wt[s] >= 0) continue;
            next_staged |= 1 << s;
            const int64_t at = (int64_t)src[s] * m.P + p;
            nc[s] = m.codes[at];
            nw[s] = m.W[at];
            nv[s] = *reinterpret_cast<const float4*>(m.V + at * C);
          }
        }
      }
      // another chain's rows: at 4 codes every lane waits for itself; at
      // 20 one lane of the warp, then the warp
      pr.mark(kPrWait);
      if (kLanes == 1 || lane == 0) {
        if (it.w1 >= 0) wait_flag(flag_at(it.w1), epoch);
        if (it.w2 >= 0) wait_flag(flag_at(it.w2), epoch);
      }
      if constexpr (kLanes > 1) __syncwarp();
      const int cur = S::kBufs == 1 ? 0 : (i - first) & 1;
      const RowRef& prev = (cur ^ (S::kBufs - 1)) ? chain_row[1] : chain_row[0];
      const RowRef s1 = (it.side & 1) ? prev : (staged & 1) ? stage_row[0]
                                                            : store_row<C>(m, it.r1);
      const RowRef s2 = (it.side & 2) ? prev : (staged & 2) ? stage_row[1]
                                                            : store_row<C>(m, it.r2);
      pr.mark(kPrEntries);
      const int64_t trow = (int64_t)it.t * m.P;
      float* vo = chain_v[cur] + lp * C;
      if (live) {
        float e1[C], e2[C], w = 0.0f;
        if constexpr (C == 4) {
          const float* t1 = etab + ((2 * k) * kMaxRates + rate) * C;
          const float* t2 = t1 + kMaxRates * C;
#pragma unroll
          for (int x = 0; x < C; ++x) {
            e1[x] = t1[x];
            e2[x] = t2[x];
          }
        } else {
          entries_at<C>(m, it.len1, rv, tb.eigenval, e1);
          entries_at<C>(m, it.len2, rv, tb.eigenval, e2);
        }
        pr.mark(kPrPost);
        int kind = kCountNone;
        if constexpr (C == 20) {
          if (!m.jc)
            kind = sweep_site20<C>(m, tb, s1, s2, e1, e2, tol, p, h * (C / 2), mask, w, vo);
          else if (h == 0)
            kind = posterior_site<C>(m, s1, s2, e1, e2, tol, p, w, vo);
        } else {
          kind = posterior_site<C>(m, s1, s2, e1, e2, tol, p, w, vo);
          *reinterpret_cast<float4*>(V_out + (trow + p) * C) =
              *reinterpret_cast<const float4*>(vo);
        }
        if (h == 0) {
          codes_out[trow + p] = (int8_t)kNoCode;
          W_out[trow + p] = w;
          chain_w[cur][lp] = w;
          if constexpr (C == 20) {
            n_rough += kind == kCountRough ? it.weight : 0ull;
            n_exact += kind == kCountExact ? it.weight : 0ull;
          }
        }
      }
      pr.mark(kPrStore);
      if constexpr (C == 20) {
        // the warp's vectors, coalesced: its positions are contiguous in the
        // buffer and in the target row
        __syncwarp();
        constexpr int kWarpPos = 32 / kLanes;
        const int wp0 = p0 + warp * kWarpPos;
        const int n_pos = min(kWarpPos, m.P - wp0);
        if (n_pos > 0) {
          const float4* from = reinterpret_cast<const float4*>(chain_v[cur] +
                                                               warp * kWarpPos * C);
          float4* to = reinterpret_cast<float4*>(V_out + (trow + wp0) * C);
          for (int x = lane; x < n_pos * C / 4; x += 32) to[x] = from[x];
        }
      } else {
        // the staged rows of item i + 1, now that item i has read its own
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (!((next_staged >> s) & 1)) continue;
          stage_c[s][lp] = (int8_t)nc[s];
          stage_w[s][lp] = nw[s];
          reinterpret_cast<float4*>(stage_v[s])[lp] = nv[s];
        }
        staged = next_staged;
      }
      pr.mark(kPrPublish);
      if (it.fslot >= 0) publish_warp(flag_at(it.fslot), epoch);
      if constexpr (C == 4) it = nx;
    }
    pr.mark(kPrUnit);
    if constexpr (C == 20) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        n_rough += __shfl_xor_sync(0xffffffffu, n_rough, off);
        n_exact += __shfl_xor_sync(0xffffffffu, n_exact, off);
      }
      if (lane == 0 && m.counts != nullptr) {
        if (n_rough) atomicAdd(m.counts, n_rough);
        if (n_exact) atomicAdd(m.counts + 1, n_exact);
      }
    }
  }
  pr.flush();
  finish(ctrl);
}

// ---------------------------------------------------- tree log-likelihood
constexpr int kCols = 32;       // columns of a summing unit (a lane each)
constexpr int kTileRows = 32;   // rows of a cp.async tile
constexpr int kStages = 4;      // tiles in flight
constexpr int kGroupRows = 64;  // pairs a level group gathers (a wider level alone)

// The most pairs a pair unit takes, their loads in flight together (more
// at 20 codes would spill).
template <int C>
__host__ __device__ constexpr int max_pair_g() {
  return C == 20 ? 2 : 4;
}

// The tables and scratch of a tree log-likelihood.
struct TreeArgs {
  const int32_t* seg;    // [n_seg + 1] each level's first pair; the root's term the last level
  const int32_t* group;  // [n_groups + 1] each level group's first level
  const int32_t* r1;     // [K]
  const int32_t* r2;     // [K]
  const float* len;      // [K]
  int K, n_seg, n_groups;
  int G;                 // pairs a pair unit takes: 1, 2 or 4
  int n_cc;              // chunks of 32 columns
  int ld;                // doubles a row of the scratch matrices (n_cc * 32)
  int n_pos, ll_col;     // the sites; the column of the pairs' totals
  int root;              // 1: unit 0 is the root's 3-way term (row K)
  int s_ab, c0, c1, c2;
  float l0, l1, l2;      // the root term's lengths (l0, l1 clamped)
  int want_site;
  double* rows;          // [K + root, ld] each pair's per-site logs, its total at ll_col
  double* lvl;           // [n_seg, ld] the level sums
  double* out_ll;        // the total
  double* out_site;      // [n_pos], or null
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// log(max(lk, 1e-300)) in float64, as torch.log(torch.clamp_min(lk.double(),
// 1e-300)) takes it (a NaN stays NaN).
__device__ __forceinline__ double site_log(float lk) {
  const double x = (double)lk;
  return log(x < 1e-300 ? 1e-300 : x);
}

// G pairs (rows ra[g], rb[g] at len[g], g < n <= G) at once, into rows j0
// + g of the scratch matrix: pair_loglk_block's arithmetic and thread map
// (thread t adds its positions t, t + 128, ... of each pair in order, and
// block_sum adds the threads as it does, so each total is the per-level
// launch's bit for bit), with every pair's loads of a position in flight
// together; each pair's per-site logs log(max(lk, 1e-300)) and its total.
template <int C, int G>
__device__ __forceinline__ void pair_group(const MLView& m, const TreeArgs& a, int j0, int n,
                                           const int64_t (&ra)[G], const int64_t (&rb)[G],
                                           const float (&len)[G], Red& red) {
  double acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0;
  for (int p = threadIdx.x; p < m.P; p += kUnitThreads) {
    const int rate = m.ratecat[p];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= n) continue;
      float w1, w2, f1[C], f2[C], e[C];
      effective<C>(m, store_row<C>(m, ra[g]), p, false, w1, f1);
      effective<C>(m, store_row<C>(m, rb[g]), p, false, w2, f2);
      rate_entries<C>(m, len[g], rate, e);
      float lk = site_lk<C>(m, e, f1, f2);
      if (p >= m.n_pos || (!m.jc && w1 == 0.0f && w2 == 0.0f)) lk = 1.0f;
      if (a.want_site && p < m.n_pos) a.rows[(int64_t)(j0 + g) * a.ld + p] = site_log(lk);
      acc[g] += (double)logf(fmaxf(lk, 1e-37f));
    }
  }
  bool stopped = false;
  block_sum<G>(acc, red, NoStop{}, stopped);
  if (threadIdx.x == 0)
    for (int g = 0; g < n; ++g) a.rows[(int64_t)(j0 + g) * a.ld + a.ll_col] = acc[g];
}

// Column sums of rows [seg[0], seg[n]) of src (ld doubles a row) at columns
// [col, col + 32), in n segments (segment s: rows [seg[s], seg[s + 1]),
// seg in shared memory): lane l of warp 0 adds column col + l, each segment
// from 0.0 in row order, and hands segment s's sum to out(s, lane, sum).
// The whole block streams the rows through `ring` (kStages tiles of
// kTileRows x 32 doubles); every thread of the block calls it.
template <class Out>
__device__ __forceinline__ void column_sums(const double* src, int64_t ld, int col,
                                            const int* seg, int n, double* ring, Out out) {
  const int r0 = seg[0], n_rows = seg[n] - r0;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      double* dst = ring + (tile % kStages) * kTileRows * kCols;
      for (int q = threadIdx.x; q < kTileRows * kCols / 2; q += blockDim.x) {
        const int r = tile * kTileRows + q / (kCols / 2), x = (q % (kCols / 2)) * 2;
        if (r < n_rows) cp_async16(dst + (q / (kCols / 2)) * kCols + x,
                                   src + (int64_t)(r0 + r) * ld + col + x);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  const int lane = threadIdx.x;
  int s = 0, seg_end = seg[1];
  double acc = 0.0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<kStages - 2>();
    __syncthreads();  // every thread's copies of this tile; warp 0 is done with the last
    issue(tile + kStages - 1);
    if (threadIdx.x < 32) {
      const double* buf = ring + (tile % kStages) * kTileRows * kCols;
      const int row0 = r0 + tile * kTileRows;
      const int rows = min(kTileRows, n_rows - tile * kTileRows);
      for (int k = 0; k < rows; ++k) {
        acc = acc + buf[k * kCols + lane];
        if (row0 + k + 1 == seg_end) {
          out(s, lane, acc);
          acc = 0.0;
          if (++s < n) seg_end = seg[s + 1];
        }
      }
    }
  }
  cp_wait<0>();
}

template <int C>
__global__ void __launch_bounds__(kUnitThreads) ml_tree_loglk_kernel(
    MLView m, int8_t* codes_out, float* W_out, float* V_out, float tol, TreeArgs a, int* ctrl,
    int* flags, int epoch) {
  __shared__ float tab1[kMaxRates * C];
  __shared__ float tab2[kMaxRates * C];
  __shared__ double red_slot[2 * kRedSlots];
  __shared__ __align__(16) double ring[kStages * kTileRows * kCols];
  __shared__ int segs[kGroupRows + 1];
  __shared__ int slot;
  Red red{red_slot, 0};
  const int G = a.G;
  const int tid = threadIdx.x;
  const int n_pos = m.n_pos;
  const int n_pair_units = (a.K + G - 1) / G;
  const int pair0 = a.root, grp0 = pair0 + n_pair_units, fin0 = grp0 + a.n_groups * a.n_cc;
  const int n_units = fin0 + a.n_cc;


  Probe pr;
  for (;;) {
    pr.mark(kPrUnit);
    const int u = next_unit(ctrl, &slot);
    if (u >= n_units) break;
    if (u < pair0) {  // the root's 3-way term
      pr.mark(kPrRoot);
      fill_table<C>(m, a.l0, tab1);
      fill_table<C>(m, a.l1, tab2);
      __syncthreads();
      const RowRef A = store_row<C>(m, a.c0), B = store_row<C>(m, a.c1);
      for (int p0 = 0; p0 < m.P; p0 += kUnitThreads) {
        const int p = p0 + tid;
        int kind = kCountNone;
        if (p < m.P) {
          float w;
          const int rate = m.ratecat[p];
          const int64_t at = (int64_t)a.s_ab * m.P + p;
          kind = posterior_site<C>(m, A, B, tab1 + rate * C, tab2 + rate * C, tol, p, w,
                                   V_out + at * C);
          codes_out[at] = (int8_t)kNoCode;
          W_out[at] = w;
        }
        if constexpr (C == 20)
          count_kinds(kind == kCountRough ? 1u : 0u, kind == kCountExact ? 1u : 0u, m.counts);
      }
      // the root term's pair, row K (each thread reads the positions it
      // wrote)
      const int64_t ra[1] = {a.s_ab}, rb[1] = {a.c2};
      const float len[1] = {a.l2};
      pair_group<C, 1>(m, a, a.K, 1, ra, rb, len, red);
    } else if (u < grp0) {  // G pairs
      pr.mark(kPrPairs);
      const int j0 = (u - pair0) * G, n = min(G, a.K - j0);
      auto run = [&](auto width) {
        constexpr int W = decltype(width)::value;
        int64_t ra[W], rb[W];
        float len[W];
#pragma unroll
        for (int g = 0; g < W; ++g) {
          const int j = j0 + (g < n ? g : 0);
          ra[g] = a.r1[j];
          rb[g] = a.r2[j];
          len[g] = a.len[j];
        }
        pair_group<C, W>(m, a, j0, n, ra, rb, len, red);
      };
      if (G == 1) run(std::integral_constant<int, 1>{});
      else if (G == 2 || max_pair_g<C>() == 2) run(std::integral_constant<int, 2>{});
      else run(std::integral_constant<int, max_pair_g<C>()>{});
    } else if (u < fin0) {  // a level group's sums at 32 columns
      pr.mark(kPrGroupWait);
      const int g = (u - grp0) / a.n_cc, cc = (u - grp0) - g * a.n_cc;
      const int l0 = a.group[g], n = a.group[g + 1] - l0;
      for (int i = tid; i <= n; i += kUnitThreads) segs[i] = a.seg[l0 + i];
      // the pair units (and the root's) that write these rows
      const int r0 = a.seg[l0], r1 = a.seg[l0 + n];
      const int q1 = min(r1, a.K);
      if (q1 > r0)
        for (int q = r0 / G + tid; q <= (q1 - 1) / G; q += kUnitThreads)
          wait_flag(flags + pair0 + q, epoch);
      if (r1 > a.K && tid == 0) wait_flag(flags, epoch);
      __syncthreads();
      pr.mark(kPrGroups);
      const int col = cc * kCols;
      column_sums(a.rows, a.ld, col, segs, n, ring, [&](int s, int lane, double v) {
        a.lvl[(int64_t)(l0 + s) * a.ld + col + lane] = v;
      });
    } else {  // the levels' sums at 32 columns, in order
      pr.mark(kPrFinalWait);
      const int cc = u - fin0;
      for (int g = tid; g < a.n_groups; g += kUnitThreads)
        wait_flag(flags + grp0 + (int64_t)g * a.n_cc + cc, epoch);
      if (tid == 0) {
        segs[0] = 0;
        segs[1] = a.n_seg;
      }
      __syncthreads();
      pr.mark(kPrFinal);
      const int col = cc * kCols;
      column_sums(a.lvl, a.ld, col, segs, 1, ring, [&](int, int lane, double v) {
        const int x = col + lane;
        if (x == a.ll_col) *a.out_ll = v;
        else if (a.want_site && x < n_pos) a.out_site[x] = v;
      });
    }
    publish(flags + u, epoch);
  }
  pr.flush();
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

int sweep_grid_of(int C) { return C == 4 ? sweep_grid<4>() : C == 20 ? sweep_grid<20>() : 0; }
int tree_grid_of(int C) { return C == 4 ? tree_grid<4>() : C == 20 ? tree_grid<20>() : 0; }

int sweep_chunks(int P, int C) {
  const int chunk = C == 20 ? SweepShape<20>::kChunk : SweepShape<4>::kChunk;
  return (P + chunk - 1) / chunk;
}

// The column chunks of a tree log-likelihood: the sites' (with want_site),
// then the chunk of the totals.
// Pairs a pair unit of a tree log-likelihood of K pairs takes at C codes:
// the fewest of 1, 2 and 4 (20 codes: 1, 2) at which the pair units fit
// on the card at once.
int pair_width(int64_t K, int C) {
  const int grid = tree_grid_of(C), top = C == 20 ? max_pair_g<20>() : max_pair_g<4>();
  int g = 1;
  while (g < top && (K + g - 1) / g > grid) g *= 2;
  return g;
}

int col_chunks(int n_pos, int want_site) {
  return (want_site ? (n_pos + kCols - 1) / kCols : 0) + 1;
}

// The scratch of a tree log-likelihood in one buffer (16-byte aligned
// pieces); returns its bytes, and with base set the pointers.
size_t tree_scratch(TreeArgs& a, int64_t K, int n_seg, char* base) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base != nullptr ? base + at : nullptr;
    at += align16(bytes);
    return p;
  };
  a.rows = reinterpret_cast<double*>(take(8 * (size_t)(K + 1) * a.ld));
  a.lvl = reinterpret_cast<double*>(take(8 * (size_t)n_seg * a.ld));
  return at;
}

void tree_shape(TreeArgs& a, int n_pos, int want_site) {
  a.n_cc = col_chunks(n_pos, want_site);
  a.ld = a.n_cc * kCols;
  a.ll_col = (a.n_cc - 1) * kCols;
  a.n_pos = n_pos;
  a.want_site = want_site;
}

MLView make_view(const int8_t* codes, const float* W, const float* V, const float* code_freq,
                 const float* eigenval, const float* eigeninv, const float* statinv,
                 const float* rates, const int32_t* ratecat, int P, int n_pos, int n_rates, int jc,
                 float min_rel_len, const float* near_p, const float* near_freq, int approx,
                 unsigned long long* counts) {
  return MLView{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, P,
                n_pos, n_rates, jc, min_rel_len, near_p, near_freq, approx, counts};
}

template <int C>
int posterior_sweep(const MLView& m, int8_t* codes, float* W, float* V, const SweepArgs& a,
                    float tol, int* ctrl, int n_units, int epoch, cudaStream_t st) {
  const int resident = sweep_grid<C>();
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int grid = n_units < resident ? n_units : resident;
  ml_posterior_sweep_kernel<C><<<grid, kUnitThreads, 0, st>>>(m, codes, W, V, a, tol, n_units,
                                                              ctrl, ctrl + kCtrlWords, epoch);
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
      int n_rates, int jc, float min_rel_len, const float *near_p, const float *near_freq, \
      int approx, unsigned long long *counts
#define VFT_ML_VIEW_PASS                                                                 \
  codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, P, n_pos, n_rates, jc, \
      min_rel_len, near_p, near_freq, approx, counts

extern "C" {

// Blocks of a posterior sweep's launch with at least that many units at C
// codes (the blocks that fit on the card at once; 0 if it cannot be asked).
int vft_ml_posterior_sweep_grid(int C) { return sweep_grid_of(C); }

// Work units of a sweep of n_chains chains at P positions and C codes, and
// the ready flags of n_slots flagged items (one a warp of each unit).
int64_t vft_ml_posterior_sweep_units(int64_t n_chains, int P, int C) {
  return n_chains * sweep_chunks(P, C);
}

int64_t vft_ml_posterior_sweep_flags(int64_t n_slots, int P, int C) {
  return n_slots * sweep_chunks(P, C) * kWarps;
}

// Work units (ready flags) of a tree log-likelihood of K pairs in n_seg
// levels (the root's term counted as one) gathered in n_groups level
// groups, at C codes.
int64_t vft_ml_tree_loglk_units(int64_t K, int n_groups, int n_pos, int root, int want_site,
                                int C) {
  const int n_cc = col_chunks(n_pos, want_site);
  const int G = pair_width(K, C);
  return root + (K + G - 1) / G + (int64_t)n_groups * n_cc + n_cc;
}

// Pairs a level group gathers (a wider level is a group alone).
int vft_ml_tree_loglk_group_rows() { return kGroupRows; }

// Bytes of device scratch one tree log-likelihood takes (0 when the card
// cannot be asked).
int64_t vft_ml_tree_loglk_scratch_bytes(int64_t K, int n_seg, int P, int n_pos, int C,
                                        int want_site) {
  const int grid = tree_grid_of(C);
  if (grid <= 0) return 0;
  TreeArgs a{};
  (void)P;
  tree_shape(a, n_pos, want_site);
  return (int64_t)tree_scratch(a, K, n_seg, nullptr);
}

// The posterior sweep of n items in chain order (SweepTables): rows [8n] =
// targets, r1, r2, the flag slots of r1's and r2's producers in other
// chains (-1: none), the item's own flag slot (-1: none), its side bits
// (bit 0: r1 is the chain's previous target, bit 1: r2), the times its
// rough and exact positions count; lens [2n] = len1, len2 (clamped);
// chains [n_chains + 1] each chain's first item, all in device memory.
// ctrl: kCtrlWords control words then n_flags ready flags (zeroed when
// first allocated; vft_ml_posterior_sweep_flags of n_slots); epoch differs
// from every earlier launch's on the same ctrl and is not 0.
int vft_ml_posterior_sweep_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* rows,
                               const float* lens, int64_t n, const int32_t* chains,
                               int64_t n_chains, int64_t n_slots, int* ctrl, int64_t n_flags,
                               int epoch, void* stream) {
  (void)n_rows;
  if (n <= 0 || n_chains <= 0 || epoch == 0) return (int)cudaErrorInvalidValue;
  if (n_rates < 1 || n_rates > kMaxRates || (C != 4 && C != 20)) return (int)cudaErrorInvalidValue;
  const int64_t units = vft_ml_posterior_sweep_units(n_chains, P, C);
  if (vft_ml_posterior_sweep_flags(n_slots, P, C) > n_flags || units > 0x7fff0000LL)
    return (int)cudaErrorInvalidValue;
  SweepArgs a{rows,         rows + n,     rows + 2 * n, rows + 3 * n,
              rows + 4 * n, rows + 5 * n, rows + 6 * n, rows + 7 * n,
              lens,         lens + n,     chains,       (int)n_chains,
              sweep_chunks(P, C)};
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  const int nu = (int)units;
  if (C == 4) return posterior_sweep<4>(m, c_out, w_out, v_out, a, tol, ctrl, nu, epoch, st);
  return posterior_sweep<20>(m, c_out, w_out, v_out, a, tol, ctrl, nu, epoch, st);
}

// The tree log-likelihood: the pairs (rows[k], rows[K + k]) at lens[k] in
// n_seg levels, level l's pairs from seg[l] to seg[l + 1], with c0 >= 0 the
// root term the last level (seg[n_seg - 1] = K, seg[n_seg] = K + 1: the
// posterior of rows c0, c1 at l0, l1 into row s_ab, then the pair of s_ab
// and c2 at l2); the levels gathered in n_groups groups (group g: levels
// group[g] to group[g + 1]), all in device memory.  out_ll gets the total,
// and with want_site out_site [n_pos] the per-site sums, both float64 in
// device memory.  scratch holds vft_ml_tree_loglk_scratch_bytes; ctrl and
// epoch as for the sweep, one flag a unit.
int vft_ml_tree_loglk_f32(VFT_ML_STORE_ARGS, float tol, const int32_t* seg, const int32_t* group,
                          const int32_t* rows, const float* lens, int64_t K, int n_seg,
                          int n_groups, int s_ab, int c0, int c1, int c2, float l0, float l1,
                          float l2, int want_site, double* out_ll, double* out_site,
                          void* scratch, int64_t scratch_bytes, int* ctrl, int64_t n_flags,
                          int epoch, void* stream) {
  (void)n_rows;
  if (n_seg < 1 || n_groups < 1 || K < 0 || epoch == 0 || (want_site && out_site == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rates < 1 || n_rates > kMaxRates || (C != 4 && C != 20)) return (int)cudaErrorInvalidValue;
  const int root = c0 >= 0 ? 1 : 0;
  const int64_t units = vft_ml_tree_loglk_units(K, n_groups, n_pos, root, want_site, C);
  if (units > n_flags || units > 0x7fff0000LL) return (int)cudaErrorInvalidValue;
  const int grid = tree_grid_of(C);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  TreeArgs a{};
  a.seg = seg;
  a.group = group;
  a.r1 = rows;
  a.r2 = rows + K;
  a.len = lens;
  a.K = (int)K;
  a.n_seg = n_seg;
  a.n_groups = n_groups;
  a.G = pair_width(K, C);
  a.root = root;
  a.s_ab = s_ab;
  a.c0 = c0;
  a.c1 = c1;
  a.c2 = c2;
  a.l0 = l0;
  a.l1 = l1;
  a.l2 = l2;
  tree_shape(a, n_pos, want_site);
  a.out_ll = out_ll;
  a.out_site = out_site;
  if ((int64_t)tree_scratch(a, K, n_seg, static_cast<char*>(scratch)) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const MLView m = make_view(VFT_ML_VIEW_PASS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = units < grid ? (int)units : grid;
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  if (C == 4) return tree_loglk<4>(m, c_out, w_out, v_out, tol, a, g, ctrl, epoch, st);
  return tree_loglk<20>(m, c_out, w_out, v_out, tol, a, g, ctrl, epoch, st);
}

#ifdef VFT_SWEEP_PROBE
// The probes' cycles per phase since the last call (kPrPhases words), which
// it resets.
int vft_ml_sweep_probe(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sweep_probe, sizeof(sweep_probe));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[kPrPhases] = {};
  return (int)cudaMemcpyToSymbol(sweep_probe, zero, sizeof(zero));
}
#endif

}  // extern "C"
