// Whole maximum-likelihood NNI rounds and branch-length passes on the card
// (Hopper, sm_90a), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py, wrappers in ops/ml_round.py).
//
// The JAX package runs both on the host (veryfasttree_tpu/engine/
// rearrange.py do_nni :246 with use_ml, its quartets decided by ml.py
// ml_quartet_nni :231; ml.py optimize_all_branch_lengths :380), one store
// call per posterior, line search or quartet optimization with a blocking
// fetch after each search; so did this port (engine/rearrange.do_nni,
// engine/ml.optimize_all_branch_lengths, with the kernels ml_quartet_opt,
// ml_opt_branch and ml_posterior).  The JAX package has no device round to
// port.  Here one launch runs, in the host loop's order:
//
// ml_nni_round_kernel, one ML NNI round (ref DoNNI tcc:5997-6183,
//   traverseNNI :5797-5995, MLQuartetNNI :4885-5004): the fast-NNI skip set
//   (support threshold TREE_LOGLK_DELTA); the restartable postorder walk
//   with revisits (a revisited node gets its memo entries reset and its
//   posterior recomputed); for every other internal node its quartet
//   (setupABCD with the memoised up-profile of its parent, a posterior of C
//   and D at their lengths), then ml_quartet_nni's decision: up to n_rounds
//   passes of the star-tested AB optimization and of the AC and AD
//   optimizations, pruned under CLOSE_LOGLK_LIMIT; the choice, the swap,
//   the lengths onto the post-swap topology, the NNIStats update and the
//   profile repairs (a posterior of the node, or updateForNNI).
// ml_lengths_pass_kernel, one pass of optimizeAllBranchLengths (ref
//   tcc:5006-5111): for every internal node in postorder, the root included,
//   the up-profile of a non-root node through the memo, two sweeps of the
//   three branches (a posterior of the two others into a temporary, one
//   line search from max(length, ml_min_branch_length)), then the node's
//   posterior and its memo entry reset.
//
// Bound (chip_smoke.ml_round_bound): a round must read each store row it
// uses once and write each row it changes once (P * (4C + 5) bytes each),
// and do each posterior's, line-search evaluation's and pair likelihood's
// operations per position.  Each quartet depends on the one before (a swap
// changes the tree, the lengths and the rows its successors read), and each
// line search is a chain of about 9 dependent evaluations, so the work is
// serial but for the positions and for the AB, AC and AD optimizations of
// one quartet, which are independent.  What the design does about it:
//
// - No launch and no fetch per quartet or search, and one barrier per
//   evaluation (ml_lk.cuh: each thread owns its positions and computes their
//   rate entries; a reduction is one barrier on double-buffered partials;
//   the bracket's first three evaluations share one sweep).
// - The round is a cluster of three blocks of kOptThreads threads, one per
//   SM.  Block 0 holds the tree and the up-profile memo in its shared memory
//   and runs the walk, setup_abcd, the node and up-profile posteriors, the
//   decisions and the AB optimization; block 1 runs AC and block 2 AD, each
//   out of its own SM's shared memory.  So an iteration of ml_quartet_nni
//   costs one optimization, not two (AB, then AC beside AD).
// - Commands and results go through distributed shared memory: block 0
//   writes a worker's command (rows, lengths, a sequence number) into the
//   worker's shared memory and every block meets at a cluster barrier
//   (barrier.cluster.arrive.release / wait.acquire); the workers read the
//   store rows block 0 wrote before it, ordered by that barrier's release
//   and acquire (block 0's threads also __threadfence() before arriving),
//   and write their QuartetResult into block 0's shared memory before the
//   next barrier.  Between the two barriers of an iteration block 0 writes
//   no store row.
// - Speculation: the host loop runs AC and AD only when AB's star test did
//   not fire.  Here they start with AB, from the lengths the host loop would
//   give them (each only ever changed by its own optimization); when AB's
//   star test fires block 0 writes the iteration's sequence number into
//   each worker's abandon flag, which the worker's thread 0 reads at each
//   evaluation's barrier (ml_lk.cuh Stop), and block 0 drops the results.
//   A worker writes only its own shared memory, so a discarded optimization
//   leaves nothing behind, and the host loop's bits are kept: every
//   optimization that counts ran the same body on the same inputs.  The
//   counters add only what the host loop adds; discarded optimizations
//   count in kSpeculative.
// - Where each piece lives (P=512, C=4): each block's quartet pieces as
//   ml_quartet_opt keeps them (77 KB: six temporaries, the search's vectors,
//   rate bytes, reduction partials); block 0's tree, memo, path and
//   traversal flags before them (26 bytes per node: 26 KB at N=500, 104 KB
//   at N=2000; in device memory past about 5,800 nodes, the same code on
//   other pointers).  Nothing goes to device scratch unless P is so large
//   that a quartet's pieces leave shared memory, as at 20 codes: there each
//   block's six temporaries (258 KB at P=512) lie in device scratch, the
//   search's vectors, rate bytes and partials in shared memory (83 KB), the
//   tree beside them to about 5,600 nodes.  The NNIStats and the
//   branch lengths stay in device memory, read by every thread of block 0
//   and written by its thread 0.
// - The lengths pass is one block of kOptThreads threads with the same
//   bodies and layout (its searches are serial).  Both kernels are bound to
//   one block of kOptThreads threads per SM (__launch_bounds__(kOptThreads,
//   1); with the thread count alone ptxas aims at two blocks and caps a
//   thread at 128 registers, which spilled), so a thread may take up to 255
//   registers; every function is inlined and no small array is indexed at
//   run time (round_tree.cuh pick3): no stack frame.
//
// Bit for bit with the host loop through the per-call kernels: every
// posterior, search and quartet runs the single-call kernels' bodies of
// ml_lk.cuh with their thread maps on kOptThreads threads (a posterior's
// positions one per thread on any count); the host's casts are repeated
// (posterior lengths to float and raised to xmin, quartet lengths raised in
// float64, searched lengths back as float values, the quartet loglk summed
// from its parts in the host's order), and the criteria, pruning tests,
// deltas and supports are double in numpy's order (this file is compiled
// with -fmad=false).  The debug counters grow by the amounts the host's
// store calls add.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VFT_TREE_INLINE __forceinline__
#include "ml_lk.cuh"
#include "round_tree.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMlRoundSmemCap = 225 * 1024;  // dynamic shared memory of a round's block
constexpr int kClusterBlocks = 3;            // block 0: walk and AB; 1: AC; 2: AD
constexpr int kABvsCD = 0, kACvsBD = 1, kADvsBC = 2;

// int64 counters of a round or pass, in the wrappers' order (ops/ml_round.py)
enum : int {
  kMlNni = 0,     // nj.debug.n_ml_nni: swaps
  kStarTests,     // nj.debug.n_star_tests
  kLkCompute,     // nj.debug.n_lk_compute, as the host's store calls add it
  kPostCompute,   // nj.debug.n_posterior_compute, likewise
  kQuartetOpts,   // quartet optimizations
  kPosteriors,    // posterior profiles, the quartets' temporaries included
  kSearches,      // line searches
  kEvals,         // their evaluations
  kPairs,         // pair log-likelihoods
  kAaRough,       // positions of those posteriors that took the rough path,
  kAaExact,       // and the exact one (20 codes; added to atomically)
  kSpeculative,   // AC and AD optimizations started and discarded (not above)
  kMlFault,       // a broken tree invariant: the round is void
  kMlCounters
};

// one worker's quartet optimization, written into block 0's shared memory
struct QuartetResult {
  double parts[3];
  double len[5];
  unsigned long long kinds[2];  // its posteriors' rough and exact positions
  int n_eval;
};

enum { kIdle, kRun, kStop };

// block 0's command to a worker, written into the worker's shared memory
struct Command {
  int op;     // kIdle, kRun, kStop
  int seq;    // the iteration's sequence number
  int rows[4];
  double len[5];
};

// shared scratch of a block
struct MlShared {
  long long ctr[kMlCounters];                // block 0's
  QuartetResult res[kClusterBlocks];         // block 0's: res[k] from block k
  Command cmd;                               // a worker's
  int abandon;                               // a worker's: the abandoned seq
  int any_bad;  // set by whichever thread finds a fault in the skip set
};

// ml_lk.cuh's Stop of a worker: block 0 abandoned the optimization of
// sequence number seq
struct AbandonFlag {
  static constexpr bool kPolls = true;
  const volatile int* flag;
  int seq;
  __device__ __forceinline__ bool operator()() const { return *flag == seq; }
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

struct MlArgs {
  int n_seqs;
  int maxnodes;     // M: node rows [0, M), up-profile rows M + node
  int root;
  int ml_accuracy;
  double min_len;   // ml_min_branch_length, the host's float64
  float tol;        // f_post_total_tolerance
};

// where a round's or pass's block keeps its pieces, in shared memory in
// this order: block 0's tree where it fits, then the block's quartet
// pieces as ml_quartet_opt keeps them (quartet_layout); what does not fit
// goes to device scratch, n_blocks shares of q.scratch_floats
struct RoundLayout {
  QuartetLayout q;
  bool tree_smem;
  size_t tree_bytes, smem, scratch_floats;
};

// At 20 codes the model tables that a posterior reads character by
// character (code_freq's 128 rows, eigeninv, and -approxml's near_p and
// near_freq: 15,040 bytes) are staged at the front of every block's dynamic
// shared memory (stage_tables), ahead of the pieces above; at 4 codes none.
template <int C>
struct MlTables {
  float code_freq[128 * C];
  float eigeninv[C * C];
  float near_p[C * C];
  float near_freq[C * C];
};
static_assert(sizeof(MlTables<20>) % 16 == 0, "the pieces after it stay 16-byte aligned");

template <int C>
constexpr size_t kTablesBytes = C == 20 ? sizeof(MlTables<20>) : 0;

RoundLayout round_layout(int M, int P, int C, bool want_tree_smem, int n_blocks) {
  const size_t tables = C == 20 ? kTablesBytes<20> : 0;
  const QuartetLayout q = quartet_layout(P, C);
  const size_t tree = tree_smem_bytes(M, 2);
  const bool tree_smem = want_tree_smem && tables + tree + q.smem <= (size_t)kMlRoundSmemCap;
  const size_t tree_bytes = tree_smem ? tree : 0;
  return {q, tree_smem, tree_bytes, tables + tree_bytes + q.smem, n_blocks * q.scratch_floats};
}

// The MLView of a block with its 20-code tables copied into its shared
// memory (every thread calls it; one barrier); m itself at 4 codes.
template <int C>
__device__ __forceinline__ MLView stage_tables(MLView m) {
  if constexpr (C == 20) {
    extern __shared__ __align__(16) unsigned char smem[];
    MlTables<C>& s = *reinterpret_cast<MlTables<C>*>(smem);
    for (int i = threadIdx.x; i < 128 * C; i += kOptThreads) s.code_freq[i] = m.code_freq[i];
    for (int i = threadIdx.x; i < C * C; i += kOptThreads) {
      s.eigeninv[i] = m.eigeninv[i];
      s.near_p[i] = m.near_p[i];
      s.near_freq[i] = m.near_freq[i];
    }
    __syncthreads();
    m.code_freq = s.code_freq;
    m.eigeninv = s.eigeninv;
    m.near_p = s.near_p;
    m.near_freq = s.near_freq;
  }
  return m;
}

template <int C>
struct MlRound : RoundTree {
  MLView m;
  int8_t* codes;      // the store, written in place
  float* W;
  float* V;
  QuartetScratch q;   // the block's quartet pieces
  Red red;            // its reductions' partials (q.red)
  SearchLimits lim;
  MlArgs a;
  double* bl;         // [M] branch lengths
  MlShared* sh;
  uint8_t* trav;      // [M] the walk's traversal flags
  NniStats st;
  double max_delta;   // the NNI round's
  int seq;            // the last command's sequence number

  __device__ __forceinline__ void count(int k, long long n) {
    if (tid == 0) sh->ctr[k] += n;
  }

  // where the posteriors' rough and exact positions go: kAaRough and
  // kAaExact, which every warp adds to atomically
  __device__ __forceinline__ unsigned long long* kinds() const {
    return reinterpret_cast<unsigned long long*>(sh->ctr + kAaRough);
  }

  __device__ __forceinline__ RowRef row(int r) const { return store_row<C>(m, r); }

  // the posterior profile of rows r1 and r2 at lengths l1, l2 (as
  // MLProfiles.posterior_into: float lengths raised to the minimum) into
  // store row t (codes_out not null) or a temporary; each position by its
  // own thread, as every body that reads it but the pair log-likelihood,
  // which synchronises first
  __device__ __forceinline__ void posterior_to(int8_t* codes_out, float* w_out, float* v_out,
                                               const RowRef& r1, const RowRef& r2, double l1,
                                               double l2) {
    posterior_row<C>(m, r1, r2, fmaxf((float)l1, lim.xmin), fmaxf((float)l2, lim.xmin), a.tol,
                     codes_out, w_out, v_out, kinds());
    count(kPostCompute, 1);
    count(kPosteriors, 1);
  }

  __device__ __forceinline__ void posterior(int t, int r1, int r2, double l1, double l2) {
    const int64_t at = (int64_t)t * m.P;
    posterior_to(codes + at, W + at, V + at * C, row(r1), row(r2), l1, l2);
  }

  // -------------------------------------------------- up-profiles, repairs
  __device__ __forceinline__ void setup_abcd(int node, int nodes4[4], int rows4[4]) {
    RoundTree::setup_abcd(node, nodes4, rows4, [this](int n, int nc, int d_row, int nd) {
      posterior(maxnodes + n, nc, d_row, bl[nc], bl[nd]);
    });
  }

  // ref recomputeProfile tcc:3436-3472 (ML)
  __device__ __forceinline__ void recompute_profile(int node) {
    if (node < n_seqs || node == root) return;
    if (!node_ok(node) || nch[node] != 2) {
      bad = true;
      return;
    }
    const int c0 = child[3 * node], c1 = child[3 * node + 1];
    posterior(node, c0, c1, bl[c0], bl[c1]);
  }

  __device__ __forceinline__ void update_for_nni(int node) {
    RoundTree::update_for_nni(node, [this](int n) { recompute_profile(n); });
  }

  // ------------------------------------------------------------- quartets
  // the host's counts of one quartet optimization (MLProfiles.
  // quartet_optimize) that ran n_eval evaluations and did (star) or did not
  // end at the star test
  __device__ __forceinline__ void count_quartet(bool star_test, bool star, int n_eval) {
    count(kQuartetOpts, 1);
    count(kEvals, n_eval);
    count(kPostCompute, 2);
    count(kLkCompute, 8 + (star_test ? 1 : 0));
    if (star) {
      count(kLkCompute, 2);
      count(kPosteriors, 2);
      count(kSearches, 1);
      count(kPairs, 3);
    } else {
      count(kPostCompute, 5);
      count(kLkCompute, 34);
      count(kPosteriors, 7);
      count(kSearches, 5);
      count(kPairs, 2 + (star_test ? 1 : 0));
    }
  }

  // the quartet's loglk summed from its parts as the host sums them
  __device__ __forceinline__ static double quartet_ll(const double parts[3], bool star) {
    return star ? parts[0] + (parts[1] + parts[2]) : parts[0] + parts[1] + parts[2];
  }

  // raise each of the five lengths to the minimum, in float64 (as
  // MLProfiles.quartet_optimize does)
  __device__ __forceinline__ void raise_to_min(double l[5]) const {
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (l[i] < a.min_len) l[i] = a.min_len;
  }

  // block 0: the command of worker k for this iteration (kRun with the
  // quartet's rows and lengths, or kIdle), in the worker's shared memory
  __device__ __forceinline__ void send(const cg::cluster_group& cl, int k, bool run,
                                       const int r[4], const double l[5]) {
    if (tid != 0) return;
    Command* c = cl.map_shared_rank(&sh->cmd, k);
    c->op = run ? kRun : kIdle;
    c->seq = seq;
#pragma unroll
    for (int i = 0; i < 4; ++i) c->rows[i] = r[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) c->len[i] = l[i];
  }

  // the worker's result into len and ll, counted as the host counts it
  __device__ __forceinline__ void take(int k, double len[5], double& ll) {
    const QuartetResult& o = sh->res[k];
#pragma unroll
    for (int i = 0; i < 5; ++i) len[i] = o.len[i];
    ll = quartet_ll(o.parts, false);
    count_quartet(false, false, o.n_eval);
    // atomically: block 0's other warps may be in a posterior already
    if (tid == 0) {
      atomicAdd(kinds(), o.kinds[0]);
      atomicAdd(kinds() + 1, o.kinds[1]);
    }
  }

  // ml.ml_quartet_nni (ref MLQuartetNNI tcc:4885-5004, no constraints) on
  // the cluster: returns the choice; crit the criteria, out the chosen
  // quartet's lengths (A, B, C, D, I in its own order)
  __device__ __forceinline__ int quartet_nni(const cg::cluster_group& cl, const int r[4],
                                             const double len[5], double crit[3],
                                             double out[5]) {
    double lab[5] = {len[kLenA], len[kLenB], len[kLenC], len[kLenD], len[kLenI]};
    double lac[5] = {len[kLenA], len[kLenC], len[kLenB], len[kLenD], len[kLenI]};
    double lad[5] = {len[kLenA], len[kLenD], len[kLenC], len[kLenB], len[kLenI]};
    const int rac[4] = {r[0], r[2], r[1], r[3]}, rad[4] = {r[0], r[3], r[2], r[1]};
    bool consider_ac = true, consider_ad = true;
    const int n_rounds = a.ml_accuracy < 2 ? 2 : a.ml_accuracy;
    double c_ab = -1e20, c_ac = -1e20, c_ad = -1e20;
    for (int it = 0; it < n_rounds; ++it) {
      // AC and AD start beside AB, on the lengths the host loop would give
      // them; they count only if AB's star test does not fire
      raise_to_min(lab);
      if (consider_ac) raise_to_min(lac);
      if (consider_ad) raise_to_min(lad);
      ++seq;
      send(cl, 1, consider_ac, rac, lac);
      send(cl, 2, consider_ad, rad, lad);
      __threadfence();
      prof_mark(kPhWait);
      cluster_sync();  // the commands and the store rows they read
      double parts[3];
      int n_eval;
      bool stopped;
      const bool star = quartet_optimize<C>(m, q, red, lim, a.tol, true, row(r[0]), row(r[1]),
                                            row(r[2]), row(r[3]), lab, parts, n_eval, nullptr,
                                            NoStop{}, stopped, kinds());
      if (star && tid == 0) {
        if (consider_ac) *cl.map_shared_rank(&sh->abandon, 1) = seq;
        if (consider_ad) *cl.map_shared_rank(&sh->abandon, 2) = seq;
      }
      prof_mark(kPhWait);
      cluster_sync();  // the workers' results
      prof_mark(kPhWalk);
      c_ab = quartet_ll(parts, star);
      count_quartet(true, star, n_eval);
      if (star) {
        count(kStarTests, 1);
        count(kSpeculative, (consider_ac ? 1 : 0) + (consider_ad ? 1 : 0));
        crit[kABvsCD] = c_ab;
        crit[kACvsBD] = -1e20;
        crit[kADvsBC] = -1e20;
#pragma unroll
        for (int i = 0; i < 5; ++i) out[i] = len[i];
        out[kLenI] = lab[kLenI];
        return kABvsCD;
      }
      if (consider_ac) take(1, lac, c_ac);
      if (consider_ad) take(2, lad, c_ad);
      if (a.ml_accuracy < 2) {
        const double close = kCloseLogLkLimit;
        if (c_ac < c_ab - close || (lac[kLenI] <= 2.0 * a.min_len && c_ac < c_ab))
          consider_ac = false;
        if (c_ad < c_ab - close || (lad[kLenI] <= 2.0 * a.min_len && c_ad < c_ab))
          consider_ad = false;
        if (!consider_ac && !consider_ad) break;
        if (c_ac > c_ab + close && c_ac > c_ad + close) break;
        if (c_ad > c_ab + close && c_ad > c_ac + close) break;
      }
    }
    int choice = kABvsCD;
    if (c_ac > c_ab && c_ac > c_ad)
      choice = kACvsBD;
    else if (c_ad > c_ab && c_ad > c_ac)
      choice = kADvsBC;
    crit[kABvsCD] = c_ab;
    crit[kACvsBD] = c_ac;
    crit[kADvsBC] = c_ad;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      out[i] = choice == kACvsBD ? lac[i] : (choice == kADvsBC ? lad[i] : lab[i]);
    return choice;
  }

  // one quartet of the walk (rearrange.do_nni's body with use_ml)
  __device__ __forceinline__ void nni_node(const cg::cluster_group& cl, int node) {
    int n4[4], r4[4];
    setup_abcd(node, n4, r4);
    if (bad) return;
    const int na = n4[0], nb = n4[1], nc = n4[2], nd = n4[3];
    const double len[5] = {bl[na], bl[nb], bl[nc], bl[nd], bl[node]};
    double crit[3], nl[5];
    const int choice = quartet_nni(cl, r4, len, crit, nl);
    if (choice != kABvsCD) {
      const int moved = choice == kACvsBD ? nb : na;
      replace_child(node, moved, nc);
      replace_child(parent[node], nc, moved);
      if (bad) return;
    }
    // the lengths onto the post-swap topology (ref :5887-5917): nl is the
    // chosen quartet's (A, B, C, D, I) in its own order
    nni_finish(
        node, n4, choice, crit, st, max_delta,
        [&] {
          bl[node] = nl[kLenI];
          bl[na] = nl[kLenA];
          bl[nb] = choice == kADvsBC ? nl[3] : (choice == kACvsBD ? nl[2] : nl[1]);
          bl[nc] = choice == kACvsBD ? nl[1] : nl[2];
          bl[nd] = choice == kADvsBC ? nl[1] : nl[3];
          if (choice != kABvsCD) sh->ctr[kMlNni] += 1;
        },
        [this](int n) { recompute_profile(n); });
  }

  // the walk's visit of a node: a functor, not a lambda, so that nvcc
  // inlines it as it is told (a lambda's call it kept, with spills)
  struct Visit {
    MlRound* self;
    const cg::cluster_group* cl;
    __device__ __forceinline__ void operator()(int n) const { self->nni_node(*cl, n); }
  };

  // the round (rearrange.do_nni with use_ml, not -slow), on block 0
  __device__ __forceinline__ void nni_round(const cg::cluster_group& cl) {
    nni_walk(trav, st, &sh->any_bad, Visit{this, &cl}, [this](int n) { recompute_profile(n); });
  }

  // --------------------------------------------------------- lengths pass
  // ml.optimize_all_branch_lengths for three tips or more: the temporary
  // S_TMP1 is the first of the block's quartet temporaries
  __device__ __forceinline__ void lengths_pass() {
    float* tmp_w = q.temps;
    float* tmp_v = q.temps + m.P;
    const RowRef tmp{nullptr, tmp_w, tmp_v};
    int node = root, climbs = 0;
    while (!bad) {
      bool up = false;
      node = next_postorder(trav, node, up, climbs);
      if (node < 0 || bad) break;
      if (up) {  // the tree does not change during a pass
        bad = true;
        break;
      }
      const int n_child = nch[node];
      if (n_child == 0) continue;
      if (n_child != 2 && n_child != 3) {
        bad = true;
        break;
      }
      const int nodes3[3] = {child[3 * node], child[3 * node + 1],
                             n_child == 3 ? child[3 * node + 2] : node};
      int rows3[3] = {nodes3[0], nodes3[1], nodes3[2]};
      if (n_child != 3)
        rows3[2] = up_get(node, [this](int n, int nc, int d_row, int nd) {
          posterior(maxnodes + n, nc, d_row, bl[nc], bl[nd]);
        });
      if (bad) break;
      for (int sweep = 0; sweep < 2; ++sweep) {
        for (int i = 0; i < 3; ++i) {
          const int b1 = i == 2 ? 0 : i + 1, b2 = i == 0 ? 2 : i - 1;
          const int n1 = pick3(nodes3, b1), n2 = pick3(nodes3, b2), ni = pick3(nodes3, i);
          posterior_to(nullptr, tmp_w, tmp_v, row(pick3(rows3, b1)), row(pick3(rows3, b2)),
                       bl[n1], bl[n2]);
          const double cur = bl[ni];
          const double guess = cur < a.min_len ? a.min_len : cur;  // Python's max
          float fx;
          int n;
          bool stopped;
          const float x = line_search<C>(m, row(pick3(rows3, i)), tmp, (float)guess, lim, q.eff1,
                                         q.eff2, q.rate, red, fx, n, NoStop{}, stopped);
          prof_mark(kPhWalk);
          count(kLkCompute, 8);
          count(kSearches, 1);
          count(kEvals, n);
          commit([&] { bl[ni] = (double)x; });
        }
      }
      if (node != root) {
        recompute_profile(node);
        commit([&] { uvalid[node] = 0; });
      }
    }
  }
};

#define VFT_ML_ROUND_PARAMS                                                                    \
  MLView m, int8_t *codes, float *W, float *V, SearchLimits lim, MlArgs args, NniStats st,     \
      double *bl, int32_t *g_tree, uint8_t *g_flags, int32_t *g_path, long long *g_ctr,        \
      double *g_max_delta, float *scratch, RoundLayout L

// block 0 of a round (kRound: the round, then kStop to the workers), or
// the one block of a pass: stage the tree, run, put the tree and the
// counters back.  No lambda: nvcc kept a lambda this large as a call, with
// spills.
template <int C, bool kRound>
__device__ __forceinline__ void tree_block(VFT_ML_ROUND_PARAMS, MlShared& sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, M = args.maxnodes;
  const TreeArrays t = stage_tree(smem + kTablesBytes<C>, g_tree, g_path, g_flags, M, 2,
                                  L.tree_smem);
  if (tid < kMlCounters) sh.ctr[tid] = 0;
  __syncthreads();
  const QuartetScratch q = quartet_scratch<C>(smem + kTablesBytes<C> + L.tree_bytes, scratch,
                                              L.q.temps_smem, L.q.eff_smem, m.P);
  MlRound<C> b{{t.tree, t.tree + M, t.tree + 4 * M, t.flags, t.path, args.n_seqs, args.root, M,
                tid, false},
               m, codes, W, V, q, Red{q.red, 0}, lim, args, bl, &sh, t.flags + M, st, 0.0, 0};
  if constexpr (kRound) {
    const cg::cluster_group cl = cg::this_cluster();
    if (args.n_seqs > 3) b.nni_round(cl);
    if (tid == 0) {
      *g_max_delta = b.max_delta;
#pragma unroll
      for (int k = 1; k < kClusterBlocks; ++k) cl.map_shared_rank(&sh.cmd, k)->op = kStop;
    }
    prof_mark(kPhWait);
    cluster_sync();  // the workers read kStop and end
    prof_mark(kPhWalk);
  } else {
    b.lengths_pass();
  }
  unstage_tree(t, g_tree, M, L.tree_smem, sh.ctr, kMlCounters, kMlFault, b.bad, g_ctr);
}

// a worker of the round (block k = 1, 2): run the commands of block 0 until
// it sends kStop.  Its posteriors' rough and exact positions gather in its
// own ctr[kAaRough], ctr[kAaExact] (zero at each command's start), and go to
// block 0 with the result, where they count only if the result is taken
template <int C>
__device__ __forceinline__ void worker_block(const cg::cluster_group& cl, int k, const MLView& m,
                                             const SearchLimits& lim, float tol, float* scratch,
                                             const RoundLayout& L, MlShared& sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const QuartetScratch q = quartet_scratch<C>(smem + kTablesBytes<C>,
                                              scratch + k * L.q.scratch_floats, L.q.temps_smem,
                                              L.q.eff_smem, m.P);
  Red red{q.red, 0};
  for (;;) {
    prof_mark(kPhWait);
    cluster_sync();  // block 0's command and the store rows it reads
    const int op = sh.cmd.op, seq = sh.cmd.seq;
    if (op == kStop) break;
    if (op == kRun) {
      double len[5], parts[3];
#pragma unroll
      for (int i = 0; i < 5; ++i) len[i] = sh.cmd.len[i];
      const int r0 = sh.cmd.rows[0], r1 = sh.cmd.rows[1], r2 = sh.cmd.rows[2],
                r3 = sh.cmd.rows[3];
      int n_eval;
      bool stopped;
      unsigned long long* kinds = reinterpret_cast<unsigned long long*>(sh.ctr + kAaRough);
      quartet_optimize<C>(m, q, red, lim, tol, false, store_row<C>(m, r0), store_row<C>(m, r1),
                          store_row<C>(m, r2), store_row<C>(m, r3), len, parts, n_eval, nullptr,
                          AbandonFlag{&sh.abandon, seq}, stopped, kinds);
      // every posterior's adds came before a barrier this thread passed
      if (threadIdx.x == 0) {
        if (!stopped) {
          QuartetResult* o = cl.map_shared_rank(&sh.res[k], 0);
#pragma unroll
          for (int i = 0; i < 3; ++i) o->parts[i] = parts[i];
#pragma unroll
          for (int i = 0; i < 5; ++i) o->len[i] = len[i];
          o->kinds[0] = kinds[0];
          o->kinds[1] = kinds[1];
          o->n_eval = n_eval;
        }
        kinds[0] = kinds[1] = 0;
      }
    }
    prof_mark(kPhWait);
    cluster_sync();  // the results
  }
}

template <int C>
__global__ void __launch_bounds__(kOptThreads, 1) ml_nni_round_kernel(VFT_ML_ROUND_PARAMS) {
  __shared__ MlShared sh;
  prof_begin();
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  if (threadIdx.x == 0) {
    sh.abandon = -1;
    sh.ctr[kAaRough] = sh.ctr[kAaExact] = 0;  // a worker's
  }
  const MLView mt = stage_tables<C>(m);
  cluster_sync();  // every block runs before any writes another's memory
  if (rank != 0) {
    worker_block<C>(cl, rank, mt, lim, args.tol, scratch, L, sh);
  } else {
    tree_block<C, true>(mt, codes, W, V, lim, args, st, bl, g_tree, g_flags, g_path, g_ctr,
                        g_max_delta, scratch, L, sh);
  }
  prof_end();
}

template <int C>
__global__ void __launch_bounds__(kOptThreads, 1) ml_lengths_pass_kernel(VFT_ML_ROUND_PARAMS) {
  __shared__ MlShared sh;
  prof_begin();
  tree_block<C, false>(stage_tables<C>(m), codes, W, V, lim, args, st, bl, g_tree, g_flags,
                       g_path, g_ctr, g_max_delta, scratch, L, sh);
  prof_end();
}

template <int C>
int round_launch(const MLView& m, int8_t* codes, float* W, float* V, const SearchLimits& lim,
                 const MlArgs& args, const NniStats& st, int lengths, double* bl, int32_t* tree,
                 uint8_t* flags, int32_t* path, long long* ctr, double* max_delta, float* scratch,
                 int smem_tree, cudaStream_t stream) {
  const int n_blocks = lengths ? 1 : kClusterBlocks;
  const RoundLayout L = round_layout(args.maxnodes, m.P, C, smem_tree != 0, n_blocks);
  if (L.scratch_floats > 0 && scratch == nullptr) return kBadArgs;
  if (L.smem > (size_t)kMlRoundSmemCap) return kBadArgs;
  auto kernel = lengths ? ml_lengths_pass_kernel<C> : ml_nni_round_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMlRoundSmemCap);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(kOptThreads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = lengths ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, kernel, m, codes, W, V, lim, args, st, bl, tree, flags, path,
                           ctr, max_delta, scratch, L);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : 0;
}

int launch(const int8_t* codes, const float* W, const float* V, const float* code_freq,
           const float* eigenval, const float* eigeninv, const float* statinv,
           const float* rates, const int32_t* ratecat, int64_t n_rows, int P, int C, int n_pos,
           int n_rates, int jc, float min_rel_len, const float* near_p, const float* near_freq,
           int approx, unsigned long long* counts, const SearchLimits& lim, const MlArgs& args,
           const NniStats& st, int lengths, double* bl, int32_t* tree, uint8_t* flags,
           int32_t* path, int64_t* ctr, double* max_delta, float* scratch, int smem_tree,
           void* stream) {
  if (3 * (int64_t)args.maxnodes > n_rows || args.root < args.n_seqs ||
      args.root >= args.maxnodes || args.n_seqs < 3 || st.n > args.maxnodes ||
      n_rates < 1 || n_rates > kMaxRates)
    return kBadArgs;
  // the store's counts stay untouched: the round's rough and exact
  // positions come back in ctr, and the caller adds them
  const MLView m{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, P,
                 n_pos, n_rates, jc, min_rel_len, near_p, near_freq, approx, counts};
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  long long* c = reinterpret_cast<long long*>(ctr);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (C == 4)
    return round_launch<4>(m, c_out, w_out, v_out, lim, args, st, lengths, bl, tree, flags, path,
                           c, max_delta, scratch, smem_tree, cs);
  if (C == 20)
    return round_launch<20>(m, c_out, w_out, v_out, lim, args, st, lengths, bl, tree, flags, path,
                            c, max_delta, scratch, smem_tree, cs);
  return kBadArgs;
}

}  // namespace

#define VFT_ML_STORE_ARGS                                                                 \
  const int8_t *codes, const float *W, const float *V, const float *code_freq,           \
      const float *eigenval, const float *eigeninv, const float *statinv,                 \
      const float *rates, const int32_t *ratecat, int64_t n_rows, int P, int C, int n_pos, \
      int n_rates, int jc, float min_rel_len, const float *near_p, const float *near_freq, \
      int approx, unsigned long long *counts
#define VFT_ML_STORE_PASS                                                               \
  codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, n_rows, P, C, n_pos, \
      n_rates, jc, min_rel_len, near_p, near_freq, approx, counts

extern "C" {

// 1 if a round's tree (M nodes) fits in block 0's shared memory beside its
// quartet pieces at (P, C); otherwise the round keeps it in device memory.
int vft_ml_round_tree_fits_smem(int M, int P, int C) {
  return round_layout(M, P, C, true, kClusterBlocks).tree_smem ? 1 : 0;
}

// Floats of device scratch a round needs at (M, P, C) for the quartet
// pieces that do not fit in its blocks' shared memory (0 unless P is very
// large); a lengths pass needs no more.  smem_tree as the round's.
int64_t vft_ml_round_scratch_floats(int M, int P, int C, int smem_tree) {
  return (int64_t)round_layout(M, P, C, smem_tree != 0, kClusterBlocks).scratch_floats;
}

// One ML NNI round on the ML store, in place, in one launch of a cluster of
// three blocks.  The line searches' limits xmin, xmax, ftol, atol (float),
// min_len the minimum length as the host's float64.  The round's state on
// the device: tree = parent [M] | children [M, 3] | child counts [M]
// (int32), flags [2M] (uint8 scratch: the memo, the traversal), path [M]
// (int32 scratch), branch lengths bl [M] (double), the NNIStats age,
// subtree_age (int64), delta, support (double), [n_stats] each, read and
// written; ctr [kMlCounters] (int64, zero at the round's start, added to)
// and max_delta (double, out).  scratch: vft_ml_round_scratch_floats(M, P,
// C, smem_tree) floats, or NULL when that is 0.  smem_tree: 1 keeps the
// tree in shared memory where it fits, 0 in device memory.  Returns 0, a
// cudaError of the launch, or -2 for arguments the kernel does not take.
int vft_ml_nni_round_f32(VFT_ML_STORE_ARGS, float tol, float xmin, float xmax, float ftol,
                         float atol, double min_len, int ml_accuracy, int n_seqs, int maxnodes,
                         int root, int fast_nni, double min_delta, int n_stats, int64_t* age,
                         int64_t* subtree_age, double* delta, double* support, double* bl,
                         int32_t* tree, uint8_t* flags, int32_t* path, int64_t* ctr,
                         double* max_delta, float* scratch, int smem_tree, void* stream) {
  const SearchLimits lim{xmin, xmax, ftol, atol};
  const MlArgs args{n_seqs, maxnodes, root, ml_accuracy, min_len, tol};
  const NniStats st{reinterpret_cast<long long*>(age), reinterpret_cast<long long*>(subtree_age),
                    delta, support, n_stats, fast_nni, min_delta};
  if (root >= n_stats) return kBadArgs;
  return launch(VFT_ML_STORE_PASS, lim, args, st, 0, bl, tree, flags, path, ctr, max_delta,
                scratch, smem_tree, stream);
}

// One pass of optimizeAllBranchLengths (three tips or more) on the ML
// store, in place, in one launch of one block; the state as for
// vft_ml_nni_round_f32, without the NNIStats and max_delta.
int vft_ml_lengths_pass_f32(VFT_ML_STORE_ARGS, float tol, float xmin, float xmax, float ftol,
                            float atol, double min_len, int n_seqs, int maxnodes, int root,
                            double* bl, int32_t* tree, uint8_t* flags, int32_t* path,
                            int64_t* ctr, float* scratch, int smem_tree, void* stream) {
  const SearchLimits lim{xmin, xmax, ftol, atol};
  const MlArgs args{n_seqs, maxnodes, root, 1, min_len, tol};
  const NniStats st{nullptr, nullptr, nullptr, nullptr, 0, 0, 0.0};
  return launch(VFT_ML_STORE_PASS, lim, args, st, 1, bl, tree, flags, path, ctr, nullptr,
                scratch, smem_tree, stream);
}

#ifdef VFT_ML_ROUND_PROFILE
// The probes' cycles, [kProfSlots][kProfPhases] (block * 2 + group, then
// ProfPhase), summed over the launches since the last reset, into out;
// reset 1 zeroes them after.  Returns 0 or a cudaError.
int vft_ml_round_profile_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, prof_total, sizeof(prof_total));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[kProfSlots][kProfPhases] = {};
    err = cudaMemcpyToSymbol(prof_total, zero, sizeof(prof_total));
  }
  return (int)err;
}
#endif

}  // extern "C"
