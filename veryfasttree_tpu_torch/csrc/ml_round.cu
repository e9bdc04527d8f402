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
//   that a quartet's pieces leave shared memory.  The NNIStats and the
//   branch lengths stay in device memory, read by every thread of block 0
//   and written by its thread 0.
// - The 4-code lengths pass is one block of kOptThreads threads with the
//   same bodies and layout (its searches are serial).
// - At 20 codes (a posterior's two 20 x 20 rotations are most of the work,
//   and six temporaries take 258 KB at P=512) block 0 holds the tree and
//   the model tables only: it walks, decides and sends commands, and groups
//   of kg blocks (ranks 1 + g kg ...) run the work: a round's AB (g = 0),
//   AC (1) and AD (2) optimizations and a pass's searches (0), and every
//   posterior into a store row (0).  A group's blocks split each body's
//   positions (ml_lk.cuh Part), each holding its share of the temporaries,
//   search vectors and rate bytes in its shared memory (at kg = 4 and
//   P=512: 122 KB with the tables and part_sum's values), so nothing goes
//   to device scratch at P=512 for kg >= 2; each position's value goes to
//   every group block by st.async, counted in the receiver's mbarrier, so
//   the data is the group's barrier, and each sum is added in the
//   one-block order (part_sum; a flag barrier where the values lie in
//   device memory, past P of about 1,200).
//   Group 0's first block abandons groups 1 and 2 where AB's star test
//   fires (their first blocks poll, and part_sum gives every block of the
//   group the answer at the same evaluation).
// - Both kernels are bound to
//   one block of kOptThreads threads per SM (__launch_bounds__(kOptThreads,
//   1); with the thread count alone ptxas aims at two blocks and caps a
//   thread at 128 registers, which spilled), so a thread may take up to 255
//   registers; every function is inlined and no small array is indexed at
//   run time (round_tree.cuh pick3): no stack frame at 4 codes, 8 bytes in
//   the 20-code round (_build.STACK_LIMITS_20).
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

// With VFT_ROUND_CONS defined (ml_round_cons.cu) this file compiles the
// round under -constraints instead: ml_nni_round_cons_kernel and the entry
// vft_ml_nni_round_cons_f32, in a translation unit of its own (it builds
// beside this one; the layout and scratch entries stay here).

#define VFT_TREE_INLINE __forceinline__
#include "constraints.cuh"
#include "ml_lk.cuh"
#include "round_tree.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMlRoundSmemCap = 225 * 1024;  // dynamic shared memory of a round's block
constexpr int kClusterBlocks = 3;            // 4 codes: block 0: walk and AB; 1: AC; 2: AD
constexpr int kABvsCD = 0, kACvsBD = 1, kADvsBC = 2;
// 20 codes: block 0 walks; group g of kg blocks (ranks 1 + g kg ...) runs the
// AB (g = 0), AC (1) and AD (2) optimizations, or the pass's searches (0)
constexpr int kMaxRanks = 1 + 3 * kMaxGroup;

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

// one worker's quartet optimization (20 codes: or line search), written
// into block 0's shared memory
struct QuartetResult {
  double parts[3];
  double len[5];
  unsigned long long kinds[2];  // its posteriors' rough and exact positions
  int n_eval;
  int star;                     // 20 codes: the AB optimization's star test fired
  float x;                      // 20 codes: a search's length
};

enum { kIdle, kRun, kStop };
// what a 20-code group runs: a quartet optimization (rows A B C D, lengths
// A B C D I), a pass's search (the posterior of rows 0, 1 at lengths 0, 1
// into a temporary, then the search against row 2 from length 2), or a
// posterior of rows 0, 1 at lengths 0, 1 into store row 2
enum { kOpQuartet, kOpSearch, kOpPosterior };

// block 0's command to a worker, written into the worker's shared memory
struct Command {
  int op;     // kIdle, kRun, kStop
  int seq;    // the iteration's sequence number
  int what;   // 20 codes: kOpQuartet, kOpSearch or kOpPosterior
  int rows[4];
  double len[5];
};

// shared scratch of a block
struct MlShared {
  long long ctr[kMlCounters];                // block 0's
  QuartetResult res[kMaxRanks];              // block 0's: res[k] from block k
  Command cmd;                               // a worker's
  int abandon;                               // a worker's: the abandoned seq
  int any_bad;  // set by whichever thread finds a fault in the skip set
  PartLinks links;                           // a 20-code group block's (part_sum)
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

// the shared::cluster address of p (this block's shared memory) in block
// `rank` of the cluster
__device__ __forceinline__ unsigned map_cluster(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
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
// goes to device scratch, n_blocks shares of q.scratch_floats.  At 20 codes
// block 0 keeps the tree alone and each group block (after the model
// tables) its share of the pieces, `local` positions of each temporary and
// search vector (quartet_layout(local, 20)), then part_sum's values at
// vals_at; smem is the larger of the two.
struct RoundLayout {
  QuartetLayout q;
  bool tree_smem;
  size_t tree_bytes, smem, scratch_floats;
  int kg;          // 20 codes: the blocks of a group (1, 2 or 4); else 1
  int n_blocks;    // the cluster's blocks
  int local;       // 20 codes: a group block's positions, ceil(P / kg)
  size_t vals_at;  // 20 codes: a group block's part_sum values in shared
                   // memory, or 0: at the end of its scratch share
  size_t group_smem;  // 20 codes: a group block's shared memory
  size_t block_scratch;  // 20 codes: a group block's share of the scratch (floats)
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
  return {q, tree_smem, tree_bytes, tables + tree_bytes + q.smem, n_blocks * q.scratch_floats,
          1, n_blocks, P, 0, 0, q.scratch_floats};
}

// The 20-code layout: block 0 and n_groups groups of kg blocks (3 for a
// round, 1 for a pass).  A group block keeps part_sum's values of all P
// positions (48 P bytes) in its shared memory up to P = 1,200, in device
// scratch past it, and its share of the quartet pieces in shared memory
// where they fit beside them: every piece stays out of device scratch at
// kg = 1 up to P of about 300, at kg = 2 about 560, at kg = 4 about 1,000.
RoundLayout round_layout20(int M, int P, bool want_tree_smem, int n_groups, int kg) {
  const size_t tables = kTablesBytes<20>;
  const int local = (P + kg - 1) / kg;
  const size_t vals = align16((6 * (size_t)P + 2) * sizeof(double));
  const bool vals_smem = vals <= (size_t)kMlRoundSmemCap / 4;
  const size_t vals_in_smem = vals_smem ? vals : 0;
  const QuartetLayout q = quartet_layout(local, 20, kMlRoundSmemCap - tables - vals_in_smem);
  const size_t tree = tree_smem_bytes(M, 2);
  const bool tree_smem = want_tree_smem && tables + tree <= (size_t)kMlRoundSmemCap;
  const size_t tree_bytes = tree_smem ? tree : 0;
  const size_t group = tables + q.smem + vals_in_smem;
  const size_t block0 = tables + tree_bytes;
  const int n_blocks = 1 + n_groups * kg;
  const size_t per_block = q.scratch_floats + (vals_smem ? 0 : vals / sizeof(float));
  return {q, tree_smem, tree_bytes, group > block0 ? group : block0,
          (size_t)(n_blocks - 1) * per_block, kg, n_blocks, local,
          vals_smem ? tables + q.smem : 0, group, per_block};
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

// Cons: the round under -constraints (ml_nni_round_cons_kernel): each
// criterion is the quartet's log-likelihood less its topology's constraint
// penalty (ml.ml_quartet_nni), the penalties of the counts the ME phase
// left (the ML round reads the counts and writes none)
template <int C, bool Cons = false>
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
  int kg;             // 20 codes: the blocks of a group
  int n_groups;       // 20 codes: the groups (3 in a round, 1 in a pass)
  ConView con{};      // Cons: the counts (int32 [M, n_cons], read only)
  double pen[3]{};    // Cons: the quartet's penalties (ABvsCD, ACvsBD, ADvsBC)

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
    if constexpr (C == 20) {
      // on group 0, each block its positions
      ++seq;
      const int r[4] = {r1, r2, t, 0};
      const double l[5] = {l1, l2, 0.0, 0.0, 0.0};
      const cg::cluster_group cl = cg::this_cluster();
      send_group(cl, 0, true, kOpPosterior, r, l);
      for (int g = 1; g < n_groups; ++g) send_group(cl, g, false, kOpPosterior, r, l);
      run_groups();
      count(kPostCompute, 1);
      count(kPosteriors, 1);
      take_kinds(0);
      return;
    }
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

  // topology k's criterion from its log-likelihood: ll less the penalty
  // under Cons (ml.ml_quartet_nni's ll - penalty[k]), ll without
  __device__ __forceinline__ double less_pen(double ll, int k) const {
    if constexpr (Cons) return ll - pick3(pen, k);
    return ll;
  }

  // ml.ml_quartet_nni (ref MLQuartetNNI tcc:4885-5004) on the cluster:
  // returns the choice; crit the criteria (less the constraint penalties
  // under Cons), out the chosen quartet's lengths (A, B, C, D, I in its
  // own order)
  __device__ __forceinline__ int quartet_nni(const cg::cluster_group& cl, const int r[4],
                                             const double len[5], double crit[3],
                                             double out[5]) {
    if constexpr (C == 20) return quartet_nni_groups(cl, r, len, crit, out);
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
      c_ab = less_pen(quartet_ll(parts, star), kABvsCD);
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
      if (consider_ac) {
        take(1, lac, c_ac);
        c_ac = less_pen(c_ac, kACvsBD);
      }
      if (consider_ad) {
        take(2, lad, c_ad);
        c_ad = less_pen(c_ad, kADvsBC);
      }
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

  // 20 codes: block 0's command to every block of group g (kRun with the
  // rows and lengths, or kIdle), in the blocks' shared memory
  __device__ __forceinline__ void send_group(const cg::cluster_group& cl, int g, bool run,
                                             int what, const int r[4], const double l[5]) {
    if (tid != 0) return;
    for (int j = 0; j < kg; ++j) {
      Command* c = cl.map_shared_rank(&sh->cmd, 1 + g * kg + j);
      c->op = run ? kRun : kIdle;
      c->seq = seq;
      c->what = what;
#pragma unroll
      for (int i = 0; i < 4; ++i) c->rows[i] = r[i];
#pragma unroll
      for (int i = 0; i < 5; ++i) c->len[i] = l[i];
    }
  }

  // 20 codes: the commands out, every block at a cluster barrier (the
  // commands and the store rows they read), the groups run, and a second
  // barrier (their results in sh->res)
  __device__ __forceinline__ void run_groups() {
    __threadfence();
    prof_mark(kPhWait);
    cluster_sync();
    cluster_sync();
    prof_mark(kPhWalk);
  }

  // 20 codes: the rough and exact positions of group g's posteriors
  __device__ __forceinline__ void take_kinds(int g) {
    if (tid != 0) return;
    for (int j = 0; j < kg; ++j) {
      const QuartetResult& o = sh->res[1 + g * kg + j];
      atomicAdd(kinds(), o.kinds[0]);
      atomicAdd(kinds() + 1, o.kinds[1]);
    }
  }

  // 20 codes: group g's optimization into len and ll, counted as the host
  // counts it
  __device__ __forceinline__ void take_group(int g, double len[5], double& ll) {
    const QuartetResult& o = sh->res[1 + g * kg];
#pragma unroll
    for (int i = 0; i < 5; ++i) len[i] = o.len[i];
    ll = quartet_ll(o.parts, false);
    count_quartet(false, false, o.n_eval);
    take_kinds(g);
  }

  // quartet_nni at 20 codes: the AB, AC and AD optimizations on groups 0, 1
  // and 2 (AC and AD speculative as above: group 0's first block abandons
  // them when AB's star test fires), block 0 deciding
  __device__ __forceinline__ int quartet_nni_groups(const cg::cluster_group& cl, const int r[4],
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
      raise_to_min(lab);
      if (consider_ac) raise_to_min(lac);
      if (consider_ad) raise_to_min(lad);
      ++seq;
      send_group(cl, 0, true, kOpQuartet, r, lab);
      send_group(cl, 1, consider_ac, kOpQuartet, rac, lac);
      send_group(cl, 2, consider_ad, kOpQuartet, rad, lad);
      run_groups();
      const QuartetResult& ab = sh->res[1];
      const bool star = ab.star != 0;
#pragma unroll
      for (int i = 0; i < 5; ++i) lab[i] = ab.len[i];
      c_ab = less_pen(quartet_ll(ab.parts, star), kABvsCD);
      count_quartet(true, star, ab.n_eval);
      take_kinds(0);
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
      if (consider_ac) {
        take_group(1, lac, c_ac);
        c_ac = less_pen(c_ac, kACvsBD);
      }
      if (consider_ad) {
        take_group(2, lad, c_ad);
        c_ad = less_pen(c_ad, kADvsBC);
      }
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
    if constexpr (Cons) quartet_penalties(con, n4, pen);
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
  __device__ __forceinline__ void lengths_pass(const cg::cluster_group* cl = nullptr) {
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
          const double cur = bl[ni];
          const double guess = cur < a.min_len ? a.min_len : cur;  // Python's max
          float x;
          int n;
          if constexpr (C == 20) {
            // the temporary's posterior and the search on group 0
            ++seq;
            const int r[4] = {pick3(rows3, b1), pick3(rows3, b2), pick3(rows3, i), 0};
            const double l[5] = {bl[n1], bl[n2], guess, 0.0, 0.0};
            send_group(*cl, 0, true, kOpSearch, r, l);
            run_groups();
            count(kPostCompute, 1);
            count(kPosteriors, 1);
            take_kinds(0);
            x = sh->res[1].x;
            n = sh->res[1].n_eval;
          } else {
            posterior_to(nullptr, tmp_w, tmp_v, row(pick3(rows3, b1)), row(pick3(rows3, b2)),
                         bl[n1], bl[n2]);
            float fx;
            bool stopped;
            x = line_search<C>(m, row(pick3(rows3, i)), tmp, (float)guess, lim, q.eff1, q.eff2,
                               q.rate, red, fx, n, NoStop{}, stopped);
          }
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
// the one block of a pass (at 20 codes block 0 of the pass's cluster, then
// kStop to its group): stage the tree, run, put the tree and the counters
// back.  No lambda: nvcc kept a lambda this large as a call, with spills.
template <int C, bool kRound, bool Cons = false>
__device__ __forceinline__ void tree_block(VFT_ML_ROUND_PARAMS, MlShared& sh,
                                           const ConView& con = ConView{}) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, M = args.maxnodes;
  const TreeArrays t = stage_tree(smem + kTablesBytes<C>, g_tree, g_path, g_flags, M, 2,
                                  L.tree_smem);
  if (tid < kMlCounters) sh.ctr[tid] = 0;
  __syncthreads();
  QuartetScratch q{};
  if constexpr (C != 20)  // at 20 codes the groups keep the quartet pieces
    q = quartet_scratch<C>(smem + kTablesBytes<C> + L.tree_bytes, scratch, L.q.temps_smem,
                           L.q.eff_smem, m.P);
  MlRound<C, Cons> b{{t.tree, t.tree + M, t.tree + 4 * M, t.flags, t.path, args.n_seqs,
                      args.root, M, tid, false},
                     m, codes, W, V, q, Red{q.red, 0}, lim, args, bl, &sh, t.flags + M, st, 0.0,
                     0, L.kg, (L.n_blocks - 1) / L.kg};
  if constexpr (Cons) b.con = con;
  if constexpr (kRound || C == 20) {
    const cg::cluster_group cl = cg::this_cluster();
    if constexpr (kRound) {
      if (args.n_seqs > 3) b.nni_round(cl);
      if (tid == 0) *g_max_delta = b.max_delta;
    } else {
      b.lengths_pass(&cl);
    }
    if (tid == 0)
      for (int k = 1; k < L.n_blocks; ++k) cl.map_shared_rank(&sh.cmd, k)->op = kStop;
    prof_mark(kPhWait);
    cluster_sync();  // the workers read kStop and end
    prof_mark(kPhWalk);
  } else {
    b.lengths_pass();
  }
  unstage_tree(t, g_tree, M, L.tree_smem, sh.ctr, kMlCounters, kMlFault, b.bad, g_ctr);
}

// a worker of the 4-code round (block k = 1, 2): run the commands of block 0
// until it sends kStop.  Its posteriors' rough and exact positions gather in
// its own ctr[kAaRough], ctr[kAaExact] (zero at each command's start), and
// go to block 0 with the result, where they count only if the result is
// taken
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

// a block of a 20-code group (rank 1 + g kg + j: block j of group g): run
// block 0's commands until it sends kStop, each spread over the group's kg
// blocks (ml_lk.cuh Part), its pieces in this block's shared memory where
// they fit.  A quartet (group 0 with the star test, whose first block then
// abandons the other groups' optimizations; groups 1 and 2 polling their
// abandon flag, through their first block) or a pass's search: the
// posterior of two rows into the first temporary, then the line search
// (kRound false: a pass's group, which runs only searches).
// Every block of the group sends block 0 its posteriors' rough and exact
// positions, the first block the result, unless it was abandoned.
template <int C, bool kRound>
__device__ __forceinline__ void group_block(const cg::cluster_group& cl, int rank,
                                            const MLView& m, const SearchLimits& lim, float tol,
                                            float* scratch, const RoundLayout& L, MlShared& sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = (rank - 1) / L.kg, lead = 1 + g * L.kg;
  float* share = scratch + (size_t)(rank - 1) * L.block_scratch;
  const QuartetScratch q = quartet_scratch<C>(smem + kTablesBytes<C>, share, L.q.temps_smem,
                                              L.q.eff_smem, L.local);
  Red red{q.red, 0};
  const Part part{L.kg, L.kg == 4 ? 2 : (L.kg == 2 ? 1 : 0), rank - lead, L.local, &sh.links};
  if (threadIdx.x == 0) {
    // part_sum's values: each group block's, in its shared memory (async)
    // or at the end of its scratch share
    PartLinks& ln = sh.links;
    ln.async = L.vals_at != 0;
    for (int i = 0; i < kMaxGroup; ++i) {
      const int peer = lead + (i < L.kg ? i : 0);
      ln.peer[i] =
          ln.async ? cl.map_shared_rank(reinterpret_cast<double*>(smem + L.vals_at), peer)
                   : reinterpret_cast<double*>(scratch + (size_t)(peer - 1) * L.block_scratch +
                                               L.q.scratch_floats);
      ln.peer_arrived[i] = cl.map_shared_rank(ln.arrived, peer);
      ln.vals_cl[i] = map_cluster(smem + L.vals_at, peer);
      ln.full_cl[i] = map_cluster(ln.full, peer);
    }
    ln.vals = ln.peer[rank - lead];
    if (ln.async) {
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         (unsigned)__cvta_generic_to_shared(&ln.full[b]))
                     : "memory");
      // the barriers' first phases, before any block of the group stores
      // into them (after the next cluster barrier)
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  unsigned long long* kinds = reinterpret_cast<unsigned long long*>(sh.ctr + kAaRough);
  for (;;) {
    prof_mark(kPhWait);
    cluster_sync();  // block 0's command and the store rows it reads
    const int op = sh.cmd.op, seq = sh.cmd.seq;
    if (op == kStop) break;
    if (op == kRun) {
      double len[5], parts[3] = {0.0, 0.0, 0.0};
#pragma unroll
      for (int i = 0; i < 5; ++i) len[i] = sh.cmd.len[i];
      const int r0 = sh.cmd.rows[0], r1 = sh.cmd.rows[1], r2 = sh.cmd.rows[2],
                r3 = sh.cmd.rows[3];
      int n_eval;
      bool stopped = false, star = false;
      float x = 0.0f;
      if (sh.cmd.what == kOpPosterior) {
        // into store row r2, each position by its block and thread; the
        // fence before the results' barrier lets every block read it
        const int64_t at = (int64_t)r2 * m.P;
        prof_mark(kPhWalk);
        posterior_row<C>(m, store_row<C>(m, r0), store_row<C>(m, r1),
                         fmaxf((float)len[0], lim.xmin), fmaxf((float)len[1], lim.xmin), tol,
                         const_cast<int8_t*>(m.codes) + at, const_cast<float*>(m.W) + at,
                         const_cast<float*>(m.V) + at * C, kinds, part, 0);
        __threadfence();
        __syncthreads();  // every warp's rough and exact adds, before thread 0 sends them
        n_eval = 0;
      } else if constexpr (kRound) {
        star = quartet_optimize<C>(m, q, red, lim, tol, g == 0, store_row<C>(m, r0),
                                   store_row<C>(m, r1), store_row<C>(m, r2),
                                   store_row<C>(m, r3), len, parts, n_eval, nullptr,
                                   AbandonFlag{&sh.abandon, seq}, stopped, kinds, part);
        if (star && g == 0 && part.j == 0 && threadIdx.x == 0)
          for (int k = 1; k < 3; ++k) *cl.map_shared_rank(&sh.abandon, 1 + k * L.kg) = seq;
      } else {
        float* tw = q.temps;
        const RowRef tmp{nullptr, tw, tw + L.local, part.log2k};
        prof_mark(kPhQPost);
        posterior_row<C>(m, store_row<C>(m, r0), store_row<C>(m, r1),
                         fmaxf((float)len[0], lim.xmin), fmaxf((float)len[1], lim.xmin), tol,
                         nullptr, tw, tw + L.local, kinds, part, part.log2k);
        float fx;
        x = line_search<C>(m, store_row<C>(m, r2), tmp, (float)len[2], lim, q.eff1, q.eff2,
                           q.rate, red, fx, n_eval, NoStop{}, stopped, part);
      }
      // every posterior's adds came before a barrier this thread passed
      if (threadIdx.x == 0) {
        QuartetResult* o = cl.map_shared_rank(&sh.res[rank], 0);
        o->kinds[0] = kinds[0];
        o->kinds[1] = kinds[1];
        if (!stopped && rank == lead) {
#pragma unroll
          for (int i = 0; i < 3; ++i) o->parts[i] = parts[i];
#pragma unroll
          for (int i = 0; i < 5; ++i) o->len[i] = len[i];
          o->n_eval = n_eval;
          o->star = star ? 1 : 0;
          o->x = x;
        }
        kinds[0] = kinds[1] = 0;
      }
    }
    prof_mark(kPhWait);
    cluster_sync();  // the results
  }
}

// the start of every block of a cluster: its flags zeroed and the model
// tables staged before any block writes another's shared memory
template <int C>
__device__ __forceinline__ MLView cluster_start(const MLView& m, MlShared& sh) {
  if (threadIdx.x == 0) {
    sh.abandon = -1;
    sh.ctr[kAaRough] = sh.ctr[kAaExact] = 0;  // a worker's
#pragma unroll
    for (int i = 0; i < kMaxGroup; ++i) sh.links.arrived[i] = 0;
  }
  const MLView mt = stage_tables<C>(m);
  cluster_sync();
  return mt;
}

// a block of a round's cluster; con the counts under Cons
template <int C, bool Cons>
__device__ __forceinline__ void round_block(VFT_ML_ROUND_PARAMS, const ConView& con) {
  __shared__ MlShared sh;
  prof_begin();
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const MLView mt = cluster_start<C>(m, sh);
  if (rank != 0) {
    if constexpr (C == 20)
      group_block<C, true>(cl, rank, mt, lim, args.tol, scratch, L, sh);
    else
      worker_block<C>(cl, rank, mt, lim, args.tol, scratch, L, sh);
  } else {
    tree_block<C, true, Cons>(mt, codes, W, V, lim, args, st, bl, g_tree, g_flags, g_path, g_ctr,
                              g_max_delta, scratch, L, sh, con);
  }
  prof_end();
}

#ifndef VFT_ROUND_CONS
template <int C>
__global__ void __launch_bounds__(kOptThreads, 1) ml_nni_round_kernel(VFT_ML_ROUND_PARAMS) {
  round_block<C, false>(m, codes, W, V, lim, args, st, bl, g_tree, g_flags, g_path, g_ctr,
                        g_max_delta, scratch, L, ConView{});
}
#else
// the round under -constraints: block 0's criteria less the quartets'
// constraint penalties (MlRound's Cons); the other blocks as above
template <int C>
__global__ void __launch_bounds__(kOptThreads, 1)
    ml_nni_round_cons_kernel(VFT_ML_ROUND_PARAMS, ConView con) {
  round_block<C, true>(m, codes, W, V, lim, args, st, bl, g_tree, g_flags, g_path, g_ctr,
                       g_max_delta, scratch, L, con);
}
#endif

#ifndef VFT_ROUND_CONS
template <int C>
__global__ void __launch_bounds__(kOptThreads, 1) ml_lengths_pass_kernel(VFT_ML_ROUND_PARAMS) {
  __shared__ MlShared sh;
  prof_begin();
  if constexpr (C == 20) {
    const cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
    const MLView mt = cluster_start<C>(m, sh);
    if (rank != 0)
      group_block<C, false>(cl, rank, mt, lim, args.tol, scratch, L, sh);
    else
      tree_block<C, false>(mt, codes, W, V, lim, args, st, bl, g_tree, g_flags, g_path, g_ctr,
                           g_max_delta, scratch, L, sh);
  } else {
    tree_block<C, false>(stage_tables<C>(m), codes, W, V, lim, args, st, bl, g_tree, g_flags,
                         g_path, g_ctr, g_max_delta, scratch, L, sh);
  }
  prof_end();
}
#endif

// the layout of a round (lengths 0) or a pass at (M, P, C); kg the blocks
// of a 20-code group
RoundLayout layout_of(int M, int P, int C, bool smem_tree, int lengths, int kg) {
  if (C == 20) return round_layout20(M, P, smem_tree, lengths ? 1 : 3, kg);
  return round_layout(M, P, C, smem_tree, lengths ? 1 : kClusterBlocks);
}

bool group_ok(int kg) { return kg == 1 || kg == 2 || kg == kMaxGroup; }

constexpr int kClusterRefused = -3;  // the card cannot place the cluster
#ifndef VFT_ROUND_CONS
constexpr bool kConsUnit = false;     // this unit's round kernel
#else
constexpr bool kConsUnit = true;
#endif

template <int C>
int round_launch(const MLView& m, int8_t* codes, float* W, float* V, const SearchLimits& lim,
                 const MlArgs& args, const NniStats& st, int lengths, double* bl, int32_t* tree,
                 uint8_t* flags, int32_t* path, long long* ctr, double* max_delta, float* scratch,
                 int smem_tree, int kg, const ConView* con, cudaStream_t stream) {
  if (C == 20 && !group_ok(kg)) return kBadArgs;
  // the constrained kernel is a round's (a pass makes no decision)
  if ((con != nullptr) != kConsUnit || (con != nullptr && lengths)) return kBadArgs;
  const RoundLayout L = layout_of(args.maxnodes, m.P, C, smem_tree != 0, lengths, kg);
  if (L.scratch_floats > 0 && scratch == nullptr) return kBadArgs;
  if (L.smem > (size_t)kMlRoundSmemCap) return kBadArgs;
#ifndef VFT_ROUND_CONS
  auto kernel = lengths ? ml_lengths_pass_kernel<C> : ml_nni_round_kernel<C>;
#else
  auto kernel = ml_nni_round_cons_kernel<C>;
#endif
  const void* fn = (const void*)kernel;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMlRoundSmemCap);
  if (err != cudaSuccess) return (int)err;
  // a cluster of more than 8 blocks (kg = 4: 13) is not portable
  if (L.n_blocks > 8)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.n_blocks);
  cfg.blockDim = dim3(kOptThreads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = L.n_blocks > 1 ? 1 : 0;
  // a cluster the card cannot place is refused here, not left to hang
  if (L.n_blocks > 1) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kClusterRefused;
  }
#ifndef VFT_ROUND_CONS
  err = cudaLaunchKernelEx(&cfg, kernel, m, codes, W, V, lim, args, st, bl, tree, flags, path,
                           ctr, max_delta, scratch, L);
#else
  err = cudaLaunchKernelEx(&cfg, kernel, m, codes, W, V, lim, args, st, bl, tree, flags, path,
                           ctr, max_delta, scratch, L, *con);
#endif
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
           int kg, const ConView* con, void* stream) {
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
                           c, max_delta, scratch, smem_tree, 1, con, cs);
  if (C == 20)
    return round_launch<20>(m, c_out, w_out, v_out, lim, args, st, lengths, bl, tree, flags, path,
                            c, max_delta, scratch, smem_tree, kg, con, cs);
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

#ifndef VFT_ROUND_CONS
// 1 if a round's tree (M nodes) fits in block 0's shared memory (beside its
// quartet pieces at 4 codes) at (P, C); otherwise the round keeps it in
// device memory.
int vft_ml_round_tree_fits_smem(int M, int P, int C) {
  return layout_of(M, P, C, true, 0, 1).tree_smem ? 1 : 0;
}

// Floats of device scratch a round needs at (M, P, C) for the quartet
// pieces that do not fit in its blocks' shared memory (at 4 codes 0 unless
// P is very large; at 20 codes 0 for P up to about 600 with groups of 2
// blocks); a lengths pass needs no more.  smem_tree as the round's, group
// the blocks of a 20-code group (1, 2 or 4); -2 for a group the kernels do
// not take.
int64_t vft_ml_round_scratch_floats(int M, int P, int C, int smem_tree, int group) {
  if (C == 20 && !group_ok(group)) return kBadArgs;
  return (int64_t)layout_of(M, P, C, smem_tree != 0, 0, group).scratch_floats;
}

// A round's (lengths 0) or pass's layout into out [7]: the cluster's
// blocks, the dynamic shared memory of each, a 20-code group block's, the
// floats of device scratch, whether the tree is in shared memory, a group
// block's positions and the blocks of a group.  Returns 0, or -2 for a
// group the kernels do not take.
int vft_ml_round_layout(int M, int P, int C, int smem_tree, int lengths, int group,
                        int64_t* out) {
  if (C == 20 && !group_ok(group)) return kBadArgs;
  const RoundLayout L = layout_of(M, P, C, smem_tree != 0, lengths, group);
  out[0] = L.n_blocks;
  out[1] = (int64_t)L.smem;
  out[2] = (int64_t)L.group_smem;
  out[3] = (int64_t)L.scratch_floats;
  out[4] = L.tree_smem ? 1 : 0;
  out[5] = L.local;
  out[6] = L.kg;
  return 0;
}

// One ML NNI round on the ML store, in place, in one launch of a cluster of
// three blocks (at 20 codes, 1 + 3 group blocks: the walk, then groups of
// `group` blocks for AB, AC and AD).  The line searches' limits xmin, xmax, ftol, atol (float),
// min_len the minimum length as the host's float64.  The round's state on
// the device: tree = parent [M] | children [M, 3] | child counts [M]
// (int32), flags [2M] (uint8 scratch: the memo, the traversal), path [M]
// (int32 scratch), branch lengths bl [M] (double), the NNIStats age,
// subtree_age (int64), delta, support (double), [n_stats] each, read and
// written; ctr [kMlCounters] (int64, zero at the round's start, added to)
// and max_delta (double, out).  scratch: vft_ml_round_scratch_floats(M, P,
// C, smem_tree, group) floats, or NULL when that is 0.  smem_tree: 1 keeps
// the tree in shared memory where it fits, 0 in device memory.  Returns 0,
// a cudaError of the launch, -3 for a cluster the card cannot place, or -2
// for arguments the kernel does not take.
int vft_ml_nni_round_f32(VFT_ML_STORE_ARGS, float tol, float xmin, float xmax, float ftol,
                         float atol, double min_len, int ml_accuracy, int n_seqs, int maxnodes,
                         int root, int fast_nni, double min_delta, int n_stats, int64_t* age,
                         int64_t* subtree_age, double* delta, double* support, double* bl,
                         int32_t* tree, uint8_t* flags, int32_t* path, int64_t* ctr,
                         double* max_delta, float* scratch, int smem_tree, int group,
                         void* stream) {
  const SearchLimits lim{xmin, xmax, ftol, atol};
  const MlArgs args{n_seqs, maxnodes, root, ml_accuracy, min_len, tol};
  const NniStats st{reinterpret_cast<long long*>(age), reinterpret_cast<long long*>(subtree_age),
                    delta, support, n_stats, fast_nni, min_delta};
  if (root >= n_stats) return kBadArgs;
  return launch(VFT_ML_STORE_PASS, lim, args, st, 0, bl, tree, flags, path, ctr, max_delta,
                scratch, smem_tree, group, nullptr, stream);
}

#else
// The same round under -constraints (ml_nni_round_cons_kernel): con_on,
// con_off the counts, int32 [maxnodes, n_cons] on the device, read only
// (n_cons >= 1); con_weight constraint_weight.
int vft_ml_nni_round_cons_f32(VFT_ML_STORE_ARGS, float tol, float xmin, float xmax, float ftol,
                              float atol, double min_len, int ml_accuracy, int n_seqs,
                              int maxnodes, int root, int fast_nni, double min_delta,
                              int n_stats, int64_t* age, int64_t* subtree_age, double* delta,
                              double* support, double* bl, int32_t* tree, uint8_t* flags,
                              int32_t* path, int64_t* ctr, double* max_delta, float* scratch,
                              int smem_tree, int group, const int32_t* con_on,
                              const int32_t* con_off, int n_cons, double con_weight,
                              void* stream) {
  const SearchLimits lim{xmin, xmax, ftol, atol};
  const MlArgs args{n_seqs, maxnodes, root, ml_accuracy, min_len, tol};
  const NniStats st{reinterpret_cast<long long*>(age), reinterpret_cast<long long*>(subtree_age),
                    delta, support, n_stats, fast_nni, min_delta};
  if (root >= n_stats || n_cons < 1 || con_on == nullptr || con_off == nullptr) return kBadArgs;
  const ConView con{con_on, con_off, n_cons, con_weight};
  return launch(VFT_ML_STORE_PASS, lim, args, st, 0, bl, tree, flags, path, ctr, max_delta,
                scratch, smem_tree, group, &con, stream);
}
#endif

#ifndef VFT_ROUND_CONS

// One pass of optimizeAllBranchLengths (three tips or more) on the ML
// store, in place, in one launch of one block (at 20 codes a cluster of
// 1 + group blocks: the walk, then one group for the searches); the state
// as for vft_ml_nni_round_f32, without the NNIStats and max_delta.
int vft_ml_lengths_pass_f32(VFT_ML_STORE_ARGS, float tol, float xmin, float xmax, float ftol,
                            float atol, double min_len, int n_seqs, int maxnodes, int root,
                            double* bl, int32_t* tree, uint8_t* flags, int32_t* path,
                            int64_t* ctr, float* scratch, int smem_tree, int group,
                            void* stream) {
  const SearchLimits lim{xmin, xmax, ftol, atol};
  const MlArgs args{n_seqs, maxnodes, root, 1, min_len, tol};
  const NniStats st{nullptr, nullptr, nullptr, nullptr, 0, 0, 0.0};
  return launch(VFT_ML_STORE_PASS, lim, args, st, 1, bl, tree, flags, path, ctr, nullptr,
                scratch, smem_tree, group, nullptr, stream);
}
#endif

#ifdef VFT_ML_ROUND_PROFILE
// The probes' table shape: kProfSlots rows of kProfPhases phases.
void vft_ml_round_profile_shape(int* slots, int* phases) {
  *slots = kProfSlots;
  *phases = kProfPhases;
}

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
