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
// port.  Here one launch of one block runs, in the host loop's order:
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
// Bound: a round must read each store row it uses once and write each row
// it changes once (P * (4C + 5) bytes each), and do each posterior's, line
// search evaluation's and pair likelihood's operations per position.  Each
// quartet depends on the one before (a swap changes the tree, the lengths
// and the rows its successors read), and each line search is a chain of
// about 15 dependent evaluations, so the work is serial and parallel only
// over positions.  What the design does about it: no launch and no fetch
// per quartet or search.  The block has two groups of kOptThreads threads,
// each with a named barrier: the AC and AD optimizations, which are
// independent, run side by side, one on each group; everything else runs on
// group 0 (the AB optimization, the line searches of a lengths pass) or on
// the whole block (the walk, the posteriors of node rows and up-profiles).
// Group 0's quartet temporaries and line-search vectors stay where
// ml_quartet_opt keeps them (shared memory at P=512); the tree, the
// up-profile memo, its path and the traversal flags follow in shared memory
// where they fit (26 bytes per node; else device memory, the same code on
// other pointers); group 1's pieces take what room is left (at N=2000,
// P=512: its vectors, while its temporaries go to device scratch); the
// NNIStats and the branch lengths stay in device memory, read by every
// thread and written by thread 0.
//
// Bit for bit with the host loop through the per-call kernels: every
// posterior, search and quartet runs the single-call kernels' bodies of
// ml_lk.cuh with their thread maps on a group of kOptThreads threads (a
// posterior on any); the host's casts
// are repeated (posterior lengths to float and raised to xmin, quartet
// lengths raised in float64, searched lengths back as float values, the
// quartet loglk summed from its parts in the host's order), and the
// criteria, pruning tests, deltas and supports are double in numpy's order
// (this file is compiled with -fmad=false).  The debug counters grow by
// the amounts the host's store calls add.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ml_lk.cuh"
#include "round_tree.cuh"

namespace {

constexpr int kMlRoundSmemCap = 225 * 1024;  // dynamic shared memory of a round's block
constexpr int kMlRoundThreads = 2 * kOptThreads;  // two groups of kOptThreads
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
  kMlFault,       // a broken tree invariant: the round is void
  kMlCounters
};

// one quartet optimization's result, from the group that ran it to the
// block
struct QuartetResult {
  double parts[3];
  double len[5];
  int n_eval;
  int star;
};

// shared scratch of the decisions
struct MlShared {
  long long ctr[kMlCounters];
  QuartetResult res[2];
  float x;      // a lengths pass's searched length
  int n_eval;   // and its evaluations
  int any_bad;  // set by whichever thread finds a fault in the skip set
};

struct MlArgs {
  int n_seqs;
  int maxnodes;     // M: node rows [0, M), up-profile rows M + node
  int root;
  int ml_accuracy;
  double min_len;   // ml_min_branch_length, the host's float64
  float tol;        // f_post_total_tolerance
};

template <int C>
struct MlRound : RoundTree {
  MLView m;
  int8_t* codes;      // the store, written in place
  float* W;
  float* V;
  QuartetScratch q[2];  // group 0's (threads 0-255) and group 1's
  SearchLimits lim;
  MlArgs a;
  double* bl;         // [M] branch lengths
  MlShared* sh;
  uint8_t* trav;      // [M] the walk's traversal flags
  NniStats st;
  double max_delta;   // the NNI round's

  __device__ __forceinline__ void count(int k, long long n) {
    if (tid == 0) sh->ctr[k] += n;
  }

  // the thread's group: 0 (HalfBlock<1>) or 1 (HalfBlock<2>)
  __device__ __forceinline__ int group() const { return tid / kOptThreads; }

  __device__ __forceinline__ RowRef row(int r) const { return store_row<C>(m, r); }

  // the posterior profile of rows r1 and r2 at lengths l1, l2 (as
  // MLProfiles.posterior_into: float lengths raised to the minimum) into
  // store row t (codes_out not null) or a temporary, by the whole block
  // with group 0's rate tables
  __device__ void posterior_to(int8_t* codes_out, float* w_out, float* v_out, const RowRef& r1,
                               const RowRef& r2, double l1, double l2) {
    const WholeBlock all;
    __syncthreads();  // earlier readers of the tables and of the target are done
    fill_table<C>(all, m, fmaxf((float)l1, lim.xmin), q[0].tab1);
    fill_table<C>(all, m, fmaxf((float)l2, lim.xmin), q[0].tab2);
    __syncthreads();
    for (int p = tid; p < m.P; p += kMlRoundThreads) {
      float w, o[C];
      posterior_site<C>(m, r1, r2, q[0].tab1, q[0].tab2, a.tol, p, w, o);
      if (codes_out != nullptr) codes_out[p] = (int8_t)kNoCode;
      w_out[p] = w;
#pragma unroll
      for (int c = 0; c < C; ++c) v_out[p * C + c] = o[c];
    }
    __syncthreads();  // the target is whole before anyone reads it
    count(kPostCompute, 1);
    count(kPosteriors, 1);
  }

  __device__ void posterior(int t, int r1, int r2, double l1, double l2) {
    const int64_t at = (int64_t)t * m.P;
    posterior_to(codes + at, W + at, V + at * C, row(r1), row(r2), l1, l2);
  }

  // -------------------------------------------------- up-profiles, repairs
  __device__ void setup_abcd(int node, int nodes4[4], int rows4[4]) {
    RoundTree::setup_abcd(node, nodes4, rows4, [this](int n, int nc, int d_row, int nd) {
      posterior(maxnodes + n, nc, d_row, bl[nc], bl[nd]);
    });
  }

  // ref recomputeProfile tcc:3436-3472 (ML)
  __device__ void recompute_profile(int node) {
    if (node < n_seqs || node == root) return;
    if (!node_ok(node) || nch[node] != 2) {
      bad = true;
      return;
    }
    const int c0 = child[3 * node], c1 = child[3 * node + 1];
    posterior(node, c0, c1, bl[c0], bl[c1]);
  }

  __device__ void update_for_nni(int node) {
    RoundTree::update_for_nni(node, [this](int n) { recompute_profile(n); });
  }

  // ------------------------------------------------------------- quartets
  // one quartet optimization by group g, its result into `out`
  template <class G>
  __device__ void quartet_on(const G& g, const QuartetScratch& qs, const int* r,
                             const double* len, bool star_test, QuartetResult& out) {
    double parts[3], l[5];
    for (int i = 0; i < 5; ++i) l[i] = len[i];
    int n_eval;
    const bool st = quartet_optimize<C>(g, m, qs, lim, a.tol, star_test, row(r[0]), row(r[1]),
                                        row(r[2]), row(r[3]), l, parts, n_eval, nullptr);
    if (g.tid() == 0) {
      for (int i = 0; i < 3; ++i) out.parts[i] = parts[i];
      for (int i = 0; i < 5; ++i) out.len[i] = l[i];
      out.n_eval = n_eval;
      out.star = st ? 1 : 0;
    }
  }

  // MLProfiles.quartet_optimize of n (1 or 2) quartets of store rows r[k]
  // from lengths len[k] (raised to the minimum in float64 first), side by
  // side: group k runs quartet k on its own scratch, and every thread gets
  // the searched lengths in len[k], the star decisions, and each quartet's
  // loglk summed from its parts as the host sums them; counts as the host
  // counts
  __device__ void quartets(int n, const int* const r[2], double* const len[2], bool star_test,
                           double ll[2], bool star[2]) {
    for (int k = 0; k < n; ++k)
      for (int i = 0; i < 5; ++i)
        if (len[k][i] < a.min_len) len[k][i] = a.min_len;
    const int k = group();
    __syncthreads();  // earlier readers of the results are done
    if (k == 0)
      quartet_on(HalfBlock<1>(), q[0], r[0], len[0], star_test, sh->res[0]);
    else if (k < n)
      quartet_on(HalfBlock<2>(), q[1], r[1], len[1], star_test, sh->res[1]);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const QuartetResult& o = sh->res[j];
      for (int i = 0; i < 5; ++i) len[j][i] = o.len[i];
      star[j] = o.star != 0;
      count(kQuartetOpts, 1);
      count(kEvals, o.n_eval);
      count(kPostCompute, 2);
      count(kLkCompute, 8 + (star_test ? 1 : 0));
      if (star[j]) {
        count(kLkCompute, 2);
        count(kPosteriors, 2);
        count(kSearches, 1);
        count(kPairs, 3);
        ll[j] = o.parts[0] + (o.parts[1] + o.parts[2]);
      } else {
        count(kPostCompute, 5);
        count(kLkCompute, 34);
        count(kPosteriors, 7);
        count(kSearches, 5);
        count(kPairs, 2 + (star_test ? 1 : 0));
        ll[j] = o.parts[0] + o.parts[1] + o.parts[2];
      }
    }
  }

  // ml.ml_quartet_nni (ref MLQuartetNNI tcc:4885-5004, no constraints):
  // returns the choice; crit the criteria, out the chosen quartet's lengths
  // (A, B, C, D, I in its own order)
  __device__ int quartet_nni(const int r[4], const double len[5], double crit[3], double out[5]) {
    double lab[5] = {len[kLenA], len[kLenB], len[kLenC], len[kLenD], len[kLenI]};
    double lac[5] = {len[kLenA], len[kLenC], len[kLenB], len[kLenD], len[kLenI]};
    double lad[5] = {len[kLenA], len[kLenD], len[kLenC], len[kLenB], len[kLenI]};
    const int rac[4] = {r[0], r[2], r[1], r[3]}, rad[4] = {r[0], r[3], r[2], r[1]};
    bool consider_ac = true, consider_ad = true;
    const int n_rounds = a.ml_accuracy < 2 ? 2 : a.ml_accuracy;
    crit[0] = crit[1] = crit[2] = -1e20;
    for (int it = 0; it < n_rounds; ++it) {
      bool star[2];
      double ll[2];
      {
        const int* const rs[2] = {r, r};
        double* const ls[2] = {lab, lab};
        quartets(1, rs, ls, true, ll, star);
      }
      crit[kABvsCD] = ll[0];
      if (star[0]) {
        count(kStarTests, 1);
        crit[kACvsBD] = -1e20;
        crit[kADvsBC] = -1e20;
        for (int i = 0; i < 5; ++i) out[i] = len[i];
        out[kLenI] = lab[kLenI];
        return kABvsCD;
      }
      // AC and AD are independent: side by side when both are due
      if (consider_ac && consider_ad) {
        const int* const rs[2] = {rac, rad};
        double* const ls[2] = {lac, lad};
        quartets(2, rs, ls, false, ll, star);
        crit[kACvsBD] = ll[0];
        crit[kADvsBC] = ll[1];
      } else if (consider_ac || consider_ad) {
        const int* const rs[2] = {consider_ac ? rac : rad, nullptr};
        double* const ls[2] = {consider_ac ? lac : lad, nullptr};
        quartets(1, rs, ls, false, ll, star);
        crit[consider_ac ? kACvsBD : kADvsBC] = ll[0];
      }
      if (a.ml_accuracy < 2) {
        const double close = kCloseLogLkLimit;
        if (crit[kACvsBD] < crit[kABvsCD] - close ||
            (lac[kLenI] <= 2.0 * a.min_len && crit[kACvsBD] < crit[kABvsCD]))
          consider_ac = false;
        if (crit[kADvsBC] < crit[kABvsCD] - close ||
            (lad[kLenI] <= 2.0 * a.min_len && crit[kADvsBC] < crit[kABvsCD]))
          consider_ad = false;
        if (!consider_ac && !consider_ad) break;
        if (crit[kACvsBD] > crit[kABvsCD] + close && crit[kACvsBD] > crit[kADvsBC] + close) break;
        if (crit[kADvsBC] > crit[kABvsCD] + close && crit[kADvsBC] > crit[kACvsBD] + close) break;
      }
    }
    const double* chosen = lab;
    int choice = kABvsCD;
    if (crit[kACvsBD] > crit[kABvsCD] && crit[kACvsBD] > crit[kADvsBC]) {
      choice = kACvsBD;
      chosen = lac;
    } else if (crit[kADvsBC] > crit[kABvsCD] && crit[kADvsBC] > crit[kACvsBD]) {
      choice = kADvsBC;
      chosen = lad;
    }
    for (int i = 0; i < 5; ++i) out[i] = chosen[i];
    return choice;
  }

  // one quartet of the walk (rearrange.do_nni's body with use_ml)
  __device__ void nni_node(int node) {
    int n4[4], r4[4];
    setup_abcd(node, n4, r4);
    if (bad) return;
    const int na = n4[0], nb = n4[1], nc = n4[2], nd = n4[3];
    const double len[5] = {bl[na], bl[nb], bl[nc], bl[nd], bl[node]};
    double crit[3], nl[5];
    const int choice = quartet_nni(r4, len, crit, nl);
    if (choice != kABvsCD) {
      const int moved = choice == kACvsBD ? nb : na;
      replace_child(node, moved, nc);
      replace_child(parent[node], nc, moved);
      if (bad) return;
    }
    // the lengths onto the post-swap topology (ref :5887-5917): nl is the
    // chosen quartet's (A, B, C, D, I) in its own order
    const int ib = choice == kADvsBC ? 3 : (choice == kACvsBD ? 2 : 1);
    const int ic = choice == kACvsBD ? 1 : 2;
    const int id = choice == kADvsBC ? 1 : 3;
    nni_finish(
        node, n4, choice, crit, st, max_delta,
        [&] {
          bl[node] = nl[kLenI];
          bl[na] = nl[kLenA];
          bl[nb] = nl[ib];
          bl[nc] = nl[ic];
          bl[nd] = nl[id];
          if (choice != kABvsCD) sh->ctr[kMlNni] += 1;
        },
        [this](int n) { recompute_profile(n); });
  }

  // the round (rearrange.do_nni with use_ml, not -slow)
  __device__ void nni_round() {
    nni_walk(
        trav, st, &sh->any_bad, [this](int n) { nni_node(n); },
        [this](int n) { recompute_profile(n); });
  }

  // --------------------------------------------------------- lengths pass
  // ml.optimize_all_branch_lengths for three tips or more: the temporary
  // S_TMP1 is the first of group 0's quartet temporaries, and group 0 runs
  // the line searches
  __device__ void lengths_pass() {
    float* tmp_w = q[0].temps;
    float* tmp_v = q[0].temps + m.P;
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
          const int b1 = (i + 1) % 3, b2 = (i + 2) % 3;
          posterior_to(nullptr, tmp_w, tmp_v, row(rows3[b1]), row(rows3[b2]), bl[nodes3[b1]],
                       bl[nodes3[b2]]);
          const double cur = bl[nodes3[i]];
          const double guess = cur < a.min_len ? a.min_len : cur;  // Python's max
          if (group() == 0) {
            const HalfBlock<1> g;
            float fx;
            int n;
            const float x = line_search<C>(g, m, row(rows3[i]), tmp, (float)guess, lim, q[0].eff1,
                                           q[0].eff2, q[0].rate, q[0].tab1, q[0].red, fx, n);
            if (g.tid() == 0) {
              sh->x = x;
              sh->n_eval = n;
            }
          }
          __syncthreads();
          count(kLkCompute, 8);
          count(kSearches, 1);
          count(kEvals, sh->n_eval);
          commit([&] { bl[nodes3[i]] = (double)sh->x; });
        }
      }
      if (node != root) {
        recompute_profile(node);
        commit([&] { uvalid[node] = 0; });
      }
    }
  }
};

// where a round's block keeps its pieces, in shared memory in this order:
// the tree where it fits (after group 0's pieces and the least of group
// 1's), group 0's quartet pieces as ml_quartet_opt keeps them
// (quartet_layout), then group 1's in what room is left under
// kMlRoundSmemCap; what does not fit goes to device scratch, group 0's
// first
struct RoundLayout {
  QuartetLayout q[2];
  bool tree_smem;
  size_t tree_bytes, smem, scratch_floats;
};

RoundLayout round_layout(int M, int P, int C, bool want_tree_smem) {
  const QuartetLayout q0 = quartet_layout(P, C);
  const size_t tree = tree_smem_bytes(M, 2);
  const size_t least = quartet_layout(P, C, 0).smem;
  const bool tree_smem =
      want_tree_smem && tree + q0.smem + least <= (size_t)kMlRoundSmemCap;
  const size_t used = (tree_smem ? tree : 0) + q0.smem;
  const QuartetLayout q1 =
      quartet_layout(P, C, used < (size_t)kMlRoundSmemCap ? kMlRoundSmemCap - used : 0);
  return {{q0, q1}, tree_smem, tree_smem ? tree : 0, used + q1.smem,
          q0.scratch_floats + q1.scratch_floats};
}

// the body of both kernels: stage the tree, run the NNI round or the
// lengths pass, put the tree and the counters back
template <int C>
__device__ __forceinline__ void ml_round_body(MLView m, int8_t* codes, float* W, float* V,
                                              SearchLimits lim, MlArgs args, NniStats st,
                                              bool lengths, double* bl, int32_t* g_tree,
                                              uint8_t* g_flags, int32_t* g_path, long long* g_ctr,
                                              double* g_max_delta, float* scratch,
                                              RoundLayout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ MlShared sh;
  const int tid = threadIdx.x, M = args.maxnodes;
  const TreeArrays t = stage_tree(smem, g_tree, g_path, g_flags, M, 2, L.tree_smem);
  if (tid < kMlCounters) sh.ctr[tid] = 0;
  __syncthreads();

  unsigned char* at = smem + L.tree_bytes;
  MlRound<C> b{{t.tree, t.tree + M, t.tree + 4 * M, t.flags, t.path, args.n_seqs, args.root, M,
                tid, false},
               m, codes, W, V,
               {quartet_scratch<C>(at, scratch, L.q[0].temps_smem, L.q[0].eff_smem, m.P),
                quartet_scratch<C>(at + L.q[0].smem, scratch + L.q[0].scratch_floats,
                                   L.q[1].temps_smem, L.q[1].eff_smem, m.P)},
               lim, args, bl, &sh, t.flags + M, st, 0.0};
  if (lengths) {
    b.lengths_pass();
  } else {
    if (args.n_seqs > 3) b.nni_round();
    if (tid == 0) *g_max_delta = b.max_delta;
  }
  unstage_tree(t, g_tree, M, L.tree_smem, sh.ctr, kMlCounters, kMlFault, b.bad, g_ctr);
}

#define VFT_ML_ROUND_PARAMS                                                                    \
  MLView m, int8_t *codes, float *W, float *V, SearchLimits lim, MlArgs args, NniStats st,     \
      double *bl, int32_t *g_tree, uint8_t *g_flags, int32_t *g_path, long long *g_ctr,        \
      double *g_max_delta, float *scratch, RoundLayout L

template <int C>
__global__ void __launch_bounds__(kMlRoundThreads) ml_nni_round_kernel(VFT_ML_ROUND_PARAMS) {
  ml_round_body<C>(m, codes, W, V, lim, args, st, false, bl, g_tree, g_flags, g_path, g_ctr,
                   g_max_delta, scratch, L);
}

template <int C>
__global__ void __launch_bounds__(kMlRoundThreads) ml_lengths_pass_kernel(VFT_ML_ROUND_PARAMS) {
  ml_round_body<C>(m, codes, W, V, lim, args, st, true, bl, g_tree, g_flags, g_path, g_ctr,
                   g_max_delta, scratch, L);
}

template <int C>
int round_launch(const MLView& m, int8_t* codes, float* W, float* V, const SearchLimits& lim,
                 const MlArgs& args, const NniStats& st, int lengths, double* bl, int32_t* tree,
                 uint8_t* flags, int32_t* path, long long* ctr, double* max_delta, float* scratch,
                 int smem_tree, cudaStream_t stream) {
  const RoundLayout L = round_layout(args.maxnodes, m.P, C, smem_tree != 0);
  if (L.scratch_floats > 0 && scratch == nullptr) return kBadArgs;
  if (L.smem > (size_t)kMlRoundSmemCap) return kBadArgs;
  auto kernel = lengths ? ml_lengths_pass_kernel<C> : ml_nni_round_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMlRoundSmemCap);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kMlRoundThreads, L.smem, stream>>>(m, codes, W, V, lim, args, st, bl, tree, flags,
                                                 path, ctr, max_delta, scratch, L);
  err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : 0;
}

int launch(const int8_t* codes, const float* W, const float* V, const float* code_freq,
           const float* eigenval, const float* eigeninv, const float* statinv,
           const float* rates, const int32_t* ratecat, int64_t n_rows, int P, int C, int n_pos,
           int n_rates, int jc, float min_rel_len, const SearchLimits& lim, const MlArgs& args,
           const NniStats& st, int lengths, double* bl, int32_t* tree, uint8_t* flags,
           int32_t* path, int64_t* ctr, double* max_delta, float* scratch, int smem_tree,
           void* stream) {
  if (3 * (int64_t)args.maxnodes > n_rows || args.root < args.n_seqs ||
      args.root >= args.maxnodes || args.n_seqs < 3 || st.n > args.maxnodes ||
      n_rates < 1 || n_rates > kMaxRates)
    return kBadArgs;
  const MLView m{codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat,
                 P, n_pos, n_rates, jc, min_rel_len};
  int8_t* c_out = const_cast<int8_t*>(codes);
  float* w_out = const_cast<float*>(W);
  float* v_out = const_cast<float*>(V);
  long long* c = reinterpret_cast<long long*>(ctr);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // 4 codes: the ML store takes no protein alignment yet
  // (engine/ml_profiles.py), so the 20-code kernels are not built
  if (C == 4)
    return round_launch<4>(m, c_out, w_out, v_out, lim, args, st, lengths, bl, tree, flags, path,
                           c, max_delta, scratch, smem_tree, cs);
  return kBadArgs;
}

}  // namespace

#define VFT_ML_STORE_ARGS                                                                 \
  const int8_t *codes, const float *W, const float *V, const float *code_freq,           \
      const float *eigenval, const float *eigeninv, const float *statinv,                 \
      const float *rates, const int32_t *ratecat, int64_t n_rows, int P, int C, int n_pos, \
      int n_rates, int jc, float min_rel_len
#define VFT_ML_STORE_PASS                                                               \
  codes, W, V, code_freq, eigenval, eigeninv, statinv, rates, ratecat, n_rows, P, C, n_pos, \
      n_rates, jc, min_rel_len

extern "C" {

// 1 if a round's tree (M nodes) fits in shared memory beside its quartets'
// pieces at (P, C); otherwise the round keeps it in device memory.
int vft_ml_round_tree_fits_smem(int M, int P, int C) {
  return round_layout(M, P, C, true).tree_smem ? 1 : 0;
}

// Floats of device scratch a round needs at (M, P, C) for the quartets'
// pieces that do not fit in shared memory; smem_tree as the round's.
int64_t vft_ml_round_scratch_floats(int M, int P, int C, int smem_tree) {
  return (int64_t)round_layout(M, P, C, smem_tree != 0).scratch_floats;
}

// One ML NNI round on the ML store, in place, in one launch.  The line
// searches' limits xmin, xmax, ftol, atol (float), min_len the minimum
// length as the host's float64.  The round's state on the device: tree =
// parent [M] | children [M, 3] | child counts [M] (int32), flags [2M]
// (uint8 scratch: the memo, the traversal), path [M] (int32 scratch),
// branch lengths bl [M] (double), the NNIStats age, subtree_age (int64),
// delta, support (double), [n_stats] each, read and written; ctr
// [kMlCounters] (int64, zero at the round's start, added to) and max_delta
// (double, out).  scratch: vft_ml_round_scratch_floats(M, P, C, smem_tree)
// floats, or NULL when that is 0.  smem_tree: 1 keeps the tree in shared memory where
// it fits, 0 in device memory.  Returns 0, a cudaError of the launch, or -2
// for arguments the kernel does not take.
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
// store, in place, in one launch; the state as for vft_ml_nni_round_f32,
// without the NNIStats and max_delta.
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

}  // extern "C"
