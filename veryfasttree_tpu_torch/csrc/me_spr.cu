// Whole SPR rounds of the minimum-evolution phase on the card (Hopper,
// sm_90a), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py, wrapper ops/spr_kernels.py).
//
// Replaces veryfasttree_tpu/engine/spr_epoch.py (_spr_node_impl :97, one
// jitted dispatch per node) and, in this port, the host loop
// engine/spr.run_spr, which launched one me_average per profile average and
// one me_dists plus a blocking fetch per chain step.  One launch runs the SPR
// of every node of the round's postorder snapshot in one block, in the host
// loop's order (ref SPR tcc:6315-6404, traverseSPR :6185-6313,
// findSPRSteps :1805-1858, unwindSPRStep :1861-1879):
//   for each node, the four chains (around its parent, then its sibling;
//   the AB-first, then the AC-first first step) until one is accepted; each
//   chain step sets up the quartet (ABCD, with the memoised up-profile of
//   the parent), takes its six corrected distances, chooses, swaps and runs
//   updateForNNI (its invalidations and two profile recomputes); the best
//   prefix is kept and the rest unwound; an accepted node clears the
//   up-profile memo and recomputes its ancestors to the root.
//
// Bound: a round must read each store row it uses once and write each row
// it changes once (node rows and up-profiles, P * (4C + 5) bytes each), and
// do each step's operations: six pair distances of 2 (C + 1) operations per
// position, an average of 4C + 6 per position.  Each step depends on the one
// before, so the work is serial in steps and parallel only over positions.
// What the design does about it: no launch and no fetch per step.  The tree
// (parent, children, child counts), the up-profile memo's validity and the
// up-profile path live in shared memory while they fit (25 bytes per node;
// past that in device memory, the same code on other pointers), the store's
// rows stay in L2, and store rows are written in place.
//
// Every thread of the block runs the same decisions on the same data (the
// tree walks read shared memory, the distances are reduced into shared
// memory); only thread 0 writes the tree, between two barriers.  Row work is
// shared: a profile average takes one thread per position, a quartet's six
// pair distances four 128-thread groups, each with the single-call kernel's
// thread-to-position mapping and reduction order (me_store.cuh), so the
// distances and rows equal the single-call kernels' bit for bit.  The
// corrected distances, criteria and BIONJ weights are double, in the host
// loop's order; this file is compiled with -fmad=false so that every double
// expression rounds as numpy's does.  No atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "me_store.cuh"

namespace {

constexpr int kSprThreads = 512;
constexpr int kSprGroups = kSprThreads / kDistThreads;
constexpr int kMaxChain = 64;                // the longest chain (max_spr_length)
constexpr int kSprSmemCap = 200 * 1024;      // dynamic shared memory a block may take
constexpr int kBadArgs = -2;

// int64 counters of a round, in the wrapper's order (ops/spr_kernels.py)
enum : int {
  kProfileOps = 0,   // nj.debug.profile_ops: 6 per corrected quartet
  kAvgOps,           // nj.debug.profile_avg_ops: node profile recomputes
  kNSpr,             // nj.debug.n_spr: accepted nodes
  kRowsAveraged,     // every averaged row, up-profiles included
  kQuartets,         // corrected quartets (four rows read each)
  kFault,            // a broken tree invariant: the round is void
  kNumCounters
};

constexpr int kQAB = 0, kQAC = 1, kQAD = 2, kQBC = 3, kQBD = 4, kQCD = 5;

struct SprArgs {
  int n_seqs;
  int maxnodes;      // M: node rows [0, M), up-profile rows M + node
  int root;
  int max_spr_len;
  int bionj;
  int logdist;
  int jc;            // Jukes-Cantor log correction (4 codes, no matrix)
  double pseudo;     // pseudo_weight
  float tol;         // f_post_total_tolerance
};

// shared scratch of the decisions
struct SprShared {
  double den[6 * kDistWarps];
  double dots[6 * kDistWarps];
  long long ctr[kNumCounters];
  int n0[kMaxChain];          // the chain's swaps (thread 0 writes)
  int n1[kMaxChain];
};

template <int C>
struct SprBlock {
  StoreView s;
  int8_t* codes;
  float* W;
  float* U;
  const double* ev;   // [C] in matrix mode, else null
  const float* et;    // [C] in matrix mode, else null
  SprArgs a;
  int* parent;        // [M]
  int* child;         // [M, 3]
  const int* nch;     // [M]
  uint8_t* uvalid;    // [M] up-profile memo validity
  int* path;          // [M] up-profile path to the root
  SprShared* sh;
  int tid;
  bool bad;           // the same in every thread

  // one thread writes, after every thread has read what it needs
  template <class F>
  __device__ __forceinline__ void commit(F write) {
    __syncthreads();
    if (tid == 0) write();
    __syncthreads();
  }

  __device__ __forceinline__ void count(int k, long long n) {
    if (tid == 0) sh->ctr[k] += n;
  }

  __device__ __forceinline__ bool node_ok(int n) const { return n >= 0 && n < a.maxnodes; }

  // ------------------------------------------------------------ the tree
  __device__ int sibling(int node) {
    const int par = parent[node];
    if (par < 0 || par == a.root) return -1;
    for (int k = 0; k < nch[par]; ++k) {
      const int c = child[3 * par + k];
      if (c != node) return c;
    }
    bad = true;
    return -1;
  }

  // the other two children of the (3-child) root, in slot order
  __device__ void root_siblings(int node, int& s0, int& s1) {
    int out[3] = {-1, -1, -1}, n = 0;
    for (int k = 0; k < 3; ++k) {
      const int c = child[3 * a.root + k];
      if (c != node) out[n++] = c;
    }
    if (n != 2 || nch[a.root] != 3 || parent[node] != a.root) bad = true;
    s0 = out[0];
    s1 = out[1];
  }

  // ref replaceChild tcc:1930-1940
  __device__ void replace_child(int par, int old, int nw) {
    if (!node_ok(par) || !node_ok(nw)) {
      bad = true;
      return;
    }
    int k = -1;
    for (int kk = 0; kk < nch[par]; ++kk)
      if (child[3 * par + kk] == old) {
        k = kk;
        break;
      }
    if (k < 0) bad = true;
    commit([&] {
      parent[nw] = par;
      if (k >= 0) child[3 * par + k] = nw;
    });
  }

  // --------------------------------------------------------- row work
  // set_from_average(t, i, j, weight): bw = 0.5 for a negative weight, the
  // kernel's float bw rounded from the double, and the 0.5 path chosen on
  // the double (ops/store_kernels.me_average)
  __device__ void average(int t, int i, int j, double weight) {
    const double bw = weight < 0.0 ? 0.5 : weight;
    const float bwf = __double2float_rn(bw);
    const float omb = __fsub_rn(1.0f, bwf);
    const float fallback = (float)(1.0 / C);
    for (int p = tid; p < s.P; p += kSprThreads)
      average_pos<C>(s, codes, W, U, et, t, i, j, p, bwf, omb, bw == 0.5, a.tol, fallback);
    __syncthreads();
    count(kRowsAveraged, 1);
  }

  // (dist, denom) of the six pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) of
  // four rows, as me_pair_dist_kernel computes each
  __device__ void dist6(const int r[4], double dist[6], double den[6]) {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {1, 2, 3, 2, 3, 3};
    const int g = tid / kDistThreads, t = tid % kDistThreads;
    for (int k = g; k < 6; k += kSprGroups) {
      double dn, dt;
      pair_partial<C>(s, r[pi[k]], r[pj[k]], nullptr, nullptr, ev, t, dn, dt);
      if ((t & 31) == 0) {
        sh->den[k * kDistWarps + (t >> 5)] = dn;
        sh->dots[k * kDistWarps + (t >> 5)] = dt;
      }
    }
    __syncthreads();
    for (int k = 0; k < 6; ++k)
      pair_finish(sh->den + k * kDistWarps, sh->dots + k * kDistWarps, ev, dist[k], den[k]);
    __syncthreads();
  }

  // nj.log_corrected (ref logCorrect tcc:322-330), numpy's order
  __device__ double log_corr(double d) const {
    const double maxscore = 3.0;
    double out;
    if (a.jc) {
      const double m = d < 0.7399 ? d : 0.7399;
      out = d < 0.74 ? -0.75 * log1p((-m) * 4.0 / 3.0) : maxscore;
    } else {
      const double m = d < 0.9899 ? d : 0.9899;
      out = d < 0.99 ? -1.3 * log1p(-m) : maxscore;
    }
    return out < maxscore ? out : maxscore;
  }

  // rearrange.corrected_pair_distances over four rows (ref
  // correctedPairDistances tcc:1460-1488); six-term sums left to right, as
  // numpy sums six elements
  __device__ void corrected6(const int r[4], double d[6]) {
    double w[6];
    dist6(r, d, w);
    count(kProfileOps, 6);
    count(kQuartets, 1);
    for (int k = 0; k < 6; ++k) w[k] = w[k] > 0.0 ? w[k] : 0.01;
    if (a.pseudo > 0.0) {
      double bottom = w[0], top = d[0] * w[0];
      for (int k = 1; k < 6; ++k) {
        bottom = bottom + w[k];
        top = top + d[k] * w[k];
      }
      const double prior = bottom > 0.01 ? top / bottom : 3.0;
      for (int k = 0; k < 6; ++k) d[k] = (d[k] * w[k] + prior * a.pseudo) / (w[k] + a.pseudo);
    }
    if (a.logdist)
      for (int k = 0; k < 6; ++k) d[k] = log_corr(d[k]);
  }

  // BIONJ-ish profile weight (ref quartetWeight tcc:3541-3561); -1 when
  // -bionj is off
  __device__ double quartet_weight(const int r[4]) {
    if (!a.bionj) return -1.0;
    double d[6];
    corrected6(r, d);
    if (d[kQAB] < 0.01) return -1.0;
    double w = 0.5 + ((d[kQBC] + d[kQBD]) - (d[kQAC] + d[kQAD])) / (4.0 * d[kQAB]);
    w = 0.0 > w ? 0.0 : w;  // Python's min(max(w, 0.0), 1.0)
    return 1.0 < w ? 1.0 : w;
  }

  // --------------------------------------------------------- up-profiles
  // UpProfiles.get (ref getUpProfile tcc:3382-3434): fill every invalid
  // memo entry on node's path to the root, top-down; returns its row
  __device__ int up_get(int node) {
    if (!node_ok(node) || node == a.root || node < a.n_seqs) {
      bad = true;
      return a.maxnodes;
    }
    if (uvalid[node]) return a.maxnodes + node;
    __syncthreads();  // earlier readers of path are done
    int len = 0;
    for (int n = node; n >= 0; n = parent[n]) {
      if (len == a.maxnodes) {  // a cycle
        bad = true;
        return a.maxnodes;
      }
      if (tid == 0) path[len] = n;
      ++len;
    }
    __syncthreads();
    for (int k = len - 2; k >= 0 && !bad; --k) {
      const int n = path[k];
      if (uvalid[n]) continue;
      // setupABCD(n): its parent's up-profile is valid by now
      const int par = parent[n];
      const int na = child[3 * n], nb = child[3 * n + 1];
      int nc, d_row;
      if (par == a.root) {
        root_siblings(n, nc, d_row);
      } else {
        nc = sibling(n);
        d_row = a.maxnodes + par;
        if (!uvalid[par]) bad = true;
      }
      if (nch[n] != 2 || bad) {
        bad = true;
        break;
      }
      // BIONJ weight from the CDAB-ordered quartet (ref tcc:3421-3428)
      const int r4[4] = {nc, d_row, na, nb};
      const double w = quartet_weight(r4);
      average(a.maxnodes + n, nc, d_row, w);
      commit([&] { uvalid[n] = 1; });
    }
    return a.maxnodes + node;
  }

  // ref setupABCD tcc:1942-1974: the quartet's nodes and rows (D's row is
  // the parent's up-profile unless the parent is the root)
  __device__ void setup_abcd(int node, int nodes4[4], int rows4[4]) {
    const int par = parent[node];
    if (par < 0 || nch[node] != 2) {
      bad = true;
      return;
    }
    nodes4[0] = rows4[0] = child[3 * node];
    nodes4[1] = rows4[1] = child[3 * node + 1];
    if (par == a.root) {
      root_siblings(node, nodes4[2], nodes4[3]);
      rows4[2] = nodes4[2];
      rows4[3] = nodes4[3];
    } else {
      nodes4[2] = rows4[2] = sibling(node);
      nodes4[3] = par;
      rows4[3] = up_get(par);
    }
  }

  // ------------------------------------------------------ profile repairs
  // ref recomputeProfile tcc:3436-3472 (ME)
  __device__ void recompute_profile(int node) {
    if (node < a.n_seqs || node == a.root) return;
    if (!node_ok(node) || nch[node] != 2) {
      bad = true;
      return;
    }
    const int c0 = child[3 * node], c1 = child[3 * node + 1];
    double w = -1.0;
    if (a.bionj) {
      int nodes4[4], rows4[4];
      setup_abcd(node, nodes4, rows4);
      if (bad) return;
      w = quartet_weight(rows4);
    }
    average(node, c0, c1, w);
    count(kAvgOps, 1);
  }

  // ref updateForNNI tcc:1882-1927 (not -slow)
  __device__ void update_for_nni(int node) {
    if (!node_ok(node) || node == a.root) {
      bad = true;
      return;
    }
    int ids[8], n = 0;
    ids[n++] = node;
    for (int k = 0; k < nch[node] && k < 3; ++k) ids[n++] = child[3 * node + k];
    const int par = parent[node];
    if (!node_ok(par)) {
      bad = true;
      return;
    }
    if (par == a.root) {
      root_siblings(node, ids[n], ids[n + 1]);
    } else {
      ids[n] = par;
      ids[n + 1] = sibling(node);
    }
    n += 2;
    const int uncle = sibling(par);
    if (uncle >= 0) ids[n++] = uncle;
    if (bad) return;
    commit([&] {
      for (int k = 0; k < n; ++k)
        if (node_ok(ids[k])) uvalid[ids[k]] = 0;
    });
    recompute_profile(node);
    recompute_profile(par);
  }

  // ----------------------------------------------------------------- SPR
  // ref findSPRSteps tcc:1805-1858 with the best prefix (the first minimum
  // of the running sum of deltas); returns the chain's length, its swaps
  // in sh->n0 / sh->n1
  __device__ int find_spr_steps(int node_move, int around, bool first_ac, int& best) {
    double d_tot = 0.0, d_min = 0.0;
    best = -1;
    int n_steps = 0;
    for (int i = 0; i < a.max_spr_len && !bad; ++i) {
      if (!node_ok(around) || nch[around] != 2) break;
      int nodes4[4], rows4[4];
      setup_abcd(around, nodes4, rows4);
      if (bad) break;
      double d[6];
      corrected6(rows4, d);
      const double crit_ab = d[kQAB] + d[kQCD], crit_ac = d[kQAC] + d[kQBD],
                   crit_ad = d[kQAD] + d[kQBC];
      // the first step's direction is given; then the better of AC and AD
      const bool swap_bc = i == 0 ? first_ac : crit_ac < crit_ad;
      const int n0 = swap_bc ? nodes4[1] : nodes4[0], n1 = nodes4[2];
      const double delta = swap_bc ? crit_ac - crit_ab : crit_ad - crit_ab;
      if (tid == 0) {
        sh->n0[i] = n0;
        sh->n1[i] = n1;
      }
      n_steps = i + 1;
      d_tot = d_tot + delta;
      if (d_tot < d_min) {
        d_min = d_tot;
        best = i;
      }
      replace_child(around, n0, n1);
      replace_child(parent[around], n1, n0);
      update_for_nni(around);
      if (bad) break;

      const int pm = parent[node_move];
      int na0, na1;
      if (pm == a.root) {
        root_siblings(node_move, na0, na1);
      } else {
        na0 = pm;
        na1 = sibling(node_move);
      }
      if ((na0 != around && na1 != around) || na0 == na1) bad = true;
      around = na0 == around ? na1 : na0;
    }
    return n_steps;
  }

  // ref unwindSPRStep tcc:1861-1879
  __device__ void unwind_spr_step(int n0, int n1) {
    if (!node_ok(n0) || !node_ok(n1)) {
      bad = true;
      return;
    }
    const int p0 = parent[n0], p1 = parent[n1];
    if (p0 < 0 || p1 < 0 || p0 == p1) {
      bad = true;
      return;
    }
    replace_child(p0, n0, n1);
    replace_child(p1, n1, n0);
    int younger = p0;
    if (parent[p0] != p1) {
      if (parent[p1] != p0) bad = true;
      younger = p1;
    }
    update_for_nni(younger);
  }

  // one node of the round (ref traverseSPR tcc:6185-6313 body)
  __device__ void spr_node(int node) {
    if (!node_ok(node)) {
      bad = true;
      return;
    }
    if (node == a.root) return;
    const int par = parent[node];
    int around[2];
    if (par == a.root) {
      root_siblings(node, around[0], around[1]);
    } else {
      around[0] = par;
      around[1] = sibling(node);
    }
    bool changed = false;
    for (int ia = 0; ia < 2 && !changed && !bad; ++ia) {
      for (int ac = 0; ac < 2 && !changed && !bad; ++ac) {
        int best;
        const int n_steps = find_spr_steps(node, around[ia], ac == 1, best);
        __syncthreads();  // the chain's swaps are in shared memory
        for (int ic = n_steps - 1; ic > best && !bad; --ic)
          unwind_spr_step(sh->n0[ic], sh->n1[ic]);
        changed = best >= 0;
      }
    }
    if (!changed || bad) return;
    count(kNSpr, 1);
    __syncthreads();
    for (int i = tid; i < a.maxnodes; i += kSprThreads) uvalid[i] = 0;
    __syncthreads();
    for (int anc = parent[node]; anc >= 0 && !bad; anc = parent[anc]) recompute_profile(anc);
  }
};

// tree (parent M, children 3M, child counts M), path M, then the memo M
size_t tree_smem_bytes(int M) { return ((size_t)6 * M * sizeof(int) + M + 15) / 16 * 16; }

template <int C>
__global__ void __launch_bounds__(kSprThreads) me_spr_round_kernel(
    StoreView s, int8_t* codes, float* W, float* U, const double* ev, const float* et,
    SprArgs args, const int32_t* nodes, int n_nodes, int32_t* g_tree, uint8_t* g_uvalid,
    int32_t* g_path, long long* g_ctr, int tree_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ SprShared sh;
  const int tid = threadIdx.x, M = args.maxnodes;
  int* tree = g_tree;
  uint8_t* uvalid = g_uvalid;
  int* path = g_path;
  if (tree_in_smem) {
    tree = reinterpret_cast<int*>(smem);
    path = tree + 5 * M;
    uvalid = reinterpret_cast<uint8_t*>(path + M);
    for (int i = tid; i < 5 * M; i += kSprThreads) tree[i] = g_tree[i];
    for (int i = tid; i < M; i += kSprThreads) uvalid[i] = g_uvalid[i];
  }
  if (tid < kNumCounters) sh.ctr[tid] = 0;
  __syncthreads();

  SprBlock<C> b{s,    codes,    W,        U,    ev,   et,  args, tree, tree + M,
                tree + 4 * M, uvalid, path, &sh, tid, false};
  for (int k = 0; k < n_nodes && !b.bad; ++k) b.spr_node(nodes[k]);
  __syncthreads();

  if (tree_in_smem) {
    for (int i = tid; i < 4 * M; i += kSprThreads) g_tree[i] = tree[i];
    for (int i = tid; i < M; i += kSprThreads) g_uvalid[i] = uvalid[i];
  }
  if (tid == 0) {
    if (b.bad) sh.ctr[kFault] += 1;
    for (int k = 0; k < kNumCounters; ++k) g_ctr[k] += sh.ctr[k];
  }
}

template <int C>
int spr_launch(const StoreView& s, int8_t* codes, float* W, float* U, const double* ev,
               const float* et, const SprArgs& args, const int32_t* nodes, int n_nodes,
               int32_t* tree, uint8_t* uvalid, int32_t* path, long long* ctr, int smem_tree,
               cudaStream_t st) {
  const size_t smem = tree_smem_bytes(args.maxnodes);
  const int in_smem = smem_tree && smem <= (size_t)kSprSmemCap;
  cudaError_t err = cudaFuncSetAttribute(me_spr_round_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSprSmemCap);
  if (err != cudaSuccess) return (int)err;
  me_spr_round_kernel<C><<<1, kSprThreads, in_smem ? smem : 0, st>>>(
      s, codes, W, U, ev, et, args, nodes, n_nodes, tree, uvalid, path, ctr, in_smem);
  err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : 0;
}

}  // namespace

extern "C" {

// SPR of nodes[0 .. n_nodes) (device int32), in order, on an n_rows-row
// store, in place, in one launch.  The round's state on the device: tree =
// parent [M] | children [M, 3] | child counts [M] (int32), uvalid [M]
// (uint8, zero at the round's start), path [M] (int32 scratch) and ctr
// [kNumCounters] (int64, zero at the round's start, added to).
// ev: [C] eigenvalues (double) and et: [C] eigentotals (float) in matrix
// mode, NULL in %different mode.  smem_tree: 1 keeps the tree in shared
// memory where it fits, 0 in device memory (the layout of large trees).
// Returns 0, a cudaError of the launch, or -2 for arguments the kernel does
// not take.
int vft_me_spr_round_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                         int64_t n_rows, int64_t leaf_rows, int P, int C, const double* ev,
                         const float* et, float tol, int n_seqs, int maxnodes, int root,
                         int max_spr_len, int bionj, int logdist, int jc, double pseudo,
                         const int32_t* nodes, int n_nodes, int32_t* tree, uint8_t* uvalid,
                         int32_t* path, int64_t* ctr, int smem_tree, void* stream) {
  if (max_spr_len < 0 || max_spr_len > kMaxChain || 2 * (int64_t)maxnodes > n_rows ||
      leaf_rows > n_seqs || root < n_seqs || root >= maxnodes)
    return kBadArgs;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  const SprArgs args{n_seqs, maxnodes, root, max_spr_len, bionj, logdist, jc, pseudo, tol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* c = reinterpret_cast<long long*>(ctr);
  if (C == 4) return spr_launch<4>(s, codes, W, U, ev, et, args, nodes, n_nodes, tree, uvalid,
                                   path, c, smem_tree, st);
  if (C == 20) return spr_launch<20>(s, codes, W, U, ev, et, args, nodes, n_nodes, tree, uvalid,
                                     path, c, smem_tree, st);
  return kBadArgs;
}

}  // extern "C"
