// The machinery of a whole minimum-evolution round in one block, shared by
// the SPR round (me_spr.cu) and the NNI round (me_nni.cu): the round's
// arguments and shared scratch, its counters, the tree walks, the row work
// (profile averages and quartet distances with the single-call kernels'
// bodies of me_store.cuh), the corrected distances, the up-profile memo and
// the profile repairs after a swap.
//
// Every thread of the block runs the same decisions on the same data (the
// tree walks read shared memory, the distances are reduced into shared
// memory); only thread 0 writes the tree, between two barriers.  `bad` is
// set by every thread alike, never inside a commit.  A profile average takes
// one thread per position, a quartet's six pair distances four 128-thread
// groups, each with the single-call kernel's thread-to-position mapping and
// reduction order, so the distances and rows equal the single-call kernels'
// bit for bit.  The corrected distances, criteria and BIONJ weights are
// double, in the host loop's order; the files that include this one are
// compiled with -fmad=false so that every double expression rounds as
// numpy's does.  No atomics.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "me_store.cuh"

namespace {

constexpr int kRoundThreads = 512;
constexpr int kRoundGroups = kRoundThreads / kDistThreads;
constexpr int kRoundSmemCap = 200 * 1024;    // dynamic shared memory a block may take
constexpr int kBadArgs = -2;

// int64 counters of a round, in the wrappers' order (ops/me_round.py)
enum : int {
  kProfileOps = 0,   // nj.debug.profile_ops: 6 per corrected quartet
  kAvgOps,           // nj.debug.profile_avg_ops: node profile recomputes
  kMoves,            // nj.debug.n_spr (accepted nodes) or n_nni (swaps)
  kRowsAveraged,     // every averaged row, up-profiles included
  kQuartets,         // corrected quartets (four rows read each)
  kFault,            // a broken tree invariant: the round is void
  kNumCounters
};

constexpr int kQAB = 0, kQAC = 1, kQAD = 2, kQBC = 3, kQBD = 4, kQCD = 5;

struct RoundArgs {
  int n_seqs;
  int maxnodes;      // M: node rows [0, M), up-profile rows M + node
  int root;
  int bionj;
  int logdist;
  int jc;            // Jukes-Cantor log correction (4 codes, no matrix)
  double pseudo;     // pseudo_weight
  float tol;         // f_post_total_tolerance
};

// shared scratch of the decisions
struct RoundShared {
  double den[6 * kDistWarps];
  double dots[6 * kDistWarps];
  long long ctr[kNumCounters];
  int any_bad;       // set by whichever thread finds a fault in a parallel pass
};

// the round's tree (parent [M] | children [M, 3] | child counts [M]), the
// up-profile path scratch [M] and n_flags byte arrays [M] (zeroed), in
// shared memory where they fit (copied from the device arrays) or in place
size_t tree_smem_bytes(int M, int n_flags) {
  return ((size_t)6 * M * sizeof(int) + (size_t)n_flags * M + 15) / 16 * 16;
}

struct TreeArrays {
  int* tree;
  int* path;
  uint8_t* flags;
};

__device__ TreeArrays stage_tree(unsigned char* smem, int32_t* g_tree, int32_t* g_path,
                                 uint8_t* g_flags, int M, int n_flags, bool in_smem) {
  TreeArrays t{g_tree, g_path, g_flags};
  if (in_smem) {
    t.tree = reinterpret_cast<int*>(smem);
    t.path = t.tree + 5 * M;
    t.flags = reinterpret_cast<uint8_t*>(t.path + M);
    for (int i = threadIdx.x; i < 5 * M; i += blockDim.x) t.tree[i] = g_tree[i];
  }
  for (int i = threadIdx.x; i < n_flags * M; i += blockDim.x) t.flags[i] = 0;
  return t;
}

// the round's end: the tree (parent and children) back to the device
// arrays, the counters added to the device's
__device__ void unstage_tree(const TreeArrays& t, int32_t* g_tree, int M, bool in_smem,
                             RoundShared& sh, bool bad, long long* g_ctr) {
  __syncthreads();
  if (in_smem)
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) g_tree[i] = t.tree[i];
  if (threadIdx.x == 0) {
    if (bad) sh.ctr[kFault] += 1;
    for (int k = 0; k < kNumCounters; ++k) g_ctr[k] += sh.ctr[k];
  }
}

template <int C>
struct MeRound {
  StoreView s;
  int8_t* codes;
  float* W;
  float* U;
  const double* ev;   // [C] in matrix mode, else null
  const float* et;    // [C] in matrix mode, else null
  RoundArgs a;
  int* parent;        // [M]
  int* child;         // [M, 3]
  const int* nch;     // [M]
  uint8_t* uvalid;    // [M] up-profile memo validity
  int* path;          // [M] up-profile path to the root
  RoundShared* sh;
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
    for (int p = tid; p < s.P; p += kRoundThreads)
      average_pos<C>(s, codes, W, U, et, t, i, j, p, bwf, omb, bw == 0.5, a.tol, fallback);
    __syncthreads();
    count(kRowsAveraged, 1);
  }

  // (dist, denom) of the six pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) of
  // four rows, as me_pair_dist_kernel computes each
  __device__ void dist6(const int r[4], double dist[6], double den[6]) {
    const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {1, 2, 3, 2, 3, 3};
    const int g = tid / kDistThreads, t = tid % kDistThreads;
    for (int k = g; k < 6; k += kRoundGroups) {
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
};

}  // namespace
