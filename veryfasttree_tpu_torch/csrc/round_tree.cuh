// The tree of a whole round in one block, shared by the minimum-evolution
// rounds (me_round.cuh: the SPR round me_spr.cu, the NNI round me_nni.cu)
// and the maximum-likelihood rounds (ml_round.cu): the tree's staging in
// shared memory, its walks (sibling, root siblings, the restartable
// postorder with revisits), the swaps, the up-profile memo's walk and
// invalidations, and an NNI round's skip set, walk and NNIStats update.
// What a profile is made of (an ME average or an ML posterior) and how a
// quartet is decided are the caller's: the memo walk, the NNI walk and the
// repairs after a swap call back into it.
//
// Every thread of the block runs the same walks on the same data.  In the
// maximum-likelihood rounds only thread 0 writes the tree, between two
// barriers (commit); the minimum-evolution rounds define
// VFT_TREE_WRITE_ALL, and there every thread makes the same writes after
// one barrier (each thread then reads its own writes, and another thread's
// are the same values).  `bad` is set by every thread alike, never inside a
// commit.  No small array is indexed by
// a value known only at run time (pick3 instead), so the arrays stay in
// registers and the kernels keep no stack frame.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "probes.cuh"

// ml_round.cu defines this as __forceinline__, so that its kernels hold the
// tree's state in registers (a member function that is not inlined takes
// its object's address, which puts the object on the stack); the ME rounds
// leave it to nvcc
#ifndef VFT_TREE_INLINE
#define VFT_TREE_INLINE
#endif

namespace {

constexpr int kBadArgs = -2;

// a[i] of a three-element array, i in [0, 3), without indexing it at run
// time
template <class T>
__device__ __forceinline__ T pick3(const T* a, int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

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
// arrays, the n_ctr counters (a fault counted in ctr[fault]) added to the
// device's
__device__ void unstage_tree(const TreeArrays& t, int32_t* g_tree, int M, bool in_smem,
                             long long* ctr, int n_ctr, int fault, bool bad, long long* g_ctr) {
  __syncthreads();
  if (in_smem)
    for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) g_tree[i] = t.tree[i];
  if (threadIdx.x == 0) {
    if (bad) ctr[fault] += 1;
    for (int k = 0; k < n_ctr; ++k) g_ctr[k] += ctr[k];
  }
}

// a round's NNIStats (rearrange.NNIStats), [n] each, in device memory
struct NniStats {
  long long* age;
  long long* subtree_age;
  double* delta;
  double* support;
  int n;             // tree.maxnode: every node of the tree lies below it
  int fast_nni;
  double min_delta;  // the support threshold: me_min_delta, or TREE_LOGLK_DELTA under ML

  __device__ VFT_TREE_INLINE bool ok(int node) const { return node >= 0 && node < n; }

  // ref tcc:5931-5971, by one thread: the entries of node after its quartet
  // (nodes n4; node's children ch0, ch1 after the swap) chose `choice` by
  // the criteria crit (higher is better); max_delta follows the deltas
  __device__ VFT_TREE_INLINE void record(int node, const int n4[4], int ch0, int ch1,
                                         int choice, const double crit[3],
                                         double& max_delta) const {
    if (choice == 0)
      age[node] += 1;
    else
      age[node] = age[n4[0]] = age[n4[1]] = age[n4[2]] = age[n4[3]] = 0;
    const double best = pick3(crit, choice);
    const double dl = best - crit[0];
    delta[node] = dl;
    if (dl > max_delta) max_delta = dl;
    // Python's min over the other two, in index order
    const int k1 = choice == 0 ? 1 : 0, k2 = choice == 2 ? 1 : 2;
    const double s1 = best - pick3(crit, k1), s2 = best - pick3(crit, k2);
    support[node] = s2 < s1 ? s2 : s1;
    if (dl > min_delta) {
      subtree_age[node] = 0;
    } else {
      subtree_age[node] += 1;
      if (subtree_age[node] > subtree_age[ch0]) subtree_age[node] = subtree_age[ch0];
      if (subtree_age[node] > subtree_age[ch1]) subtree_age[node] = subtree_age[ch1];
    }
  }
};

struct RoundTree {
  int* parent;        // [M]
  int* child;         // [M, 3]
  const int* nch;     // [M]
  uint8_t* uvalid;    // [M] up-profile memo validity
  int* path;          // [M] up-profile path to the root
  int n_seqs;
  int root;
  int maxnodes;       // M: node rows [0, M), up-profile rows M + node
  int tid;
  bool bad;           // the same in every thread
  bool dirty = false; // rows written since the last barrier (VFT_TREE_WRITE_ALL)

  // the tree's writes, after every thread has read what it needs
  template <class F>
  __device__ __forceinline__ void commit(F write) {
    ProbeScope probe(kMePCommit);
    __syncthreads();
#ifdef VFT_TREE_WRITE_ALL
    dirty = false;
    write();
#else
    if (tid == 0) write();
    __syncthreads();
#endif
  }

  // writes that thread 0 alone reads afterwards (a round's counters and
  // NNIStats): with VFT_TREE_WRITE_ALL no barrier, else a commit
  template <class F>
  __device__ __forceinline__ void commit_own(F write) {
#ifdef VFT_TREE_WRITE_ALL
    if (tid == 0) write();
#else
    commit(write);
#endif
  }

  __device__ __forceinline__ bool node_ok(int n) const { return n >= 0 && n < maxnodes; }

  __device__ VFT_TREE_INLINE int sibling(int node) {
    const int par = parent[node];
    if (par < 0 || par == root) return -1;
    for (int k = 0; k < nch[par]; ++k) {
      const int c = child[3 * par + k];
      if (c != node) return c;
    }
    bad = true;
    return -1;
  }

  // the other two children of the (3-child) root, in slot order
  __device__ VFT_TREE_INLINE void root_siblings(int node, int& s0, int& s1) {
    int n = 0;
    s0 = s1 = -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = child[3 * root + k];
      if (c != node) {
        if (n == 0) s0 = c;
        else if (n == 1) s1 = c;
        ++n;
      }
    }
    if (n != 2 || nch[root] != 3 || parent[node] != root) bad = true;
  }

  // ref replaceChild tcc:1930-1940
  __device__ VFT_TREE_INLINE void replace_child(int par, int old, int nw) {
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

  // UpProfiles.get (ref getUpProfile tcc:3382-3434): fill every invalid
  // memo entry on node's path to the root, top-down; returns its row.
  // fill(n, c, d_row, d) makes the up-profile of n (row M + n) from its
  // quartet's C and D: C its sibling (or the first other root child), D its
  // parent, whose up-profile is d_row (or the second other root child).
  template <class Fill>
  __device__ VFT_TREE_INLINE int up_get(int node, Fill fill) {
    if (!node_ok(node) || node == root || node < n_seqs) {
      bad = true;
      return maxnodes;
    }
    if (uvalid[node]) return maxnodes + node;
    int len = 0;
    {
      ProbeScope probe(kMePWalk);
#ifdef VFT_TREE_WRITE_ALL
      // every thread writes the path alike; the readers of the last path
      // read it before its last fill's commit barrier
      for (int n = node; n >= 0; n = parent[n]) {
        if (len == maxnodes) {  // a cycle
          bad = true;
          return maxnodes;
        }
        path[len] = n;
        ++len;
      }
#else
      __syncthreads();  // earlier readers of path are done
      for (int n = node; n >= 0; n = parent[n]) {
        if (len == maxnodes) {  // a cycle
          bad = true;
          return maxnodes;
        }
        if (tid == 0) path[len] = n;
        ++len;
      }
      __syncthreads();
#endif
    }
    for (int k = len - 2; k >= 0 && !bad; --k) {
      const int n = path[k];
      if (uvalid[n]) continue;
      // setupABCD(n): its parent's up-profile is valid by now
      const int par = parent[n];
      int nc, nd, d_row;
      if (par == root) {
        root_siblings(n, nc, nd);
        d_row = nd;
      } else {
        nc = sibling(n);
        nd = par;
        d_row = maxnodes + par;
        if (!uvalid[par]) bad = true;
      }
      if (nch[n] != 2 || bad) {
        bad = true;
        break;
      }
      fill(n, nc, d_row, nd);
      commit([&] { uvalid[n] = 1; });
    }
    return maxnodes + node;
  }

  // ref setupABCD tcc:1942-1974: the quartet's nodes and rows (D's row is
  // the parent's up-profile, through up_get(par, fill), unless the parent
  // is the root)
  template <class Fill>
  __device__ VFT_TREE_INLINE void setup_abcd(int node, int nodes4[4], int rows4[4], Fill fill) {
    const int par = parent[node];
    if (par < 0 || nch[node] != 2) {
      bad = true;
      return;
    }
    nodes4[0] = rows4[0] = child[3 * node];
    nodes4[1] = rows4[1] = child[3 * node + 1];
    if (par == root) {
      root_siblings(node, nodes4[2], nodes4[3]);
      rows4[2] = nodes4[2];
      rows4[3] = nodes4[3];
    } else {
      nodes4[2] = rows4[2] = sibling(node);
      nodes4[3] = par;
      rows4[3] = up_get(par, fill);
    }
  }

  // ref updateForNNI tcc:1882-1927 (not -slow): the memo entries around
  // node invalidated, then recompute(node) and recompute(its parent)
  template <class Recompute>
  __device__ VFT_TREE_INLINE void update_for_nni(int node, Recompute recompute) {
    if (!node_ok(node) || node == root) {
      bad = true;
      return;
    }
    // the node, its children, its quartet's other two (the parent and the
    // sibling, or the root's other children) and the uncle
    const int n_ch = nch[node];
    const int c0 = n_ch > 0 ? child[3 * node] : -1;
    const int c1 = n_ch > 1 ? child[3 * node + 1] : -1;
    const int c2 = n_ch > 2 ? child[3 * node + 2] : -1;
    const int par = parent[node];
    if (!node_ok(par)) {
      bad = true;
      return;
    }
    int x0, x1;
    if (par == root) {
      root_siblings(node, x0, x1);
    } else {
      x0 = par;
      x1 = sibling(node);
    }
    const int uncle = sibling(par);
    if (bad) return;
    commit([&] {
      const int ids[7] = {node, c0, c1, c2, x0, x1, uncle};
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (node_ok(ids[k])) uvalid[ids[k]] = 0;
    });
    recompute(node);
    recompute(par);
  }

  // rearrange.do_nni's end of a quartet at node (nodes n4) that chose
  // `choice` (0: no swap) by the criteria crit and has swapped: the
  // NNIStats entries, with the caller's own writes `extra` in the same
  // commit, then the profile repairs (after no swap the memo entries of A,
  // B, C and recompute(node); else updateForNNI)
  template <class Extra, class Recompute>
  __device__ VFT_TREE_INLINE void nni_finish(int node, const int n4[4], int choice,
                                             const double crit[3], const NniStats& st,
                                             double& max_delta, Extra extra, Recompute recompute) {
    const int ch0 = child[3 * node], ch1 = child[3 * node + 1];
    if (!st.ok(node) || !st.ok(n4[0]) || !st.ok(n4[1]) || !st.ok(n4[2]) || !st.ok(n4[3]) ||
        !st.ok(ch0) || !st.ok(ch1)) {
      bad = true;
      return;
    }
    commit_own([&] {
      extra();
      st.record(node, n4, ch0, ch1, choice, crit, max_delta);
    });
    if (choice == 0) {
      commit([&] { uvalid[n4[0]] = uvalid[n4[1]] = uvalid[n4[2]] = 0; });
      recompute(node);
    } else {
      update_for_nni(node, recompute);
    }
  }

  // the walk of rearrange.do_nni's round (not -slow) after the skip set: a
  // node revisited after a swap below it gets its memo entries reset and
  // recompute(node) (ref :5809-5819), every other internal node
  // visit(node)
  template <class Visit, class Recompute>
  __device__ VFT_TREE_INLINE void nni_walk(uint8_t* trav, const NniStats& st, int* any_bad,
                                           Visit visit, Recompute recompute) {
    skip_set(trav, st, any_bad);
    int node = root, climbs = 0;
    while (!bad) {
      bool up = false;
      node = next_postorder(trav, node, up, climbs);
      if (node < 0 || bad) break;
      if (node < n_seqs || node == root) continue;
      if (up) {
        commit([&] {
          for (int k = 0; k < nch[node] && k < 3; ++k)
            if (node_ok(child[3 * node + k])) uvalid[child[3 * node + k]] = 0;
          uvalid[node] = 0;
        });
        recompute(node);
      } else {
        visit(node);
      }
    }
  }

  // the fast-NNI skip set (ref tcc:6049-6075): an old, well-supported node
  // whose quartet holds no newly swapped, well-supported node is marked
  // traversed in trav, which skips it and its subtree.  One thread per
  // node; a fault goes through *any_bad (shared memory) to every thread.
  __device__ VFT_TREE_INLINE void skip_set(uint8_t* trav, const NniStats& st, int* any_bad) {
    if (tid == 0) *any_bad = 0;
    __syncthreads();
    if (st.fast_nni) {
      for (int node = tid; node < st.n; node += blockDim.x) {
        if (node == root || node < n_seqs || st.age[node] < 2 || st.subtree_age[node] < 2 ||
            !(st.support[node] > st.min_delta))
          continue;
        const int par = parent[node];
        bool fault = par < 0 || nch[node] != 2;
        int n4[4] = {-1, -1, -1, -1};
        if (!fault) {
          n4[0] = child[3 * node];
          n4[1] = child[3 * node + 1];
          if (par == root) {  // root_siblings: the first two others
            int k = 0;
#pragma unroll
            for (int s = 0; s < 3; ++s) {
              const int c = child[3 * root + s];
              if (c != node) {
                if (k == 0) n4[2] = c;
                else if (k == 1) n4[3] = c;
                ++k;
              }
            }
            fault = k < 2 || nch[root] != 3;
          } else {            // sibling, then the parent
            for (int s = 0; s < nch[par] && s < 3; ++s)
              if (child[3 * par + s] != node) {
                n4[2] = child[3 * par + s];
                break;
              }
            n4[3] = par;
          }
        }
        bool skip = !fault;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (fault) break;
          if (!st.ok(n4[k])) {
            fault = true;
          } else if (st.age[n4[k]] == 0 && st.support[n4[k]] > st.min_delta) {
            skip = false;
          }
        }
        if (fault) *any_bad = 1;
        else if (skip) trav[node] = 1;
      }
    }
    __syncthreads();
    bad = bad || *any_bad != 0;
  }

  // TreeState.traverse_postorder with want_up, one step: returns the next
  // node (up: a revisit of a traversed node) or -1 at the walk's end.  One
  // call goes up, then down, at most M steps each; `climbs` counts the
  // revisits since the last newly traversed node, at most the depth.  On a
  // tree that does not change during the walk it never revisits, and is
  // TreeState.postorder_nodes.
  __device__ VFT_TREE_INLINE int next_postorder(uint8_t* trav, int node, bool& up, int& climbs) {
    for (int steps = 0; steps <= 2 * maxnodes + 2; ++steps) {
      int next = -1;
      for (int k = 0; k < nch[node] && k < 3; ++k) {
        const int c = child[3 * node + k];
        if (!node_ok(c)) {
          bad = true;
          return -1;
        }
        if (!trav[c]) {
          next = c;
          break;
        }
      }
      if (next >= 0) {
        node = next;
        continue;
      }
      if (!trav[node]) {
        commit([&] { trav[node] = 1; });
        up = false;
        climbs = 0;
        return node;
      }
      if (node == root) return -1;
      node = parent[node];
      if (!node_ok(node)) {
        bad = true;
        return -1;
      }
      if (trav[node]) {
        up = true;
        if (++climbs > maxnodes) break;
        return node;
      }
    }
    bad = true;
    return -1;
  }
};

}  // namespace
