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
// What the design does about it: no launch and no fetch per step, and as
// few waits per step as the bits allow.  The tree (parent, children, child
// counts), the up-profile memo's validity and the up-profile path live in
// shared memory while they fit (25 bytes per node; past that in device
// memory, the same code on other pointers), the store's rows stay in L2,
// and store rows are written in place.  Every walk is inlined, so the
// round's state stays in registers (no stack frame: a local-memory access
// missed L1 behind the streaming rows); a quartet's six distances take one
// pass and one barrier, every thread writes the tree after one barrier,
// and the averages need none of their own (me_round.cuh).  A ring of the
// averaged rows in the shared memory beside the tree was measured slower
// (a tag check before every load) and is not kept.  The tree walks are
// round_tree.cuh's, the row work and profile repairs me_round.cuh's, shared
// with the NNI round (me_nni.cu).

// With VFT_ROUND_CONS defined (me_spr_cons.cu) this file compiles the
// round under -constraints instead: me_spr_round_cons_kernel and the entry
// vft_me_spr_round_cons_f32, in a translation unit of its own.

// every tree walk inlined (the round's state in registers, no stack
// frame), and every thread makes the tree's writes (round_tree.cuh)
#define VFT_TREE_INLINE __forceinline__
#define VFT_TREE_WRITE_ALL
#include "me_round.cuh"

namespace {

constexpr int kMaxChain = 64;                // the longest chain (max_spr_length)

template <int C, bool Cons = false>
struct SprBlock : MeRound<C, Cons> {
  using B = MeRound<C, Cons>;
  using B::a;
  using B::bad;
  using B::nch;
  using B::node_ok;
  using B::parent;
  using B::root_siblings;
  using B::sibling;
  using B::tid;
  using B::uvalid;

  int max_spr_len;
  int* n0;            // [kMaxChain] the chain's swaps (every thread writes alike)
  int* n1;

  // ref findSPRSteps tcc:1805-1858 with the best prefix (the first minimum
  // of the running sum of deltas); returns the chain's length, its swaps
  // in n0 / n1
  __device__ __forceinline__ int find_spr_steps(int node_move, int around, bool first_ac,
                                                int& best) {
    double d_tot = 0.0, d_min = 0.0;
    best = -1;
    int n_steps = 0;
    for (int i = 0; i < max_spr_len && !bad; ++i) {
      if (!node_ok(around) || nch[around] != 2) break;
      int nodes4[4], rows4[4];
      this->setup_abcd(around, nodes4, rows4);
      if (bad) break;
      double d[6];
      this->corrected6(rows4, d);
      double crit[3] = {d[kQAB] + d[kQCD], d[kQAC] + d[kQBD], d[kQAD] + d[kQBC]};
      this->add_penalties(nodes4, crit);
      const double crit_ab = crit[0], crit_ac = crit[1], crit_ad = crit[2];
      // the first step's direction is given; then the better of AC and AD
      const bool swap_bc = i == 0 ? first_ac : crit_ac < crit_ad;
      const int m0 = swap_bc ? nodes4[1] : nodes4[0], m1 = nodes4[2];
      const double delta = swap_bc ? crit_ac - crit_ab : crit_ad - crit_ab;
      n0[i] = m0;
      n1[i] = m1;
      n_steps = i + 1;
      d_tot = d_tot + delta;
      if (d_tot < d_min) {
        d_min = d_tot;
        best = i;
      }
      this->replace_child(around, m0, m1);
      this->replace_child(parent[around], m1, m0);
      this->update_for_nni(around);
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
  __device__ __forceinline__ void unwind_spr_step(int m0, int m1) {
    if (!node_ok(m0) || !node_ok(m1)) {
      bad = true;
      return;
    }
    const int p0 = parent[m0], p1 = parent[m1];
    if (p0 < 0 || p1 < 0 || p0 == p1) {
      bad = true;
      return;
    }
    this->replace_child(p0, m0, m1);
    this->replace_child(p1, m1, m0);
    int younger = p0;
    if (parent[p0] != p1) {
      if (parent[p1] != p0) bad = true;
      younger = p1;
    }
    this->update_for_nni(younger);
  }

  // one node of the round (ref traverseSPR tcc:6185-6313 body)
  __device__ __forceinline__ void spr_node(int node) {
    if (!node_ok(node)) {
      bad = true;
      return;
    }
    if (node == a.root) return;
    const int par = parent[node];
    int around0, around1;
    if (par == a.root) {
      root_siblings(node, around0, around1);
    } else {
      around0 = par;
      around1 = sibling(node);
    }
    bool changed = false;
    for (int ia = 0; ia < 2 && !changed && !bad; ++ia) {
      for (int ac = 0; ac < 2 && !changed && !bad; ++ac) {
        int best;
        const int n_steps = find_spr_steps(node, ia == 0 ? around0 : around1, ac == 1, best);
        // each thread reads the chain's swaps it wrote itself
        ProbeOuter probe(kMePUnwind);
        for (int ic = n_steps - 1; ic > best && !bad; --ic) unwind_spr_step(n0[ic], n1[ic]);
        changed = best >= 0;
      }
    }
    if (!changed || bad) return;
    ProbeOuter probe(kMePAncestors);
    this->count(kMoves, 1);
    __syncthreads();
    for (int i = tid; i < a.maxnodes; i += kRoundThreads) uvalid[i] = 0;
    __syncthreads();
    for (int anc = parent[node]; anc >= 0 && !bad; anc = parent[anc]) this->recompute_profile(anc);
  }
};

// the round's block (the kernels' body): con the counts under Cons
template <int C, bool Cons>
__device__ __forceinline__ void spr_round_block(StoreView s, int8_t* codes, float* W, float* U,
                                                const double* ev, const float* et,
                                                const RoundArgs& args, int max_spr_len,
                                                const int32_t* nodes, int n_nodes,
                                                int32_t* g_tree, uint8_t* g_uvalid,
                                                int32_t* g_path, long long* g_ctr,
                                                int tree_in_smem, const ConView& con) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoundShared sh;
  __shared__ int n0[kMaxChain], n1[kMaxChain];
  const int tid = threadIdx.x, M = args.maxnodes;
  const TreeArrays t = stage_tree(smem, g_tree, g_path, g_uvalid, M, 1, tree_in_smem);
  if (tid < kNumCounters) sh.ctr[tid] = 0;
  __syncthreads();

  SprBlock<C, Cons> b{{{t.tree, t.tree + M, t.tree + 4 * M, t.flags, t.path, args.n_seqs,
                        args.root, M, tid, false},
                       s, codes, W, U, ev, et, args, &sh},
                      max_spr_len, n0, n1};
  if constexpr (Cons) b.con = con;
  probe_begin(kMePDecide);
  for (int k = 0; k < n_nodes && !b.bad; ++k) b.spr_node(nodes[k]);
  probe_end();
  unstage_tree(t, g_tree, M, tree_in_smem, sh.ctr, kNumCounters, kFault, b.bad, g_ctr);
}

#ifndef VFT_ROUND_CONS
template <int C>
__global__ void __launch_bounds__(kRoundThreads) me_spr_round_kernel(
    StoreView s, int8_t* codes, float* W, float* U, const double* ev, const float* et,
    RoundArgs args, int max_spr_len, const int32_t* nodes, int n_nodes, int32_t* g_tree,
    uint8_t* g_uvalid, int32_t* g_path, long long* g_ctr, int tree_in_smem) {
  spr_round_block<C, false>(s, codes, W, U, ev, et, args, max_spr_len, nodes, n_nodes, g_tree,
                            g_uvalid, g_path, g_ctr, tree_in_smem, ConView{});
}
#define VFT_SPR_KERNEL me_spr_round_kernel
#define VFT_SPR_CONS_ARG
#else
// the round under -constraints: the quartet penalties in the chains'
// criteria and the recomputed profiles' counts (MeRound's Cons)
template <int C>
__global__ void __launch_bounds__(kRoundThreads) me_spr_round_cons_kernel(
    StoreView s, int8_t* codes, float* W, float* U, const double* ev, const float* et,
    RoundArgs args, int max_spr_len, const int32_t* nodes, int n_nodes, int32_t* g_tree,
    uint8_t* g_uvalid, int32_t* g_path, long long* g_ctr, int tree_in_smem, ConView con) {
  spr_round_block<C, true>(s, codes, W, U, ev, et, args, max_spr_len, nodes, n_nodes, g_tree,
                           g_uvalid, g_path, g_ctr, tree_in_smem, con);
}
#define VFT_SPR_KERNEL me_spr_round_cons_kernel
#define VFT_SPR_CONS_ARG , con
#endif

template <int C>
int spr_launch(const StoreView& s, int8_t* codes, float* W, float* U, const double* ev,
               const float* et, const RoundArgs& args, int max_spr_len, const int32_t* nodes,
               int n_nodes, int32_t* tree, uint8_t* uvalid, int32_t* path, long long* ctr,
               int smem_tree, const ConView& con, cudaStream_t st) {
  const size_t smem = tree_smem_bytes(args.maxnodes, 1);
  const int in_smem = smem_tree && smem <= (size_t)kRoundSmemCap;
  cudaError_t err = cudaFuncSetAttribute(VFT_SPR_KERNEL<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRoundSmemCap);
  if (err != cudaSuccess) return (int)err;
  VFT_SPR_KERNEL<C><<<1, kRoundThreads, in_smem ? smem : 0, st>>>(
      s, codes, W, U, ev, et, args, max_spr_len, nodes, n_nodes, tree, uvalid, path, ctr,
      in_smem VFT_SPR_CONS_ARG);
  err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : 0;
}

// the entries' body: the checks, then the launch (con: the counts of a
// constrained round)
int entry(int8_t* codes, float* W, float* U, const float* code_freq, int64_t n_rows,
          int64_t leaf_rows, int P, int C, const double* ev, const float* et, float tol,
          int n_seqs, int maxnodes, int root, int bionj, int logdist, int jc, double pseudo,
          int max_spr_len, const int32_t* nodes, int n_nodes, int32_t* tree, uint8_t* uvalid,
          int32_t* path, int64_t* ctr, int smem_tree, const ConView& con, void* stream) {
  if (max_spr_len < 0 || max_spr_len > kMaxChain || 2 * (int64_t)maxnodes > n_rows ||
      leaf_rows > n_seqs || root < n_seqs || root >= maxnodes)
    return kBadArgs;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  const RoundArgs args{n_seqs, maxnodes, root, bionj, logdist, jc, pseudo, tol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* c = reinterpret_cast<long long*>(ctr);
  if (C == 4)
    return spr_launch<4>(s, codes, W, U, ev, et, args, max_spr_len, nodes, n_nodes, tree,
                         uvalid, path, c, smem_tree, con, st);
  if (C == 20)
    return spr_launch<20>(s, codes, W, U, ev, et, args, max_spr_len, nodes, n_nodes, tree,
                          uvalid, path, c, smem_tree, con, st);
  return kBadArgs;
}

}  // namespace

extern "C" {

#ifndef VFT_ROUND_CONS
// SPR of nodes[0 .. n_nodes) (device int32), in order, on an n_rows-row
// store, in place, in one launch.  The round's state on the device: tree =
// parent [M] | children [M, 3] | child counts [M] (int32), uvalid [M]
// (uint8 scratch), path [M] (int32 scratch) and ctr [kNumCounters] (int64,
// zero at the round's start, added to).  ev: [C] eigenvalues (double) and
// et: [C] eigentotals (float) in matrix mode, NULL in %different mode.
// smem_tree: 1 keeps the tree in shared memory where it fits, 0 in device
// memory (the layout of large trees).  Returns 0, a cudaError of the launch,
// or -2 for arguments the kernel does not take.
int vft_me_spr_round_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                         int64_t n_rows, int64_t leaf_rows, int P, int C, const double* ev,
                         const float* et, float tol, int n_seqs, int maxnodes, int root,
                         int bionj, int logdist, int jc, double pseudo, int max_spr_len,
                         const int32_t* nodes, int n_nodes, int32_t* tree, uint8_t* uvalid,
                         int32_t* path, int64_t* ctr, int smem_tree, void* stream) {
  return entry(codes, W, U, code_freq, n_rows, leaf_rows, P, C, ev, et, tol, n_seqs, maxnodes,
               root, bionj, logdist, jc, pseudo, max_spr_len, nodes, n_nodes, tree, uvalid, path,
               ctr, smem_tree, ConView{}, stream);
}
#else
// The same round under -constraints (me_spr_round_cons_kernel): con_on,
// con_off the counts, int32 [maxnodes, n_cons] on the device, read and
// written (n_cons >= 1); con_weight constraint_weight.
int vft_me_spr_round_cons_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                              int64_t n_rows, int64_t leaf_rows, int P, int C, const double* ev,
                              const float* et, float tol, int n_seqs, int maxnodes, int root,
                              int bionj, int logdist, int jc, double pseudo, int max_spr_len,
                              const int32_t* nodes, int n_nodes, int32_t* tree, uint8_t* uvalid,
                              int32_t* path, int64_t* ctr, int smem_tree, int32_t* con_on,
                              int32_t* con_off, int n_cons, double con_weight, void* stream) {
  if (n_cons < 1 || con_on == nullptr || con_off == nullptr) return kBadArgs;
  return entry(codes, W, U, code_freq, n_rows, leaf_rows, P, C, ev, et, tol, n_seqs, maxnodes,
               root, bionj, logdist, jc, pseudo, max_spr_len, nodes, n_nodes, tree, uvalid, path,
               ctr, smem_tree, ConView{con_on, con_off, n_cons, con_weight}, stream);
}
#endif

}  // extern "C"

#ifndef VFT_ROUND_CONS
VFT_PROBE_READ(vft_me_round_profile_read)
#endif
