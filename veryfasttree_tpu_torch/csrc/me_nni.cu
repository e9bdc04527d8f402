// Whole NNI rounds of the minimum-evolution phase on the card (Hopper,
// sm_90a), with a plain C interface loaded through ctypes
// (veryfasttree_tpu_torch/ops/_build.py, wrapper ops/nni_kernels.py).
//
// The JAX package runs its ME NNI round on the host
// (veryfasttree_tpu/engine/rearrange.py do_nni :246, choose_nni :178,
// update_for_nni :218, setup_abcd :92), one store call per profile average
// and one distance call with a blocking fetch per quartet; so did this port
// (engine/rearrange.do_nni with the single-call kernels me_average and
// me_dists).  One launch runs the whole round in one block, in the host
// loop's order (ref DoNNI tcc:5997-6183, traverseNNI :5797-5995):
//   the fast-NNI skip set (ref tcc:6049-6075), one thread per node; then the
//   restartable postorder walk with revisits (engine/state.traverse_postorder
//   with want_up): a node revisited after a swap below it gets its memo
//   entries reset and its profile recomputed; every other internal node
//   sets up its quartet (ABCD, with the memoised up-profile of its parent),
//   takes the six corrected distances, chooses as chooseNNI does (tcc:
//   4836-4882), swaps, updates its NNIStats (age, subtree age, delta,
//   support) and repairs the profiles: after no swap its memo entries and
//   its own profile, after a swap updateForNNI.
//
// Bound: a round must read each store row it uses once and write each row
// it changes once (node rows and up-profiles, P * (4C + 5) bytes each), and
// do each quartet's operations: six pair distances of 2 (C + 1) operations
// per position, an average of 4C + 6 per position.  Each quartet depends on
// the one before (a swap changes the tree and the rows its successors read),
// so the work is serial in quartets and parallel only over positions.  What
// the design does about it: no launch and no fetch per quartet.  The tree,
// the up-profile memo, the up-profile path and the traversal flags live in
// shared memory while they fit (26 bytes per node; past that in device
// memory, the same code on other pointers), the NNIStats arrays in device
// memory (thread 0 alone reads and writes them after the skip set), and
// store rows are written in place.  The tree walks and the skip set are
// round_tree.cuh's, the row work and profile repairs me_round.cuh's, shared
// with the SPR round (me_spr.cu),
// so the distances and rows equal the single-call kernels' bit for bit; the
// criteria, deltas and supports are double, in the host loop's order (this
// file is compiled with -fmad=false).

// every tree walk inlined (the round's state in registers, no stack
// frame), and every thread makes the tree's writes (round_tree.cuh)
#define VFT_TREE_INLINE __forceinline__
#define VFT_TREE_WRITE_ALL
#include "me_round.cuh"

namespace {

constexpr int kABvsCD = 0, kACvsBD = 1, kADvsBC = 2;

template <int C>
struct NniBlock : MeRound<C> {
  using B = MeRound<C>;
  using B::a;
  using B::bad;
  using B::child;
  using B::commit;
  using B::nch;
  using B::node_ok;
  using B::parent;
  using B::sh;
  using B::tid;
  using B::uvalid;

  uint8_t* trav;      // [M] the walk's traversal flags
  NniStats st;
  double max_delta;   // thread 0's

  // the walk's two steps (and the repairs after a quartet), as functors
  // whose calls are inlined (a lambda's may not be, which would put the
  // block's state on the stack)
  struct Visit {
    NniBlock* b;
    __device__ __forceinline__ void operator()(int n) const { b->nni_node(n); }
  };
  struct Recompute {
    NniBlock* b;
    __device__ __forceinline__ void operator()(int n) const { b->recompute_profile(n); }
  };

  // one quartet of the walk (rearrange.do_nni's body with use_ml off)
  __device__ __forceinline__ void nni_node(int node) {
    int n4[4], r4[4];
    this->setup_abcd(node, n4, r4);
    if (bad) return;
    double d[6];
    this->corrected6(r4, d);
    // choose_nni (ref chooseNNI tcc:4836-4882), then negated: higher is better
    double crit[3] = {d[kQAB] + d[kQCD], d[kQAC] + d[kQBD], d[kQAD] + d[kQBC]};
    int choice = kABvsCD;
    if (crit[kACvsBD] < crit[kABvsCD] && crit[kACvsBD] <= crit[kADvsBC])
      choice = kACvsBD;
    else if (crit[kADvsBC] < crit[kABvsCD] && crit[kADvsBC] <= crit[kACvsBD])
      choice = kADvsBC;
    for (int k = 0; k < 3; ++k) crit[k] = -crit[k];
    const int na = n4[0], nb = n4[1], nc = n4[2];
    if (choice != kABvsCD) {
      const int moved = choice == kACvsBD ? nb : na;
      this->replace_child(node, moved, nc);
      this->replace_child(parent[node], nc, moved);
      if (bad) return;
    }
    this->nni_finish(
        node, n4, choice, crit, st, max_delta,
        [&] {
          if (choice != kABvsCD) sh->ctr[kMoves] += 1;
        },
        Recompute{this});
  }

  // the round (rearrange.do_nni with use_ml off, not -slow)
  __device__ __forceinline__ void round() {
    this->nni_walk(trav, st, &sh->any_bad, Visit{this}, Recompute{this});
  }
};

template <int C>
__global__ void __launch_bounds__(kRoundThreads) me_nni_round_kernel(
    StoreView s, int8_t* codes, float* W, float* U, const double* ev, const float* et,
    RoundArgs args, NniStats st, int32_t* g_tree, uint8_t* g_flags, int32_t* g_path,
    long long* g_ctr, double* g_max_delta, int tree_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ RoundShared sh;
  const int tid = threadIdx.x, M = args.maxnodes;
  const TreeArrays t = stage_tree(smem, g_tree, g_path, g_flags, M, 2, tree_in_smem);
  if (tid < kNumCounters) sh.ctr[tid] = 0;
  __syncthreads();

  NniBlock<C> b{{{t.tree, t.tree + M, t.tree + 4 * M, t.flags, t.path, args.n_seqs, args.root, M,
                  tid, false},
                 s, codes, W, U, ev, et, args, &sh},
                t.flags + M, st, 0.0};
  if (args.n_seqs > 3) b.round();
  if (tid == 0) *g_max_delta = b.max_delta;
  unstage_tree(t, g_tree, M, tree_in_smem, sh.ctr, kNumCounters, kFault, b.bad, g_ctr);
}

template <int C>
int nni_launch(const StoreView& s, int8_t* codes, float* W, float* U, const double* ev,
               const float* et, const RoundArgs& args, const NniStats& st, int32_t* tree,
               uint8_t* flags, int32_t* path, long long* ctr, double* max_delta, int smem_tree,
               cudaStream_t stream) {
  const size_t smem = tree_smem_bytes(args.maxnodes, 2);
  const int in_smem = smem_tree && smem <= (size_t)kRoundSmemCap;
  cudaError_t err = cudaFuncSetAttribute(me_nni_round_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kRoundSmemCap);
  if (err != cudaSuccess) return (int)err;
  me_nni_round_kernel<C><<<1, kRoundThreads, in_smem ? smem : 0, stream>>>(
      s, codes, W, U, ev, et, args, st, tree, flags, path, ctr, max_delta, in_smem);
  err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : 0;
}

}  // namespace

extern "C" {

// One ME NNI round on an n_rows-row store, in place, in one launch.  The
// round's state on the device: tree = parent [M] | children [M, 3] | child
// counts [M] (int32), flags [2M] (uint8 scratch: the memo, the traversal),
// path [M] (int32 scratch); the NNIStats age, subtree_age (int64), delta,
// support (double), [n_stats] each, read and written; ctr [kNumCounters]
// (int64, zero at the round's start, added to) and max_delta (double, out).
// ev: [C] eigenvalues (double) and et: [C] eigentotals (float) in matrix
// mode, NULL in %different mode.  smem_tree: 1 keeps the tree in shared
// memory where it fits, 0 in device memory (the layout of large trees).
// Returns 0, a cudaError of the launch, or -2 for arguments the kernel does
// not take.
int vft_me_nni_round_f32(int8_t* codes, float* W, float* U, const float* code_freq,
                         int64_t n_rows, int64_t leaf_rows, int P, int C, const double* ev,
                         const float* et, float tol, int n_seqs, int maxnodes, int root,
                         int bionj, int logdist, int jc, double pseudo, int fast_nni,
                         double min_delta, int n_stats, int64_t* age, int64_t* subtree_age,
                         double* delta, double* support, int32_t* tree, uint8_t* flags,
                         int32_t* path, int64_t* ctr, double* max_delta, int smem_tree,
                         void* stream) {
  if (2 * (int64_t)maxnodes > n_rows || leaf_rows > n_seqs || root < n_seqs ||
      root >= maxnodes || n_stats > maxnodes || root >= n_stats)
    return kBadArgs;
  const StoreView s{codes, W, U, code_freq, leaf_rows, P};
  const RoundArgs args{n_seqs, maxnodes, root, bionj, logdist, jc, pseudo, tol};
  const NniStats st{reinterpret_cast<long long*>(age), reinterpret_cast<long long*>(subtree_age),
                    delta, support, n_stats, fast_nni, min_delta};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  long long* c = reinterpret_cast<long long*>(ctr);
  if (C == 4)
    return nni_launch<4>(s, codes, W, U, ev, et, args, st, tree, flags, path, c, max_delta,
                         smem_tree, cs);
  if (C == 20)
    return nni_launch<20>(s, codes, W, U, ev, et, args, st, tree, flags, path, c, max_delta,
                          smem_tree, cs);
  return kBadArgs;
}

}  // extern "C"
