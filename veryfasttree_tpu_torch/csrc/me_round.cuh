// The machinery of a whole minimum-evolution round in one block, shared by
// the SPR round (me_spr.cu) and the NNI round (me_nni.cu): the round's
// arguments and shared scratch, its counters, the row work (profile averages
// and quartet distances with the single-call kernels' bodies of
// me_store.cuh), the corrected distances, the up-profiles and the profile
// repairs after a swap.  The tree, its walks and the up-profile memo are
// round_tree.cuh's, shared with the maximum-likelihood rounds.
//
// Every thread of the block runs the same decisions on the same data (the
// tree walks read shared memory, the distances are reduced into shared
// memory) and makes the same tree writes after one barrier
// (round_tree.cuh, VFT_TREE_WRITE_ALL).  `bad` is set by every thread alike,
// never inside a commit.  A profile average takes one thread per position:
// a thread reads only the positions it wrote itself, so an average needs no
// barrier until a quartet's distances read its row (`dirty`).  A quartet's
// six pair distances take four 128-thread groups in one pass (groups 0 and
// 1 two pairs each, side by side with 4 codes, one after the other with
// 20), each pair with the single-call kernel's thread-to-position mapping
// and reduction order, and one barrier (the partial sums are
// double-buffered), so the distances and rows equal the single-call
// kernels' bit for bit; lanes 0-5 of every warp finish the six pairs and
// take their log corrections side by side, and each warp shares them by
// shuffles.  The including files define VFT_TREE_INLINE as
// __forceinline__, so that the round's state stays in registers.  The
// corrected distances, criteria and BIONJ weights are double, in the host
// loop's order; the files that include this one are compiled with
// -fmad=false so that every double expression rounds as numpy's does.  No
// atomics.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "constraints.cuh"
#include "me_store.cuh"
#include "round_tree.cuh"

namespace {

constexpr int kRoundThreads = 512;
constexpr int kRoundGroups = kRoundThreads / kDistThreads;
constexpr int kRoundSmemCap = 200 * 1024;    // dynamic shared memory a block may take

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
  double den[2][6 * kDistWarps];   // double-buffered: a quartet's partials
  double dots[2][6 * kDistWarps];
  long long ctr[kNumCounters];
  int any_bad;       // set by whichever thread finds a fault in a parallel pass
};

// Cons: the round under -constraints (the *_cons_kernel instantiations):
// the quartet penalties in the criteria, and each recomputed profile's
// constraint counts, its children's sum, column c written by thread c mod
// kRoundThreads alone (so a thread reads back the columns it wrote, and
// the average's `dirty` puts a barrier before the next quartet's
// penalties read them all)
template <int C, bool Cons = false>
struct MeRound : RoundTree {
  StoreView s;
  int8_t* codes;
  float* W;
  float* U;
  const double* ev;   // [C] in matrix mode, else null
  const float* et;    // [C] in matrix mode, else null
  RoundArgs a;
  RoundShared* sh;
  int buf = 0;        // the partials' buffer of the next quartet
  ConView con{};      // Cons: the counts (written through, int32 [M, n_cons])

  __device__ __forceinline__ void count(int k, long long n) {
    if (tid == 0) sh->ctr[k] += n;
  }

  // --------------------------------------------------------- row work
  // set_from_average(t, i, j, weight): bw = 0.5 for a negative weight, the
  // kernel's float bw rounded from the double, and the 0.5 path chosen on
  // the double (ops/store_kernels.me_average)
  __device__ __forceinline__ void average(int t, int i, int j, double weight) {
    const double bw = weight < 0.0 ? 0.5 : weight;
    const float bwf = __double2float_rn(bw);
    const float omb = __fsub_rn(1.0f, bwf);
    const float fallback = (float)(1.0 / C);
    for (int p = tid; p < s.P; p += kRoundThreads)
      average_pos<C>(s, codes, W, U, et, t, i, j, p, bwf, omb, bw == 0.5, a.tol, fallback);
    dirty = true;
    count(kRowsAveraged, 1);
  }

  // (dist, denom) of the six pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) of
  // the rows r0..r3, as me_pair_dist_kernel computes each: group g takes
  // pair g, groups 0 and 1 also pairs 4 and 5
  __device__ __forceinline__ void dist6(int r0, int r1, int r2, int r3, double dist[6],
                                        double den[6]) {
    const int g = tid / kDistThreads, t = tid % kDistThreads;
    const int prev = probe_mark(kMePLoads);
    if (dirty) {  // rows averaged since the last barrier: other threads wrote them
      __syncthreads();
      dirty = false;
    }
    double* pden = sh->den[buf];
    double* pdots = sh->dots[buf];
    buf ^= 1;
    double dn, dt, dn2 = 0.0, dt2 = 0.0;
    if constexpr (C <= 4) {
      if (g == 0)
        pair_partial2<C>(s, r0, r1, r1, r3, ev, t, dn, dt, dn2, dt2);
      else if (g == 1)
        pair_partial2<C>(s, r0, r2, r2, r3, ev, t, dn, dt, dn2, dt2);
      else
        pair_partial<C>(s, g == 2 ? r0 : r1, g == 2 ? r3 : r2, nullptr, nullptr, ev, t, dn, dt);
    } else {  // four rows of C floats at once would not stay in registers
      pair_partial<C>(s, g < 3 ? r0 : r1, g == 0 ? r1 : (g == 2 ? r3 : r2), nullptr, nullptr, ev,
                      t, dn, dt);
      if (g < 2) pair_partial<C>(s, g == 0 ? r1 : r2, r3, nullptr, nullptr, ev, t, dn2, dt2);
    }
    if ((t & 31) == 0) {
      pden[g * kDistWarps + (t >> 5)] = dn;
      pdots[g * kDistWarps + (t >> 5)] = dt;
      if (g < 2) {
        pden[(g + 4) * kDistWarps + (t >> 5)] = dn2;
        pdots[(g + 4) * kDistWarps + (t >> 5)] = dt2;
      }
    }
    probe_mark(kMePReduce);
    __syncthreads();
    // lane k of every warp finishes pair k (< 6), and the warp shares them
    const int k = (int)(tid & 31u) < 6 ? (int)(tid & 31u) : 0;
    double dk, wk;
    pair_finish(pden + k * kDistWarps, pdots + k * kDistWarps, ev, dk, wk);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      dist[q] = __shfl_sync(0xffffffffu, dk, q);
      den[q] = __shfl_sync(0xffffffffu, wk, q);
    }
    probe_mark(prev);
  }

  // nj.log_corrected (ref logCorrect tcc:322-330), numpy's order
  __device__ __forceinline__ double log_corr(double d) const {
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
  __device__ __forceinline__ void corrected6(const int r[4], double d[6]) {
    double w[6];
    dist6(r[0], r[1], r[2], r[3], d, w);
    ProbeScope probe(kMePCorrect);
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
    if (a.logdist) {
      // lane k of every warp corrects d[k] (< 6), and the warp shares them
      const int lane = (int)(tid & 31u);
      const double mine = lane == 1 ? d[1] : lane == 2 ? d[2] : lane == 3 ? d[3]
                          : lane == 4 ? d[4] : lane == 5 ? d[5] : d[0];
      const double corr = log_corr(mine);
#pragma unroll
      for (int q = 0; q < 6; ++q) d[q] = __shfl_sync(0xffffffffu, corr, q);
    }
  }

  // BIONJ-ish profile weight (ref quartetWeight tcc:3541-3561); -1 when
  // -bionj is off
  __device__ __forceinline__ double quartet_weight(const int r[4]) {
    if (!a.bionj) return -1.0;
    double d[6];
    corrected6(r, d);
    if (d[kQAB] < 0.01) return -1.0;
    double w = 0.5 + ((d[kQBC] + d[kQBD]) - (d[kQAC] + d[kQAD])) / (4.0 * d[kQAB]);
    w = 0.0 > w ? 0.0 : w;  // Python's min(max(w, 0.0), 1.0)
    return 1.0 < w ? 1.0 : w;
  }

  // --------------------------------------------------------- up-profiles
  // the up-profile of n (row M + n): the average of its quartet's C and D,
  // with the BIONJ weight of the CDAB-ordered quartet (ref tcc:3421-3428)
  __device__ __forceinline__ void fill_up(int n, int nc, int d_row) {
    ProbeScope probe(kMePFill);
    const int r4[4] = {nc, d_row, child[3 * n], child[3 * n + 1]};
    const double w = quartet_weight(r4);
    average(a.maxnodes + n, nc, d_row, w);
  }

  // ref setupABCD tcc:1942-1974, with the memoised up-profiles
  __device__ __forceinline__ void setup_abcd(int node, int nodes4[4], int rows4[4]) {
    ProbeScope probe(kMePSetup);
    RoundTree::setup_abcd(node, nodes4, rows4,
                          [this](int n, int nc, int d_row, int) { fill_up(n, nc, d_row); });
  }

  // ------------------------------------------------------ profile repairs
  // ref recomputeProfile tcc:3436-3472 (ME)
  __device__ __forceinline__ void recompute_profile(int node) {
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
    {
      ProbeScope probe(kMePAverage);
      average(node, c0, c1, w);
    }
    count(kAvgOps, 1);
    if constexpr (Cons) {
      int32_t* on = const_cast<int32_t*>(con.on);
      int32_t* off = const_cast<int32_t*>(con.off);
      const int64_t n = con.n_cons;
      for (int64_t c = tid; c < n; c += kRoundThreads) {
        on[node * n + c] = on[c0 * n + c] + on[c1 * n + c];
        off[node * n + c] = off[c0 * n + c] + off[c1 * n + c];
      }
    }
  }

  // the three criteria of quartet n4 plus its constraint penalties (the
  // host's criteria + quartet_constraint_penalties); unchanged without
  // constraints
  __device__ __forceinline__ void add_penalties(const int n4[4], double crit[3]) const {
    if constexpr (Cons) {
      double pen[3];
      quartet_penalties(con, n4, pen);
#pragma unroll
      for (int k = 0; k < 3; ++k) crit[k] = crit[k] + pen[k];
    }
  }

  // ref updateForNNI tcc:1882-1927 (not -slow)
  __device__ __forceinline__ void update_for_nni(int node) {
    RoundTree::update_for_nni(node, [this](int n) { recompute_profile(n); });
  }
};

}  // namespace
