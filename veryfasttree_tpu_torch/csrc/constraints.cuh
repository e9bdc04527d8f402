// The constraint penalties of -constraints on the card (ref
// joinConstraintPenalty tcc:559-605, quartetConstraintPenalties
// :1490-1522), shared by the join epoch (nj_epoch.cuh), the ME rounds
// (me_round.cuh) and the ML NNI round (ml_round.cu): each is the host
// loop's function (engine/nj.py join_penalties_batch,
// engine/rearrange.py quartet_constraint_penalties) in its order.
//
// The counts are int32 [M, n_cons] in device memory, row node: nOn and
// nOff, the leaves of the node's subtree on either side of each
// constraint.  A join penalty is an integer sum (exact in any order); a
// quartet penalty is numpy's sum of the relevant constraints' weighted
// terms, which np_sum repeats: numpy adds a float64 array pairwise (below 8
// terms from 0 in order; up to 128 in eight stride-8 partials, combined
// ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the rest in order; above 128
// the halves, split at a multiple of 8), over the relevant terms only.  The
// including files are compiled with -fmad=false, so each term rounds as
// numpy's does.  Host C++ compiles it too (tests/epoch_host).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ConView {
  const int32_t* on;    // [M, n_cons]
  const int32_t* off;   // [M, n_cons]
  int n_cons;
  double weight;        // constraint_weight
};

// numpy's pairwise sum of n terms, at most 128, each term() in turn
template <class Term>
__host__ __device__ __forceinline__ double np_sum_block(int n, Term& term) {
  if (n < 8) {
    double res = 0.0;
    for (int i = 0; i < n; ++i) res += term();
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = term();
  int i = 8;
  for (; i < n - n % 8; i += 8)
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += term();
  double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += term();
  return res;
}

__host__ __device__ __forceinline__ int np_sum_split(int n) {
  const int n2 = n / 2;
  return n2 - n2 % 8;
}

// numpy's pairwise sum of n terms, each term() in turn: its recursion on
// an explicit stack (24 levels reach 2^31 terms)
template <class Term>
__host__ __device__ __forceinline__ double np_sum(int n, Term& term) {
  if (n <= 128) return np_sum_block(n, term);
  int size[24];
  double left[24];
  bool right[24];
  int sp = 0, cur = n;
  for (;;) {
    while (cur > 128) {
      size[sp] = cur;
      right[sp] = false;
      ++sp;
      cur = np_sum_split(cur);
    }
    double val = np_sum_block(cur, term);
    for (;;) {
      if (sp == 0) return val;
      const int top = sp - 1;
      if (!right[top]) {
        left[top] = val;
        right[top] = true;
        cur = size[top] - np_sum_split(size[top]);
        break;
      }
      val = left[top] + val;
      --sp;
    }
  }
}

// ref joinConstraintPenaltyPiece tcc:570-605
__host__ __device__ __forceinline__ int64_t join_penalty_piece(int64_t on1, int64_t off1,
                                                               int64_t on2, int64_t off2,
                                                               int64_t on3, int64_t off3) {
  if (on1 + off1 <= 0 || on2 + off2 <= 0 || on3 + off3 <= 0) return 0;
  const int c1 = (on1 > 0 && off1 > 0) ? -1 : (on1 > 0 ? 1 : 0);
  const int c2 = (on2 > 0 && off2 > 0) ? -1 : (on2 > 0 ? 1 : 0);
  const int c3 = (on3 > 0 && off3 > 0) ? -1 : (on3 > 0 ? 1 : 0);
  const int n_split = (c1 == -1) + (c2 == -1) + (c3 == -1);
  const int n_on = (c1 == 1) + (c2 == 1) + (c3 == 1);
  if (n_split != 1 || n_on != 1) return 0;
  // split_constraint_penalty(on1 + on2, off1 + off2, on3, off3)
  const int64_t a_on = on1 + on2, a_off = off1 + off2;
  if (a_on + off3 < on3 + a_off) return a_on < off3 ? a_on : off3;
  return on3 < a_off ? on3 : a_off;
}

// ref joinConstraintPenalty tcc:559-605: the constrained leaves the join of
// i and j must move, out_on / out_off [n_cons] the leaf totals (the
// out-profile's counts, which no join changes)
__host__ __device__ __forceinline__ int64_t join_penalty(const ConView& k, const int32_t* out_on,
                                                         const int32_t* out_off, int i, int j) {
  const int32_t* on1 = k.on + (int64_t)i * k.n_cons;
  const int32_t* off1 = k.off + (int64_t)i * k.n_cons;
  const int32_t* on2 = k.on + (int64_t)j * k.n_cons;
  const int32_t* off2 = k.off + (int64_t)j * k.n_cons;
  int64_t pen = 0;
  for (int c = 0; c < k.n_cons; ++c)
    pen += join_penalty_piece(on1[c], off1[c], on2[c], off2[c],
                              (int64_t)out_on[c] - on1[c] - on2[c],
                              (int64_t)out_off[c] - off1[c] - off2[c]);
  return pen;
}

// the relevant constraints of a quartet, one at a time in order, and the
// weighted term of topology `topo` (0 ABvsCD, 1 ACvsBD, 2 ADvsBC) of each
struct QuartetTerms {
  const ConView& k;
  const int32_t* on[4];
  const int32_t* off[4];
  int topo;
  int c;

  __host__ __device__ __forceinline__ bool relevant(int cc) const {
    int n_plus = 0, n_minus = 0;
    bool all = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int32_t a = on[q][cc], b = off[q][cc];
      all = all && a + b > 0;
      n_plus += a > 0 && b == 0;
      n_minus += b > 0 && a == 0;
    }
    return all && n_plus < 3 && n_minus < 3;
  }

  __host__ __device__ __forceinline__ double frac(int q, int cc) const {
    return (double)on[q][cc] / (double)(on[q][cc] + off[q][cc]);
  }

  // rearrange.quartet_constraint_penalties's pair_dist(i, j)
  __host__ __device__ __forceinline__ double pd(int i, int j, int cc) const {
    const double f1 = frac(i, cc), f2 = frac(j, cc);
    return (f1 + f2) - ((2.0 * f1) * f2);
  }

  __host__ __device__ __forceinline__ double operator()() {
    while (!relevant(c)) ++c;
    const int cc = c++;
    double s;
    if (topo == 0) s = pd(0, 1, cc) + pd(2, 3, cc);
    else if (topo == 1) s = pd(0, 2, cc) + pd(1, 3, cc);
    else s = pd(0, 3, cc) + pd(2, 1, cc);
    return k.weight * s;
  }
};

// ref quartetConstraintPenalties tcc:1490-1522: the penalties of the
// quartet n4 (A, B, C, D) into pen[3]
__host__ __device__ __forceinline__ void quartet_penalties(const ConView& k, const int n4[4],
                                                           double pen[3]) {
  QuartetTerms t{k, {}, {}, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    t.on[q] = k.on + (int64_t)n4[q] * k.n_cons;
    t.off[q] = k.off + (int64_t)n4[q] * k.n_cons;
  }
  int n = 0;
  for (int c = 0; c < k.n_cons; ++c) n += t.relevant(c);
#pragma unroll
  for (int topo = 0; topo < 3; ++topo) {
    t.topo = topo;
    t.c = 0;
    pen[topo] = np_sum(n, t);
  }
}

}  // namespace
