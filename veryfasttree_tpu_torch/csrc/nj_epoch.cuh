// The decisions of the NJ join epoch (nj_epoch.cu): the port's host join
// loop (engine/nj.py NeighbourJoining._join_loop_host with the top-hits
// heuristic of engine/tophits.py), join after join, in its order.
//
// One warp takes every decision (the master): its 32 lanes run the same
// control flow with the same scalar state, and split every list loop and
// every sweep over the nodes among themselves, so that the lists are read
// and written 32 entries at a time.  Gathers compact by ballot, so a list
// keeps the serial loop's order; the dedupe keeps the first occurrence; an
// argmin is a shuffle reduction with the serial loop's tie rule; the top-K
// selections merge sorted chunks on the total order (criterion, node).
// Each wide step -- pair and out-profile distances, the profile average,
// the refresh scan -- is a phase that the master hands to the rest of the
// grid and waits for (Ph::run).  The decisions are double arithmetic in the
// host loop's order (the including file is compiled with -fmad=false, so
// every expression rounds as numpy's does); ties go to the lowest node or
// the first slot, as numpy's stable sorts and argmin do.  The phases' bodies
// (out_update_pos, query_pos here, the pair and scan bodies of me_store.cuh
// and nj_scan.cuh) are those of the single-call kernels, so every distance
// and row equals the host loop's on the per-call kernels bit for bit.
//
// The master's warp primitives come from its Wp parameter (nj_epoch.cu's
// DeviceWarp), so the decisions use no device-only construct outside the
// phase bodies.

#pragma once

#include <stdint.h>

#include "me_store.cuh"
#include "probes.cuh"

namespace {

// int64 words of the epoch state, in the wrapper's order; each comment
// starts with the word's name in ops/epoch_kernels.py WORDS (the nj.debug
// counters first)
enum : int {
  kWOutOps = 0,   // outprofile_ops
  kWProfOps,      // profile_ops
  kWSeqOps,       // seq_ops
  kWAvgOps,       // profile_avg_ops
  kWHill,         // n_hill_better
  kWVisUp,        // n_visible_update
  kWRefresh,      // n_refresh_tophits
  kWScans,        // scans: refresh scans run (one-vs-all over the active rows)
  kWScanRows,     // scan_rows: rows those scans read
  kWPhases,       // phases: phases handed to the grid
  kWFault,        // fault: a broken invariant (kFault*): the launch ends
  kWFaultAt,      // fault_at: the n_active at which it was found
  kWMaxnode,      // maxnode: tree.maxnode
  kWTvAge,        // tv_age: topvisible_age
  kWJoins,        // joins: joins logged
  kNumWords
};

enum : int {
  kFaultNone = 0,
  kFaultNoBest,      // a hit list without a valid entry, or no search candidate
  kFaultNoList,      // an active node without a hit list
  kFaultNoEntries,   // resetTopVisible found no visible entry
  kFaultCapacity,    // a phase larger than the scratch
  kFaultInactive,    // a join or hill-climb node already joined
};

enum : int { kPhExit = 0, kPhPairs, kPhJoin, kPhQuery, kPhScan, kPhOutQuery };

// what the master hands to the grid
struct PhaseCmd {
  int64_t kind;
  int64_t n;        // kPhPairs, kPhScan: items in pa/pb
  int64_t i, j, t;  // kPhJoin: rows averaged into row t; kPhQuery: t is the query row
  int64_t n_old;    // kPhJoin: n_active of the join (out-profile update), 0: none
  double bw;        // kPhJoin: the weight of row i (0.5: the plain average)
};

// Every field is 8 bytes, in the order of ops/epoch_kernels.py EpochParams.
struct EpochParams {
  // the profile store (engine/profiles.py layout) and model
  int8_t* codes;
  float* W;
  float* U;
  const float* code_freq;   // [C, C]
  const double* ev;         // [C] eigenvalues (matrix mode) or null
  const float* et;          // [C] eigentot (matrix mode) or null
  float* w_out;             // [P] out-profile weights, updated in place
  float* f_out;             // [P, C] out-profile frequencies, updated in place
  float* qU;                // [P, C] w_out * f_out: the out-profile as a query
  double* qa;               // [P, C] refresh-scan query (times ev in matrix mode)
  double* qw;               // [P] its weights
  double* qg;               // [C, P] its projection on the codes (two-tier)
  int64_t n_rows, leaf_rows, P, C, use_matrix;
  double tol;               // f_post_total_tolerance (rounded to float)
  // the engine state, [M] unless stated
  double* od;               // out_distances
  int64_t* noda;            // n_out_dist_active
  double* selfdist;
  double* selfweight;
  double* diam;             // diameter
  double* vard;             // var_diameter
  double* bl;               // tree.branchlength
  int32_t* parent;          // tree.parent
  int32_t* kids;            // [M, 2] children of the joined nodes
  int32_t* hits_j;          // [M, m], -1 past a list's end
  double* hits_d;           // [M, m]
  int64_t* age;
  int32_t* vis_j;
  double* vis_d;
  int32_t* tv;              // [ntv] topvisible
  int32_t* join_i;          // [n_seqs - 3] the join log
  int32_t* join_j;
  double* totdiam;          // [1]
  int64_t* words;           // [kNumWords]
  // scratch: phase items, their results, and the master's lists
  int32_t* pa;              // [cap] first rows (-1: the out-profile query)
  int32_t* pb;              // [cap]
  double* rd;               // [cap] dist
  double* rw;               // [cap] denom
  int32_t* li;              // [cap] batch pairs
  int32_t* lj;              // [cap]
  double* ld;               // [cap]
  double* lc;               // [cap]
  int32_t* iscr;            // [iscr_len] the master's other int lists
  double* dscr;             // [dscr_len] the master's other double lists
  int32_t* mark;            // [M] zero at launch: dedupe stamps
  int32_t* mark2;           // [M] zero at launch: resetTopVisible's pair map
  int32_t* partner;         // [M]
  PhaseCmd* cmd;            // the phase under way
  uint32_t* ctl;            // [2] zero at launch: phase sequence, groups done
  int64_t cap;
  // options and this launch's share of the joins
  int64_t n_seqs, M, m, ntv, bionj;
  double stale_limit;       // stale_out_limit
  int64_t refresh_thresh;   // int(0.5 + m * tophits_refresh)
  int64_t age_limit;        // max(1, int(0.5 + log2(m)))
  int64_t n_hi, n_lo;       // joins at n_active = n_hi down to n_lo
  int64_t resume;           // first finish the join at n_hi + 1 (its top-hits merge)
  int64_t stop_reset;       // the join at n_lo resets the out-profile: stop before
  int64_t smem_state;       // stage the hottest per-node arrays in shared memory
  int64_t smem_lists;       // keep the master's small lists in shared memory
};

struct Hit {
  int i, j;
  double weight, dist, crit;
};

// ordered by (crit, node): numpy's stable sort of lists in node order
__device__ __forceinline__ bool key_less(double c1, int n1, double c2, int n2) {
  return c1 < c2 || (c1 == c2 && n1 < n2);
}

// ------------------------------------------------------------ phase bodies

// The incremental out-profile update at position p after the join of rows
// (i, j) into row t at n_active = n_old (ops/kernels.py update_out_profile,
// ref updateOutProfile tcc:943-1010), and the out-profile query w_out * f_out
// at p.  Each float operation is the twin's, in its order.
template <int C>
__device__ __forceinline__ void out_update_pos(const EpochParams& e, const StoreView& s, int64_t i,
                                               int64_t j, int64_t t, int64_t n_old, int p) {
  float wi, wj, wn, ui[C], uj[C], un[C];
  load_pos<C>(s, i, p, nullptr, nullptr, wi, ui);
  load_pos<C>(s, j, p, nullptr, nullptr, wj, uj);
  load_pos<C>(s, t, p, nullptr, nullptr, wn, un);
  const float fn = (float)n_old;
  const float wo = e.w_out[p];
  const float om = __fmul_rn(wo, fn);
  float nm = __fsub_rn(__fsub_rn(fma_via_double(wo, fn, wn), wi), wj);
  // a float tensor over a number: PyTorch's CUDA kernel multiplies by the
  // number's reciprocal
  float w2 = __fmul_rn(nm, __fdiv_rn(1.0f, (float)(n_old - 1)));
  if (w2 < 1e-20f) w2 = 1e-20f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    acc[c] = __fadd_rn(__fsub_rn(fma_via_double(e.f_out[p * C + c], om, -ui[c]), uj[c]), un[c]);
  float total;
  if (e.et != nullptr) {
    total = __fmul_rn(acc[0], e.et[0]);
#pragma unroll
    for (int c = 1; c < C; ++c) total = __fadd_rn(total, __fmul_rn(acc[c], e.et[c]));
  } else {
    total = acc[0];
#pragma unroll
    for (int c = 1; c < C; ++c) total = __fadd_rn(total, acc[c]);
  }
  const bool ok = total > (float)e.tol;
  const float fallback = (float)(1.0 / C);
  e.w_out[p] = w2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float f = ok ? __fdiv_rn(acc[c], total) : (e.et != nullptr ? e.code_freq[c] : fallback);
    e.f_out[p * C + c] = f;
    e.qU[p * C + c] = __fmul_rn(w2, f);
  }
}

// The refresh scan's query at position p from row t (scan_kernels.nj_scan,
// nj_scan_two_tier): a = u (times eigenval), wq = w, and for a two-tier
// store G[c][p] = sum_k a[p][k] * code_freq[c][k] left to right
// (scan_kernels.project_query), or a[p][c] in %different mode.
template <int C>
__device__ __forceinline__ void query_pos(const EpochParams& e, const StoreView& s, int64_t t,
                                          int p) {
  float w, u[C];
  load_pos<C>(s, t, p, nullptr, nullptr, w, u);
  double a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a[c] = (double)u[c];
    if (e.use_matrix) a[c] = __dmul_rn(a[c], e.ev[c]);
    e.qa[p * C + c] = a[c];
  }
  e.qw[p] = (double)w;
  if (e.leaf_rows == 0) return;
  for (int c = 0; c < C; ++c) {
    double g = a[c];
    if (e.use_matrix) {
      g = __dmul_rn(a[0], (double)e.code_freq[c * C]);
      for (int k = 1; k < C; ++k) g = __dadd_rn(g, __dmul_rn(a[k], (double)e.code_freq[c * C + k]));
    }
    e.qg[(int64_t)c * e.P + p] = g;
  }
}

// The master's lists, in elements: the small ones (iscr, and dscr up to
// d_small) in shared memory where they fit, the two [M] ones (sc, sd) in
// device memory after them; sizes from M, m and ntv (the wrapper asks
// vft_nj_epoch_scratch for them).
struct ScratchLayout {
  int64_t anc[3], flag[3], sel, sel2, seln, sel2n, uj, kj, wnode, woff, wcnt, snap, tvok, uvok,
      chunk_n, sli, slj, i_small;
  int64_t outd[3], ud, uc, kd, kc, snapod, tvc, uvc, selc, sel2c, chunk_c, sld, slc, d_small, sc,
      sd, d_len;
  int64_t small;   // the small pair lists' capacity
};

__host__ __device__ inline ScratchLayout scratch_layout(int64_t M, int64_t m, int64_t ntv) {
  ScratchLayout s;
  const int64_t lists = 2 * m + 2;
  const int64_t sel = m > 2 * ntv ? m : 2 * ntv;
  s.small = lists > ntv ? lists : ntv;
  int64_t o = 0;
  for (int h = 0; h < 3; ++h) { s.anc[h] = o; o += m; }
  for (int h = 0; h < 3; ++h) { s.flag[h] = o; o += m; }
  s.sel = o; o += sel;
  s.sel2 = o; o += sel;
  s.seln = o; o += sel;
  s.sel2n = o; o += sel;
  s.uj = o; o += lists;
  s.kj = o; o += lists;
  s.wnode = o; o += m;
  s.woff = o; o += m;
  s.wcnt = o; o += m;
  s.snap = o; o += 2 * (m + 1);
  s.tvok = o; o += ntv;
  s.uvok = o; o += lists;
  s.chunk_n = o; o += 32;
  s.sli = o; o += s.small;
  s.slj = o; o += s.small;
  s.i_small = o;
  o = 0;
  for (int h = 0; h < 3; ++h) { s.outd[h] = o; o += m; }
  s.ud = o; o += lists;
  s.uc = o; o += lists;
  s.kd = o; o += lists;
  s.kc = o; o += lists;
  s.snapod = o; o += m + 1;
  s.tvc = o; o += ntv;
  s.uvc = o; o += lists;
  s.selc = o; o += sel;
  s.sel2c = o; o += sel;
  s.chunk_c = o; o += 32;
  s.sld = o; o += s.small;
  s.slc = o; o += s.small;
  s.d_small = o;
  s.sc = o; o += M;
  s.sd = o; o += M;
  s.d_len = o;
  return s;
}

// The per-node arrays the decisions read most (od, vis_d, diam, noda,
// parent, vis_j, mark), which no phase reads: the master works on them in
// shared memory for the launch where they fit, and writes them back at its
// end.  Bytes for M nodes.
__host__ __device__ inline int64_t state_smem_bytes(int64_t M) {
  return M * (4 * sizeof(double) + 3 * sizeof(int32_t));
}

constexpr int64_t kStateSmemCap = 200 * 1024;   // the per-node arrays staged up to this
constexpr int64_t kEpochSmemCap = 224 * 1024;   // the block's dynamic shared memory at most

// What the launch keeps in shared memory: the per-node arrays while they
// fit in kStateSmemCap (N below about 2,300), and the master's small lists
// while they fit beside them; bytes in all.  Layout: the state's doubles,
// the lists' doubles, the state's ints, the lists' ints.
struct SmemPlan {
  bool state, lists;
  int64_t bytes;
};

__host__ __device__ inline SmemPlan smem_plan(int64_t M, int64_t m, int64_t ntv, bool want_state,
                                              bool want_lists) {
  const ScratchLayout L = scratch_layout(M, m, ntv);
  const int64_t state = state_smem_bytes(M);
  const int64_t lists = L.d_small * (int64_t)sizeof(double) + L.i_small * (int64_t)sizeof(int32_t);
  SmemPlan p;
  p.state = want_state && state <= kStateSmemCap;
  p.lists = want_lists && (p.state ? state : 0) + lists <= kEpochSmemCap;
  p.bytes = (p.state ? state : 0) + (p.lists ? lists : 0);
  return p;
}

// ----------------------------------------------------------------- master

// The master's state and its steps.  Every lane of the deciding warp runs
// them with the same scalar state; Wp gives the lane's index and the warp's
// collectives (sync, ballot, match, shuffles).  A loop over a list takes one
// entry per lane; a gather into a list compacts by ballot, so the list keeps
// the serial order; an argmin is a shuffle reduction with the serial loop's
// tie rule.  Writes that need one writer are lane 0's, between two syncs
// (solo).  Ph::run(cmd), called by every lane, runs one phase to its end.
template <class Wp, class Ph>
struct Master {
  const EpochParams& e;     // as given (the kernel's parameters)
  Ph& ph;
  unsigned lane;
  // the per-node arrays, in shared memory when staged
  double* od;
  double* vis_d;
  double* diam;
  int64_t* noda;
  int32_t* parent;
  int32_t* vis_j;
  int32_t* mark;
  bool staged;
  ScratchLayout L;
  int32_t* isl;             // the small int lists (shared or device memory)
  double* dsl;              // the small double lists
  // the pair lists (li, lj) and their distances and criteria (ld, lc): the
  // small set among the small lists for the batches of one node's hits
  // (at most L.small pairs), the [cap] device arrays for the sweeps over
  // the nodes; each gather picks its set
  int32_t* li;
  int32_t* lj;
  double* ld;
  double* lc;
  int maxnode, tv_age, n_joins;
  double totdiam;
  long long n_out, n_prof, n_seq, n_avg, n_hill, n_visup, n_refresh, n_scans, n_scan_rows,
      n_phases;
  int fault;
  int fault_at;
  int stamp, stamp2;

  // smem: the launch's dynamic shared memory (smem_plan), or null
  __device__ Master(const EpochParams& params, Ph& phases, unsigned char* smem, bool stage_state,
                    bool stage_lists)
      : e(params), ph(phases), lane(Wp::lane()), staged(smem != nullptr && stage_state) {
    const int64_t M = e.M;
    L = scratch_layout(M, e.m, e.ntv);
    od = e.od;
    vis_d = e.vis_d;
    diam = e.diam;
    noda = e.noda;
    parent = e.parent;
    vis_j = e.vis_j;
    mark = e.mark;
    isl = e.iscr;
    dsl = e.dscr;
    double* d = reinterpret_cast<double*>(smem);
    if (staged) {
      od = d;
      vis_d = d + M;
      diam = d + 2 * M;
      noda = reinterpret_cast<int64_t*>(d + 3 * M);
      d += 4 * M;
    }
    if (smem != nullptr && stage_lists) {
      dsl = d;
      d += L.d_small;
    }
    int32_t* w = reinterpret_cast<int32_t*>(d);
    if (staged) {
      parent = w;
      vis_j = w + M;
      mark = w + 2 * M;
      w += 3 * M;
#pragma unroll 4
      for (int64_t x = lane; x < M; x += 32) {
        od[x] = e.od[x];
        vis_d[x] = e.vis_d[x];
        diam[x] = e.diam[x];
        noda[x] = e.noda[x];
        parent[x] = e.parent[x];
        vis_j[x] = e.vis_j[x];
        mark[x] = 0;
      }
    }
    if (smem != nullptr && stage_lists) isl = w;
    Wp::sync();
    maxnode = (int)e.words[kWMaxnode];
    tv_age = (int)e.words[kWTvAge];
    n_joins = (int)e.words[kWJoins];
    totdiam = e.totdiam[0];
    n_out = e.words[kWOutOps];
    n_prof = e.words[kWProfOps];
    n_seq = e.words[kWSeqOps];
    n_avg = e.words[kWAvgOps];
    n_hill = e.words[kWHill];
    n_visup = e.words[kWVisUp];
    n_refresh = e.words[kWRefresh];
    n_scans = e.words[kWScans];
    n_scan_rows = e.words[kWScanRows];
    n_phases = e.words[kWPhases];
    fault = (int)e.words[kWFault];
    fault_at = (int)e.words[kWFaultAt];
    stamp = stamp2 = 0;
    big_lists();
  }

  __device__ void save() {
    Wp::sync();
    if (lane == 0) {
      e.words[kWOutOps] = n_out;
      e.words[kWProfOps] = n_prof;
      e.words[kWSeqOps] = n_seq;
      e.words[kWAvgOps] = n_avg;
      e.words[kWHill] = n_hill;
      e.words[kWVisUp] = n_visup;
      e.words[kWRefresh] = n_refresh;
      e.words[kWScans] = n_scans;
      e.words[kWScanRows] = n_scan_rows;
      e.words[kWPhases] = n_phases;
      e.words[kWFault] = fault;
      e.words[kWFaultAt] = fault_at;
      e.words[kWMaxnode] = maxnode;
      e.words[kWTvAge] = tv_age;
      e.words[kWJoins] = n_joins;
      e.totdiam[0] = totdiam;
    }
    if (staged)
#pragma unroll 4
      for (int64_t x = lane; x < e.M; x += 32) {
        e.od[x] = od[x];
        e.vis_d[x] = vis_d[x];
        e.diam[x] = diam[x];
        e.noda[x] = noda[x];
        e.parent[x] = parent[x];
        e.vis_j[x] = vis_j[x];
      }
    Wp::sync();
  }

  __device__ void set_fault(int code, int n) {
    if (!fault) {
      fault = code;
      fault_at = n;
    }
  }

  __device__ int32_t* iv(int64_t off) { return isl + off; }
  __device__ double* dv(int64_t off) { return dsl + off; }

  // the pair lists of a gather of at most L.small pairs, or of a sweep
  __device__ void small_lists() {
    li = iv(L.sli);
    lj = iv(L.slj);
    ld = dv(L.sld);
    lc = dv(L.slc);
  }
  __device__ void big_lists() {
    li = e.li;
    lj = e.lj;
    ld = e.ld;
    lc = e.lc;
  }

  // ------------------------------------------------------ warp helpers
  __device__ __forceinline__ unsigned below() const { return (1u << lane) - 1u; }

  // lane 0 writes, after every lane has read what it needs; then every lane
  // sees the write
  template <class F>
  __device__ __forceinline__ void solo(F write) {
    Wp::sync();
    if (lane == 0) write();
    Wp::sync();
  }

  // The k in [0, K) with pred(k), in order: emit(pos, k) for each, pos
  // counting from base.  Returns base plus their number.
  template <class Pred, class Emit>
  __device__ __forceinline__ int compact(int K, int base, Pred pred, Emit emit) {
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + (int)lane;
      const bool p = k < K && pred(k);
      const unsigned b = Wp::ballot(p);
      if (p) emit(base + __popc(b & below()), k);
      base += __popc(b);
    }
    return base;
  }

  // The first k in [0, K) with pred(k), or -1.
  template <class Pred>
  __device__ __forceinline__ int first_true(int K, Pred pred) {
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + (int)lane;
      const unsigned b = Wp::ballot(k < K && pred(k));
      if (b) return k0 + __ffs(b) - 1;
    }
    return -1;
  }

  // How many k in [0, K) have pred(k).
  template <class Pred>
  __device__ __forceinline__ int count_true(int K, Pred pred) {
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + (int)lane;
      n += __popc(Wp::ballot(k < K && pred(k)));
    }
    return n;
  }

  // The k in [0, K) with ok(k) and the least val(k), the first on ties (the
  // serial loop's `<`), or -1; every lane gets it.
  template <class Ok, class Val>
  __device__ __forceinline__ int argmin_first(int K, Ok ok, Val val) {
    double bv = 0.0;
    int bk = -1;
    for (int k = (int)lane; k < K; k += 32)
      if (ok(k)) {
        const double v = val(k);
        if (bk < 0 || v < bv) {
          bv = v;
          bk = k;
        }
      }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = Wp::shfl_xor(bv, off);
      const int ok2 = Wp::shfl_xor(bk, off);
      if (ok2 >= 0 && (bk < 0 || ov < bv || (ov == bv && ok2 < bk))) {
        bv = ov;
        bk = ok2;
      }
    }
    return bk;
  }

  // The k in [0, K) with the greatest val(k), the last on ties (the serial
  // loop's `>=`); every lane gets it.
  template <class Val>
  __device__ __forceinline__ int argmax_last(int K, Val val) {
    double bv = 0.0;
    int bk = -1;
    for (int k = (int)lane; k < K; k += 32) {
      const double v = val(k);
      if (bk < 0 || v >= bv) {
        bv = v;
        bk = k;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = Wp::shfl_xor(bv, off);
      const int ok2 = Wp::shfl_xor(bk, off);
      if (ok2 >= 0 && (bk < 0 || ov > bv || (ov == bv && ok2 > bk))) {
        bv = ov;
        bk = ok2;
      }
    }
    return bk;
  }

  // ------------------------------------------------------------- helpers
  __device__ int anc(int x) const {
    if (x < 0) return x;
    while (parent[x] >= 0) x = parent[x];
    return x;
  }
  __device__ bool active(int x) const { return parent[x] < 0; }
  __device__ long long allow(int n) const { return (long long)((double)n * e.stale_limit); }
  __device__ bool stale(int x, int n) const { return noda[x] - n > allow(n); }
  __device__ int list_len(int x) {
    const int32_t* h = e.hits_j + (int64_t)x * e.m;
    const int k = first_true((int)e.m, [&](int k) { return h[k] < 0; });
    return k < 0 ? (int)e.m : k;
  }

  // dedupe: ubegin(), then uadd(S, list, count, cand) appends to list
  // (which holds count entries) each x = cand(s) >= 0, s in [0, S) in
  // order, not yet added since ubegin, and returns the new count.  In a
  // chunk of 32 the lowest lane of each x (match) checks and sets its mark.
  __device__ void ubegin() { ++stamp; }
  template <class Cand>
  __device__ __forceinline__ int uadd(int S, int32_t* list, int count, Cand cand) {
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + (int)lane;
      const int x = s < S ? cand(s) : -1;
      if (!Wp::ballot(x >= 0)) continue;
      const unsigned same = Wp::match(x);
      const bool keep = x >= 0 && (same & below()) == 0 && mark[x] != stamp;
      const unsigned b = Wp::ballot(keep);
      if (keep) {
        mark[x] = stamp;
        list[count + __popc(b & below())] = x;
      }
      count += __popc(b);
      Wp::sync();
    }
    return count;
  }

  // out-distance of node from d(node, out-profile) (apply_out_refresh)
  __device__ void apply_out(int x, double dist, double weight, int n) {
    const double nn = (double)n;
    const double top = (double)(n - 1) * (dist * weight * nn - e.selfweight[x] * e.selfdist[x]);
    const double bottom = weight * nn - e.selfweight[x];
    double o = 3.0;
    if (bottom > 0.01) o = top / bottom - diam[x] * (double)(n - 1) - (totdiam - diam[x]);
    od[x] = o;
    noda[x] = n;
  }

  __device__ double scaled_out(int x, int n) const {
    if (noda[x] != n) return od[x] * (double)(n - 1) / (double)(noda[x] - 1);
    return od[x];
  }
  __device__ double crit_of(int i, int j, double d, int n) const {
    return d - (scaled_out(i, n) + scaled_out(j, n)) / (double)(n - 2);
  }

  // one phase over items (pa, pb)[0, K)
  __device__ bool run_pairs(int K) {
    if (K == 0) return true;
    if (K > e.cap) {
      set_fault(kFaultCapacity, K);
      return false;
    }
    PhaseCmd c{};
    c.kind = kPhPairs;
    c.n = K;
    run(c);
    return true;
  }
  __device__ void run(const PhaseCmd& c) {
    ph.run(c);
    ++n_phases;
  }

  // the refreshes pb[0, R) (forced setOutDistance) and the pairs
  // (pa, pb)[R, R + K) in one phase
  __device__ bool pairs_phase(int R, int K, int n) {
    for (int r = (int)lane; r < R; r += 32) e.pa[r] = -1;
    if (!run_pairs(R + K)) return false;
    for (int r = (int)lane; r < R; r += 32) apply_out(e.pb[r], e.rd[r], e.rw[r], n);
    Wp::sync();
    n_out += R;
    return true;
  }

  // the stale ends of the pairs (li, lj)[0, K), in order, into pb from R on
  __device__ int stale_ends(int K, int R, int n) {
    return uadd(2 * K, e.pb, R, [&](int s) {
      const int x = (s & 1) ? lj[s >> 1] : li[s >> 1];
      return stale(x, n) ? x : -1;
    });
  }

  // setCriterionBatch over (li, lj, ld)[0, K) -> lc
  __device__ bool crit_batch(int K, int n) {
    ubegin();
    const int R = stale_ends(K, 0, n);
    if (!pairs_phase(R, 0, n)) return false;
    for (int k = (int)lane; k < K; k += 32) lc[k] = crit_of(li[k], lj[k], ld[k], n);
    Wp::sync();
    return true;
  }

  // setDistCriterionBatch over the pairs (li, lj)[0, K) -> ld (dist), lc
  // (the weights are not kept: no decision reads them); neq: a node
  // refreshed when not current (-1: none); extra: nodes also refreshed when
  // stale beyond the allowance
  __device__ bool dist_crit_batch(int K, int n, int neq = -1, const int32_t* extra = nullptr,
                                  int n_extra = 0) {
    if (K == 0) return true;
    ubegin();
    int R = stale_ends(K, 0, n);
    R = uadd(n_extra, e.pb, R, [&](int k) { return stale(extra[k], n) ? extra[k] : -1; });
    if (neq >= 0 && noda[neq] != n) R = uadd(1, e.pb, R, [&](int) { return neq; });
    if (R + K > e.cap) {
      set_fault(kFaultCapacity, n);
      return false;
    }
    for (int k = (int)lane; k < K; k += 32) {
      e.pa[R + k] = li[k];
      e.pb[R + k] = lj[k];
    }
    if (!pairs_phase(R, K, n)) return false;
    const int seq = count_true(K, [&](int k) { return li[k] < e.n_seqs && lj[k] < e.n_seqs; });
    n_seq += seq;
    n_prof += K - seq;
    for (int k = (int)lane; k < K; k += 32)
      ld[k] = e.rd[R + k] - (diam[li[k]] + diam[lj[k]]);
    Wp::sync();
    return crit_batch(K, n);
  }

  // getVisibleBatch of list[0, K): ok[k], and crit[k] where ok
  __device__ bool vis_batch(const int32_t* list, int K, int n, int32_t* ok, double* crit) {
    small_lists();  // K is ntv or a hit list's length
    int V = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + (int)lane;
      const int x = k < K ? list[k] : -1;
      const int j = x >= 0 && active(x) ? vis_j[x] : -1;
      const bool p = j >= 0 && active(j);
      const unsigned b = Wp::ballot(p);
      if (k < K) {
        const int pos = V + __popc(b & below());
        ok[k] = p ? pos : -1;
        if (p) {
          li[pos] = x;
          lj[pos] = j;
          ld[pos] = vis_d[x];
        }
      }
      V += __popc(b);
    }
    Wp::sync();
    if (V == 0) return true;
    if (!crit_batch(V, n)) return false;
    for (int k = (int)lane; k < K; k += 32)
      if (ok[k] >= 0) crit[k] = lc[ok[k]];
    Wp::sync();
    return true;
  }

  // the K smallest of `count` entries by (c[x], node[x]) (node null: x),
  // sorted, as indices into out; returns how many.  The keys are distinct,
  // so the order is total and the result the serial insertion sort's: each
  // chunk of 32 below the current K-th is ranked across the lanes and
  // merged by ranks into the list, whose keys are kept beside it.
  __device__ int select(int K, int count, const double* c, const int32_t* node, int32_t* out) {
    ProbeScope probe(kNjPSelect);
    int32_t* cur = out;
    int32_t* nxt = iv(L.sel2);
    double* cur_c = dv(L.selc);
    double* nxt_c = dv(L.sel2c);
    int32_t* cur_n = iv(L.seln);
    int32_t* nxt_n = iv(L.sel2n);
    double* chunk_c = dv(L.chunk_c);
    int32_t* chunk_n = iv(L.chunk_n);
    int len = 0;
    for (int x0 = 0; x0 < count && K > 0; x0 += 32) {
      const int x = x0 + (int)lane;
      bool v = x < count;
      double kc = 0.0;
      int kn = 0, kx = x;
      if (v) {
        kc = c[x];
        kn = node ? node[x] : x;
        if (len == K) v = key_less(kc, kn, cur_c[K - 1], cur_n[K - 1]);
      }
      const unsigned vb = Wp::ballot(v);
      if (!vb) continue;
      // a candidate's place in the chunk: the chunk's candidates below it
      int r = 0;
      for (unsigned b = vb; b; b &= b - 1) {
        const int src = __ffs(b) - 1;
        const double oc = Wp::shfl(kc, src);
        const int on = Wp::shfl(kn, src);
        if (key_less(oc, on, kc, kn)) ++r;
      }
      const int nv = __popc(vb);
      if (v) {
        chunk_c[r] = kc;
        chunk_n[r] = kn;
      }
      Wp::sync();
      // merge: an entry's place is its index plus the other side's smaller keys
      if (v) {
        int lo = 0, hi = len;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (key_less(cur_c[mid], cur_n[mid], kc, kn)) lo = mid + 1;
          else hi = mid;
        }
        if (r + lo < K) {
          nxt[r + lo] = kx;
          nxt_c[r + lo] = kc;
          nxt_n[r + lo] = kn;
        }
      }
      for (int i = (int)lane; i < len; i += 32) {
        const double yc = cur_c[i];
        const int yn = cur_n[i];
        int lo = 0, hi = nv;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (key_less(chunk_c[mid], chunk_n[mid], yc, yn)) lo = mid + 1;
          else hi = mid;
        }
        if (i + lo < K) {
          nxt[i + lo] = cur[i];
          nxt_c[i + lo] = yc;
          nxt_n[i + lo] = yn;
        }
      }
      Wp::sync();
      int32_t* t = cur;
      cur = nxt;
      nxt = t;
      double* tc = cur_c;
      cur_c = nxt_c;
      nxt_c = tc;
      t = cur_n;
      cur_n = nxt_n;
      nxt_n = t;
      len = len + nv < K ? len + nv : K;
    }
    if (cur != out) {
      for (int i = (int)lane; i < len; i += 32) out[i] = cur[i];
      Wp::sync();
    }
    return len;
  }

  // sortSaveBestHits: node's list from sorted candidates (already distinct,
  // none equal to node): entry k is js[order[k]] (js null: order[k]) at
  // distance ds[order[k]]
  __device__ void save_list(int node, int cnt, const int32_t* js, const double* ds,
                            const int32_t* order) {
    int32_t* h = e.hits_j + (int64_t)node * e.m;
    double* hd = e.hits_d + (int64_t)node * e.m;
    Wp::sync();
    for (int k = (int)lane; k < e.m; k += 32) {
      int j = -1;
      double d = 0.0;
      if (k < cnt) {
        const int o = order[k];
        j = js ? js[o] : o;
        d = ds[o];
      }
      h[k] = j;
      hd[k] = d;
      if (k == 0 && cnt > 0) {
        vis_j[node] = j;
        vis_d[node] = d;
      }
    }
    Wp::sync();
  }

  // ----------------------------------------------------------- hill climb
  // getBestFromTopHits's remap of node's list (h: 0 and 1 the hill-climb's
  // halves, 2 the single-node form): anc, flags (1 valid, 2 changed too),
  // out_d; returns the list's length, or -1 for no list
  __device__ int prep(int node, int h) {
    const int cnt = list_len(node);
    if (cnt == 0) {
      set_fault(kFaultNoList, node);
      return -1;
    }
    int32_t* an = iv(L.anc[h]);
    int32_t* fl = iv(L.flag[h]);
    double* o = dv(L.outd[h]);
    const int32_t* js = e.hits_j + (int64_t)node * e.m;
    const double* ds = e.hits_d + (int64_t)node * e.m;
    ProbeScope probe(kNjPAnc);
    for (int k = (int)lane; k < cnt; k += 32) {
      const int a = anc(js[k]);
      an[k] = a;
      const bool valid = a >= 0 && a != node;
      fl[k] = valid ? (a != js[k] ? 3 : 1) : 0;
      o[k] = ds[k];
    }
    Wp::sync();
    return cnt;
  }

  // the out-distance refreshes of one half (node when not current, and the
  // stale valid ancestors); with snap, what they overwrite
  __device__ bool half_refresh(int node, int h, int cnt, int n, int* n_snap) {
    const int32_t* an = iv(L.anc[h]);
    const int32_t* fl = iv(L.flag[h]);
    ubegin();
    int R = 0;
    if (noda[node] != n) R = uadd(1, e.pb, R, [&](int) { return node; });
    R = uadd(cnt, e.pb, R, [&](int k) { return fl[k] && stale(an[k], n) ? an[k] : -1; });
    if (n_snap) {
      int32_t* sn = iv(L.snap);
      double* so = dv(L.snapod);
      for (int r = (int)lane; r < R; r += 32) {
        const int x = e.pb[r];
        sn[2 * r] = x;
        sn[2 * r + 1] = (int32_t)noda[x];
        so[r] = od[x];
      }
      Wp::sync();
      *n_snap = R;
    }
    return pairs_phase(R, 0, n);
  }

  // criterion and argmin over a prepped list's valid entries
  __device__ Hit best_from(int node, int h, int cnt, int n) {
    const int32_t* an = iv(L.anc[h]);
    const int32_t* fl = iv(L.flag[h]);
    const double* o = dv(L.outd[h]);
    Hit best{node, -1, 0.0, 1e20, 1e20};
    small_lists();
    const int V = compact(cnt, 0, [&](int k) { return fl[k] != 0; }, [&](int pos, int k) {
      li[pos] = node;
      lj[pos] = an[k];
      ld[pos] = o[k];
    });
    Wp::sync();
    if (V == 0) {
      set_fault(kFaultNoBest, node);
      return best;
    }
    if (!crit_batch(V, n)) return best;
    const int kb = argmin_first(V, [](int) { return true; }, [&](int k) { return lc[k]; });
    best.j = lj[kb];
    best.weight = -1.0;
    best.dist = ld[kb];
    best.crit = lc[kb];
    return best;
  }

  // the changed entries' new distances (ld, in entry order) back into the
  // prepped list h's out_d; from: their first index in ld
  __device__ int scatter_changed(int h, int cnt, int from) {
    const int32_t* fl = iv(L.flag[h]);
    double* o = dv(L.outd[h]);
    const int to = compact(cnt, from, [&](int k) { return (fl[k] & 2) != 0; },
                           [&](int pos, int k) { o[k] = ld[pos]; });
    Wp::sync();
    return to;
  }

  // getBestFromTopHits (the single-node form)
  __device__ Hit best_from_top_hits(int node, int n) {
    Hit none{node, -1, 0.0, 1e20, 1e20};
    if (!active(node)) {
      set_fault(kFaultInactive, node);
      return none;
    }
    const int cnt = prep(node, 2);
    if (cnt < 0) return none;
    const int32_t* an = iv(L.anc[2]);
    const int32_t* fl = iv(L.flag[2]);
    int32_t* extra = iv(L.sel);
    small_lists();
    const int V = compact(cnt, 0, [&](int k) { return fl[k] != 0; },
                          [&](int pos, int k) { extra[pos] = an[k]; });
    const int K = compact(cnt, 0, [&](int k) { return (fl[k] & 2) != 0; }, [&](int pos, int k) {
      li[pos] = node;
      lj[pos] = an[k];
    });
    Wp::sync();
    if (K) {
      if (!dist_crit_batch(K, n, node, extra, V)) return none;
      scatter_changed(2, cnt, 0);
    } else if (noda[node] != n) {
      solo([&] { e.pb[0] = node; });
      if (!pairs_phase(1, 0, n)) return none;
    }
    return best_from(node, 2, cnt, n);
  }

  // one hill-climb step (tophits.hill_climb_step); returns whether join changed
  __device__ bool hill_climb_step(Hit& join, int n) {
    const int i = join.i, j = join.j;
    if (!active(i) || !active(j)) {
      set_fault(kFaultInactive, n);
      return false;
    }
    const int ci = prep(i, 0), cj = prep(j, 1);
    if (ci < 0 || cj < 0) return false;
    int n_snap = 0;
    if (!half_refresh(i, 0, ci, n, nullptr) || !half_refresh(j, 1, cj, n, &n_snap)) return false;
    int K = 0;
    small_lists();  // at most the two lists' 2m entries
    for (int h = 0; h < 2; ++h) {
      const int32_t* an = iv(L.anc[h]);
      const int32_t* fl = iv(L.flag[h]);
      const int node = h ? j : i;
      K = compact(h ? cj : ci, K, [&](int k) { return (fl[k] & 2) != 0; }, [&](int pos, int k) {
        li[pos] = node;
        lj[pos] = an[k];
      });
    }
    Wp::sync();
    if (K) {
      if (!dist_crit_batch(K, n)) return false;
      scatter_changed(1, cj, scatter_changed(0, ci, 0));
    }
    Hit best = best_from(i, 0, ci, n);
    if (fault) return false;
    if (best.j != join.j && best.crit < join.crit) {
      // the j half was speculative: undo its refreshes
      const int32_t* sn = iv(L.snap);
      const double* so = dv(L.snapod);
      for (int r = (int)lane; r < n_snap; r += 32) {
        od[sn[2 * r]] = so[r];
        noda[sn[2 * r]] = sn[2 * r + 1];
      }
      Wp::sync();
      join = best;
      const Hit b2 = best_from_top_hits(join.j, n);
      if (fault) return false;
      if (b2.j != join.i && b2.crit < join.crit) join = b2;
      return true;
    }
    best = best_from(j, 1, cj, n);
    if (fault) return false;
    if (best.j != join.i && best.crit < join.crit) {
      join = best;
      return true;
    }
    return false;
  }

  // ------------------------------------------------------- visible sets
  // resetTopVisible: the best visible entries of all active nodes, one per
  // pair
  __device__ bool reset_top_visible(int n) {
    ProbeScope probe(kNjPVisible);
    big_lists();
    const int K = compact(maxnode, 0, [&](int x) {
      if (!active(x)) return false;
      const int j = vis_j[x];
      return j >= 0 && active(j);
    }, [&](int pos, int x) {
      li[pos] = x;
      lj[pos] = vis_j[x];
      ld[pos] = vis_d[x];
    });
    Wp::sync();
    if (K == 0) {
      set_fault(kFaultNoEntries, n);
      return false;
    }
    if (!crit_batch(K, n)) return false;
    // an entry is skipped only as the reverse of an earlier saved one, so
    // the first 2 * ntv entries fill the set; lane 0 walks them
    int32_t* order = iv(L.sel);
    const int cnt = select(2 * (int)e.ntv, K, lc, li, order);
    ++stamp2;
    int i_save = 0;
    if (lane == 0) {
      for (int k = 0; k < cnt && i_save < e.ntv; ++k) {
        const int vi = li[order[k]], vj = lj[order[k]];
        if (e.mark2[vi] == stamp2 && e.partner[vi] == vj) continue;
        e.tv[i_save++] = vi;
        e.mark2[vi] = stamp2;
        e.partner[vi] = vj;
        e.mark2[vj] = stamp2;
        e.partner[vj] = vi;
      }
    }
    i_save = Wp::shfl(i_save, 0);
    Wp::sync();
    for (int k = i_save + (int)lane; k < e.ntv; k += 32) e.tv[k] = -1;
    Wp::sync();
    tv_age = 0;
    return true;
  }

  // updateTopVisible
  __device__ bool update_top_visible(int n, int i_in, int hit_j, double hit_dist) {
    const int ntv = (int)e.ntv;
    int k = first_true(ntv, [&](int q) {
      const int x = e.tv[q];
      return x == i_in || x < 0 || !active(x);
    });
    if (k >= 0) {
      if (e.tv[k] != i_in) solo([&] { e.tv[k] = i_in; });
      return true;
    }
    int32_t* ok = iv(L.tvok);
    double* tc = dv(L.tvc);
    if (!vis_batch(e.tv, ntv, n, ok, tc)) return false;
    k = first_true(ntv, [&](int q) {
      const int x = e.tv[q];
      return ok[q] < 0 || (x == hit_j && vis_j[x] == i_in);
    });
    if (k >= 0) {
      if (ok[k] < 0) solo([&] { e.tv[k] = i_in; });
      return true;
    }
    const int worst_pos = argmax_last(ntv, [&](int q) { return tc[q]; });
    const double worst = tc[worst_pos];
    if (worst >= -1e20) {
      small_lists();
      solo([&] {
        li[0] = i_in;
        lj[0] = hit_j;
        ld[0] = hit_dist;
      });
      if (!crit_batch(1, n)) return false;
      if (lc[0] < worst) solo([&] { e.tv[worst_pos] = i_in; });
    }
    return true;
  }

  // updateVisible of the nodes kj[0, cnt) against node, their (dist, crit)
  // in kd, kc: the entries that improve are found at once (their test reads
  // only what the batch fetched), then taken one by one
  __device__ bool update_visible(int n, int node, int cnt) {
    const int32_t* kj = iv(L.kj);
    const double* kd = dv(L.kd);
    const double* kc = dv(L.kc);
    int32_t* ok = iv(L.uvok);
    double* vc = dv(L.uvc);
    if (!vis_batch(kj, cnt, n, ok, vc)) return false;
    // the improving entries' indices, in order, over the ok flags
    int32_t* upd = iv(L.wnode);
    const int U = compact(cnt, 0, [&](int k) { return ok[k] < 0 || kc[k] < vc[k]; },
                          [&](int pos, int k) { upd[pos] = k; });
    n_visup += count_true(cnt, [&](int k) { return ok[k] >= 0 && kc[k] < vc[k]; });
    Wp::sync();
    for (int u = 0; u < U; ++u) {
      const int k = upd[u];
      const int j = kj[k];
      solo([&] {
        vis_j[j] = node;
        vis_d[j] = kd[k];
      });
      if (!update_top_visible(n, j, node, kd[k])) return false;
    }
    return true;
  }

  // ------------------------------------------------------------ search
  // the visible-set walk of topHitNJSearch when the top-visible set is
  // reset early
  __device__ bool walk_visible(int n) {
    ProbeScope probe(kNjPVisible);
    big_lists();
    int K = 0;
    for (int x0 = 0; x0 < maxnode; x0 += 32) {
      const int x = x0 + (int)lane;
      int newj = -1;
      bool p = false;
      if (x < maxnode && active(x)) {
        const int vj = vis_j[x];
        newj = anc(vj);
        if (newj >= 0 && newj != vj) {
          if (newj == x) {
            newj = 0;
            while (!active(newj) || newj == x) ++newj;
          }
          p = true;
        }
      }
      const unsigned b = Wp::ballot(p);
      if (p) {
        const int pos = K + __popc(b & below());
        li[pos] = x;
        lj[pos] = newj;
      }
      K += __popc(b);
    }
    Wp::sync();
    if (K == 0) return true;
    if (!dist_crit_batch(K, n)) return false;
    for (int k = (int)lane; k < K; k += 32) {
      vis_j[li[k]] = lj[k];
      vis_d[li[k]] = ld[k];
    }
    Wp::sync();
    return true;
  }

  // topHitNJSearch
  __device__ Hit search(int n) {
    ProbeScope probe(kNjPSearch);
    Hit join{-1, -1, 0.0, 1e20, 1e20};
    int32_t* ok = iv(L.tvok);
    double* tc = dv(L.tvc);
    const int ntv = (int)e.ntv;
    for (;;) {
      if (!vis_batch(e.tv, ntv, n, ok, tc)) return join;
      const int n_cand = count_true(ntv, [&](int k) { return ok[k] >= 0; });
      const int kb = argmin_first(ntv, [&](int k) { return ok[k] >= 0; },
                                  [&](int k) { return tc[k]; });
      ++tv_age;
      if (2 * tv_age > e.m || (3 * n_cand < e.ntv && 3 * n_cand < n)) {
        if (tv_age <= 2 && !walk_visible(n)) return join;
        if (!reset_top_visible(n)) return join;
        continue;
      }
      const int best = kb < 0 ? -1 : e.tv[kb];
      if (best < 0 || !active(best)) {
        set_fault(kFaultNoBest, n);
        return join;
      }
      join = Hit{best, vis_j[best], -1.0, vis_d[best], tc[kb]};
      break;
    }
    ProbeScope climb(kNjPHill);
    for (;;) {
      const bool changed = hill_climb_step(join, n);
      if (fault || !changed) break;
      ++n_hill;
    }
    return join;
  }

  // ------------------------------------------------------ top-hits merge
  // _refresh_node: the new node's list from a one-vs-all scan, then the
  // lists of its top hits, then a new top-visible set
  __device__ bool refresh_node(int node, int n) {
    ProbeScope probe(kNjPRefresh);
    ++n_refresh;
    solo([&] { e.age[node] = 0; });
    // the active nodes not current: distinct, so no dedupe
    const int R = compact(maxnode, 0, [&](int x) { return active(x) && noda[x] != n; },
                          [&](int pos, int x) { e.pb[pos] = x; });
    Wp::sync();
    if (!pairs_phase(R, 0, n)) return false;

    PhaseCmd q{};
    q.kind = kPhQuery;
    q.t = node;
    run(q);
    const int K = compact(maxnode, 0, [&](int x) { return active(x); },
                          [&](int pos, int x) { e.pa[pos] = x; });
    Wp::sync();
    if (K > e.cap) {
      set_fault(kFaultCapacity, n);
      return false;
    }
    PhaseCmd sc{};
    sc.kind = kPhScan;
    sc.n = K;
    run(sc);
    ++n_scans;
    n_scan_rows += K;
    n_prof += K;
    double* c = e.dscr + L.sc;   // [M] each, in device memory
    double* d = e.dscr + L.sd;
    // x's scan result is entry k of pa: its rank among the active nodes
    int k = 0;
    for (int x0 = 0; x0 < maxnode; x0 += 32) {
      const int x = x0 + (int)lane;
      const bool act = x < maxnode && active(x);
      const unsigned b = Wp::ballot(act);
      if (x < maxnode) {
        if (act) {
          const double dist = e.rd[k + __popc(b & below())] - (diam[node] + diam[x]);
          d[x] = dist;
          c[x] = x == node ? 2e20 : crit_of(node, x, dist, n);  // node sorts after every slot
        } else {
          d[x] = 1e20;
          c[x] = x == node ? 2e20 : 1e20;
        }
      }
      k += __popc(b);
    }
    Wp::sync();
    int32_t* order = iv(L.sel);
    int cnt = select((int)e.m, maxnode, c, nullptr, order);
    if (cnt > 0 && order[cnt - 1] == node) --cnt;
    // the candidate lists are the slots themselves
    save_list(node, cnt, nullptr, d, order);

    // expand the lists of the new node's top hits
    const int32_t* top = e.hits_j + (int64_t)node * e.m;
    const int n_top = list_len(node);
    int32_t* wnode = iv(L.wnode);
    int32_t* woff = iv(L.woff);
    int32_t* wcnt = iv(L.wcnt);
    int W = 0, tot = 0;
    big_lists();
    for (int t = 0; t < n_top; ++t) {
      const int jn = top[t];
      const int len = list_len(jn);
      if (!active(jn) || len == 0) continue;
      solo([&] { e.age[jn] = 0; });
      ubegin();
      int32_t* u = lj + tot;
      const int32_t* hj = e.hits_j + (int64_t)jn * e.m;
      int cu;
      {
        ProbeScope chains(kNjPAnc);
        cu = uadd(len, u, 0, [&](int r) {
          const int a = anc(hj[r]);
          return a >= 0 && a != jn ? a : -1;
        });
        if (node != jn) cu = uadd(1, u, cu, [&](int) { return node; });
        cu = uadd(n_top, u, cu, [&](int r) {
          const int a = anc(top[r]);
          return a >= 0 && a != jn ? a : -1;
        });
      }
      for (int r = (int)lane; r < cu; r += 32) li[tot + r] = jn;
      if (lane == 0) {
        wnode[W] = jn;
        woff[W] = tot;
        wcnt[W] = cu;
      }
      Wp::sync();
      tot += cu;
      ++W;
      if (tot + 2 * e.m + 2 > e.cap) {
        set_fault(kFaultCapacity, n);
        return false;
      }
    }
    if (W) {
      if (!dist_crit_batch(tot, n)) return false;
      for (int w = 0; w < W; ++w) {
        const int off = woff[w];
        const int got = select((int)e.m, wcnt[w], lc + off, lj + off, order);
        save_list(wnode[w], got, lj + off, ld + off, order);
      }
    }
    return reset_top_visible(n);
  }

  // topHitJoin of the new node (n: n_active after the join)
  __device__ bool top_hit_join(int node, int n) {
    ProbeScope probe(kNjPMerge);
    const int c0 = e.kids[2 * node], c1 = e.kids[2 * node + 1];
    const int len0 = list_len(c0), len1 = list_len(c1);
    if (len0 == 0 || len1 == 0) {
      set_fault(kFaultNoList, node);
      return false;
    }
    int32_t* uj = iv(L.uj);
    ubegin();
    int nu;
    {
      ProbeScope chains(kNjPAnc);
      const int32_t* h0 = e.hits_j + (int64_t)c0 * e.m;
      const int32_t* h1 = e.hits_j + (int64_t)c1 * e.m;
      nu = uadd(len0, uj, 0, [&](int r) {
        const int a = anc(h0[r]);
        return a >= 0 && a != node ? a : -1;
      });
      nu = uadd(len1, uj, nu, [&](int r) {
        const int a = anc(h1[r]);
        return a >= 0 && a != node ? a : -1;
      });
    }
    double* ud = dv(L.ud);
    double* uc = dv(L.uc);
    if (nu > 0) {
      small_lists();  // at most the two children's 2m entries
      for (int k = (int)lane; k < nu; k += 32) {
        li[k] = node;
        lj[k] = uj[k];
      }
      Wp::sync();
      if (!dist_crit_batch(nu, n)) return false;
      for (int k = (int)lane; k < nu; k += 32) {
        ud[k] = ld[k];
        uc[k] = lc[k];
      }
    }
    for (int r = (int)lane; r < e.m; r += 32) {
      e.hits_j[(int64_t)c0 * e.m + r] = -1;
      e.hits_d[(int64_t)c0 * e.m + r] = 0.0;
      e.hits_j[(int64_t)c1 * e.m + r] = -1;
      e.hits_d[(int64_t)c1 * e.m + r] = 0.0;
    }
    const int64_t age = (e.age[c0] + e.age[c1] + 1) / 2 + 1;
    Wp::sync();
    if (lane == 0) e.age[node] = age;
    Wp::sync();
    const bool b_use = nu == n - 1 || (age <= e.age_limit && nu >= e.refresh_thresh);
    if (!b_use) return refresh_node(node, n);
    const int n_save = nu < e.m ? nu : (int)e.m;
    int32_t* order = iv(L.sel);
    select(n_save, nu, uc, uj, order);
    save_list(node, n_save, uj, ud, order);
    if (!update_top_visible(n, node, vis_j[node], vis_d[node])) return false;
    int32_t* kj = iv(L.kj);
    double* kd = dv(L.kd);
    double* kc = dv(L.kc);
    for (int k = (int)lane; k < n_save; k += 32) {
      kj[k] = uj[order[k]];
      kd[k] = ud[order[k]];
      kc[k] = uc[order[k]];
    }
    Wp::sync();
    return update_visible(n, node, n_save);
  }

  // ------------------------------------------------------------ the join
  // the join of `join` at n_active = n (fast_nj's loop body); stop: the
  // join resets the out-profile, which the host recomputes, so stop before
  // the out-profile step (the next launch resumes with the merge)
  __device__ bool do_join(Hit join, int n, bool stop) {
    const int i = join.i, j = join.j;
    if (!active(i) || !active(j) || i == j) {
      set_fault(kFaultInactive, n);
      return false;
    }
    const int node = maxnode;
    // fresh out-distances of i and j, then their distance and criterion
    const int R = (noda[i] != n) + (noda[j] != n);
    solo([&] {
      e.join_i[n_joins] = i;
      e.join_j[n_joins] = j;
      e.kids[2 * node] = i < j ? i : j;
      e.kids[2 * node + 1] = i < j ? j : i;
      int r = 0;
      if (noda[i] != n) e.pb[r++] = i;
      if (noda[j] != n) e.pb[r++] = j;
      e.pa[R] = i;
      e.pb[R] = j;
      parent[i] = node;
      parent[j] = node;
    });
    ++n_joins;
    ++maxnode;
    if (!pairs_phase(R, 1, n)) return false;
    if (i < e.n_seqs && j < e.n_seqs) ++n_seq;
    else ++n_prof;
    join.weight = e.rw[R] > 0 ? e.rw[R] : 0.01;
    join.dist = e.rd[R] - (diam[i] + diam[j]);

    const double raw_ij = join.dist + diam[i] + diam[j];
    const double dist_ij = join.dist;
    const double delta = (od[i] - od[j]) / (double)(n - 2);
    const double bl_i = (dist_ij + delta) / 2.0;
    const double bl_j = (dist_ij - delta) / 2.0;

    double bw = 0.5;
    const double var_ij = raw_ij - e.vard[i] - e.vard[j];
    if (e.bionj && join.weight > 0.01 && var_ij > 0.001) {
      // BIONJ weighting, Gascuel 1997 eq. 9 via out-profile moments
      solo([&] {
        e.pa[0] = -1;
        e.pb[0] = i;
        e.pa[1] = -1;
        e.pb[1] = j;
      });
      if (!run_pairs(2)) return false;
      n_out += 2;
      const double nn = (double)n;
      const double do0 = e.rd[0], do1 = e.rd[1], wo0 = e.rw[0], wo1 = e.rw[1];
      const double var_i_weight = nn * wo0 - e.selfweight[i] - join.weight;
      const double var_j_weight = nn * wo1 - e.selfweight[j] - join.weight;
      const double var_i_top =
          do0 * wo0 * nn - e.selfdist[i] * e.selfweight[i] - raw_ij * join.weight;
      const double var_j_top =
          do1 * wo1 * nn - e.selfdist[j] * e.selfweight[j] - raw_ij * join.weight;
      if (var_j_weight > 0.01 && var_i_weight > 0.01) {
        const double d_pv_out =
            (double)(n - 2) * (var_j_top / var_j_weight - var_i_top / var_i_weight);
        const double d_var_diam = (double)(n - 2) * (e.vard[i] - e.vard[j]);
        bw = 0.5 + (d_pv_out + d_var_diam) / ((double)(2 * (n - 2)) * var_ij);
      }
      bw = 0.0 > bw ? 0.0 : bw;
      bw = 1.0 < bw ? 1.0 : bw;
    }
    const double diam_node = bw * (bl_i + diam[i]) + (1 - bw) * (bl_j + diam[j]);
    const double vard_node = bw * e.vard[i] + (1 - bw) * e.vard[j] + bw * (1 - bw) * var_ij;
    solo([&] {
      e.bl[i] = bl_i;
      e.bl[j] = bl_j;
      diam[node] = diam_node;
      e.vard[node] = vard_node;
    });

    PhaseCmd c{};
    c.kind = kPhJoin;
    c.i = i;
    c.j = j;
    c.t = node;
    c.bw = e.bionj ? bw : 0.5;
    c.n_old = stop ? 0 : n;
    run(c);
    ++n_avg;
    const double self_d = e.rd[0], self_w = e.rw[0];
    solo([&] {
      e.selfdist[node] = self_d;
      e.selfweight[node] = self_w;
    });
    if (stop) return true;
    totdiam += diam_node - diam[i] - diam[j];
    return top_hit_join(node, n - 1);
  }

  // this launch's joins
  __device__ void run_launch() {
    probe_begin(kNjPOther);
    PhaseCmd q{};
    q.kind = kPhOutQuery;
    run(q);
    if (!fault && e.resume) top_hit_join(maxnode - 1, (int)e.n_hi);
    for (int n = (int)e.n_hi; n >= (int)e.n_lo && !fault; --n) {
      const Hit join = search(n);
      if (fault) break;
      do_join(join, n, e.stop_reset && n == e.n_lo);
    }
    save();
    probe_end();
    PhaseCmd x{};
    x.kind = kPhExit;
    ph.run(x);
  }
};

}  // namespace
