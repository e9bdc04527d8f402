// The decisions of the NJ join epoch (nj_epoch.cu): the port's host join
// loop (engine/nj.py NeighbourJoining._join_loop_host with the top-hits
// heuristic of engine/tophits.py), join after join, in its order.
//
// One thread takes every decision (the master); each wide step -- pair and
// out-profile distances, the profile average, the refresh scan -- is a
// phase that the master hands to the rest of the grid and waits for
// (Ph::run).  The decisions are double arithmetic in the host loop's order
// (the including file is compiled with -fmad=false, so every expression
// rounds as numpy's does); ties go to the lowest node or the first slot, as
// numpy's stable sorts and argmin do.  The phases' bodies (out_update_pos,
// query_pos here, the pair and scan bodies of me_store.cuh and nj_scan.cuh)
// are those of the single-call kernels, so every distance and row equals the
// host loop's on the per-call kernels bit for bit.
//
// The file uses no device-only construct outside the phase bodies, so the
// decisions also compile as host C++.

#pragma once

#include <stdint.h>

#include "me_store.cuh"

namespace {

// int64 words of the epoch state, in the wrapper's order
// (ops/epoch_kernels.py WORDS): nj.debug counters first
enum : int {
  kWOutOps = 0,   // outprofile_ops
  kWProfOps,      // profile_ops
  kWSeqOps,       // seq_ops
  kWAvgOps,       // profile_avg_ops
  kWHill,         // n_hill_better
  kWVisUp,        // n_visible_update
  kWRefresh,      // n_refresh_tophits
  kWScans,        // refresh scans run (one-vs-all over the active rows)
  kWScanRows,     // rows those scans read
  kWPhases,       // phases handed to the grid
  kWFault,        // a broken invariant (kFault*): the launch ends
  kWFaultAt,      // the n_active at which it was found
  kWMaxnode,      // tree.maxnode
  kWTvAge,        // topvisible_age
  kWJoins,        // joins logged
  kNumWords
};
constexpr int kNumCounters = kWPhases + 1;

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
  double* lw;               // [cap]
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

// The int and double lists of the master inside iscr / dscr (in elements);
// sizes from M, m and ntv (the wrapper asks vft_nj_epoch_scratch for them).
struct ScratchLayout {
  int64_t anc[3], flag[3], sel, uj, kj, ent, wnode, woff, wcnt, snap, tvok, uvok, iscr_len;
  int64_t outd[3], ud, uc, kd, kc, sc, sd, snapod, tvc, uvc, dscr_len;
};

__host__ __device__ inline ScratchLayout scratch_layout(int64_t M, int64_t m, int64_t ntv) {
  ScratchLayout s;
  int64_t o = 0;
  for (int h = 0; h < 3; ++h) { s.anc[h] = o; o += m; }
  for (int h = 0; h < 3; ++h) { s.flag[h] = o; o += m; }
  const int64_t lists = 2 * m + 2;
  const int64_t sel = M > 2 * ntv + lists ? M : 2 * ntv + lists;
  s.sel = o; o += sel;
  s.uj = o; o += lists;
  s.kj = o; o += lists;
  s.ent = o; o += M;
  s.wnode = o; o += m;
  s.woff = o; o += m;
  s.wcnt = o; o += m;
  s.snap = o; o += 2 * (m + 1);
  s.tvok = o; o += ntv;
  s.uvok = o; o += lists;
  s.iscr_len = o;
  o = 0;
  for (int h = 0; h < 3; ++h) { s.outd[h] = o; o += m; }
  s.ud = o; o += lists;
  s.uc = o; o += lists;
  s.kd = o; o += lists;
  s.kc = o; o += lists;
  s.sc = o; o += M;
  s.sd = o; o += M;
  s.snapod = o; o += m + 1;
  s.tvc = o; o += ntv;
  s.uvc = o; o += lists;
  s.dscr_len = o;
  return s;
}

// The per-node arrays the decisions read most (od, vis_d, diam, noda,
// parent, vis_j, mark), which no phase reads: the master works on them in
// shared memory for the launch where they fit, and writes them back at its
// end.  Bytes for M nodes.
__host__ __device__ inline int64_t state_smem_bytes(int64_t M) {
  return M * (4 * sizeof(double) + 3 * sizeof(int32_t));
}

// ----------------------------------------------------------------- master

// The master's state and its steps.  Ph::run(cmd) runs one phase to its end.
template <class Ph>
struct Master {
  EpochParams e;            // the parameters, staged arrays pointing at smem
  const EpochParams& g;     // as given
  Ph& ph;
  bool staged;
  ScratchLayout L;
  int maxnode, tv_age, n_joins;
  double totdiam;
  long long ctr[kNumCounters];
  int fault;
  int fault_at;
  int stamp, stamp2, ucount;

  // smem: room for state_smem_bytes(M), or null to work in place
  __device__ Master(const EpochParams& params, Ph& phases, unsigned char* smem)
      : e(params), g(params), ph(phases), staged(smem != nullptr) {
    if (staged) {
      const int64_t M = e.M;
      double* d = reinterpret_cast<double*>(smem);
      int32_t* w = reinterpret_cast<int32_t*>(d + 4 * M);
      e.od = d;
      e.vis_d = d + M;
      e.diam = d + 2 * M;
      e.noda = reinterpret_cast<int64_t*>(d + 3 * M);
      e.parent = w;
      e.vis_j = w + M;
      e.mark = w + 2 * M;
      for (int64_t x = 0; x < M; ++x) {
        e.od[x] = g.od[x];
        e.vis_d[x] = g.vis_d[x];
        e.diam[x] = g.diam[x];
        e.noda[x] = g.noda[x];
        e.parent[x] = g.parent[x];
        e.vis_j[x] = g.vis_j[x];
        e.mark[x] = 0;
      }
    }
    L = scratch_layout(e.M, e.m, e.ntv);
    maxnode = (int)e.words[kWMaxnode];
    tv_age = (int)e.words[kWTvAge];
    n_joins = (int)e.words[kWJoins];
    totdiam = e.totdiam[0];
    for (int k = 0; k < kNumCounters; ++k) ctr[k] = e.words[k];
    fault = (int)e.words[kWFault];
    fault_at = (int)e.words[kWFaultAt];
    stamp = stamp2 = ucount = 0;
  }

  __device__ void save() {
    for (int k = 0; k < kNumCounters; ++k) e.words[k] = ctr[k];
    e.words[kWFault] = fault;
    e.words[kWFaultAt] = fault_at;
    e.words[kWMaxnode] = maxnode;
    e.words[kWTvAge] = tv_age;
    e.words[kWJoins] = n_joins;
    e.totdiam[0] = totdiam;
    if (staged)
      for (int64_t x = 0; x < e.M; ++x) {
        g.od[x] = e.od[x];
        g.vis_d[x] = e.vis_d[x];
        g.diam[x] = e.diam[x];
        g.noda[x] = e.noda[x];
        g.parent[x] = e.parent[x];
        g.vis_j[x] = e.vis_j[x];
      }
  }

  __device__ void set_fault(int code, int n) {
    if (!fault) {
      fault = code;
      fault_at = n;
    }
  }

  __device__ int32_t* iv(int64_t off) { return e.iscr + off; }
  __device__ double* dv(int64_t off) { return e.dscr + off; }

  // ------------------------------------------------------------- helpers
  __device__ int anc(int x) const {
    if (x < 0) return x;
    while (e.parent[x] >= 0) x = e.parent[x];
    return x;
  }
  __device__ bool active(int x) const { return e.parent[x] < 0; }
  __device__ long long allow(int n) const { return (long long)((double)n * e.stale_limit); }
  __device__ bool stale(int x, int n) const { return e.noda[x] - n > allow(n); }
  __device__ int list_len(int x) const {
    const int32_t* h = e.hits_j + (int64_t)x * e.m;
    int k = 0;
    while (k < e.m && h[k] >= 0) ++k;
    return k;
  }

  // dedupe: ubegin(), then uadd(x, list) appends x to list once
  __device__ void ubegin() {
    ++stamp;
    ucount = 0;
  }
  __device__ void uadd(int x, int32_t* list) {
    if (e.mark[x] != stamp) {
      e.mark[x] = stamp;
      list[ucount++] = x;
    }
  }

  // out-distance of node from d(node, out-profile) (apply_out_refresh)
  __device__ void apply_out(int x, double dist, double weight, int n) {
    const double nn = (double)n;
    const double top = (double)(n - 1) * (dist * weight * nn - e.selfweight[x] * e.selfdist[x]);
    const double bottom = weight * nn - e.selfweight[x];
    double od = 3.0;
    if (bottom > 0.01) od = top / bottom - e.diam[x] * (double)(n - 1) - (totdiam - e.diam[x]);
    e.od[x] = od;
    e.noda[x] = n;
  }

  __device__ double scaled_out(int x, int n) const {
    if (e.noda[x] != n) return e.od[x] * (double)(n - 1) / (double)(e.noda[x] - 1);
    return e.od[x];
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
    ++ctr[kWPhases];
  }

  // the refreshes pb[0, R) (forced setOutDistance) and the pairs
  // (pa, pb)[R, R + K) in one phase
  __device__ bool pairs_phase(int R, int K, int n) {
    for (int r = 0; r < R; ++r) e.pa[r] = -1;
    if (!run_pairs(R + K)) return false;
    for (int r = 0; r < R; ++r) apply_out(e.pb[r], e.rd[r], e.rw[r], n);
    ctr[kWOutOps] += R;
    return true;
  }

  // setCriterionBatch over (li, lj, ld)[0, K) -> lc
  __device__ bool crit_batch(int K, int n) {
    ubegin();
    for (int k = 0; k < K; ++k) {
      if (stale(e.li[k], n)) uadd(e.li[k], e.pb);
      if (stale(e.lj[k], n)) uadd(e.lj[k], e.pb);
    }
    if (!pairs_phase(ucount, 0, n)) return false;
    for (int k = 0; k < K; ++k) e.lc[k] = crit_of(e.li[k], e.lj[k], e.ld[k], n);
    return true;
  }

  // setDistCriterionBatch over the pairs (li, lj)[0, K) -> ld (dist), lw,
  // lc; neq: a node refreshed when not current (-1: none); extra: nodes also
  // refreshed when stale beyond the allowance
  __device__ bool dist_crit_batch(int K, int n, int neq = -1, const int32_t* extra = nullptr,
                                  int n_extra = 0) {
    if (K == 0) return true;
    ubegin();
    for (int k = 0; k < K; ++k) {
      if (stale(e.li[k], n)) uadd(e.li[k], e.pb);
      if (stale(e.lj[k], n)) uadd(e.lj[k], e.pb);
    }
    for (int k = 0; k < n_extra; ++k)
      if (stale(extra[k], n)) uadd(extra[k], e.pb);
    if (neq >= 0 && e.noda[neq] != n) uadd(neq, e.pb);
    const int R = ucount;
    if (R + K > e.cap) {
      set_fault(kFaultCapacity, n);
      return false;
    }
    for (int k = 0; k < K; ++k) {
      e.pa[R + k] = e.li[k];
      e.pb[R + k] = e.lj[k];
    }
    if (!pairs_phase(R, K, n)) return false;
    for (int k = 0; k < K; ++k) {
      const int i = e.li[k], j = e.lj[k];
      ++ctr[(i < e.n_seqs && j < e.n_seqs) ? kWSeqOps : kWProfOps];
      const double w = e.rw[R + k];
      e.lw[k] = w > 0 ? w : 0.01;
      e.ld[k] = e.rd[R + k] - (e.diam[i] + e.diam[j]);
    }
    return crit_batch(K, n);
  }

  // getVisibleBatch of list[0, K): ok[k], and crit[k] where ok
  __device__ bool vis_batch(const int32_t* list, int K, int n, int32_t* ok, double* crit) {
    int V = 0;
    for (int k = 0; k < K; ++k) {
      const int x = list[k];
      ok[k] = -1;
      if (x < 0 || !active(x)) continue;
      const int j = e.vis_j[x];
      if (j < 0 || !active(j)) continue;
      e.li[V] = x;
      e.lj[V] = j;
      e.ld[V] = e.vis_d[x];
      ok[k] = V++;
    }
    if (V == 0) return true;
    if (!crit_batch(V, n)) return false;
    for (int k = 0; k < K; ++k)
      if (ok[k] >= 0) crit[k] = e.lc[ok[k]];
    return true;
  }

  // the K smallest of `count` entries by (c[x], node[x]) (node null: x),
  // sorted, as indices into out; returns how many
  __device__ int select(int K, int count, const double* c, const int32_t* node, int32_t* out) {
    int nsel = 0;
    for (int x = 0; x < count; ++x) {
      const double cx = c[x];
      const int nx = node ? node[x] : x;
      if (nsel == K) {
        const int last = out[nsel - 1];
        if (!key_less(cx, nx, c[last], node ? node[last] : last)) continue;
      }
      int pos = nsel < K ? nsel++ : K - 1;
      while (pos > 0) {
        const int prev = out[pos - 1];
        if (!key_less(cx, nx, c[prev], node ? node[prev] : prev)) break;
        out[pos] = prev;
        --pos;
      }
      out[pos] = x;
    }
    return nsel;
  }

  // sortSaveBestHits: node's list from sorted candidates (already distinct,
  // none equal to node)
  __device__ void save_list(int node, int cnt, const int32_t* js, const double* ds,
                            const int32_t* order) {
    int32_t* h = e.hits_j + (int64_t)node * e.m;
    double* hd = e.hits_d + (int64_t)node * e.m;
    for (int k = 0; k < e.m; ++k) {
      h[k] = k < cnt ? js[order[k]] : -1;
      hd[k] = k < cnt ? ds[order[k]] : 0.0;
    }
    if (cnt > 0) {
      e.vis_j[node] = h[0];
      e.vis_d[node] = hd[0];
    }
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
    double* od = dv(L.outd[h]);
    const int32_t* js = e.hits_j + (int64_t)node * e.m;
    const double* ds = e.hits_d + (int64_t)node * e.m;
    for (int k = 0; k < cnt; ++k) {
      an[k] = anc(js[k]);
      const bool valid = an[k] >= 0 && an[k] != node;
      fl[k] = valid ? (an[k] != js[k] ? 3 : 1) : 0;
      od[k] = ds[k];
    }
    return cnt;
  }

  // the out-distance refreshes of one half (node when not current, and the
  // stale valid ancestors); with snap, what they overwrite
  __device__ bool half_refresh(int node, int h, int cnt, int n, int* n_snap) {
    const int32_t* an = iv(L.anc[h]);
    const int32_t* fl = iv(L.flag[h]);
    ubegin();
    if (e.noda[node] != n) uadd(node, e.pb);
    for (int k = 0; k < cnt; ++k)
      if (fl[k] && stale(an[k], n)) uadd(an[k], e.pb);
    if (n_snap) {
      int32_t* sn = iv(L.snap);
      double* so = dv(L.snapod);
      for (int r = 0; r < ucount; ++r) {
        sn[2 * r] = e.pb[r];
        sn[2 * r + 1] = (int32_t)e.noda[e.pb[r]];
        so[r] = e.od[e.pb[r]];
      }
      *n_snap = ucount;
    }
    return pairs_phase(ucount, 0, n);
  }

  // criterion and argmin over a prepped list's valid entries
  __device__ Hit best_from(int node, int h, int cnt, int n) {
    const int32_t* an = iv(L.anc[h]);
    const int32_t* fl = iv(L.flag[h]);
    const double* od = dv(L.outd[h]);
    Hit best{node, -1, 0.0, 1e20, 1e20};
    int V = 0;
    for (int k = 0; k < cnt; ++k)
      if (fl[k]) {
        e.li[V] = node;
        e.lj[V] = an[k];
        e.ld[V] = od[k];
        ++V;
      }
    if (V == 0) {
      set_fault(kFaultNoBest, node);
      return best;
    }
    if (!crit_batch(V, n)) return best;
    int kb = 0;
    for (int k = 1; k < V; ++k)
      if (e.lc[k] < e.lc[kb]) kb = k;
    best.j = e.lj[kb];
    best.weight = -1.0;
    best.dist = e.ld[kb];
    best.crit = e.lc[kb];
    return best;
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
    double* od = dv(L.outd[2]);
    int K = 0, V = 0;
    int32_t* extra = iv(L.sel);
    for (int k = 0; k < cnt; ++k) {
      if (fl[k]) extra[V++] = an[k];
      if (fl[k] & 2) {
        e.li[K] = node;
        e.lj[K] = an[k];
        ++K;
      }
    }
    if (K) {
      if (!dist_crit_batch(K, n, node, extra, V)) return none;
      int r = 0;
      for (int k = 0; k < cnt; ++k)
        if (fl[k] & 2) od[k] = e.ld[r++];
    } else if (e.noda[node] != n) {
      e.pb[0] = node;
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
    for (int h = 0; h < 2; ++h) {
      const int32_t* an = iv(L.anc[h]);
      const int32_t* fl = iv(L.flag[h]);
      for (int k = 0; k < (h ? cj : ci); ++k)
        if (fl[k] & 2) {
          e.li[K] = h ? j : i;
          e.lj[K] = an[k];
          ++K;
        }
    }
    if (K) {
      if (!dist_crit_batch(K, n)) return false;
      int r = 0;
      for (int h = 0; h < 2; ++h) {
        const int32_t* fl = iv(L.flag[h]);
        double* od = dv(L.outd[h]);
        for (int k = 0; k < (h ? cj : ci); ++k)
          if (fl[k] & 2) od[k] = e.ld[r++];
      }
    }
    Hit best = best_from(i, 0, ci, n);
    if (fault) return false;
    if (best.j != join.j && best.crit < join.crit) {
      // the j half was speculative: undo its refreshes
      const int32_t* sn = iv(L.snap);
      const double* so = dv(L.snapod);
      for (int r = 0; r < n_snap; ++r) {
        e.od[sn[2 * r]] = so[r];
        e.noda[sn[2 * r]] = sn[2 * r + 1];
      }
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
    int K = 0;
    for (int x = 0; x < maxnode; ++x) {
      if (!active(x)) continue;
      const int j = e.vis_j[x];
      if (j < 0 || !active(j)) continue;
      e.li[K] = x;
      e.lj[K] = j;
      e.ld[K] = e.vis_d[x];
      ++K;
    }
    if (K == 0) {
      set_fault(kFaultNoEntries, n);
      return false;
    }
    if (!crit_batch(K, n)) return false;
    // an entry is skipped only as the reverse of an earlier saved one, so
    // the first 2 * ntv entries fill the set
    int32_t* order = iv(L.sel);
    const int cnt = select(2 * (int)e.ntv, K, e.lc, e.li, order);
    ++stamp2;
    int i_save = 0;
    for (int k = 0; k < cnt && i_save < e.ntv; ++k) {
      const int vi = e.li[order[k]], vj = e.lj[order[k]];
      if (e.mark2[vi] == stamp2 && e.partner[vi] == vj) continue;
      e.tv[i_save++] = vi;
      e.mark2[vi] = stamp2;
      e.partner[vi] = vj;
      e.mark2[vj] = stamp2;
      e.partner[vj] = vi;
    }
    for (int k = i_save; k < e.ntv; ++k) e.tv[k] = -1;
    tv_age = 0;
    return true;
  }

  // updateTopVisible
  __device__ bool update_top_visible(int n, int i_in, int hit_j, double hit_dist) {
    bool b_in = false;
    for (int k = 0; k < e.ntv; ++k) {
      const int x = e.tv[k];
      if (x == i_in) {
        b_in = true;
        break;
      }
      if (x < 0 || !active(x)) {
        e.tv[k] = i_in;
        b_in = true;
        break;
      }
    }
    if (b_in) return true;
    int32_t* ok = iv(L.tvok);
    double* tc = dv(L.tvc);
    if (!vis_batch(e.tv, (int)e.ntv, n, ok, tc)) return false;
    int worst_pos = -1;
    double worst = -1e20;
    for (int k = 0; k < e.ntv; ++k) {
      const int x = e.tv[k];
      if (ok[k] < 0) {
        e.tv[k] = i_in;
        return true;
      }
      if (x == hit_j && e.vis_j[x] == i_in) return true;
      if (tc[k] >= worst) {
        worst_pos = k;
        worst = tc[k];
      }
    }
    if (worst_pos >= 0) {
      e.li[0] = i_in;
      e.lj[0] = hit_j;
      e.ld[0] = hit_dist;
      if (!crit_batch(1, n)) return false;
      if (e.lc[0] < worst) e.tv[worst_pos] = i_in;
    }
    return true;
  }

  // updateVisible of the nodes kj[0, cnt) against node, their (dist, crit)
  // in kd, kc
  __device__ bool update_visible(int n, int node, int cnt) {
    const int32_t* kj = iv(L.kj);
    const double* kd = dv(L.kd);
    const double* kc = dv(L.kc);
    int32_t* ok = iv(L.uvok);
    double* vc = dv(L.uvc);
    if (!vis_batch(kj, cnt, n, ok, vc)) return false;
    for (int k = 0; k < cnt; ++k) {
      const int j = kj[k];
      if (ok[k] < 0 || kc[k] < vc[k]) {
        if (ok[k] >= 0) ++ctr[kWVisUp];
        e.vis_j[j] = node;
        e.vis_d[j] = kd[k];
        if (!update_top_visible(n, j, node, kd[k])) return false;
      }
    }
    return true;
  }

  // ------------------------------------------------------------ search
  // the visible-set walk of topHitNJSearch when the top-visible set is
  // reset early
  __device__ bool walk_visible(int n) {
    int K = 0;
    for (int x = 0; x < maxnode; ++x) {
      if (!active(x)) continue;
      const int vj = e.vis_j[x];
      int newj = anc(vj);
      if (newj >= 0 && newj != vj) {
        if (newj == x) {
          newj = 0;
          while (!active(newj) || newj == x) ++newj;
        }
        e.li[K] = x;
        e.lj[K] = newj;
        ++K;
      }
    }
    if (K == 0) return true;
    if (!dist_crit_batch(K, n)) return false;
    for (int k = 0; k < K; ++k) {
      e.vis_j[e.li[k]] = e.lj[k];
      e.vis_d[e.li[k]] = e.ld[k];
    }
    return true;
  }

  // topHitNJSearch
  __device__ Hit search(int n) {
    Hit join{-1, -1, 0.0, 1e20, 1e20};
    int32_t* ok = iv(L.tvok);
    double* tc = dv(L.tvc);
    for (;;) {
      if (!vis_batch(e.tv, (int)e.ntv, n, ok, tc)) return join;
      int n_cand = 0, best = -1;
      double best_c = 1e20;
      for (int k = 0; k < e.ntv; ++k)
        if (ok[k] >= 0) {
          ++n_cand;
          if (best < 0 || tc[k] < best_c) {
            best = e.tv[k];
            best_c = tc[k];
          }
        }
      ++tv_age;
      if (2 * tv_age > e.m || (3 * n_cand < e.ntv && 3 * n_cand < n)) {
        if (tv_age <= 2 && !walk_visible(n)) return join;
        if (!reset_top_visible(n)) return join;
        continue;
      }
      if (best < 0 || !active(best)) {
        set_fault(kFaultNoBest, n);
        return join;
      }
      join = Hit{best, e.vis_j[best], -1.0, e.vis_d[best], best_c};
      break;
    }
    for (;;) {
      const bool changed = hill_climb_step(join, n);
      if (fault || !changed) break;
      ++ctr[kWHill];
    }
    return join;
  }

  // ------------------------------------------------------ top-hits merge
  // _refresh_node: the new node's list from a one-vs-all scan, then the
  // lists of its top hits, then a new top-visible set
  __device__ bool refresh_node(int node, int n) {
    ++ctr[kWRefresh];
    e.age[node] = 0;
    ubegin();
    for (int x = 0; x < maxnode; ++x)
      if (active(x) && e.noda[x] != n) uadd(x, e.pb);
    if (!pairs_phase(ucount, 0, n)) return false;

    PhaseCmd q{};
    q.kind = kPhQuery;
    q.t = node;
    run(q);
    int K = 0;
    for (int x = 0; x < maxnode; ++x)
      if (active(x)) e.pa[K++] = x;
    if (K > e.cap) {
      set_fault(kFaultCapacity, n);
      return false;
    }
    PhaseCmd sc{};
    sc.kind = kPhScan;
    sc.n = K;
    run(sc);
    ++ctr[kWScans];
    ctr[kWScanRows] += K;
    ctr[kWProfOps] += K;
    double* c = dv(L.sc);
    double* d = dv(L.sd);
    int k = 0;
    for (int x = 0; x < maxnode; ++x) {
      if (k < K && e.pa[k] == x) {
        const double dist = e.rd[k] - (e.diam[node] + e.diam[x]);
        d[x] = dist;
        c[x] = crit_of(node, x, dist, n);
        ++k;
      } else {
        d[x] = 1e20;
        c[x] = 1e20;
      }
    }
    c[node] = 2e20;   // sorts after every slot; never saved
    int32_t* order = iv(L.sel);
    int cnt = select((int)e.m, maxnode, c, nullptr, order);
    if (cnt > 0 && order[cnt - 1] == node) --cnt;
    // the candidate lists are the slots themselves
    int32_t* ids = iv(L.ent);
    for (int x = 0; x < maxnode; ++x) ids[x] = x;
    save_list(node, cnt, ids, d, order);

    // expand the lists of the new node's top hits
    const int32_t* top = e.hits_j + (int64_t)node * e.m;
    const int n_top = list_len(node);
    int32_t* wnode = iv(L.wnode);
    int32_t* woff = iv(L.woff);
    int32_t* wcnt = iv(L.wcnt);
    int W = 0, tot = 0;
    for (int t = 0; t < n_top; ++t) {
      const int jn = top[t];
      const int len = list_len(jn);
      if (!active(jn) || len == 0) continue;
      e.age[jn] = 0;
      ubegin();
      int32_t* u = e.lj + tot;
      const int32_t* hj = e.hits_j + (int64_t)jn * e.m;
      for (int r = 0; r < len; ++r) {
        const int a = anc(hj[r]);
        if (a >= 0 && a != jn) uadd(a, u);
      }
      if (node != jn) uadd(node, u);
      for (int r = 0; r < n_top; ++r) {
        const int a = anc(top[r]);
        if (a >= 0 && a != jn) uadd(a, u);
      }
      for (int r = 0; r < ucount; ++r) e.li[tot + r] = jn;
      wnode[W] = jn;
      woff[W] = tot;
      wcnt[W] = ucount;
      tot += ucount;
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
        const int got = select((int)e.m, wcnt[w], e.lc + off, e.lj + off, order);
        save_list(wnode[w], got, e.lj + off, e.ld + off, order);
      }
    }
    return reset_top_visible(n);
  }

  // topHitJoin of the new node (n: n_active after the join)
  __device__ bool top_hit_join(int node, int n) {
    const int c0 = e.kids[2 * node], c1 = e.kids[2 * node + 1];
    const int len0 = list_len(c0), len1 = list_len(c1);
    if (len0 == 0 || len1 == 0) {
      set_fault(kFaultNoList, node);
      return false;
    }
    int32_t* uj = iv(L.uj);
    ubegin();
    for (int h = 0; h < 2; ++h) {
      const int32_t* hj = e.hits_j + (int64_t)(h ? c1 : c0) * e.m;
      for (int r = 0; r < (h ? len1 : len0); ++r) {
        const int a = anc(hj[r]);
        if (a >= 0 && a != node) uadd(a, uj);
      }
    }
    const int nu = ucount;
    double* ud = dv(L.ud);
    double* uc = dv(L.uc);
    if (nu > 0) {
      for (int k = 0; k < nu; ++k) {
        e.li[k] = node;
        e.lj[k] = uj[k];
      }
      if (!dist_crit_batch(nu, n)) return false;
      for (int k = 0; k < nu; ++k) {
        ud[k] = e.ld[k];
        uc[k] = e.lc[k];
      }
    }
    for (int h = 0; h < 2; ++h)
      for (int r = 0; r < e.m; ++r) {
        e.hits_j[(int64_t)(h ? c1 : c0) * e.m + r] = -1;
        e.hits_d[(int64_t)(h ? c1 : c0) * e.m + r] = 0.0;
      }
    e.age[node] = (e.age[c0] + e.age[c1] + 1) / 2 + 1;
    const bool b_use =
        nu == n - 1 || (e.age[node] <= e.age_limit && nu >= e.refresh_thresh);
    if (!b_use) return refresh_node(node, n);
    const int n_save = nu < e.m ? nu : (int)e.m;
    int32_t* order = iv(L.sel);
    select(n_save, nu, uc, uj, order);
    save_list(node, n_save, uj, ud, order);
    if (!update_top_visible(n, node, e.vis_j[node], e.vis_d[node])) return false;
    int32_t* kj = iv(L.kj);
    double* kd = dv(L.kd);
    double* kc = dv(L.kc);
    for (int k = 0; k < n_save; ++k) {
      kj[k] = uj[order[k]];
      kd[k] = ud[order[k]];
      kc[k] = uc[order[k]];
    }
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
    e.join_i[n_joins] = i;
    e.join_j[n_joins] = j;
    ++n_joins;
    const int node = maxnode++;
    e.kids[2 * node] = i < j ? i : j;
    e.kids[2 * node + 1] = i < j ? j : i;
    e.parent[i] = node;
    e.parent[j] = node;

    // fresh out-distances of i and j, then their distance and criterion
    ubegin();
    if (e.noda[i] != n) uadd(i, e.pb);
    if (e.noda[j] != n) uadd(j, e.pb);
    const int R = ucount;
    e.pa[R] = i;
    e.pb[R] = j;
    if (!pairs_phase(R, 1, n)) return false;
    ++ctr[(i < e.n_seqs && j < e.n_seqs) ? kWSeqOps : kWProfOps];
    join.weight = e.rw[R] > 0 ? e.rw[R] : 0.01;
    join.dist = e.rd[R] - (e.diam[i] + e.diam[j]);

    const double raw_ij = join.dist + e.diam[i] + e.diam[j];
    const double dist_ij = join.dist;
    const double delta = (e.od[i] - e.od[j]) / (double)(n - 2);
    e.bl[i] = (dist_ij + delta) / 2.0;
    e.bl[j] = (dist_ij - delta) / 2.0;

    double bw = 0.5;
    const double var_ij = raw_ij - e.vard[i] - e.vard[j];
    if (e.bionj && join.weight > 0.01 && var_ij > 0.001) {
      // BIONJ weighting, Gascuel 1997 eq. 9 via out-profile moments
      e.pa[0] = -1;
      e.pb[0] = i;
      e.pa[1] = -1;
      e.pb[1] = j;
      if (!run_pairs(2)) return false;
      ctr[kWOutOps] += 2;
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
    e.diam[node] = bw * (e.bl[i] + e.diam[i]) + (1 - bw) * (e.bl[j] + e.diam[j]);
    e.vard[node] = bw * e.vard[i] + (1 - bw) * e.vard[j] + bw * (1 - bw) * var_ij;

    PhaseCmd c{};
    c.kind = kPhJoin;
    c.i = i;
    c.j = j;
    c.t = node;
    c.bw = e.bionj ? bw : 0.5;
    c.n_old = stop ? 0 : n;
    run(c);
    ++ctr[kWAvgOps];
    e.selfdist[node] = e.rd[0];
    e.selfweight[node] = e.rw[0];
    if (stop) return true;
    totdiam += e.diam[node] - e.diam[i] - e.diam[j];
    return top_hit_join(node, n - 1);
  }

  // this launch's joins
  __device__ void run_launch() {
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
    PhaseCmd x{};
    x.kind = kPhExit;
    ph.run(x);
  }
};

}  // namespace
