// One NJ join of the host join loop in one cooperative launch for Hopper
// (sm_90a): the fused join step of the modes that the join epoch leaves to
// the host loop (-fastest, -2nd).  Plain C interface, loaded through
// ctypes (veryfasttree_tpu_torch/ops/_build.py, wrapper
// ops/join_kernels.py, caller engine/fused.py).
//
// Replaces the XLA program of the JAX package's fused join
// (veryfasttree_tpu/engine/fused.py:56 _fused_join), which is not a Pallas
// kernel: one launch computes what the port's unfused loop body
// (engine/nj.py NeighbourJoining._join_loop_host) computes with its
// per-call store kernels, in its order, and packs it into one float64
// vector that the host fetches once:
//   the chosen pair's distance, and i's and j's distances to the old
//   out-profile (their out-distances where stale, and the BIONJ moments);
//   the branch lengths, the BIONJ weight, the new node's diameters (thread
//   0, double arithmetic in the host loop's order);
//   the weighted average into the new node's row (average_pos,
//   me_store.cuh) and the incremental out-profile update (out_update_pos,
//   nj_epoch.cuh), position by position;
//   the new node's self-distance and its distance to the updated
//   out-profile; the merge candidates' pair distances to the new node and
//   their distances to the updated out-profile; the prefetch rows'
//   distances to it.
// Every distance is one 128-thread group with the single-call kernel's
// thread-to-position map and sum order (pair_partial / pair_finish), the
// average and the update those of me_average_kernel and the epoch, so each
// value equals the unfused loop's on the per-call kernels bit for bit.
// Compiled with -fmad=false, as the epoch: the scalar expressions round as
// numpy's do.
// Bound: latency.  A join reads a few store rows (three pairs, two
// children, one new row) and then one row per candidate and prefetch row,
// about 200 rows of 10 KB at N=2000, P=500: 2 MB, under a microsecond at
// 3.35 TB/s, against the launch, one copy in and one fetch out.
// Design: block 0 runs the join itself, its first three groups the three
// pairs, all its threads the positions of the average and update; it then
// raises a flag that the grid's other blocks wait on, and every group of
// the grid takes the pairs after the join in turn.  No float atomics.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "me_store.cuh"
#include "nj_epoch.cuh"

namespace {

constexpr int kJoinThreads = 512;
constexpr int kJoinGroups = kJoinThreads / kDistThreads;
constexpr int kBadRow = -1;
constexpr int kBadArgs = -2;

// the input scalars, in ops/join_kernels.py IN's order
enum : int {
  kInNActive = 0, kInStoredOutI, kInStoredOutJ, kInRefreshI, kInRefreshJ, kInSelfdistI,
  kInSelfweightI, kInSelfdistJ, kInSelfweightJ, kInDiamI, kInDiamJ, kInVardI, kInVardJ,
  kInTotdiam, kInPen, kNumIn
};
// the output scalars, in ops/join_kernels.py OUT's order
enum : int {
  kOutDist = 0, kOutWeight, kOutCrit, kOutOutI, kOutOutJ, kOutBlI, kOutBlJ, kOutBw, kOutDiamNew,
  kOutVardNew, kOutSelfdistNew, kOutSelfweightNew, kOutDoutNew, kOutWoutNew, kNumOut
};

// Every field is 8 bytes, in the order of ops/join_kernels.py JoinParams.
struct JoinParams {
  int8_t* codes;
  float* W;
  float* U;
  const float* code_freq;   // [C, C]
  const double* ev;         // [C] eigenvalues (matrix mode) or null
  const float* et;          // [C] eigentot (matrix mode) or null
  float* w_out;             // [P] out-profile weights, updated in place
  float* f_out;             // [P, C] out-profile frequencies, updated in place
  float* qU;                // [P, C] scratch: the out-profile as a query
  const double* scal;       // [kNumIn] (set by the C entry)
  const int32_t* rows;      // the candidates, then the prefetch rows (set by the C entry)
  double* out;              // [kNumOut + 4 n_cand + 2 n_pref]
  uint32_t* flag;           // holds seq once block 0 has written the join
  int64_t n_rows, leaf_rows, P, C;
  int64_t i, j, t;          // the joined rows and the new node's
  int64_t n_cand, n_pref;
  int64_t bionj, cons;      // -bionj; constraints (add the penalty)
  double tol;               // f_post_total_tolerance
  int64_t seq;              // this launch's number
};

__device__ __forceinline__ void group_sync(int g) {
  // named barrier 1 + g, over the group's 128 threads
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kDistThreads) : "memory");
}

// one pair distance by the calling group (t: thread of the group): the
// single-call kernel's sums (me_store.cu me_pair_dist_kernel); on t == 0
template <int C>
__device__ __forceinline__ void group_pair(const StoreView& s, int64_t ra, int64_t rb,
                                           const float* qU, const float* qW, const double* ev,
                                           int t, int g, double* s_den, double* s_dots,
                                           double& dist, double& denom) {
  double den, dots;
  pair_partial<C>(s, ra, rb, qU, qW, ev, t, den, dots);
  if ((t & 31) == 0) {
    s_den[t >> 5] = den;
    s_dots[t >> 5] = dots;
  }
  group_sync(g);
  if (t == 0) pair_finish(s_den, s_dots, ev, dist, denom);
  group_sync(g);
}

// a node's out-distance from its distance to the out-profile at n_active =
// n (the host's apply_out_refresh)
__device__ double out_distance(double dist, double weight, double selfdist, double selfweight,
                               double diam, double totdiam, int64_t n) {
  const double nn = (double)n;
  const double top = (double)(n - 1) * (dist * weight * nn - selfweight * selfdist);
  const double bottom = weight * nn - selfweight;
  if (!(bottom > 0.01)) return 3.0;
  return top / bottom - diam * (double)(n - 1) - (totdiam - diam);
}

// The join's scalars (the host loop's expressions in its order) from the
// pair (i, j) and i's and j's distances to the old out-profile; writes
// out[kOutDist .. kOutVardNew] and returns the average's weight of row i.
__device__ double join_scalars(const JoinParams& a, const double (&pr)[3][2]) {
  const double* s = a.scal;
  const int64_t n = (int64_t)s[kInNActive];
  const double nn = (double)n;
  const double diam_i = s[kInDiamI], diam_j = s[kInDiamJ];
  const double vard_i = s[kInVardI], vard_j = s[kInVardJ];
  const double sd_i = s[kInSelfdistI], sw_i = s[kInSelfweightI];
  const double sd_j = s[kInSelfdistJ], sw_j = s[kInSelfweightJ];
  const double out_i = s[kInRefreshI] > 0.0 ? out_distance(pr[1][0], pr[1][1], sd_i, sw_i, diam_i,
                                                           s[kInTotdiam], n)
                                            : s[kInStoredOutI];
  const double out_j = s[kInRefreshJ] > 0.0 ? out_distance(pr[2][0], pr[2][1], sd_j, sw_j, diam_j,
                                                           s[kInTotdiam], n)
                                            : s[kInStoredOutJ];
  const double weight = pr[0][1] > 0.0 ? pr[0][1] : 0.01;
  double dist = pr[0][0] - (diam_i + diam_j);
  if (a.cons) dist = dist + s[kInPen];
  const double crit = dist - (out_i + out_j) / (double)(n - 2);

  const double raw_ij = dist + diam_i + diam_j;
  const double delta = (out_i - out_j) / (double)(n - 2);
  const double bl_i = (dist + delta) / 2.0;
  const double bl_j = (dist - delta) / 2.0;
  double bw = 0.5;
  const double var_ij = raw_ij - vard_i - vard_j;
  if (a.bionj && weight > 0.01 && var_ij > 0.001) {
    // BIONJ weighting, Gascuel 1997 eq. 9 via out-profile moments
    const double do0 = pr[1][0], wo0 = pr[1][1], do1 = pr[2][0], wo1 = pr[2][1];
    const double var_i_weight = nn * wo0 - sw_i - weight;
    const double var_j_weight = nn * wo1 - sw_j - weight;
    const double var_i_top = do0 * wo0 * nn - sd_i * sw_i - raw_ij * weight;
    const double var_j_top = do1 * wo1 * nn - sd_j * sw_j - raw_ij * weight;
    if (var_j_weight > 0.01 && var_i_weight > 0.01) {
      const double d_pv_out =
          (double)(n - 2) * (var_j_top / var_j_weight - var_i_top / var_i_weight);
      const double d_var_diam = (double)(n - 2) * (vard_i - vard_j);
      bw = 0.5 + (d_pv_out + d_var_diam) / ((double)(2 * (n - 2)) * var_ij);
    }
    bw = 0.0 > bw ? 0.0 : bw;
    bw = 1.0 < bw ? 1.0 : bw;
  }
  double* o = a.out;
  o[kOutDist] = dist;
  o[kOutWeight] = weight;
  o[kOutCrit] = crit;
  o[kOutOutI] = out_i;
  o[kOutOutJ] = out_j;
  o[kOutBlI] = bl_i;
  o[kOutBlJ] = bl_j;
  o[kOutBw] = bw;
  o[kOutDiamNew] = bw * (bl_i + diam_i) + (1 - bw) * (bl_j + diam_j);
  o[kOutVardNew] = bw * vard_i + (1 - bw) * vard_j + bw * (1 - bw) * var_ij;
  return a.bionj ? bw : 0.5;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

template <int C>
__global__ void __launch_bounds__(kJoinThreads, 1)
    nj_join_step_kernel(const __grid_constant__ JoinParams a) {
  __shared__ double s_den[kJoinGroups][kDistWarps], s_dots[kJoinGroups][kDistWarps];
  __shared__ double s_pair[3][2];
  __shared__ double s_bw;
  const StoreView s{a.codes, a.W, a.U, a.code_freq, a.leaf_rows, (int)a.P};
  const int g = threadIdx.x / kDistThreads, t = threadIdx.x % kDistThreads;
  const int P = (int)a.P;
  if (blockIdx.x == 0) {
    // the old out-profile as a query (MEProfiles.out_query)
    for (int x = threadIdx.x; x < P * C; x += kJoinThreads)
      a.qU[x] = __fmul_rn(a.w_out[x / C], a.f_out[x]);
    __syncthreads();
    if (g < 3) {
      // (i, j), then (out-profile, i) and (out-profile, j)
      const int64_t ra = g == 0 ? a.i : -1, rb = g == 1 ? a.i : a.j;
      double dist, denom;
      group_pair<C>(s, ra, rb, a.qU, a.w_out, a.ev, t, g, s_den[g], s_dots[g], dist, denom);
      if (t == 0) {
        s_pair[g][0] = dist;
        s_pair[g][1] = denom;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) s_bw = join_scalars(a, s_pair);
    __syncthreads();
    // the average into row t, then the out-profile update and the new
    // query at each position (the epoch's kPhJoin)
    const double bw_avg = s_bw;
    const float bw = (float)bw_avg;
    const float omb = __fsub_rn(1.0f, bw);
    const bool half = bw_avg == 0.5;
    const float fallback = (float)(1.0 / C);
    EpochParams e{};
    e.code_freq = a.code_freq;
    e.et = a.et;
    e.w_out = a.w_out;
    e.f_out = a.f_out;
    e.qU = a.qU;
    e.tol = a.tol;
    for (int p = threadIdx.x; p < P; p += kJoinThreads) {
      average_pos<C>(s, a.codes, a.W, a.U, a.et, a.t, a.i, a.j, p, bw, omb, half, (float)a.tol,
                     fallback);
      out_update_pos<C>(e, s, a.i, a.j, a.t, (int64_t)a.scal[kInNActive], p);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(a.flag, (uint32_t)a.seq);
  } else {
    if (threadIdx.x == 0) {
      while (load_volatile(a.flag) != (uint32_t)a.seq) __nanosleep(32);
      __threadfence();
    }
    __syncthreads();
  }
  // the pairs after the join, a group each in turn: the new node's
  // self-distance and out-distance, the candidates' pair and
  // out-distances, the prefetch rows' out-distances
  const int64_t nc = a.n_cand, np = a.n_pref;
  const int64_t n_items = 2 + 2 * nc + np;
  double* o = a.out;
  for (int64_t k = (int64_t)blockIdx.x * kJoinGroups + g; k < n_items;
       k += (int64_t)gridDim.x * kJoinGroups) {
    int64_t ra = -1, rb;
    double *od, *ow;
    if (k == 0) {
      ra = rb = a.t;
      od = o + kOutSelfdistNew;
      ow = o + kOutSelfweightNew;
    } else if (k == 1) {
      rb = a.t;
      od = o + kOutDoutNew;
      ow = o + kOutWoutNew;
    } else if (k < 2 + nc) {
      const int64_t c = k - 2;
      ra = a.t;
      rb = a.rows[c];
      od = o + kNumOut + c;
      ow = o + kNumOut + nc + c;
    } else if (k < 2 + 2 * nc) {
      const int64_t c = k - 2 - nc;
      rb = a.rows[c];
      od = o + kNumOut + 2 * nc + c;
      ow = o + kNumOut + 3 * nc + c;
    } else {
      const int64_t r = k - 2 - 2 * nc;
      rb = a.rows[nc + r];
      od = o + kNumOut + 4 * nc + r;
      ow = o + kNumOut + 4 * nc + np + r;
    }
    double dist, denom;
    group_pair<C>(s, ra, rb, a.qU, a.w_out, a.ev, t, g, s_den[g], s_dots[g], dist, denom);
    if (t == 0) {
      *od = dist;
      *ow = denom;
    }
  }
}

bool row_in(int64_t r, int64_t lo, int64_t hi) { return r >= lo && r < hi; }

template <int C>
int launch(JoinParams& a, cudaStream_t st, int* used) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nj_join_step_kernel<C>,
                                                        kJoinThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return kBadArgs;
  // a group per pair after the join, as many blocks as that takes, at most
  // the blocks that are resident at once (the others wait on block 0)
  const int64_t items = 2 + 2 * a.n_cand + a.n_pref;
  int64_t grid = (items + kJoinGroups - 1) / kJoinGroups;
  const int64_t cap = (int64_t)sms * per_sm;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  *used = (int)grid;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)nj_join_step_kernel<C>, dim3((int)grid),
                                          dim3(kJoinThreads), args, 0, st);
}

}  // namespace

extern "C" {

// One fused join.  params: a JoinParams (void here, as the type is local to
// this file) without scal and rows; inp_host: kNumIn doubles, then the
// n_cand + n_pref int32 rows, inp_bytes long, copied into inp_dev (device
// memory of at least inp_bytes) in stream order.  Returns 0, a cudaError,
// -1 for a row outside the store (nothing launched), or -2 for arguments
// or a card the kernel does not take; *used_grid gets the grid.
int vft_nj_join_step_f32(const void* params, const void* inp_host, int64_t inp_bytes,
                         void* inp_dev, int* used_grid, void* stream) {
  JoinParams a;
  memcpy(&a, params, sizeof(a));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_rows_in = a.n_cand + a.n_pref;
  if (a.P % 16 != 0 || a.n_cand < 0 || a.n_pref < 0 ||
      inp_bytes != kNumIn * (int64_t)sizeof(double) + n_rows_in * (int64_t)sizeof(int32_t))
    return kBadArgs;
  const int32_t* rows =
      reinterpret_cast<const int32_t*>(static_cast<const char*>(inp_host) + kNumIn * sizeof(double));
  if (!row_in(a.i, 0, a.n_rows) || !row_in(a.j, 0, a.n_rows) ||
      !row_in(a.t, a.leaf_rows, a.n_rows))
    return kBadRow;
  for (int64_t k = 0; k < n_rows_in; ++k)
    if (!row_in(rows[k], 0, a.n_rows)) return kBadRow;
  cudaError_t err = cudaMemcpyAsync(inp_dev, inp_host, (size_t)inp_bytes,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  a.scal = static_cast<const double*>(inp_dev);
  a.rows = reinterpret_cast<const int32_t*>(static_cast<char*>(inp_dev) + kNumIn * sizeof(double));
  if (a.C == 4) return launch<4>(a, st, used_grid);
  if (a.C == 20) return launch<20>(a, st, used_grid);
  return kBadArgs;
}

}  // extern "C"
