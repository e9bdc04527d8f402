// The NJ join phase in one persistent cooperative kernel for Hopper
// (sm_90a): the port's host join loop with the top-hits heuristic, join
// after join, up to the next out-profile reset, in one launch.  Plain C
// interface, loaded through ctypes (veryfasttree_tpu_torch/ops/_build.py,
// wrapper ops/epoch_kernels.py).
//
// Replaces the XLA program of the JAX package's device join epoch
// (veryfasttree_tpu/engine/epoch.py _epoch_run, one lax.while_loop per
// segment) and its fused join (engine/fused.py _fused_join).
// Bound: latency.  A join reads a handful of store rows (its pair and
// out-profile distances, two children averaged into one new row) and, on a
// top-hits refresh, every active row once; a few MB per join phase at N=2000
// against tens of microseconds of dependent decisions per join.  The host
// loop spent 3-5 ms per join between its per-call launches and fetches.
// Design: block 0's first warp takes every decision (nj_epoch.cuh, in
// double, in the host loop's order), its lanes splitting each list loop and
// each sweep over the nodes, with the per-node arrays it reads most and its
// small lists in shared memory where they fit (smem_plan) and its
// parameters in the constant bank (__grid_constant__).  Each wide step is a
// phase for the rest of the grid: every other 128-thread group of the
// cooperative launch (one 512-thread block per SM) waits on a sequence word,
// runs its share of the phase's items and counts itself done; the master's
// lane 0 waits for the count.
// A pair distance is one group with the single-call kernel's
// thread-to-position map (me_store.cuh pair_partial / pair_finish), a scanned
// row one warp with the scan kernels' bodies (nj_scan.cuh), a position of an
// average one thread (average_pos), so no result depends on the grid size.
// Compiled with -fmad=false: every double expression of the decisions rounds
// as numpy's does.  No float atomics; the handshake words are the only
// atomics.
//
// With VFT_EPOCH_CONS defined (nj_epoch_cons.cu) this file compiles the
// epoch under -constraints instead: the kernel nj_epoch_cons_kernel and the
// entry vft_nj_epoch_cons_f32, whose master adds the join penalties
// (nj_epoch.cuh DevicePhasesCons); a translation unit of its own, so that
// the unconstrained kernel's code does not change with it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "me_store.cuh"
#include "nj_scan.cuh"
#include "nj_epoch.cuh"

namespace {

constexpr int kEpochThreads = 512;
constexpr int kGroupsPerBlock = kEpochThreads / kDistThreads;
constexpr int kBadArgs = -2;

__device__ __forceinline__ void group_sync(int g) {
  // named barrier 1 + g, over the group's 128 threads
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kDistThreads) : "memory");
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// the master warp's collectives (nj_epoch.cuh Master's Wp)
struct DeviceWarp {
  static __device__ __forceinline__ unsigned lane() { return threadIdx.x & 31u; }
  static __device__ __forceinline__ void sync() { __syncwarp(); }
  static __device__ __forceinline__ unsigned ballot(bool p) {
    return __ballot_sync(0xffffffffu, p);
  }
  static __device__ __forceinline__ unsigned match(int x) {
    return __match_any_sync(0xffffffffu, x);
  }
  static __device__ __forceinline__ int shfl(int v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
  static __device__ __forceinline__ double shfl(double v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
  static __device__ __forceinline__ int shfl_xor(int v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  static __device__ __forceinline__ double shfl_xor(double v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
};

// the phases block 0 runs itself: its groups 1-3 meet the master's warp at
// two named barriers (the command, then the results) instead of the grid's
// sequence words; a phase of at most kLocalItems pairs, and the join's
// average (spread over the three groups, then its self-distance on one),
// and every phase when the grid is one block
constexpr int kLocalGroups = kGroupsPerBlock - 1;
constexpr int kLocalItems = 2 * kLocalGroups;
constexpr int kLocalThreads = 32 + kLocalGroups * kDistThreads;  // the master warp and the groups
constexpr int kBarStart = 5, kBarDone = 6, kBarJoin = 7;          // group_sync takes 1-4

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// the master's side of a phase, called by every lane: lane 0 publishes the
// command and waits for every group; the fences put every lane's items
// before the publish and the phase's results before every lane's reads
struct DevicePhases {
  static constexpr bool kCons = false;
  const EpochParams& e;
  PhaseCmd* local_cmd;   // shared memory: block 0's command
  uint32_t seq;
  uint32_t n_groups;     // the grid's worker groups (0: one block)

  __device__ bool local(const PhaseCmd& c) const {
    return n_groups == 0 || (c.kind == kPhPairs && c.n <= kLocalItems) || c.kind == kPhJoin;
  }

  __device__ void run(const PhaseCmd& c) {
    if (c.kind == kPhExit) {
      run_local(c);
      if (n_groups) run_grid(c);
    } else if (local(c)) {
      ProbeScope probe(kNjPLocal);
      run_local(c);
    } else {
      ProbeScope probe(kNjPWait);
      run_grid(c);
    }
  }

  __device__ void run_local(const PhaseCmd& c) {
    __syncwarp();
    if ((threadIdx.x & 31u) == 0) *local_cmd = c;
    named_sync(kBarStart, kLocalThreads);
    if (c.kind != kPhExit) named_sync(kBarDone, kLocalThreads);
  }

  __device__ void run_grid(const PhaseCmd& c) {
    __threadfence();
    __syncwarp();
    if ((threadIdx.x & 31u) == 0) {
      const unsigned long long published = c.kind == kPhExit ? 0 : probe_publish();
      *e.cmd = c;
      __threadfence();
      ++seq;
      atomicExch(&e.ctl[0], seq);
      if (c.kind != kPhExit) {
        const uint32_t target = seq * n_groups;
        while (load_volatile(&e.ctl[1]) < target) {
        }
        __threadfence();
        probe_resume(published, c.kind == kPhScan);
      }
    }
    __syncwarp();
    __threadfence();
  }
};

#ifdef VFT_EPOCH_CONS
// the phases of the constrained master: the same, with the counts
struct DevicePhasesCons : DevicePhases {
  static constexpr bool kCons = true;
  EpochCons cons;
};
#endif

// one pair distance by the calling group (t: thread of the group)
template <int C>
__device__ __forceinline__ void group_pair(const EpochParams& e, const StoreView& s, int64_t ra,
                                           int64_t rb, int t, int g, double* s_den,
                                           double* s_dots, double& dist, double& denom) {
  double den, dots;
  pair_partial<C>(s, ra, rb, e.qU, e.w_out, e.ev, t, den, dots);
  if ((t & 31) == 0) {
    s_den[t >> 5] = den;
    s_dots[t >> 5] = dots;
  }
  group_sync(g);
  if (t == 0) pair_finish(s_den, s_dots, e.ev, dist, denom);
  group_sync(g);
}

// one scanned row by the calling warp: (dist, denom) on lane 0
template <int C>
__device__ __forceinline__ void warp_scan_row(const EpochParams& e, int64_t row, int lane,
                                              double& dist, double& den) {
  const int P = (int)e.P;
  if (row < e.leaf_rows) {
    // the query table in the code scan's layout: tile t at t * tile_len of
    // each code's row of len, the weights in row C (nj_scan.cuh
    // codes_table_index)
    const int p_tile = codes_p_tile(P, C), tile_len = codes_tile_len(p_tile);
    const int len = (int)codes_table_len(P, C);
    double pick = 0.0;
    den = 0.0;
    for (int p0 = 0, t = 0; p0 < P; p0 += p_tile, ++t) {
      const int pt = min(p_tile, P - p0);
      codes_row_tile<double, true>(e.codes + row * P + p0, pt, C, e.qg + t * tile_len, len,
                                   e.qg + C * len + t * tile_len, lane, den, pick);
    }
    den = scan_warp_sum(den);
    pick = scan_warp_sum(pick);
    dist = row_dist(pick, den, e.use_matrix != 0);
    return;
  }
  const int64_t phys = row - e.leaf_rows;
  double dots;
  dense_row<double, true>(e.U + phys * P * C, e.W + phys * P, e.qa, e.qw, P * C, P, lane, dots,
                          den);
  dist = row_dist(dots, den, e.use_matrix != 0);
}

// Group gid's share of a phase over n_groups groups (g: its block's group,
// t: its thread).  The join runs on block 0 alone (DevicePhases::local):
// its average over the three groups, which meet at kBarJoin, then its
// self-distance on the first.
template <int C>
__device__ void phase_share(const EpochParams& e, const PhaseCmd& c, int gid, int n_groups, int g,
                            int t, double* s_den, double* s_dots) {
  const StoreView s{e.codes, e.W, e.U, e.code_freq, e.leaf_rows, (int)e.P};
  const int lane = t & 31;
  const int warp = t >> 5;
  const int P = (int)e.P;
  const int n_threads = n_groups * kDistThreads;
  const int tid = gid * kDistThreads + t;
  if (c.kind == kPhPairs) {
    for (int64_t k = gid; k < c.n; k += n_groups) {
      double dist, denom;
      group_pair<C>(e, s, e.pa[k], e.pb[k], t, g, s_den, s_dots, dist, denom);
      if (t == 0) {
        e.rd[k] = dist;
        e.rw[k] = denom;
      }
    }
  } else if (c.kind == kPhJoin) {
    const float bw = (float)c.bw;
    const float omb = __fsub_rn(1.0f, bw);
    const bool half = c.bw == 0.5;
    const float fallback = (float)(1.0 / C);
    for (int p = tid; p < P; p += n_threads) {
      average_pos<C>(s, e.codes, e.W, e.U, e.et, c.t, c.i, c.j, p, bw, omb, half, (float)e.tol,
                     fallback);
      if (c.n_old > 0) out_update_pos<C>(e, s, c.i, c.j, c.t, c.n_old, p);
    }
    named_sync(kBarJoin, n_threads);
    if (gid == 0) {
      double dist, denom;
      group_pair<C>(e, s, c.t, c.t, t, g, s_den, s_dots, dist, denom);
      if (t == 0) {
        e.rd[0] = dist;
        e.rw[0] = denom;
      }
    }
  } else if (c.kind == kPhQuery) {
    for (int p = tid; p < P; p += n_threads) query_pos<C>(e, s, c.t, p);
  } else if (c.kind == kPhScan) {
    const int n_warps = n_groups * kDistWarps;
    for (int64_t k = gid * kDistWarps + warp; k < c.n; k += n_warps) {
      double dist, den;
      warp_scan_row<C>(e, e.pa[k], lane, dist, den);
      if (lane == 0) {
        e.rd[k] = dist;
        e.rw[k] = den;
      }
    }
  } else if (c.kind == kPhOutQuery) {
    for (int p = tid; p < P; p += n_threads)
      for (int cc = 0; cc < C; ++cc) e.qU[p * C + cc] = __fmul_rn(e.w_out[p], e.f_out[p * C + cc]);
  }
}

__shared__ double s_den[kGroupsPerBlock][kDistWarps];
__shared__ double s_dots[kGroupsPerBlock][kDistWarps];

// A grid worker group's loop: wait for a phase, run its share, count itself
// done.
template <int C>
__device__ void worker(const EpochParams& e, int gid, int n_groups, int g, int t) {
  __shared__ PhaseCmd s_cmd[kGroupsPerBlock];
  uint32_t seen = 0;
  for (;;) {
    if (t == 0) {
      while (load_volatile(&e.ctl[0]) == seen) __nanosleep(64);
      ++seen;
      __threadfence();
      const volatile PhaseCmd* vc = e.cmd;
      PhaseCmd c;
      c.kind = vc->kind;
      c.n = vc->n;
      c.i = vc->i;
      c.j = vc->j;
      c.t = vc->t;
      c.n_old = vc->n_old;
      c.bw = vc->bw;
      s_cmd[g] = c;
      if (c.kind != kPhExit) probe_group_start();
    }
    group_sync(g);
    const PhaseCmd c = s_cmd[g];
    if (c.kind == kPhExit) return;
    phase_share<C>(e, c, gid, n_groups, g, t, s_den[g], s_dots[g]);
    group_sync(g);
    if (t == 0) {
      probe_group_end();
      __threadfence();
      atomicAdd(&e.ctl[1], 1u);
    }
  }
}

// Block 0's groups 1-3: the master's local phases, between its barriers.
template <int C>
__device__ void local_worker(const EpochParams& e, const PhaseCmd* cmd, int g, int t) {
  for (;;) {
    named_sync(kBarStart, kLocalThreads);
    const PhaseCmd c = *cmd;
    if (c.kind == kPhExit) return;
    phase_share<C>(e, c, g - 1, kLocalGroups, g, t, s_den[g], s_dots[g]);
    named_sync(kBarDone, kLocalThreads);
  }
}

#ifndef VFT_EPOCH_CONS
template <int C>
__global__ void __launch_bounds__(kEpochThreads, 1)
    nj_epoch_kernel(const __grid_constant__ EpochParams e) {
  extern __shared__ __align__(16) unsigned char epoch_smem[];
  __shared__ PhaseCmd local_cmd;
  const int g = threadIdx.x / kDistThreads;
  const int t = threadIdx.x % kDistThreads;
  if (blockIdx.x == 0) {
    if (g > 0) {
      local_worker<C>(e, &local_cmd, g, t);
    } else if (t < 32) {
      // the master's group: its first warp decides, the other warps leave
      DevicePhases ph{e, &local_cmd, 0u, (gridDim.x - 1) * kGroupsPerBlock};
      Master<DeviceWarp, DevicePhases> master(e, ph, epoch_smem, e.smem_state != 0,
                                              e.smem_lists != 0);
      master.run_launch();
    }
    return;
  }
  worker<C>(e, (blockIdx.x - 1) * kGroupsPerBlock + g, (gridDim.x - 1) * kGroupsPerBlock, g, t);
}
#define VFT_EPOCH_KERNEL nj_epoch_kernel
#else
// the epoch under -constraints: the join penalties in every distance the
// decisions take, and each new node's counts (the master's phases carry
// the counts); the rest as nj_epoch_kernel
template <int C>
__global__ void __launch_bounds__(kEpochThreads, 1)
    nj_epoch_cons_kernel(const __grid_constant__ EpochParams e,
                         const __grid_constant__ EpochCons k) {
  extern __shared__ __align__(16) unsigned char epoch_smem[];
  __shared__ PhaseCmd local_cmd;
  const int g = threadIdx.x / kDistThreads;
  const int t = threadIdx.x % kDistThreads;
  if (blockIdx.x == 0) {
    if (g > 0) {
      local_worker<C>(e, &local_cmd, g, t);
    } else if (t < 32) {
      DevicePhasesCons ph{{e, &local_cmd, 0u, (gridDim.x - 1) * kGroupsPerBlock}, k};
      Master<DeviceWarp, DevicePhasesCons> master(e, ph, epoch_smem, e.smem_state != 0,
                                                  e.smem_lists != 0);
      master.run_launch();
    }
    return;
  }
  worker<C>(e, (blockIdx.x - 1) * kGroupsPerBlock + g, (gridDim.x - 1) * kGroupsPerBlock, g, t);
}
#define VFT_EPOCH_KERNEL nj_epoch_cons_kernel
#endif

// k: the counts (the constrained kernel's second parameter), or null
template <int C>
int launch(const EpochParams& e, const EpochCons* k, int grid, cudaStream_t st, int* used) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  EpochParams arg = e;
  const SmemPlan plan = smem_plan(e.M, e.m, e.ntv, e.smem_state != 0, e.smem_lists != 0);
  const int64_t smem = plan.bytes;
  arg.smem_state = plan.state;
  arg.smem_lists = plan.lists;
  if (err == cudaSuccess && smem)
    err = cudaFuncSetAttribute(VFT_EPOCH_KERNEL<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, VFT_EPOCH_KERNEL<C>,
                                                        kEpochThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return kBadArgs;
  // one block per SM: the groups must all be resident, and more would only
  // share SMs
  if (grid <= 0 || grid > sms) grid = sms;
  *used = grid;
  EpochCons cons{};
  if (k != nullptr) cons = *k;
  void* args[] = {&arg, &cons};
  err = cudaLaunchCooperativeKernel((const void*)VFT_EPOCH_KERNEL<C>, dim3(grid),
                                    dim3(kEpochThreads), args, (size_t)smem, st);
  return (int)err;
}

}  // namespace

extern "C" {

#ifndef VFT_EPOCH_CONS
// The scratch the master needs beside the [cap] lists, in elements:
// out[0] ints, out[1] doubles.
void vft_nj_epoch_scratch(int64_t M, int64_t m, int64_t ntv, int64_t* out) {
  const ScratchLayout s = scratch_layout(M, m, ntv);
  out[0] = s.i_small;
  out[1] = s.d_len;
}

// One launch of the join epoch over the joins the parameters (an
// EpochParams; void here, as the type is local to this file) name.  grid:
// blocks (0: one per SM).  Returns 0, a cudaError of the launch, or -2 for
// a store or card the kernel does not take; *used_grid gets the grid.
int vft_nj_epoch_f32(const void* params, int grid, int* used_grid, void* stream) {
  const EpochParams* e = static_cast<const EpochParams*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e->P % 16 != 0 || e->m < 1 || e->ntv < 1) return kBadArgs;
  if (e->C == 4) return launch<4>(*e, nullptr, grid, st, used_grid);
  if (e->C == 20) return launch<20>(*e, nullptr, grid, st, used_grid);
  return kBadArgs;
}
#else
// The same launch under -constraints (nj_epoch_cons_kernel): cons an
// EpochCons, the counts, which the launch's joins extend.
int vft_nj_epoch_cons_f32(const void* params, const void* cons, int grid, int* used_grid,
                          void* stream) {
  const EpochParams* e = static_cast<const EpochParams*>(params);
  const EpochCons* k = static_cast<const EpochCons*>(cons);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e->P % 16 != 0 || e->m < 1 || e->ntv < 1 || k == nullptr || k->n_cons < 1 ||
      k->n_cons > (int64_t)1 << 30)
    return kBadArgs;
  if (e->C == 4) return launch<4>(*e, k, grid, st, used_grid);
  if (e->C == 20) return launch<20>(*e, k, grid, st, used_grid);
  return kBadArgs;
}
#endif

}  // extern "C"

#ifndef VFT_EPOCH_CONS
VFT_PROBE_READ(vft_nj_epoch_profile_read)
#endif
