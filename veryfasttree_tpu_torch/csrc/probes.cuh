// clock64() probes of scripts/profile_me_kernels.py for the join epoch
// (nj_epoch.cu) and the SPR and NNI rounds (me_spr.cu, me_nni.cu).  Only the
// profile builds define VFT_PROBES (the script's second copy of a file,
// never the library the port loads); without it every call here is nothing.
//
// One thread records: thread 0 of block 0 (the join epoch's deciding lane,
// a round's thread 0).  It adds the cycles between two of its marks to the
// phase it was in.  A ProbeScope marks a phase for its lifetime and then
// the phase around it; a ProbeOuter makes every mark inside it count to its
// own phase (an unwind's averages count to the unwind).  The join epoch's
// master also splits its waits on the grid by the global timer: from its
// publish to the first worker group's start and from the last group's end
// to its resume (the handshake), and from that start to that end (the work;
// the refresh scans' work also apart).

#pragma once

#include <stdint.h>

namespace {

constexpr int kProbeSlots = 16;

// the phases, in the order of scripts/profile_me_kernels.py NJ_PHASES and
// ME_PHASES
enum : int {
  kNjPOther = 0,  // the join itself, the launch's setup and save
  kNjPSearch,     // topHitNJSearch: the top-visible set's criteria and argmin
  kNjPHill,       // the hill climb
  kNjPMerge,      // topHitJoin: the merge of the children's lists, visible updates
  kNjPRefresh,    // _refresh_node: the sweeps, the scan's results, the new lists
  kNjPVisible,    // resetTopVisible and the visible-set walk
  kNjPSelect,     // the top-K selections
  kNjPAnc,        // the ancestor chains of the hit lists
  kNjPWait,       // waiting for a grid phase (split by probe_ns)
  kNjPLocal,      // the phases block 0 runs itself (handshake and work)
};
enum : int {
  kMePDecide = 0,  // the chain's and the quartet's scalar decisions
  kMePWalk,        // up_get's walk to the root
  kMePFill,        // the up-profile memo's fills (their averages)
  kMePLoads,       // the quartet's pair distances: loads and partial sums
  kMePReduce,      // their reductions and finish
  kMePAverage,     // the profile recomputes of updateForNNI
  kMePCommit,      // the tree's writes and their barriers
  kMePUnwind,      // the unwinds of a chain's tail (everything inside)
  kMePAncestors,   // an accepted node's ancestors to the root (everything inside)
  kMePSetup,       // setupABCD's reads of the tree (its up_get walk and fills apart)
  kMePCorrect,     // the corrected distances from the six pairs (log corrections)
};

#ifdef VFT_PROBES
__device__ unsigned long long probe_total[kProbeSlots];  // cycles per phase, all launches
__device__ unsigned long long probe_ns[3];               // handshake, phase work, of it scans (ns)
__device__ unsigned long long probe_first;               // this phase's first group start
__device__ unsigned long long probe_last;                // its last group end
__shared__ unsigned long long probe_acc[kProbeSlots];
__shared__ long long probe_clk;
__shared__ int probe_cur, probe_outer;

__device__ __forceinline__ bool probe_on() { return threadIdx.x == 0 && blockIdx.x == 0; }

__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mark: from now on the cycles count to `phase` (or to the outer phase);
// returns the phase that was current
__device__ __forceinline__ int probe_mark(int phase) {
  if (!probe_on()) return 0;
  const long long now = clock64();
  const int prev = probe_cur;
  probe_acc[prev] += (unsigned long long)(now - probe_clk);
  probe_clk = now;
  probe_cur = probe_outer >= 0 ? probe_outer : phase;
  return prev;
}

__device__ __forceinline__ void probe_begin(int phase) {
  if (!probe_on()) return;
  for (int k = 0; k < kProbeSlots; ++k) probe_acc[k] = 0;
  probe_cur = phase;
  probe_outer = -1;
  probe_clk = clock64();
}

__device__ __forceinline__ void probe_end() {
  probe_mark(0);
  if (!probe_on()) return;
  for (int k = 0; k < kProbeSlots; ++k) probe_total[k] += probe_acc[k];
}

struct ProbeScope {
  int prev;
  __device__ __forceinline__ explicit ProbeScope(int phase) : prev(probe_mark(phase)) {}
  __device__ __forceinline__ ~ProbeScope() { probe_mark(prev); }
};

struct ProbeOuter {
  int prev;
  __device__ __forceinline__ explicit ProbeOuter(int phase) {
    prev = probe_mark(phase);
    if (probe_on() && probe_outer < 0) probe_outer = phase;
    else prev = -1;  // nested: the outer phase stays
  }
  __device__ __forceinline__ ~ProbeOuter() {
    if (prev < 0 || !probe_on()) return;
    probe_outer = -1;
    probe_mark(prev);
  }
};

// the master's side of one grid phase: before it publishes, and after the
// last group is done
__device__ __forceinline__ unsigned long long probe_publish() {
  if (!probe_on()) return 0;
  probe_first = ~0ull;
  probe_last = 0;
  __threadfence();
  return probe_gtime();
}
__device__ __forceinline__ void probe_resume(unsigned long long published, bool scan = false) {
  if (!probe_on()) return;
  const unsigned long long now = probe_gtime();
  const unsigned long long first = *(volatile unsigned long long*)&probe_first;
  const unsigned long long last = *(volatile unsigned long long*)&probe_last;
  if (first > last) return;  // no group ran (cannot happen)
  probe_ns[0] += (first > published ? first - published : 0) + (now > last ? now - last : 0);
  probe_ns[1] += last - first;
  if (scan) probe_ns[2] += last - first;
}
// a worker group's start and end of a phase
__device__ __forceinline__ void probe_group_start() { atomicMin(&probe_first, probe_gtime()); }
__device__ __forceinline__ void probe_group_end() { atomicMax(&probe_last, probe_gtime()); }
#else
__host__ __device__ __forceinline__ int probe_mark(int) { return 0; }
__host__ __device__ __forceinline__ void probe_begin(int) {}
__host__ __device__ __forceinline__ void probe_end() {}
struct ProbeScope {
  __host__ __device__ __forceinline__ explicit ProbeScope(int) {}
};
struct ProbeOuter {
  __host__ __device__ __forceinline__ explicit ProbeOuter(int) {}
};
__host__ __device__ __forceinline__ unsigned long long probe_publish() { return 0; }
__host__ __device__ __forceinline__ void probe_resume(unsigned long long, bool = false) {}
__host__ __device__ __forceinline__ void probe_group_start() {}
__host__ __device__ __forceinline__ void probe_group_end() {}
#endif

}  // namespace

#ifdef VFT_PROBES
// The probes' cycles per phase [kProbeSlots] and the handshake and work
// nanoseconds [2], summed over the launches since the last reset, into out
// [kProbeSlots + 2]; reset 1 zeroes them after.  Returns 0 or a cudaError.
// NAME is the entry's name in the including file.
#define VFT_PROBE_READ(NAME)                                                          \
  extern "C" int NAME(unsigned long long* out, int reset) {                          \
    cudaError_t err = cudaDeviceSynchronize();                                        \
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, probe_total, sizeof(probe_total)); \
    if (err == cudaSuccess)                                                           \
      err = cudaMemcpyFromSymbol(out + kProbeSlots, probe_ns, sizeof(probe_ns));      \
    if (err == cudaSuccess && reset) {                                                \
      static const unsigned long long zero[kProbeSlots] = {};                         \
      err = cudaMemcpyToSymbol(probe_total, zero, sizeof(probe_total));               \
      if (err == cudaSuccess) err = cudaMemcpyToSymbol(probe_ns, zero, sizeof(probe_ns)); \
    }                                                                                 \
    return (int)err;                                                                  \
  }
#else
#define VFT_PROBE_READ(NAME)
#endif
