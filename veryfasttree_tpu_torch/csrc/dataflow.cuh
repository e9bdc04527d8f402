// The scheduler of the whole-tree kernels (ml_sweep.cu: the ML posterior
// sweep and tree log-likelihood; me_store.cu: the ME up-profile sweep):
// dataflow over a list of work units in which each unit depends only on
// units before it.
//
// A grid of at most the blocks that fit on the card at once takes the units
// in list order from an integer counter (next_unit), and a unit waits on the
// integer ready flags of the units it reads (wait_flag; release and acquire
// at gpu scope), then sets its own (publish).  Every unit it waits on was
// taken before it, by a block that is running, so nothing deadlocks: for any
// depth, any level width, and no grid-wide barrier.
//
// The ready flags hold the epoch of the launch that set them: the host gives
// every launch on one control block a new epoch, so no flag is ever reset;
// the work counter is put back to 0 by the last block to finish (finish).
// A wait that lasts 10 s traps (a fault on the host's side, not a hang of
// the card).
//
// A unit may also keep flags finer than its own: ml_sweep.cu's posterior
// sweep gives each warp of a unit its flags (publish_warp), so that a warp
// waits on the one warp of an earlier unit that wrote its positions, with
// no block barrier.  The order of the units is what keeps it free of
// deadlock, as above.
//
// Control block: kCtrlWords int32 words (the counter, the blocks done,
// padding), then the ready flags.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCtrlWords = 4;
constexpr unsigned long long kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the flag holds this launch's epoch.
__device__ __forceinline__ void wait_flag(const int* flag, int epoch) {
  if (ld_acquire(flag) == epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) != epoch) {
    __nanosleep(64);
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// The next unit of the list, the same in every thread.  Its barrier also
// ends the block's previous unit: every thread has read the shared tables
// and the slot of that unit.
__device__ __forceinline__ int next_unit(int* ctrl, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(ctrl, 1);
  __syncthreads();
  return *slot;
}

// Every thread's writes of the unit, then its ready flag.
__device__ __forceinline__ void publish(int* flag, int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, epoch);
  }
}

// A warp's writes, then its ready flag (every lane of the warp calls it):
// the warp barrier orders every lane's writes before lane 0's release
// store, and a release at gpu scope makes what happened before it visible
// to the acquire that reads the flag.
__device__ __forceinline__ void publish_warp(int* flag, int epoch) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st_release(flag, epoch);
}

// The last block to finish puts the counter back to 0 for the next launch
// (every block has taken its last unit before it counts itself done).
__device__ __forceinline__ void finish(int* ctrl) {
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(ctrl + 1, 1) == (int)gridDim.x - 1) {
    atomicExch(ctrl, 0);
    atomicExch(ctrl + 1, 0);
  }
}

// Blocks of `threads` threads of `kernel` that fit on the card at once (0 if
// the card cannot be asked).
template <class Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace

// Int32 words of the control block before the ready flags, for the host
// (ops/dataflow.py).  Every file that includes this header defines it, the
// same, as a weak symbol: the library keeps one.
extern "C" __attribute__((weak)) int vft_dataflow_ctrl_words() { return kCtrlWords; }
