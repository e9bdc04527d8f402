// Bootstrap column counts of the SH-like supports for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (veryfasttree_tpu_torch/ops/
// _build.py, wrapper in veryfasttree_tpu_torch/ops/resample_kernels.py).
//
// Replaces the host draw of the JAX package's resample_columns and
// resample_count_matrix (veryfasttree_tpu/engine/supports.py:37-56; ref
// resampleColumns tcc:705-727): B resamples of P columns, each column
// int(9.31322574615479e-10 * v * P) of the next value v of Knuth's
// lagged-Fibonacci stream (utils/knuth.py, ref src/Knuth.cpp), and the
// [P, B] multiplicities of the draws.  No TPU kernel did this; the host
// loop made B * P Python calls (500,000 at B=1000, P=500).
//
// The stream is serial: KnuthRandom hands out the first KK = 100 values of
// each ran_array(1009) cycle, which are the generator state x before the
// cycle (the sentinel buf[KK] = -1 then starts the next cycle), and the
// state after it is the continuation of a[j] = a[j - 100] - a[j - 37] mod
// 2^30 to a[1009 .. 1108].  A value depends only on values 37 and 100 back,
// so one block runs a cycle's recurrence 37 lanes wide (28 steps, one
// barrier each) while its first 100 threads turn the cycle's draws into
// columns and count them with integer atomics into counts [P, B] (int32;
// the wrapper makes them float64).  What bounds it is that chain of
// barriers, 5,000 cycles at B=1000, P=500, not the 2 MB it writes.  The
// host seeds it with the state after ran_start(314159) and its ten warm-up
// cycles, as utils/knuth.py leaves it.  The column is computed in double,
// product by product, as the twin's Python floats (-fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKK = 100;                  // long lag: the values a cycle hands out
constexpr int kLL = 37;                   // short lag: the recurrence's width
constexpr int kQuality = 1009;            // ran_array's length per cycle
constexpr int kSpan = kQuality + kKK;     // a cycle's values and the next state
constexpr int32_t kMask = (1 << 30) - 1;  // mod 2^30
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    sh_resample_counts_kernel(const int32_t* __restrict__ state, int64_t n_draws, int P, int B,
                              int32_t* __restrict__ counts) {
  __shared__ int32_t a[kSpan];
  const int i = threadIdx.x;
  if (i < kKK) a[i] = state[i];
  __syncthreads();
  for (int64_t base = 0; base < n_draws; base += kKK) {
    // draw base + i is a[i]: resample (base + i) / P, column as the twin
    // computes int(rng.next_double() * n_pos), clamped
    if (i < kKK && base + i < n_draws) {
      const int64_t d = base + i;
      const double u = 9.31322574615479e-10 * (double)a[i];
      int col = (int)(u * (double)P);
      col = col < 0 ? 0 : (col > P - 1 ? P - 1 : col);
      atomicAdd(&counts[(int64_t)col * B + d / P], 1);
    }
    // the cycle: a[j] for j in [KK, kSpan), kLL at a time; the reads of
    // the draws above come before the first barrier, a[0 .. KK) is not
    // written until the copy after the last
    for (int j = kKK; j < kSpan; j += kLL) {
      if (i < kLL && j + i < kSpan) a[j + i] = (a[j + i - kKK] - a[j + i - kLL]) & kMask;
      __syncthreads();
    }
    if (i < kKK) a[i] = a[kQuality + i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// counts [P, B] int32, zero on entry: the multiplicities of the B * P
// draws from the stream whose state is `state` [100] (device memory).
int vft_sh_resample_counts(const int32_t* state, int P, int B, int32_t* counts, void* stream) {
  if (P < 1 || B < 1) return (int)cudaErrorInvalidValue;
  sh_resample_counts_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state, (int64_t)P * B, P, B, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
