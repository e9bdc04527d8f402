// Bootstrap column counts of the SH-like supports for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (veryfasttree_tpu_torch/ops/
// _build.py, wrapper and plan in veryfasttree_tpu_torch/ops/
// resample_kernels.py).
//
// Replaces the host draw of the JAX package's resample_columns and
// resample_count_matrix (veryfasttree_tpu/engine/supports.py:37-56; ref
// resampleColumns tcc:705-727): B resamples of P columns, each column
// int(9.31322574615479e-10 * v * P) of the next value v of Knuth's
// lagged-Fibonacci stream (utils/knuth.py, ref src/Knuth.cpp), and the
// [P, B] multiplicities of the draws.  No TPU kernel did this; the host
// loop made B * P Python calls (500,000 at B=1000, P=500).
//
// The stream: KnuthRandom hands out the first KK = 100 values of each
// ran_array(1009) cycle, which are the generator state s_k before cycle k,
// and the state after it continues the recurrence a[j] = a[j - 100] -
// a[j - 37] mod 2^30 to a[1009 .. 1108].  So s_{k+1} = M s_k mod 2^30 for a
// fixed 100 x 100 matrix M.  The host (ops/resample_kernels.py) hands each
// block the state at the start of its range's cycles and the matrices
// M^(w T), computed once per process and launch plan from the seed by
// powers of M; warp w starts its chunk from their product, one 100 x 100
// integer matrix-vector product.  Draw d is value d % 100 of cycle d / 100;
// it falls in resample d / P.
//
// Design: block (x, y) owns the resamples [x R, x R + R) and the columns
// [y S, y S + S): an int32 histogram [S][R] in shared memory, the
// multiplicities of the draws of those resamples that land in those
// columns.  Its W warps split the cycles that hold those draws into chunks
// of T cycles, each from its own start state (above); a warp runs its chunk's
// recurrence 32 values wide (a value depends only on values 37 and 100
// back) in a ring of 256 values in shared memory, one __syncwarp a step, 32
// steps a cycle, and counts the cycle's draws into the histogram with
// shared-memory integer atomics (the sum does not depend on their order).
// Then the block writes its [S][R] counts as float64 into counts [P, B]:
// every element of counts is written once, so it needs no zero fill and no
// conversion launch.  The column is computed in double, product by
// product, as the twin's Python floats (-fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKK = 100;                  // long lag: the values a cycle hands out
constexpr int kLL = 37;                   // short lag
constexpr int kQuality = 1009;            // ran_array's length per cycle
constexpr int kSpan = kQuality + kKK;     // a cycle's values and the next state
constexpr int32_t kMask = (1 << 30) - 1;  // mod 2^30
constexpr int kRing = 256;                // a warp's values: > 100 + 32 back
constexpr int kMaxWarps = 16;

__global__ void __launch_bounds__(kMaxWarps * 32)
    sh_resample_counts_kernel(const int32_t* __restrict__ states, const int32_t* __restrict__ jumps,
                              int P, int B, int R, int S, int T, double* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  const int n_warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* ring = smem + warp * kRing;
  int32_t* hist = smem + n_warps * kRing;  // [S][R]
  const int b0 = blockIdx.x * R, nr = min(R, B - b0);
  const int c0 = blockIdx.y * S, ns = min(S, P - c0);
  for (int i = threadIdx.x; i < S * R; i += blockDim.x) hist[i] = 0;
  // the block's draws [d0, d1) lie in the cycles [k0, k1); the warp's
  // chunk is [ka, kb)
  const int64_t d0 = (int64_t)b0 * P, d1 = d0 + (int64_t)nr * P;
  const int64_t k0 = d0 / kKK, k1 = (d1 + kKK - 1) / kKK;
  const int64_t ka = k0 + (int64_t)warp * T, kb = min(ka + (int64_t)T, k1);
  if (ka < kb) {
    // the chunk's start state J_w s mod 2^30 from the range's s, J_w =
    // M^(w T) as jumps[w][k][i] = J_w[i][k]: lane l < 25 takes the rows
    // 4l .. 4l + 3 with one 16-byte load a column, in uint32, whose
    // products and sums wrap mod 2^32, a multiple of 2^30
    const int32_t* s = states + (int64_t)blockIdx.x * kKK;
    if (warp == 0) {
      for (int i = lane; i < kKK; i += 32) ring[i] = s[i];
    } else if (lane < kKK / 4) {
      const int4* J = reinterpret_cast<const int4*>(jumps + (int64_t)warp * kKK * kKK) + lane;
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll 10
      for (int k = 0; k < kKK; ++k) {
        const uint32_t sk = (uint32_t)__ldg(s + k);
        const int4 j4 = __ldg(J + k * (kKK / 4));
        acc[0] += (uint32_t)j4.x * sk;
        acc[1] += (uint32_t)j4.y * sk;
        acc[2] += (uint32_t)j4.z * sk;
        acc[3] += (uint32_t)j4.w * sk;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ring[4 * lane + e] = (int32_t)(acc[e] & (uint32_t)kMask);
    }
  }
  __syncthreads();
  int base = 0;  // the ring slot of the cycle's first value
  for (int64_t k = ka; k < kb; ++k) {
    __syncwarp();
    // draw d = 100 k + i is value i of the cycle: resample d / P, column
    // as the twin computes int(rng.next_double() * n_pos), clamped
    const int64_t x0 = k * kKK - d0;  // value 0's draw, from the block's first
    for (int i = lane; i < kKK; i += 32) {
      if (x0 + i < 0 || x0 + i >= d1 - d0) continue;
      const int x = (int)(x0 + i);  // < R P, which the histogram bounds
      const double u = 9.31322574615479e-10 * (double)ring[(base + i) & (kRing - 1)];
      int col = (int)(u * (double)P);
      col = (col < 0 ? 0 : (col > P - 1 ? P - 1 : col)) - c0;
      if (col >= 0 && col < ns) atomicAdd(&hist[col * R + x / P], 1);
    }
    if (k + 1 == kb) break;
    // the cycle's values 100 .. 1108, 32 a step: a step reads values 37 and
    // more back, all from earlier steps, and its writes fall on ring slots
    // 132 or more ahead of its reads, so one __syncwarp a step orders it
    for (int j = kKK; j < kSpan; j += 32) {
      const int jj = j + lane;
      if (jj < kSpan)
        ring[(base + jj) & (kRing - 1)] = (ring[(base + jj - kKK) & (kRing - 1)] -
                                           ring[(base + jj - kLL) & (kRing - 1)]) &
                                          kMask;
      __syncwarp();
    }
    base = (base + kQuality) & (kRing - 1);
  }
  __syncthreads();
  // the histogram's column c, resample r is counts[c0 + c, b0 + r]: R
  // consecutive doubles a column
  for (int i = threadIdx.x; i < ns * R; i += blockDim.x) {
    const int c = i / R, r = i - c * R;
    if (r < nr) counts[(int64_t)(c0 + c) * B + b0 + r] = (double)hist[i];
  }
}

}  // namespace

extern "C" {

// counts [P, B] float64 (need not be zeroed): the multiplicities of the
// B * P draws of the stream.  Device memory: states [ceil(B / R), 100]
// int32, the state at the start of each range's cycles, and jumps [W, 100,
// 100] int32, (M^(w T))^T (ops/resample_kernels.py); blocks of W warps,
// ceil(B / R) x ceil(P / S) of them.
int vft_sh_resample_counts(const int32_t* states, const int32_t* jumps, int P, int B, int R,
                           int S, int T, int W, double* counts, void* stream) {
  if (P < 1 || B < 1 || R < 1 || S < 1 || T < 1 || W < 1 || W > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int32_t) * ((size_t)W * kRing + (size_t)S * R);
  cudaError_t err = cudaFuncSetAttribute(sh_resample_counts_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((B + R - 1) / R), (unsigned)((P + S - 1) / S));
  sh_resample_counts_kernel<<<grid, W * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      states, jumps, P, B, R, S, T, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
