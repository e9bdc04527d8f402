// Fused one-vs-all NJ scans for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (veryfasttree_tpu_torch/ops/_build.py).
//
// Both kernels compute, for every candidate row m of the profile store,
//   denom[m] = W[m] . wq                     (shared non-gap weight)
//   top[m]   = U[m] . a   (matrix mode)  or  denom[m] - U[m] . a (%different)
//   dist[m]  = top/denom, or 1 where denom <= 0
//   crit[m]  = dist[m] - outd[m] / (nActive - 2), or 1e30 for m >= m_real
// and the (min crit, lowest index) over all rows, in two launches: each block
// writes one partial, then argmin_partials reduces the partials.  No float
// atomics: every sum and every comparison runs in a fixed order, so a result
// is the same from run to run.
//
// Accumulation is in Acc (double here): every float element is converted to
// Acc before its product, as the reference's CPU path upcasts the store
// before the contraction (veryfasttree_tpu/engine/profiles.py _dist_all).
// Acc is a template parameter so that a float variant can be tried later.
// The per-row bodies are in nj_scan.cuh, which the join epoch (nj_epoch.cu)
// runs for its refresh scans.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nj_scan.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCodesRowsPerWarp = 4;
constexpr int kCodesRowsPerBlock = kWarps * kCodesRowsPerWarp;

template <typename Acc>
__device__ __forceinline__ bool better(Acc c, int64_t i, Acc bc, int64_t bi) {
  return c < bc || (c == bc && i < bi);
}

// dist / crit of one row; writes the row's outputs and folds it into the
// warp's running best (rows arrive in ascending order)
template <typename Acc>
__device__ __forceinline__ void row_epilogue(
    int64_t m, Acc dots, Acc den, Acc outd_m, bool use_matrix, Acc n_active_m2,
    int64_t m_real, Acc* dist, Acc* denom, Acc* crit, Acc& best_c, int64_t& best_i) {
  const Acc d = row_dist(dots, den, use_matrix);
  const Acc c = m < m_real ? d - outd_m / n_active_m2 : Acc(1e30);
  dist[m] = d;
  denom[m] = den;
  crit[m] = c;
  if (better(c, m, best_c, best_i)) {
    best_c = c;
    best_i = m;
  }
}

// one partial (min crit, lowest index) per block, warps merged in order
template <typename Acc>
__device__ __forceinline__ void block_partial(Acc best_c, int64_t best_i, Acc* part_crit,
                                              int64_t* part_idx) {
  __shared__ Acc s_crit[kWarps];
  __shared__ int64_t s_idx[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_crit[warp] = best_c;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc bc = s_crit[0];
    int64_t bi = s_idx[0];
    for (int w = 1; w < kWarps; ++w)
      if (better(s_crit[w], s_idx[w], bc, bi)) {
        bc = s_crit[w];
        bi = s_idx[w];
      }
    part_crit[blockIdx.x] = bc;
    part_idx[blockIdx.x] = bi;
  }
}

// Replaces the Pallas kernel _scan_kernel / _scan_pallas
// (veryfasttree_tpu/ops/pallas_kernels.py).
// Bound: device memory.  It reads M*(P*C + P)*4 bytes of store once (84 MB
// at M=8192, P=512, C=4: about 25 us at 3.35 TB/s) and does 2 flops per 4
// bytes, far below the card's FP64 rate.
// Design: one warp per row; lanes stride the contiguous P*C row and the W
// row with 16-byte float4 loads, so a warp reads 512 contiguous bytes per
// step.  The query (a, wq; 16 KB + 4 KB in double) is read through the
// read-only cache, where every warp of the SM reuses it.  Warp-shuffle sums;
// lane 0 writes the row's dist, denom and crit.
template <typename Acc>
__global__ void __launch_bounds__(kThreads) nj_scan_dense_kernel(
    const float* __restrict__ U2, const float* __restrict__ W, const Acc* __restrict__ a,
    const Acc* __restrict__ wq, const Acc* __restrict__ outd, int64_t M, int64_t m_real, int K,
    int P, Acc n_active_m2, int use_matrix, Acc* __restrict__ dist, Acc* __restrict__ denom,
    Acc* __restrict__ crit, Acc* __restrict__ part_crit, int64_t* __restrict__ part_idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  Acc best_c = Acc(INFINITY);
  int64_t best_i = INT64_MAX;
  if (m < M) {
    Acc dots, den;
    dense_row(U2 + m * K, W + m * P, a, wq, K, P, lane, dots, den);
    if (lane == 0)
      row_epilogue(m, dots, den, outd[m], use_matrix != 0, n_active_m2, m_real, dist, denom,
                   crit, best_c, best_i);
  }
  block_partial(best_c, best_i, part_crit, part_idx);
}

// Replaces the Pallas kernel _scan_codes_kernel / _scan_codes_pallas
// (veryfasttree_tpu/ops/pallas_kernels.py), the two-tier leaf scan.
// Bound: device memory, L*P bytes of int8 codes (10 MB at L=20000, P=512).
// Design: the projected query table G[C, P] and wq[P] are staged in dynamic
// shared memory in double (16 KB + 4 KB for nt at P=512, 80 KB + 4 KB for
// protein), in tiles of positions when (C+1)*P*8 bytes would not fit.  One
// warp per leaf row, four rows per warp so that a staged tile serves 32
// rows; lanes read 16 codes per 16-byte load.  A code other than NOCODE (127)
// adds wq[p] to denom and G[code][p] to the pick sum.
template <typename Acc>
__global__ void __launch_bounds__(kThreads) nj_scan_codes_kernel(
    const int8_t* __restrict__ codes, const Acc* __restrict__ G, const Acc* __restrict__ wq,
    const Acc* __restrict__ outd, int64_t L, int64_t l_real, int P, int C, int p_tile,
    Acc n_active_m2, int use_matrix, Acc* __restrict__ dist, Acc* __restrict__ denom,
    Acc* __restrict__ crit, Acc* __restrict__ part_crit, int64_t* __restrict__ part_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sG = reinterpret_cast<Acc*>(smem_raw);  // [C, p_tile]
  Acc* sW = sG + (size_t)C * p_tile;           // [p_tile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = ((int64_t)blockIdx.x * kWarps + warp) * kCodesRowsPerWarp;
  Acc den[kCodesRowsPerWarp], pick[kCodesRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kCodesRowsPerWarp; ++r) den[r] = pick[r] = 0;

  for (int p0 = 0; p0 < P; p0 += p_tile) {
    const int pt = min(p_tile, P - p0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < C * pt; i += kThreads) {
      const int c = i / pt, p = i - c * pt;
      sG[c * p_tile + p] = G[(int64_t)c * P + p0 + p];
    }
    for (int i = threadIdx.x; i < pt; i += kThreads) sW[i] = wq[p0 + i];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCodesRowsPerWarp; ++r) {
      const int64_t l = row0 + r;
      if (l >= L) break;
      codes_row_tile(codes + l * P + p0, pt, C, sG, p_tile, sW, lane, den[r], pick[r]);
    }
  }

  Acc best_c = Acc(INFINITY);
  int64_t best_i = INT64_MAX;
#pragma unroll
  for (int r = 0; r < kCodesRowsPerWarp; ++r) {
    const int64_t l = row0 + r;
    if (l >= L) break;
    const Acc d = scan_warp_sum(den[r]);
    const Acc s = scan_warp_sum(pick[r]);
    if (lane == 0)
      row_epilogue(l, s, d, outd[l], use_matrix != 0, n_active_m2, l_real, dist, denom, crit,
                   best_c, best_i);
  }
  block_partial(best_c, best_i, part_crit, part_idx);
}

// Second pass of both scans: the (min crit, lowest index) of the partials.
template <typename Acc>
__global__ void __launch_bounds__(kThreads) argmin_partials_kernel(
    const Acc* __restrict__ part_crit, const int64_t* __restrict__ part_idx, int64_t n,
    int64_t* __restrict__ best_idx, Acc* __restrict__ best_crit) {
  __shared__ Acc s_crit[kThreads];
  __shared__ int64_t s_idx[kThreads];
  Acc bc = Acc(INFINITY);
  int64_t bi = INT64_MAX;
  for (int64_t i = threadIdx.x; i < n; i += kThreads)
    if (better(part_crit[i], part_idx[i], bc, bi)) {
      bc = part_crit[i];
      bi = part_idx[i];
    }
  s_crit[threadIdx.x] = bc;
  s_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && better(s_crit[threadIdx.x + s], s_idx[threadIdx.x + s],
                                  s_crit[threadIdx.x], s_idx[threadIdx.x])) {
      s_crit[threadIdx.x] = s_crit[threadIdx.x + s];
      s_idx[threadIdx.x] = s_idx[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *best_idx = s_idx[0];
    *best_crit = s_crit[0];
  }
}

}  // namespace

extern "C" {

int64_t vft_scan_dense_blocks(int64_t M) { return (M + kWarps - 1) / kWarps; }

int64_t vft_scan_codes_blocks(int64_t L) {
  return (L + kCodesRowsPerBlock - 1) / kCodesRowsPerBlock;
}

int vft_nj_scan_dense_f64(const float* U2, const float* W, const double* a, const double* wq,
                          const double* outd, int64_t M, int64_t m_real, int K, int P,
                          int64_t n_active, int use_matrix, double* dist, double* denom,
                          double* crit, double* part_crit, int64_t* part_idx,
                          int64_t* best_idx, double* best_crit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = vft_scan_dense_blocks(M);
  nj_scan_dense_kernel<double><<<(unsigned)blocks, kThreads, 0, s>>>(
      U2, W, a, wq, outd, M, m_real, K, P, double(n_active) - 2.0, use_matrix, dist, denom,
      crit, part_crit, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argmin_partials_kernel<double><<<1, kThreads, 0, s>>>(part_crit, part_idx, blocks, best_idx,
                                                        best_crit);
  return (int)cudaGetLastError();
}

int vft_nj_scan_codes_f64(const int8_t* codes, const double* G, const double* wq,
                          const double* outd, int64_t L, int64_t l_real, int P, int C,
                          int64_t n_active, int use_matrix, double* dist, double* denom,
                          double* crit, double* part_crit, int64_t* part_idx,
                          int64_t* best_idx, double* best_crit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p_tile = codes_p_tile(P, C);
  const size_t smem = (size_t)(C + 1) * p_tile * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(nj_scan_codes_kernel<double>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = vft_scan_codes_blocks(L);
  nj_scan_codes_kernel<double><<<(unsigned)blocks, kThreads, smem, s>>>(
      codes, G, wq, outd, L, l_real, P, C, p_tile, double(n_active) - 2.0, use_matrix, dist,
      denom, crit, part_crit, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argmin_partials_kernel<double><<<1, kThreads, 0, s>>>(part_crit, part_idx, blocks, best_idx,
                                                        best_crit);
  return (int)cudaGetLastError();
}

}  // extern "C"
