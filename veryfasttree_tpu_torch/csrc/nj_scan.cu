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
constexpr int kCodesRowsPerBlock = kWarps * kCodesRowsPerWarp;
constexpr int kCodesBlocksPerSm = 4;

template <typename Acc>
__device__ __forceinline__ bool better(Acc c, int64_t i, Acc bc, int64_t bi) {
  return c < bc || (c == bc && i < bi);
}

// dist / crit of one row; writes the row's outputs and folds it into the
// warp's running best (better() orders by (crit, index), so the lowest index
// wins a tie in whatever order the rows arrive)
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
//
// kPartial (a rank's block of positions under a mesh, parallel/): each row's
// sums go into dist (dots) and denom (den), with no division, criterion or
// best; nj_scan_finish_kernel finishes them once the ranks' sums are
// combined (outd, crit and the partials unused).
template <typename Acc, bool kPartial = false>
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
    if (lane == 0) {
      if (kPartial) {
        dist[m] = dots;
        denom[m] = den;
      } else {
        row_epilogue(m, dots, den, outd[m], use_matrix != 0, n_active_m2, m_real, dist, denom,
                     crit, best_c, best_i);
      }
    }
  }
  if (!kPartial) block_partial(best_c, best_i, part_crit, part_idx);
}

// the tile of G and wq that starts at position p0, laid out (codes_slot)
template <typename Acc>
__device__ __forceinline__ void stage_codes_tile(const Acc* __restrict__ G,
                                                 const Acc* __restrict__ wq, int P, int C, int p0,
                                                 int pt, int tile_len, Acc* sG, Acc* sW) {
#pragma unroll 4
  for (int i = threadIdx.x; i < C * pt; i += kThreads) {
    const int c = i / pt, q = i - c * pt;
    sG[c * tile_len + codes_slot(q, pt)] = G[(int64_t)c * P + p0 + q];
  }
  for (int q = threadIdx.x; q < pt; q += kThreads) sW[codes_slot(q, pt)] = wq[p0 + q];
}

// Replaces the Pallas kernel _scan_codes_kernel / _scan_codes_pallas
// (veryfasttree_tpu/ops/pallas_kernels.py), the two-tier leaf scan.
// Bound: device memory, L*P bytes of int8 codes (10 MB at L=20000, P=512).
// Design: persistent blocks, a few per multiprocessor (vft_scan_codes_blocks),
// each staging the projected query table G[C, P] and wq[P] in dynamic shared
// memory once, in double and laid out (codes_slot: at each step the lanes
// read consecutive doubles, in 16 bank pairs a half-warp; 16.5 KB + 4.1 KB
// for nt at P=512, 83 KB + 4.1 KB for protein), and taking groups of 32
// rows in a grid-stride loop.  Where (C+1)*P*8 bytes would not fit, the
// table goes in tiles of positions, staged again for each group (the
// kOneTile = false instantiation).  One warp
// per leaf row, four rows per warp sharing each weight load; lanes read 16
// codes per 16-byte load, and lane r row r's out-distance with them, which
// lane 0's epilogue takes by a shuffle.  A code other than NOCODE (127) adds
// wq[p] to denom and G[code][p] to the pick sum.
// kPartial: as nj_scan_dense_kernel's, the pick sum into dist and den into
// denom, nothing else.
template <typename Acc, bool kOneTile, bool kPartial = false>
__global__ void __launch_bounds__(kThreads) nj_scan_codes_kernel(
    const int8_t* __restrict__ codes, const Acc* __restrict__ G, const Acc* __restrict__ wq,
    const Acc* __restrict__ outd, int64_t L, int64_t l_real, int P, int C, int p_tile,
    Acc n_active_m2, int use_matrix, Acc* __restrict__ dist, Acc* __restrict__ denom,
    Acc* __restrict__ crit, Acc* __restrict__ part_crit, int64_t* __restrict__ part_idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile_len = codes_tile_len(p_tile);
  Acc* sG = reinterpret_cast<Acc*>(smem_raw);  // [C, tile_len]
  Acc* sW = sG + (size_t)C * tile_len;         // [tile_len]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kOneTile) {
    stage_codes_tile(G, wq, P, C, 0, P, tile_len, sG, sW);
    __syncthreads();
  }
  Acc best_c = Acc(INFINITY);
  int64_t best_i = INT64_MAX;
  const int64_t n_groups = (L + kCodesRowsPerBlock - 1) / kCodesRowsPerBlock;
  for (int64_t grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int64_t row0 = grp * kCodesRowsPerBlock + warp * kCodesRowsPerWarp;
    const int64_t left = L - row0;
    const int n = left <= 0 ? 0 : (left < kCodesRowsPerWarp ? (int)left : kCodesRowsPerWarp);
    // row r's out-distance, loaded by lane r beside the codes
    const Acc outd_r = !kPartial && lane < n ? outd[row0 + lane] : Acc(0);
    Acc den[kCodesRowsPerWarp], pick[kCodesRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kCodesRowsPerWarp; ++r) den[r] = pick[r] = 0;
    if (kOneTile) {
      if (n > 0)
        codes_rows_tile<Acc, kCodesRowsPerWarp>(codes + row0 * P, P, n, P, C, sG, tile_len, sW,
                                                lane, den, pick);
    } else {
      for (int p0 = 0; p0 < P; p0 += p_tile) {
        const int pt = min(p_tile, P - p0);
        __syncthreads();  // the previous tile is consumed
        stage_codes_tile(G, wq, P, C, p0, pt, tile_len, sG, sW);
        __syncthreads();
        if (n > 0)
          codes_rows_tile<Acc, kCodesRowsPerWarp>(codes + row0 * P + p0, P, n, pt, C, sG,
                                                  tile_len, sW, lane, den, pick);
      }
    }
#pragma unroll
    for (int r = 0; r < kCodesRowsPerWarp; ++r) {
      if (r >= n) break;
      const Acc d = scan_warp_sum(den[r]);
      const Acc s = scan_warp_sum(pick[r]);
      const Acc od = __shfl_sync(0xffffffffu, outd_r, r);
      if (lane == 0) {
        if (kPartial) {
          dist[row0 + r] = s;
          denom[row0 + r] = d;
        } else {
          row_epilogue(row0 + r, s, d, od, use_matrix != 0, n_active_m2, l_real, dist, denom,
                       crit, best_c, best_i);
        }
      }
    }
  }
  if (!kPartial) block_partial(best_c, best_i, part_crit, part_idx);
}

// the code scan's dynamic shared memory: the laid-out tile of G and wq
size_t codes_smem(int P, int C) {
  return (size_t)(C + 1) * codes_tile_len(codes_p_tile(P, C)) * sizeof(double);
}

// the code scan's instantiation: the table staged once where one tile holds
// all P positions, else tile by tile for each group
const void* codes_kernel(int P, int C, bool partial = false) {
  if (partial)
    return codes_p_tile(P, C) >= P ? (const void*)nj_scan_codes_kernel<double, true, true>
                                   : (const void*)nj_scan_codes_kernel<double, false, true>;
  return codes_p_tile(P, C) >= P ? (const void*)nj_scan_codes_kernel<double, true>
                                 : (const void*)nj_scan_codes_kernel<double, false>;
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

// Replaces the epilogue of the Pallas kernels _scan_kernel and
// _scan_codes_kernel (veryfasttree_tpu/ops/pallas_kernels.py:38, 173) and
// of dist_scan_sharded (veryfasttree_tpu/parallel/sharded.py:22), where
// psum('sp') combines the ranks' sums: under a mesh the partial scans of
// each rank's block of positions, exchanged, are finished here.  parts
// [k, 2, M]: rank r's dots at parts[2rM + m], den at parts[(2r + 1)M + m].
// Each row's sums are added in rank order, then row_epilogue (row_dist,
// the criterion, the (crit, index) order of better()) as the fused scans
// take it, so at k = 1 every dist, denom, crit and the best are theirs
// bit for bit; the best over the rows takes argmin_partials_kernel after.
// Bound: bytes, 16(k + 1) M + 24 M written (M = 8,192 at k = 2: 0.6 MB,
// 0.18 us at 3.35 TB/s); the two launches dominate.
// Design: one thread per row; a warp's (crit, index) minimum by xor
// shuffles (every lane ends with the same, lowest index on ties), then the
// block's warps in order (block_partial).
template <typename Acc>
__global__ void __launch_bounds__(kThreads) nj_scan_finish_kernel(
    const Acc* __restrict__ parts, int k, const Acc* __restrict__ outd, int64_t M,
    int64_t m_real, Acc n_active_m2, int use_matrix, Acc* __restrict__ dist,
    Acc* __restrict__ denom, Acc* __restrict__ crit, Acc* __restrict__ part_crit,
    int64_t* __restrict__ part_idx) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  Acc best_c = Acc(INFINITY);
  int64_t best_i = INT64_MAX;
  if (m < M) {
    Acc dots = parts[m], den = parts[M + m];
    for (int r = 1; r < k; ++r) {
      dots = acc_add(dots, parts[2 * r * M + m]);
      den = acc_add(den, parts[(2 * r + 1) * M + m]);
    }
    row_epilogue(m, dots, den, outd[m], use_matrix != 0, n_active_m2, m_real, dist, denom, crit,
                 best_c, best_i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Acc oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    const int64_t oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(oc, oi, best_c, best_i)) {
      best_c = oc;
      best_i = oi;
    }
  }
  block_partial(best_c, best_i, part_crit, part_idx);
}

}  // namespace

extern "C" {

int64_t vft_scan_dense_blocks(int64_t M) { return (M + kWarps - 1) / kWarps; }

// the code scan's grid: kCodesBlocksPerSm persistent blocks a multiprocessor
// (fewer where they do not fit), no more than the row groups; 0 on an error
int64_t vft_scan_codes_blocks(int64_t L, int P, int C) {
  const int smem = (int)codes_smem(P, C);
  const void* kernel = codes_kernel(P, C);
  int dev = 0, n_sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    return 0;
  const int64_t groups = (L + kCodesRowsPerBlock - 1) / kCodesRowsPerBlock;
  const int64_t grid = (int64_t)n_sms * (per_sm < kCodesBlocksPerSm ? per_sm : kCodesBlocksPerSm);
  return groups < grid ? (groups > 0 ? groups : 1) : grid;
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
                          int64_t n_active, int use_matrix, int64_t blocks, double* dist,
                          double* denom, double* crit, double* part_crit, int64_t* part_idx,
                          int64_t* best_idx, double* best_crit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = codes_smem(P, C);
  const int p_tile = codes_p_tile(P, C);
  cudaError_t err = cudaFuncSetAttribute(codes_kernel(P, C),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto kernel =
      p_tile >= P ? nj_scan_codes_kernel<double, true> : nj_scan_codes_kernel<double, false>;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(codes, G, wq, outd, L, l_real, P, C, p_tile,
                                                  double(n_active) - 2.0, use_matrix, dist,
                                                  denom, crit, part_crit, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argmin_partials_kernel<double><<<1, kThreads, 0, s>>>(part_crit, part_idx, blocks, best_idx,
                                                        best_crit);
  return (int)cudaGetLastError();
}

// The partial scans (kPartial): each row's sums over the store's
// positions, dots into dots and den into denom, [M] (dense) or [L] (codes)
// float64 each; the codes scan's grid as vft_scan_codes_blocks gives it.
int vft_nj_scan_dense_partial_f64(const float* U2, const float* W, const double* a,
                                  const double* wq, int64_t M, int K, int P, double* dots,
                                  double* denom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = vft_scan_dense_blocks(M);
  nj_scan_dense_kernel<double, true><<<(unsigned)blocks, kThreads, 0, s>>>(
      U2, W, a, wq, nullptr, M, M, K, P, 1.0, 0, dots, denom, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int vft_nj_scan_codes_partial_f64(const int8_t* codes, const double* G, const double* wq,
                                  int64_t L, int P, int C, int64_t blocks, double* dots,
                                  double* denom, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = codes_smem(P, C);
  const int p_tile = codes_p_tile(P, C);
  cudaError_t err = cudaFuncSetAttribute(codes_kernel(P, C, true),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto kernel = p_tile >= P ? nj_scan_codes_kernel<double, true, true>
                            : nj_scan_codes_kernel<double, false, true>;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(codes, G, wq, nullptr, L, L, P, C, p_tile, 1.0,
                                                  0, dots, denom, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int64_t vft_scan_finish_blocks(int64_t M) { return (M + kThreads - 1) / kThreads; }

// The scan's result from k ranks' partial sums (parts [k, 2, M] float64 in
// device memory: dots, then den, of each rank in rank order): dist, denom
// and crit [M], the per-block partials (vft_scan_finish_blocks of them)
// and the best (lowest crit, lowest index) row.
int vft_nj_scan_finish_f64(const double* parts, int k, const double* outd, int64_t M,
                           int64_t m_real, int64_t n_active, int use_matrix, double* dist,
                           double* denom, double* crit, double* part_crit, int64_t* part_idx,
                           int64_t* best_idx, double* best_crit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || M <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = vft_scan_finish_blocks(M);
  nj_scan_finish_kernel<double><<<(unsigned)blocks, kThreads, 0, s>>>(
      parts, k, outd, M, m_real, double(n_active) - 2.0, use_matrix, dist, denom, crit,
      part_crit, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  argmin_partials_kernel<double><<<1, kThreads, 0, s>>>(part_crit, part_idx, blocks, best_idx,
                                                        best_crit);
  return (int)cudaGetLastError();
}

}  // extern "C"
