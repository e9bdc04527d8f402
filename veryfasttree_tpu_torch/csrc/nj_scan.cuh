// Per-row bodies of the one-vs-all NJ scans (nj_scan.cu), shared by the
// scan kernels and the join epoch's refresh scans (nj_epoch.cu), so that both
// give the same dist and denom bit for bit.
//
// Dense rows: one warp per row; lane l takes the 16-byte chunks l, l + 32, ...
// of the P*C vector row and of the P weight row, then the warp's xor
// butterfly.  Code rows (two-tier leaves): one warp per row, lane l takes the
// 16-code chunks l, l + 32, ... of each tile of positions, in tile order.
// Every double operation is an explicit _rn intrinsic, so the sums do not
// depend on the including file's -fmad setting.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// a*b + c with one rounding, and a + b, in the accumulation type
__device__ __forceinline__ double acc_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float acc_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double acc_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float acc_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double acc_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float acc_add(float a, float b) { return __fadd_rn(a, b); }

template <typename Acc>
__device__ __forceinline__ Acc scan_warp_sum(Acc v) {
  // xor butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = acc_add(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a 16-byte load through the read-only cache, or (kFresh) a plain load, for
// rows that may have been written earlier in the same launch
template <bool kFresh, typename T>
__device__ __forceinline__ T load16(const T* p) {
  if (kFresh) return *p;
  return __ldg(p);
}

// four products of one 16-byte chunk, summed onto the running sum
template <typename Acc>
__device__ __forceinline__ Acc chunk_dot(float4 u, const Acc* q, Acc sum) {
  Acc t = acc_mul(Acc(u.x), q[0]);
  t = acc_fma(Acc(u.y), q[1], t);
  t = acc_fma(Acc(u.z), q[2], t);
  t = acc_fma(Acc(u.w), q[3], t);
  return acc_add(sum, t);
}

// (dots, den) of one dense row against the query (a [K] = the query vector,
// times eigenval in matrix mode; wq [P]); every lane returns the warp's sums.
// u_row and w_row are 16-byte aligned; K and P are multiples of 4.
template <typename Acc, bool kFresh = false>
__device__ __forceinline__ void dense_row(const float* u_row, const float* w_row, const Acc* a,
                                          const Acc* wq, int K, int P, int lane, Acc& dots,
                                          Acc& den) {
  const float4* u4 = reinterpret_cast<const float4*>(u_row);
  const float4* w4 = reinterpret_cast<const float4*>(w_row);
  dots = 0;
  den = 0;
  for (int k = lane; k < K / 4; k += 32) dots = chunk_dot(load16<kFresh>(u4 + k), a + 4 * k, dots);
  for (int p = lane; p < P / 4; p += 32) den = chunk_dot(load16<kFresh>(w4 + p), wq + 4 * p, den);
  dots = scan_warp_sum(dots);
  den = scan_warp_sum(den);
}

// One lane's share of a code row over one tile of pt positions (a multiple
// of 16): g [C rows of stride g_stride] and w [pt] are the tile's projected
// query table and weights.  A code other than NOCODE (127) adds w[p] to den
// and g[code][p] to pick.
template <typename Acc, bool kFresh = false>
__device__ __forceinline__ void codes_row_tile(const int8_t* row, int pt, int C, const Acc* g,
                                               int g_stride, const Acc* w, int lane, Acc& den,
                                               Acc& pick) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
  for (int v = lane; v < pt / 16; v += 32) {
    const int4 raw = load16<kFresh>(r4 + v);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // byte j of the 16 (little-endian), the code of position 16v + j
      const int code = (signed char)((words[j >> 2] >> (8 * (j & 3))) & 0xff);
      const int p = 16 * v + j;
      if (code != 127) {
        den = acc_add(den, w[p]);
        if (code >= 0 && code < C) pick = acc_add(pick, g[code * g_stride + p]);
      }
    }
  }
}

// dist and denom of one row from its sums (ref setBestHit): top / den, or 1
// where the rows share no weight
template <typename Acc>
__device__ __forceinline__ Acc row_dist(Acc dots, Acc den, bool use_matrix) {
  const Acc top = use_matrix ? dots : den - dots;
  return den > Acc(0) ? top / den : Acc(1);
}

// the tile of positions the code scan stages: all P when (C+1)*P doubles fit
// in its shared memory, else the largest multiple of 16 that does
constexpr int kMaxCodesSmem = 200 * 1024;

inline __host__ __device__ int codes_p_tile(int P, int C) {
  const int per_pos = (C + 1) * (int)sizeof(double);
  if (P * per_pos <= kMaxCodesSmem) return P;
  return (kMaxCodesSmem / per_pos) / 16 * 16;
}

}  // namespace
