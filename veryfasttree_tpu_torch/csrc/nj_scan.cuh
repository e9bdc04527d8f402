// Per-row bodies of the one-vs-all NJ scans (nj_scan.cu), shared by the
// scan kernels and the join epoch's refresh scans (nj_epoch.cu), so that both
// give the same dist and denom bit for bit.
//
// Dense rows: one warp per row; lane l takes the 16-byte chunks l, l + 32, ...
// of the P*C vector row and of the P weight row, then the warp's xor
// butterfly.  Code rows (two-tier leaves): one warp per row, lane l takes the
// 16-code chunks l, l + 32, ... of each tile of positions, in tile order,
// and the position order within a chunk; the query table it reads (G and
// wq) is laid out per tile (codes_slot) so that at each step the warp's
// lanes read consecutive doubles.  Every double operation is an explicit _rn
// intrinsic, so the sums do not depend on the including file's -fmad
// setting.

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

// the tile of positions the code scan stages: all P when (C+1)*P doubles fit
// in its shared memory, else the largest multiple of 16 that does (the
// laid-out tile adds at most 16 doubles a row, within the card's 227 KB)
constexpr int kMaxCodesSmem = 200 * 1024;

inline __host__ __device__ int codes_p_tile(int P, int C) {
  const int per_pos = (C + 1) * (int)sizeof(double);
  if (P * per_pos <= kMaxCodesSmem) return P;
  return (kMaxCodesSmem / per_pos) / 16 * 16;
}

// The laid-out order of one tile's positions in the code scan's query table
// (each code's row of G, and wq): position q of a tile of pt positions (a
// multiple of 16) sits at slot (q % 16) * S + q / 16, S = pt / 16 rounded up
// to odd.  Lane v reads the positions 16v + j in the order j = 0 .. 15, so
// at each j the warp's lanes read consecutive slots: 256 contiguous bytes,
// and in shared memory the 16 lanes of a half-warp in 16 distinct bank
// pairs, whatever code each lane's row has (a code's row is 16 S doubles,
// a multiple of the 32 banks).  A thread per position staging the tile
// writes slots S apart, an odd stride: again 16 bank pairs a half-warp.
inline __host__ __device__ int codes_slot_stride(int pt) { return (pt / 16) | 1; }
inline __host__ __device__ int codes_slot(int q, int pt) {
  return (q & 15) * codes_slot_stride(pt) + (q >> 4);
}
inline __host__ __device__ int codes_tile_len(int pt) { return 16 * codes_slot_stride(pt); }

// One code's row of the laid-out table over all P positions: the tiles of
// codes_p_tile(P, C) positions one after another, each codes_tile_len long;
// codes_table_index is position p's place in it.
inline __host__ __device__ int64_t codes_table_len(int P, int C) {
  const int pt = codes_p_tile(P, C);
  return (int64_t)((P + pt - 1) / pt) * codes_tile_len(pt);
}
inline __host__ __device__ int64_t codes_table_index(int p, int P, int C) {
  const int pt = codes_p_tile(P, C), t = p / pt, p0 = t * pt;
  return (int64_t)t * codes_tile_len(pt) + codes_slot(p - p0, P - p0 < pt ? P - p0 : pt);
}

// the rows a warp of the code scan sums at once (nj_scan.cu)
constexpr int kCodesRowsPerWarp = 4;

// The lane's share of n (<= kRows) consecutive code rows over one tile of pt
// positions: row r at row0 + r * row_stride (16-byte aligned); g [C rows of
// stride g_stride] and w: the tile's laid-out table.  A code other than
// NOCODE (127) adds w[p] to den[r] and g[code][p] to pick[r].  Each row's
// sums take the single-row order (positions 16v + j of chunks v = lane,
// lane + 32, ..., j = 0 .. 15); the rows share each weight load.  No branch
// on a code: every lane loads a table value (code 0's where its code adds
// none) and keeps or drops each sum by a select, so a warp never splits on
// a gap and the rows' chains of loads and adds run side by side.
template <typename Acc, int kRows, bool kFresh = false>
__device__ __forceinline__ void codes_rows_tile(const int8_t* row0, int64_t row_stride, int n,
                                                int pt, int C, const Acc* g, int g_stride,
                                                const Acc* w, int lane, Acc* den, Acc* pick) {
  const int S = codes_slot_stride(pt);
  for (int v = lane; v < pt / 16; v += 32) {
    int words[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < n) {
        const int4 raw = load16<kFresh>(reinterpret_cast<const int4*>(row0 + r * row_stride) + v);
        words[r][0] = raw.x;
        words[r][1] = raw.y;
        words[r][2] = raw.z;
        words[r][3] = raw.w;
      } else {
        words[r][0] = words[r][1] = words[r][2] = words[r][3] = 0x7f7f7f7f;  // all NOCODE
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int slot = j * S + v;  // codes_slot(16 v + j, pt)
      const Acc wj = w[slot];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // byte j of the 16 (little-endian), the code of position 16v + j
        const int code = (signed char)((words[r][j >> 2] >> (8 * (j & 3))) & 0xff);
        const bool gap = code == 127;
        const bool hit = !gap && code >= 0 && code < C;
        const Acc gv = g[(hit ? code : 0) * g_stride + slot];
        const Acc d = acc_add(den[r], wj), s = acc_add(pick[r], gv);
        den[r] = gap ? den[r] : d;
        pick[r] = hit ? s : pick[r];
      }
    }
  }
}

// One row alone (the join epoch's refresh scans): the same sums in the same
// order as codes_rows_tile's, with branches on the code, which take fewer
// registers beside the epoch's deciding warp than the selects.
template <typename Acc, bool kFresh = false>
__device__ __forceinline__ void codes_row_tile(const int8_t* row, int pt, int C, const Acc* g,
                                               int g_stride, const Acc* w, int lane, Acc& den,
                                               Acc& pick) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
  const int S = codes_slot_stride(pt);
  for (int v = lane; v < pt / 16; v += 32) {
    const int4 raw = load16<kFresh>(r4 + v);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int code = (signed char)((words[j >> 2] >> (8 * (j & 3))) & 0xff);
      const int slot = j * S + v;  // codes_slot(16 v + j, pt)
      if (code != 127) {
        den = acc_add(den, w[slot]);
        if (code >= 0 && code < C) pick = acc_add(pick, g[code * g_stride + slot]);
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

}  // namespace
