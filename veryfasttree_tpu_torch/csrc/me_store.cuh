// Device bodies of the minimum-evolution store kernels, shared by the
// single-call kernels (me_store.cu) and the SPR round kernel (me_spr.cu), so
// that both give the same distances and the same averaged rows bit for bit.
//
// Store layout (veryfasttree_tpu_torch/engine/profiles.py): codes int8
// [n_rows, P] for every row; W float [n_float, P] and U float [n_float, P, C]
// for the float rows.  Rows below leaf_rows (the leaves of a two-tier store;
// 0 for a dense store) exist only as codes and are expanded on the fly:
// w = (code != NOCODE), u = code_freq[code] * w.  A float row's physical index
// is row - leaf_rows.
//
// Every float and double operation here is an explicit _rn intrinsic, so the
// result does not depend on the file's -fmad setting.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoCode = 127;
constexpr int kDistThreads = 128;  // threads of one pair distance
constexpr int kDistWarps = kDistThreads / 32;

struct StoreView {
  const int8_t* codes;      // [n_rows, P]
  const float* W;           // [n_float, P]
  const float* U;           // [n_float, P, C]
  const float* code_freq;   // [C, C]
  int64_t leaf_rows;
  int P;
};

// weight and vector of one row at position p (row -1: the query)
template <int C>
__device__ __forceinline__ void load_pos(const StoreView& s, int64_t row, int p, const float* qU,
                                         const float* qW, float& w, float (&u)[C]) {
  if (row < 0) {
    w = qW[p];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = qU[(int64_t)p * C + c];
    return;
  }
  if (row < s.leaf_rows) {
    const int code = s.codes[row * s.P + p];
    const bool valid = code != kNoCode;
    w = valid ? 1.0f : 0.0f;
    const int safe = valid ? code : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __fmul_rn(s.code_freq[safe * C + c], w);
    return;
  }
  const int64_t phys = row - s.leaf_rows;
  w = s.W[phys * s.P + p];
  const float* up = s.U + (phys * s.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = up[c];
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One thread's share of the distance of rows (ra, rb): thread t of a
// kDistThreads group strides the positions, converting each float to double
// before the products (the reference's CPU path upcasts the rows before the
// contraction), then the warp's sum.  Every lane returns its warp's sums.
template <int C>
__device__ __forceinline__ void pair_partial(const StoreView& s, int64_t ra, int64_t rb,
                                             const float* qU, const float* qW, const double* ev,
                                             int t, double& den, double& dots) {
  den = 0.0;
  dots = 0.0;
  for (int p = t; p < s.P; p += kDistThreads) {
    float wa, wb, ua[C], ub[C];
    load_pos<C>(s, ra, p, qU, qW, wa, ua);
    load_pos<C>(s, rb, p, qU, qW, wb, ub);
    den = __fma_rn((double)wa, (double)wb, den);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ev != nullptr)
        dots = __fma_rn(__dmul_rn((double)ua[c], (double)ub[c]), ev[c], dots);
      else
        dots = __fma_rn((double)ua[c], (double)ub[c], dots);
    }
  }
  den = warp_sum(den);
  dots = warp_sum(dots);
}

// Two pairs' shares in one pass over the positions, (ra, rb) and (rc, rd):
// each sum is pair_partial's, term for term, so each pair's bits are its
// own; the second pair's loads overlap the first's.
template <int C>
__device__ __forceinline__ void pair_partial2(const StoreView& s, int64_t ra, int64_t rb,
                                              int64_t rc, int64_t rd, const double* ev, int t,
                                              double& den1, double& dots1, double& den2,
                                              double& dots2) {
  den1 = dots1 = den2 = dots2 = 0.0;
  for (int p = t; p < s.P; p += kDistThreads) {
    float wa, wb, wc, wd, ua[C], ub[C], uc[C], ud[C];
    load_pos<C>(s, ra, p, nullptr, nullptr, wa, ua);
    load_pos<C>(s, rb, p, nullptr, nullptr, wb, ub);
    load_pos<C>(s, rc, p, nullptr, nullptr, wc, uc);
    load_pos<C>(s, rd, p, nullptr, nullptr, wd, ud);
    den1 = __fma_rn((double)wa, (double)wb, den1);
    den2 = __fma_rn((double)wc, (double)wd, den2);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ev != nullptr) {
        dots1 = __fma_rn(__dmul_rn((double)ua[c], (double)ub[c]), ev[c], dots1);
        dots2 = __fma_rn(__dmul_rn((double)uc[c], (double)ud[c]), ev[c], dots2);
      } else {
        dots1 = __fma_rn((double)ua[c], (double)ub[c], dots1);
        dots2 = __fma_rn((double)uc[c], (double)ud[c], dots2);
      }
    }
  }
  den1 = warp_sum(den1);
  dots1 = warp_sum(dots1);
  den2 = warp_sum(den2);
  dots2 = warp_sum(dots2);
}

// (dist, denom) of one pair from its warps' sums, added in warp order.
__device__ __forceinline__ void pair_finish(const double* warp_den, const double* warp_dots,
                                            const double* ev, double& dist, double& denom) {
  double d = warp_den[0], t = warp_dots[0];
  for (int w = 1; w < kDistWarps; ++w) {
    d = __dadd_rn(d, warp_den[w]);
    t = __dadd_rn(t, warp_dots[w]);
  }
  const double top = ev != nullptr ? t : __dsub_rn(d, t);
  dist = d > 0.0 ? __ddiv_rn(top, d) : 1.0;
  denom = d;
}

// a*b + c rounded once to float (up to a rare double-rounding tie), as the
// plain twins' _fma rounds it: the float product is exact in double.
__device__ __forceinline__ float fma_via_double(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// bw*x1 + (1-bw)*x2 rounded as the reference's CPU build rounds it
// (ops/kernels.py _mix): at bw = 0.5 two exact halvings and one rounded sum;
// otherwise one fused multiply-add of the second product onto the rounded
// first, or, fuse_first, of the first onto the rounded second.
__device__ __forceinline__ float mix(float x1, float x2, float bw, float omb, bool half,
                                     bool fuse_first = false) {
  if (half) return __fadd_rn(__fmul_rn(0.5f, x1), __fmul_rn(0.5f, x2));
  if (fuse_first) return fma_via_double(x1, bw, __fmul_rn(x2, omb));
  return fma_via_double(x2, omb, __fmul_rn(x1, bw));
}

// averageProfile of rows (ri, rj) into row rt at position p (ref
// averageProfile tcc:2063-2135): every float operation is the reference's,
// in its order.  Matrix mode's position total is a float dot product over
// the C codes, summed left to right; %different mode's with a weight other
// than 0.5 is one chain of fused multiply-adds over both children's vectors,
// and the weight that scales U fuses the other product than w_out does
// (ops/kernels.py average_profile).  rt lies at or above leaf_rows.
template <int C>
__device__ __forceinline__ void average_pos(const StoreView& s, int8_t* codes_out, float* W_out,
                                            float* U_out, const float* eigentot, int64_t rt,
                                            int64_t ri, int64_t rj, int p, float bw, float omb,
                                            bool half, float tol, float fallback) {
  float w1, w2, u1[C], u2[C];
  load_pos<C>(s, ri, p, nullptr, nullptr, w1, u1);
  load_pos<C>(s, rj, p, nullptr, nullptr, w2, u2);
  const int c1 = s.codes[ri * s.P + p], c2 = s.codes[rj * s.P + p];

  const float w_out = mix(w1, w2, bw, omb, half);
  // keep a child's code where the children agree or the other is absent
  const bool take1 = (w1 > 0.0f) && (c1 != kNoCode) && ((w2 <= 0.0f) || (c1 == c2));
  const bool take2 = (w1 <= 0.0f) && (w2 > 0.0f) && (c2 != kNoCode);
  int c_out = take1 ? c1 : (take2 ? c2 : kNoCode);
  if (!(w_out > 0.0f)) c_out = kNoCode;

  float f[C];
#pragma unroll
  for (int c = 0; c < C; ++c) f[c] = mix(u1[c], u2[c], bw, omb, half);
  float total;
  if (eigentot != nullptr) {
    total = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) total = __fadd_rn(total, __fmul_rn(f[c], eigentot[c]));
  } else if (!half) {
    total = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      total = fma_via_double(u1[c], bw, total);
      total = fma_via_double(u2[c], omb, total);
    }
  } else {
    total = f[0];
#pragma unroll
    for (int c = 1; c < C; ++c) total = __fadd_rn(total, f[c]);
  }
  const bool ok = total > tol;
#pragma unroll
  for (int c = 0; c < C; ++c)
    f[c] = ok ? __fdiv_rn(f[c], total) : (eigentot != nullptr ? s.code_freq[c] : fallback);
  if (c_out != kNoCode) {
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = s.code_freq[c_out * C + c];
  }

  const float w_u = mix(w1, w2, bw, omb, half, true);
  codes_out[rt * s.P + p] = (int8_t)c_out;
  const int64_t phys = rt - s.leaf_rows;
  W_out[phys * s.P + p] = w_out;
  float* uo = U_out + (phys * s.P + p) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) uo[c] = w_u > 0.0f ? __fmul_rn(w_u, f[c]) : 0.0f;
}

}  // namespace
