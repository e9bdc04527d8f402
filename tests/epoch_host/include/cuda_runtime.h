// Host stand-ins for the CUDA constructs that csrc/nj_epoch.cuh and the
// headers it includes use, so that the join epoch's decisions compile as
// host C++ (tests/test_torch_epoch_warp.py).  Each float and double
// intrinsic is the plain operation in its type; build with
// -ffp-contract=off so that none is fused.
#pragma once

#include <cmath>
#include <cstdint>

#define __device__
#define __host__
#define __forceinline__ inline
#define __global__

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __double2float_rn(double x) { return (float)x; }
// the phase bodies' warp sums are not run on the host (host_epoch.cpp has
// its own phases)
inline double __shfl_xor_sync(unsigned, double v, int) { return v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
