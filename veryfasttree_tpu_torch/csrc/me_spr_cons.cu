// The ME SPR round under -constraints (Hopper, sm_90a): me_spr.cu compiled
// with VFT_ROUND_CONS, which gives the kernel me_spr_round_cons_kernel (the
// quartet penalties of csrc/constraints.cuh in each chain step's criteria,
// each recomputed profile's counts) and the entry vft_me_spr_round_cons_f32
// (wrapper ops/spr_kernels.py).  A translation unit of its own, so that it
// builds beside me_spr.cu and the unconstrained kernel compiles as it was.
#define VFT_ROUND_CONS
#include "me_spr.cu"
