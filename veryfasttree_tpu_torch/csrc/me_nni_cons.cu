// The ME NNI round under -constraints (Hopper, sm_90a): me_nni.cu compiled
// with VFT_ROUND_CONS, which gives the kernel me_nni_round_cons_kernel (the
// quartet penalties of csrc/constraints.cuh in each criterion, each
// recomputed profile's counts) and the entry vft_me_nni_round_cons_f32
// (wrapper ops/nni_kernels.py).  A translation unit of its own, so that it
// builds beside me_nni.cu and the unconstrained kernel compiles as it was.
#define VFT_ROUND_CONS
#include "me_nni.cu"
