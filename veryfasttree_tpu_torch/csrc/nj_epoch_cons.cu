// The NJ join epoch under -constraints (Hopper, sm_90a): nj_epoch.cu
// compiled with VFT_EPOCH_CONS, which gives the kernel nj_epoch_cons_kernel
// (the master adds each pair's join penalty to its distance, ref
// joinConstraintPenalty tcc:559-605, csrc/constraints.cuh, and writes each
// new node's counts) and the entry vft_nj_epoch_cons_f32 (wrapper
// ops/epoch_kernels.py).  A translation unit of its own, so that the
// unconstrained kernel of nj_epoch.cu is compiled as it was.
#define VFT_EPOCH_CONS
#include "nj_epoch.cu"
