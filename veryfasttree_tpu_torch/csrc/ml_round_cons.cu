// The ML NNI round under -constraints (Hopper, sm_90a): ml_round.cu
// compiled with VFT_ROUND_CONS, which gives the kernel
// ml_nni_round_cons_kernel (block 0's criteria less the quartets' penalties
// of csrc/constraints.cuh; the counts read only) and the entry
// vft_ml_nni_round_cons_f32 (wrapper ops/ml_round.py), at 4 and 20 codes.
// A translation unit of its own, so that it builds beside ml_round.cu and
// the unconstrained kernels compile as they were.
#define VFT_ROUND_CONS
#include "ml_round.cu"
