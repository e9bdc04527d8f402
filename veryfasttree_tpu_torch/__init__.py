"""VeryFastTree on PyTorch and CUDA: a port of ``veryfasttree_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; each module here mirrors the module of
the same name there.  The NJ one-vs-all scans (csrc/nj_scan.cu), the small
profile-store calls of the host loops, row-pair distances and profile
averages (csrc/me_store.cu), and the ML store's likelihood calls and quartet
optimizations (csrc/ml_lk.cu) are hand-written CUDA kernels; the rest of the
device math is PyTorch.  This package imports neither jax nor the JAX
package: what it shares with it (options, constants, readers, models,
counters, the command-line parser) are copies, each naming its original on
its first line.
"""
