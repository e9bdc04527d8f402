"""VeryFastTree on PyTorch and CUDA: a port of ``veryfasttree_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; each module here mirrors the module of
the same name there.  The NJ one-vs-all scans (csrc/nj_scan.cu) and the
small profile-store calls of the host loops, row-pair distances and profile
averages (csrc/me_store.cu), are hand-written CUDA kernels; the rest of the
device math is PyTorch.  This package never imports jax.
"""
