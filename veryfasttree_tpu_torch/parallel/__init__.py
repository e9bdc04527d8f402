"""Multi-GPU execution over torch.distributed (counterpart of
``veryfasttree_tpu/parallel/``): one process drives one card, a dp x sp
grid of ranks (mesh.py), their start (multihost.py), and the sharded
kernels of the JAX package's multi-chip tests (sharded.py)."""
from .mesh import Mesh, make_mesh, mesh_from_options

__all__ = ["Mesh", "make_mesh", "mesh_from_options"]
