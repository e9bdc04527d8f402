"""Distance and transition models: the JAX package's ``models`` (plain
numpy, no jax), re-exported so that callers of the port import only this
package."""
from veryfasttree_tpu.models import DistanceMatrix, TransitionMatrix

__all__ = ["DistanceMatrix", "TransitionMatrix"]
