"""Distance and transition models: copies of the JAX package's
``veryfasttree_tpu/models`` (plain numpy; the port imports none of it)."""
from .distance_matrix import DistanceMatrix
from .transition_matrix import TransitionMatrix

__all__ = ["DistanceMatrix", "TransitionMatrix"]
