"""Protein ML in the port against the JAX package, -lg -gamma: (c) of
tests/test_torch_protein_ml.py at seed 5, the JAX package's run read from
its golden (tests/torch_protein_runs.py).  A file of its own, so that the
test workers take the six pipeline runs in parallel.
"""
import pytest

from torch_protein_runs import check_pipeline, one_torch_thread  # noqa: F401
from torch_protein_runs import run_at


@pytest.mark.parametrize("name", ["lg-gamma"])
def test_protein_pipeline_matches_jax(name, tmp_path):
    check_pipeline(name, *run_at(5, name, tmp_path))
