"""The port's -noml pipeline at -threads 4 against the JAX package's
under -constraints (12 columns), for protein (BLOSUM45) and under -slow,
as tests/test_torch_threads_noml.py holds the others: Newick
byte-identical, SplitCount equal (the constraint counts included).
"""
import pytest

from torch_thread_runs import check_identical


@pytest.mark.parametrize("name", ["constraints", "protein_noml", "slow"])
def test_threads_noml_identical_to_jax(tmp_path, name):
    check_identical(name, tmp_path)
