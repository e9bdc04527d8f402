"""Protein ML in the port against the JAX package where no ML NNI decision
flips, the default run (JTT, CAT 20, SH-like supports from 1000 resamples): tests/torch_protein_runs.py's check_pipeline with agree
on simulate_alignment(40, 120) with the amino-acid alphabet at seed 3, the
JAX package's run read from its golden.  A file of its own, so that the
test workers take the six pipeline runs in parallel.

Of seeds 1 to 7, seeds 3, 4 and 7 flip no decision in any of the three runs
and 3 is the first.  The others flip one decision in 7 of their 12 runs,
each a near tie, as seed 5 does in tests/test_torch_protein_ml_*.py (their
trees part from the JAX package's: scripts/compare_protein_supports.py
prints each run's RF).  At seed 3 the deciding differences part by up to
1.2e-2 under -approxml, the rough counts by 9 positions of 437,393, and
the supports at the minimum length by up to 0.103 (printed only:
tests/torch_protein_runs.py, FLOOR_NOISE).
"""
import pytest

from torch_protein_runs import check_pipeline, one_torch_thread  # noqa: F401
from torch_protein_runs import run_at


@pytest.mark.parametrize("name", ["default"])
def test_protein_pipeline_agrees_with_jax(name, tmp_path):
    check_pipeline(name, *run_at(3, name, tmp_path), agree=True)
