"""Protein ML in the port against the JAX package on an alignment where no
ML NNI decision flips: tests/torch_protein_runs.py's check_pipeline with
agree, so the whole list runs for the default run (JTT, CAT 20, SH-like
supports from 1000 resamples), -lg -gamma and -approxml: RF 0, ML-NNIs
per round equal, per-round LogLk within 1e-2, the final LogLk within 1e-4
relative, SH-like supports within 0.02 (but at the minimum length), the
Gamma20 LogLk and alpha within 1e-2, the stats block equal but for the
SH pass's worst delta (within 2e-2), the approximate-posteriors share
(within 0.02 points) and the rough counts (within 2e-4 of the counted
positions).

simulate_alignment(40, 120) with the amino-acid alphabet at seed 3: of
seeds 1 to 7, seeds 3, 4 and 7 flip no decision in any of the three runs
and 3 is the first.  The others flip one decision in 7 of their 12 runs,
each a near tie, as seed 5 does in tests/test_torch_protein_ml.py (their
trees part from the JAX package's: scripts/compare_protein_supports.py
prints each run's RF).  At seed 3 the deciding differences part by up to
1.2e-2 under -approxml, the rough counts by 9 positions of 437,393, and
the supports at the minimum length by up to 0.103 (printed only:
tests/torch_protein_runs.py, FLOOR_NOISE).
"""
import pytest

from torch_protein_runs import (CONFIGS, check_pipeline,  # noqa: F401
                                one_torch_thread, runs_at)


@pytest.fixture(scope="module")
def protein_runs(tmp_path_factory):
    return runs_at(3, tmp_path_factory.mktemp("protein"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_protein_pipeline_agrees_with_jax(protein_runs, name):
    check_pipeline(name, *protein_runs[name], agree=True)
