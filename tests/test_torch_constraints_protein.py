"""The port's protein -noml -constraints run (20 codes, BLOSUM45; 12
constraint columns, N=60, tests/torch_constraint_runs.py
RUNS["protein_noml"]) against the JAX package's on the CPU: the Newick
byte-identical, the join log, the counts and the SplitCount's counts
identical, its worst deltas within 1e-8 relative (the port's split test
takes the quartets' distances from one list, whose matrix-mode sums the
serial walk's single calls round otherwise: tests/test_torch_me_sweep.py).
About 15 s."""
import numpy as np
import pytest

import torch_constraint_runs as runs


def test_protein_noml_constraints_identical_to_jax(tmp_path):
    newick, meta, counts = runs.golden("protein_noml")
    got, joins, sc, nj, _ = runs.port_run("protein_noml", tmp_path)
    assert [list(j) for j in joins] == meta["join_log"]
    assert got == newick
    want = meta["split_count"]
    for k, v in want.items():
        assert sc[k] == pytest.approx(v, rel=1e-8, abs=0), k
    assert np.array_equal(nj.con_on, counts["con_on"])
    assert np.array_equal(nj.con_off, counts["con_off"])
