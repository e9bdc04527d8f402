"""The port's -nt -noml -constraints run (12 constraint columns, N=60,
tests/torch_constraint_runs.py RUNS["noml"]) against the JAX package's on
the CPU: the Newick byte-identical, the join log and the SplitCount
(constraint violations, bad splits with both kinds, the worst constrained
and unconstrained deltas) identical, and the counts the run leaves equal.
The JAX half is read from tests/data (its goldens' hash:
test_torch_constraints_options.py).  About 10 s."""
import numpy as np

import torch_constraint_runs as runs


def test_noml_constraints_identical_to_jax(tmp_path):
    newick, meta, counts = runs.golden("noml")
    got, joins, sc, nj, _ = runs.port_run("noml", tmp_path)
    assert [list(j) for j in joins] == meta["join_log"]
    assert got == newick
    assert sc == meta["split_count"]
    assert sc["n_constraint_violations"] > 0
    assert np.array_equal(nj.con_on, counts["con_on"])
    assert np.array_equal(nj.con_off, counts["con_off"])
