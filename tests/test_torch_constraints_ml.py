"""The port's default -nt -constraints run (ML NNIs, CAT 20; 12 constraint
columns, N=60, tests/torch_constraint_runs.py RUNS["ml"]) against the JAX
package's on the CPU: the NJ join log identical, RF 0 between the trees,
the final LogLk within 1e-4 relative, the SplitCount's constraint
violations and bad splits with both kinds equal and its worst deltas
within CRITERIA_TOL (tests/test_torch_ml_round.py: quartet LogLks carry
each package's float32 line searches).  The counts after the ML phase equal
the JAX package's: its ML NNIs recompute the profiles but not the counts,
which keep the ME phase's (ROADMAP.md, known departures).  About 25 s."""
import numpy as np

import torch_constraint_runs as runs
from util import rf_distance

CRITERIA_TOL = 2e-2


def test_ml_constraints_match_jax(tmp_path):
    newick, meta, counts = runs.golden("ml")
    got, joins, sc, nj, log = runs.port_run("ml", tmp_path)
    assert [list(j) for j in joins] == meta["join_log"]
    assert rf_distance(got, newick)[0] == 0
    final = runs.final_loglk(log)
    assert abs(final - meta["final_loglk"]) <= 1e-4 * abs(meta["final_loglk"])
    want = meta["split_count"]
    for k in ("n_constraint_violations", "n_bad_both", "n_splits"):
        assert sc[k] == want[k], k
    assert sc["n_constraint_violations"] > 0
    for k in ("d_worst_delta_constrained", "d_worst_delta_unconstrained"):
        assert abs(sc[k] - want[k]) <= CRITERIA_TOL, k
    assert np.array_equal(nj.con_on, counts["con_on"])
    assert np.array_equal(nj.con_off, counts["con_off"])
