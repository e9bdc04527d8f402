"""The port's default protein ML run (JTT, CAT 20, SH-like supports) at
-threads 4 against the JAX package's on the CPU, at N=40, P=120 (the size
of tests/test_torch_protein_ml_*.py), the JAX package's half read from
the goldens (tests/torch_thread_runs.py).

The final LogLk must agree within 1e-3 relative.  The 20-code quartet
criteria carry the JAX package's float32 search noise (ROADMAP Queue 3
item 2), so a decision may flip on a near tie: the batched rounds'
quartet lists are compared up to the first decision the packages take
otherwise, which must be a near tie in both (its two criteria within
0.1, chip_smoke.ML_CRITERIA_TOL_20) and is printed with its margins; the
RF distance is printed, and held to 0 only where no decision flipped.
"""
from torch_thread_runs import (Decisions, final_loglk, first_flip, golden,
                               golden_decisions, port_run)
from util import rf_distance

from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles

NEAR_TIE_20 = 0.1


def test_threads_protein_run_matches_jax(tmp_path):
    newick, meta = golden("protein_ml")
    with Decisions(MLProfiles) as ours:
        nw, sc, _, log = port_run("protein_ml", tmp_path)
    flip = first_flip(ours.log, golden_decisions("protein_ml"), NEAR_TIE_20)
    rf, n_splits = rf_distance(nw, newick)
    final = final_loglk(log)
    print(f"first flip (round, quartet, margins): {flip}; RF {rf}/{n_splits};"
          f" final LogLk {final} (JAX {meta['final_loglk']})")
    assert abs(final - meta["final_loglk"]) <= 1e-3 * abs(meta["final_loglk"])
    if flip is None:
        assert rf == 0
