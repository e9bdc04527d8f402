"""The port's default ML run at -threads 4 (the batched ML NNI rounds and
lengths passes, the SH-like supports from 1000 resamples) against the
JAX package's on the CPU, its half read from the goldens
(tests/torch_thread_runs.py): RF 0 and the final LogLk within 1e-4
relative.  Each batched NNI round's quartet list is compared too: the
same quartets, and any decision the packages take otherwise a near tie
in both (its two criteria within 5e-3), printed with its margins.
"""
from torch_thread_runs import (Decisions, final_loglk, first_flip, golden,
                               golden_decisions, port_run)
from util import rf_distance

from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles

NEAR_TIE = 5e-3


def test_threads_ml_run_matches_jax(tmp_path):
    newick, meta = golden("ml")
    with Decisions(MLProfiles) as ours:
        nw, sc, _, log = port_run("ml", tmp_path)
    flip = first_flip(ours.log, golden_decisions("ml"), NEAR_TIE)
    print(f"first flip (round, quartet, margins): {flip}")
    assert rf_distance(nw, newick)[0] == 0
    final = final_loglk(log)
    assert abs(final - meta["final_loglk"]) <= 1e-4 * abs(meta["final_loglk"])
    assert sc["n_splits"] == meta["split_count"]["n_splits"]
