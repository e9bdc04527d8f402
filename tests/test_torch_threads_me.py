"""The port's -threads ME functions against the JAX package's, both on the
CPU, from one start: batched.do_nni_batched (ME), spr_batched.
run_spr_batched, and the batched local bootstrap.

Inputs are those of tests/test_torch_spr_round.py (its founder-mutation
alignments; both engines start from one JAX checkpoint).  After each
batched NNI round n_nni must be equal; at the end the tree arrays, the
NNIStats ages, the n_nni and ME profile counters and the node rows
[:maxnode] (codes, W, U) bit for bit, the deltas, supports and max_delta
within 1e-9 (sums of log-corrected distances that the twin's pair
distances add in another order than XLA's; tests/test_torch_nni_round.py).
After a partitioned SPR round at -threads 4 and 12: the tree arrays, n_spr
and the profile counters equal, the rows bit for bit.  -threads > 1 takes
reliability_nj_list for the local bootstrap: its supports and count of
suboptimal splits must be the JAX package's reliability_nj_batched's, on
a tree after the batched NNI round (with and without -bionj, whose
batched tier averages its up-profiles 0.5 : 0.5 all the same).
"""
import numpy as np
import pytest

from test_torch_spr_round import _engines, _same_round
from test_torch_spr_round import one_torch_thread  # noqa: F401

from veryfasttree_tpu.engine import batched as jbatched
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine import spr_batched as jspr_batched
from veryfasttree_tpu.engine import supports as jsupports
from veryfasttree_tpu_torch.engine import batched as tbatched
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine import spr_batched as tspr_batched
from veryfasttree_tpu_torch.engine import supports as tsupports

ATOL = 1e-9                                        # deltas and supports


@pytest.mark.parametrize("n,p,seed,kw,rounds", [
    (80, 256, 5, {}, 1),
    (80, 256, 5, {"two_tier_min": 0}, 1),
    (100, 256, 8, {"bionj": True}, 1),
    (80, 256, 5, {}, 3),
], ids=["dense", "two-tier", "bionj", "three-rounds"])
def test_nni_batched_matches_jax(tmp_path, n, p, seed, kw, rounds):
    jnj, tnj = _engines(tmp_path, n, p, seed, kw)
    for nj in (jnj, tnj):
        nj.debug.n_nni = 0
    jstats, tstats = jrearrange.NNIStats.init(jnj), \
        trearrange.NNIStats.init(tnj)
    for i in range(rounds):
        got = tbatched.do_nni_batched(tnj, i, rounds, False, tstats)
        exp = jbatched.do_nni_batched(jnj, i, rounds, False, jstats)
        assert got[0] == exp[0], i
        assert got[1] == pytest.approx(exp[1], rel=0, abs=ATOL), i
    assert tnj.debug.n_nni > 0
    _same_round(jnj, tnj, kw.get("bionj", False))
    assert tnj.debug.n_nni == jnj.debug.n_nni
    for name in ("age", "subtree_age"):
        np.testing.assert_array_equal(getattr(tstats, name),
                                      getattr(jstats, name), err_msg=name)
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tstats, name), getattr(jstats, name),
                                   rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("threads", [4, 12])
def test_spr_batched_matches_jax(tmp_path, threads):
    jnj, tnj = _engines(tmp_path, 100, 256, 5, {"threads": threads})
    steps = tspr_batched.run_spr_batched.steps
    tspr_batched.run_spr_batched(tnj, 0, 2)
    jspr_batched.run_spr_batched(jnj, 0, 2)
    assert tnj.debug.n_spr > 0
    assert tspr_batched.run_spr_batched.steps > steps
    _same_round(jnj, tnj, False)


@pytest.mark.parametrize("bionj", [False, True])
def test_local_bootstrap_matches_jax_batched(tmp_path, bionj):
    jnj, tnj = _engines(tmp_path, 80, 256, 5, {"bionj": bionj,
                                               "n_bootstrap": 100})
    jbatched.do_nni_batched(jnj, 0, 1, False, jrearrange.NNIStats.init(jnj))
    tbatched.do_nni_batched(tnj, 0, 1, False, trearrange.NNIStats.init(tnj))
    for nj in (jnj, tnj):
        nj.debug.n_suboptimal_splits = 0
    jsupports.reliability_nj_batched(jnj)
    tsupports.reliability_nj_list(tnj)
    m = tnj.tree.maxnode
    np.testing.assert_array_equal(tnj.tree.support[:m], jnj.tree.support[:m])
    assert tnj.debug.n_suboptimal_splits == jnj.debug.n_suboptimal_splits
    assert (tnj.tree.support[tnj.n_seqs:m] > 0).any()
