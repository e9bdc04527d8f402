"""The port's ME NNI round (ops/nni_kernels.nni_round, on the CPU the host
loop engine/rearrange.do_nni on the per-call twins) against the JAX
package's (engine/rearrange.do_nni with use_ml off).

Inputs are those of tests/test_spr_epoch.py, and both engines start from
one JAX checkpoint (tests/test_torch_spr_round.py's _engines).  After each
round n_nni must be equal; at the end the tree arrays, the NNIStats age and
subtree_age, the n_nni and ME profile counters, and the node rows
[:maxnode] (codes, W, U) bit for bit.  The deltas and supports (and the
round's max_delta) are differences of sums of log-corrected distances, and
the twin's pair distances are summed in another order than XLA's: they
agree within atol 1e-9 (measured: 0 in the N=80 cases, 1.3e-10 and 5.0e-10
at N=150), -bionj included (measured 0: the port rounds the BIONJ
averages as the JAX package's CPU build does).  The three-round case carries
the NNIStats over, so that its third round skips the subtrees the fast-NNI
heuristic marks (ages reach 2 after two rounds).  About 40 s in one
process.
"""
import numpy as np
import pytest

from test_torch_spr_round import _engines, one_torch_thread  # noqa: F401

from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.profiles import fetch_np
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.ops import nni_kernels

COUNTERS = ("n_nni", "profile_ops", "profile_avg_ops")


@pytest.mark.parametrize("n,p,seed,kw,rounds", [
    (80, 256, 5, {}, 1),
    (80, 256, 5, {"two_tier_min": 0}, 1),
    (150, 300, 2, {}, 1),
    (100, 256, 8, {"bionj": True}, 1),
    (80, 256, 5, {}, 3),
], ids=["dense", "two-tier", "n150", "bionj", "three-rounds"])
def test_nni_round_matches_jax(tmp_path, n, p, seed, kw, rounds):
    jnj, tnj = _engines(tmp_path, n, p, seed, kw)
    atol = 1e-9                                    # delta and support
    assert tnj.prof.two_tier == ("two_tier_min" in kw)
    for nj in (jnj, tnj):
        nj.debug.n_nni = 0
    jstats, tstats = jrearrange.NNIStats.init(jnj), trearrange.NNIStats.init(tnj)
    n_internal = tnj.tree.maxnode - tnj.n_seqs - 1   # quartets of a full walk
    for i in range(rounds):
        ops = tnj.debug.profile_ops
        got = nni_kernels.nni_round(tnj, i, rounds, tstats)
        exp = jrearrange.do_nni(jnj, i, rounds, False, jstats)
        assert got[0] == exp[0], i
        assert got[1] == pytest.approx(exp[1], rel=0, abs=atol), i
        quartets = (tnj.debug.profile_ops - ops) // 6
    assert tnj.debug.n_nni > 0
    if rounds == 3:
        assert quartets < n_internal         # the skip set engaged
    elif not kw.get("bionj"):
        assert quartets == n_internal

    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name), err_msg=name)
    for name in ("age", "subtree_age"):
        np.testing.assert_array_equal(getattr(tstats, name),
                                      getattr(jstats, name), err_msg=name)
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tstats, name), getattr(jstats, name),
                                   rtol=0, atol=atol, err_msg=name)
    for name in COUNTERS:
        assert getattr(tnj.debug, name) == getattr(jnj.debug, name), name
    mh = jnj.tree.maxnode
    lo = tnj.prof._leaf_rows        # float rows of a two-tier store
    np.testing.assert_array_equal(tnj.prof.codes.numpy()[:mh],
                                  fetch_np(jnj.prof.codes)[:mh])
    for name in ("W", "U"):
        t = getattr(tnj.prof, name).numpy()[: mh - lo]
        j = fetch_np(getattr(jnj.prof, name))[: mh - lo]
        np.testing.assert_array_equal(t, j, err_msg=name)
