"""The port's ML NNI round and ML branch-length pass (ops/ml_round.py; on
the CPU the host loops engine/rearrange.do_nni with use_ml and
engine/ml.optimize_all_branch_lengths on the per-call twins) against the
JAX package's (rearrange.do_nni with use_ml, ml.optimize_all_branch_lengths).

Both engines start from one JAX checkpoint with an ML store under
Jukes-Cantor or GTR and four CAT rates (tests/test_torch_quartet.py's
_engines: N=48, P=200), take one lengths pass, then one ML NNI round, or
three with the NNIStats carried over so that the third takes the fast-NNI
skip set.  Held exactly: the tree arrays, the NNIs per round, the NNIStats
ages and the debug counters (n_ml_nni, n_star_tests, n_lk_compute,
n_posterior_compute), and every quartet's decision.  Tolerances (ROADMAP
Queue 3: each package's float32 objective, which the JAX package sums in
float32), with the largest value measured:
- lengths within 1e-4 + 2e-3 x length (0.64 of it);
- deltas, supports and max_delta within the quartet LogLk tolerance 5e-3
  (3.9e-3, a support);
- each quartet's three criteria within 2e-2 (9.7e-3): they are quartet
  LogLks at lengths that already differ within the length tolerance, where
  the 5e-3 of tests/test_torch_quartet.py starts both from equal lengths;
- node rows recomputed by both packages from the JAX package's lengths
  within 2e-4 (1.1e-4 under GTR after the lengths pass, 1.5e-6 elsewhere):
  ROADMAP's 5e-5 was measured on another tree, and the JAX package rotates
  its GTR posteriors with float32 products;
- the rows a round leaves are each package's posteriors at its own
  lengths: codes and weights equal, vectors within 1e-2 (2.6e-3).

One decision flips on a near tie: in the GTR round, quartet 38 (rows 0,
74, 85, 183), AB and AC are 1.5e-4 apart in the JAX package and 1.8e-5 in
the port, in the other order.  From the first flipped quartet on the trees
differ; the case asserts the decisions and criteria before it, and that
the flipped quartet's two criteria lie within 5e-3 of each other in both
packages.  About 40 s in one process.
"""
import numpy as np
import pytest

from test_torch_quartet import _engines, one_torch_thread  # noqa: F401

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.profiles import fetch_np
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.ops import ml_round

DEBUG = ("n_ml_nni", "n_star_tests", "n_lk_compute", "n_posterior_compute")
QUARTET_TOL = 5e-3                     # deltas, supports, max_delta
CRITERIA_TOL = 2e-2                    # each quartet's criteria
ROWS_TOL = 2e-4                        # rows recomputed at equal lengths


def _length_tol(j):
    return 1e-4 + 2e-3 * np.abs(j)


def _zero_debug(*njs):
    for nj in njs:
        for k in DEBUG:
            setattr(nj.debug, k, 0)


def _same_state(jnj, tnj):
    """Tree arrays, lengths, counters and node rows of the two engines."""
    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name), err_msg=name)
    jl, tl = jnj.tree.branchlength, tnj.tree.branchlength
    assert np.all(np.abs(tl - jl) <= _length_tol(jl))
    for k in DEBUG:
        assert getattr(tnj.debug, k) == getattr(jnj.debug, k), k
    rows = slice(0, 2 * tnj.tree.maxnodes)          # node and up-profile rows
    np.testing.assert_array_equal(tnj.ml.codes.numpy()[rows],
                                  fetch_np(jnj.ml.codes)[rows])
    np.testing.assert_array_equal(tnj.ml.W.numpy()[rows],
                                  fetch_np(jnj.ml.W)[rows])
    np.testing.assert_allclose(tnj.ml.V.numpy()[rows],
                               fetch_np(jnj.ml.V)[rows], rtol=0, atol=1e-2)


def _same_rows_at_jax_lengths(jnj, tnj):
    """Every node row recomputed by both packages from the JAX package's
    lengths on the common tree."""
    tnj.tree.branchlength[:] = jnj.tree.branchlength
    jnj.ml.recompute_ml_profiles()
    tnj.ml.recompute_ml_profiles()
    m = tnj.tree.maxnode
    np.testing.assert_allclose(tnj.ml.V.numpy()[:m], fetch_np(jnj.ml.V)[:m],
                               rtol=0, atol=ROWS_TOL)


def _record(monkeypatch, mod, log):
    """Log every (rows, choice, criteria) of mod.ml_quartet_nni."""
    orig = mod.ml_quartet_nni

    def rec(nj, rows4, *args):
        out = orig(nj, rows4, *args)
        log.append((tuple(int(r) for r in rows4), int(out[0]),
                    np.array(out[1], dtype=np.float64)))
        return out

    monkeypatch.setattr(mod, "ml_quartet_nni", rec)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_ml_lengths_pass_matches_jax(tmp_path, model):
    jnj, tnj = _engines(tmp_path, model)
    _zero_debug(jnj, tnj)
    before = ml_round.ml_lengths_pass.launches
    jml.optimize_all_branch_lengths(jnj)
    ml_round.ml_lengths_pass(tnj)
    assert ml_round.ml_lengths_pass.launches == before      # the host loop
    assert tnj.debug.n_lk_compute > 0
    _same_state(jnj, tnj)
    _same_rows_at_jax_lengths(jnj, tnj)


@pytest.mark.parametrize("model,rounds", [("jc", 1), ("gtr", 1), ("jc", 3)],
                         ids=["jc", "gtr", "jc-three-rounds"])
def test_ml_nni_round_matches_jax(tmp_path, monkeypatch, model, rounds):
    jnj, tnj = _engines(tmp_path, model)
    jml.optimize_all_branch_lengths(jnj)
    ml_round.ml_lengths_pass(tnj)
    _zero_debug(jnj, tnj)
    jlog, tlog = [], []
    _record(monkeypatch, jml, jlog)
    _record(monkeypatch, tml, tlog)
    jstats = jrearrange.NNIStats.init(jnj)
    tstats = trearrange.NNIStats.init(tnj)
    n_internal = tnj.tree.maxnode - tnj.n_seqs - 1
    for i in range(rounds):
        n_before = len(tlog)
        got = ml_round.ml_nni_round(tnj, i, rounds, tstats)
        exp = jrearrange.do_nni(jnj, i, rounds, True, jstats)
        for k, (j, t) in enumerate(zip(jlog, tlog)):
            assert j[0] == t[0], (i, k)                     # the same quartet
            assert np.all(np.abs(t[2] - j[2]) <= CRITERIA_TOL), (i, k)
            if j[1] != t[1]:
                # the flipped quartet: a near tie in both packages
                for crit in (j[2], t[2]):
                    assert abs(crit[j[1]] - crit[t[1]]) <= QUARTET_TOL, (i, k)
                return
        assert len(jlog) == len(tlog)
        assert got[0] == exp[0], i
        assert got[1] == pytest.approx(exp[1], rel=0, abs=QUARTET_TOL), i
        quartets = len(tlog) - n_before
    assert tnj.debug.n_ml_nni > 0
    if rounds == 3:
        assert quartets < n_internal                 # the skip set engaged
    else:
        assert quartets == n_internal
    for name in ("age", "subtree_age"):
        np.testing.assert_array_equal(getattr(tstats, name),
                                      getattr(jstats, name), err_msg=name)
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tstats, name),
                                   getattr(jstats, name), rtol=0,
                                   atol=QUARTET_TOL, err_msg=name)
    _same_state(jnj, tnj)
    _same_rows_at_jax_lengths(jnj, tnj)


def test_slow_keeps_the_host_loop(tmp_path):
    """A CPU store under -slow runs the host loop and launches no kernel
    (the CUDA store's -slow case is test_torch_cuda.py's
    test_ml_nni_round_slow_keeps_the_host_loop)."""
    _, tnj = _engines(tmp_path, "jc", jax=False)
    tnj.options.slow = True
    before = ml_round.ml_nni_round.launches
    changes, _ = ml_round.ml_nni_round(tnj, 0, 1,
                                       trearrange.NNIStats.init(tnj))
    assert ml_round.ml_nni_round.launches == before
    assert changes == tnj.debug.n_ml_nni
