"""The port's -threads ML functions against the JAX package's, both on the
CPU, from one start (tests/test_torch_quartet.py's _engines: one JAX
checkpoint, N=48, P=200, an ML store under Jukes-Cantor or GTR with four
CAT rates): batched.optimize_all_branch_lengths_batched, the ML half of
batched.do_nni_batched, and the split test that -threads > 1 takes.

Tolerances (ROADMAP Queue 3, the JAX package's float32 sums), with the
largest value read:
- lengths within 1e-4 + 2e-3 x length (0.65 of it); the tree unchanged;
  the debug counters equal (the JAX package counts a level's lists padded
  to a power of 2, and so does the port);
- the NNI round's quartets decided alike up to a flip on a near tie (its
  two criteria within 5e-3 in both packages), each quartet's criteria
  within 2e-2; without a flip the tree, NNIs, ages and counters equal,
  the lengths within their tolerance, deltas and supports (differences of
  two criteria) within 4e-2 (1.5e-2);
- the split test: -threads > 1 takes the SH pass (ops/ml_round.sh_pass),
  which tests/test_torch_ml_slice.py and chip_smoke.py phase 2f hold to
  the serial test_splits_ml; here against the JAX package's batched
  test_splits_ml_batched on the same tree and store: the SplitCount's
  counts equal, its worst delta within 2e-2, the SH-like supports within
  0.02 (0.006) but on branches at the minimum length (within the line
  search's tolerance of it), within 0.06 there (0.048, a branch of
  5.45e-4).
"""
import numpy as np
import pytest

from test_torch_quartet import _engines, one_torch_thread  # noqa: F401
from torch_thread_runs import Decisions

from veryfasttree_tpu.engine import batched as jbatched
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu_torch.engine import batched as tbatched
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.ops import ml_round

DEBUG = ("n_ml_nni", "n_lk_compute", "n_posterior_compute")
NEAR_TIE = 5e-3
CRITERIA_TOL = 2e-2


def _length_gap(t, j):
    return float(np.max(np.abs(t - j) / (1e-4 + 2e-3 * np.abs(j))))


def _zero_debug(*njs):
    for nj in njs:
        for k in DEBUG:
            setattr(nj.debug, k, 0)


def _same_tree(jnj, tnj):
    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name), err_msg=name)


def _at_jax_lengths(jnj, tnj):
    """Both stores recomputed at the JAX package's lengths."""
    tnj.tree.branchlength[:] = jnj.tree.branchlength
    jnj.ml.recompute_ml_profiles()
    tnj.ml.recompute_ml_profiles()
    _zero_debug(jnj, tnj)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_lengths_batched_matches_jax(tmp_path, model):
    jnj, tnj = _engines(tmp_path, model)
    _zero_debug(jnj, tnj)
    before = ml_round.ml_lengths_pass.launches
    jbatched.optimize_all_branch_lengths_batched(jnj)
    tbatched.optimize_all_branch_lengths_batched(tnj)
    assert ml_round.ml_lengths_pass.launches == before
    _same_tree(jnj, tnj)
    assert _length_gap(tnj.tree.branchlength, jnj.tree.branchlength) <= 1
    # float32-rounded, as the JAX package's are
    bl = tnj.tree.branchlength
    assert np.array_equal(bl, bl.astype(np.float32).astype(np.float64))
    for k in DEBUG:
        assert getattr(tnj.debug, k) == getattr(jnj.debug, k), k


def test_nni_batched_ml_matches_jax(tmp_path):
    jnj, tnj = _engines(tmp_path, "jc")
    jbatched.optimize_all_branch_lengths_batched(jnj)
    _at_jax_lengths(jnj, tnj)
    jstats = jrearrange.NNIStats.init(jnj)
    tstats = trearrange.NNIStats.init(tnj)
    with Decisions(JMLStore) as jlog, Decisions(TMLStore) as tlog:
        exp = jbatched.do_nni_batched(jnj, 0, 2, True, jstats)
        got = tbatched.do_nni_batched(tnj, 0, 2, True, tstats)
    (rows_j, ch_j, cr_j), = jlog.log
    (rows_t, ch_t, cr_t), = tlog.log
    np.testing.assert_array_equal(rows_t, rows_j)
    assert np.all(np.abs(cr_t - cr_j) <= CRITERIA_TOL)
    flips = np.flatnonzero(ch_t != ch_j)
    for k in flips:
        for crit in (cr_j, cr_t):
            assert abs(crit[k, ch_j[k]] - crit[k, ch_t[k]]) <= NEAR_TIE, k
    if len(flips):
        return
    assert got[0] == exp[0] > 0
    assert got[1] == pytest.approx(exp[1], rel=0, abs=2 * CRITERIA_TOL)
    _same_tree(jnj, tnj)
    np.testing.assert_array_equal(tstats.age, jstats.age)
    np.testing.assert_array_equal(tstats.subtree_age, jstats.subtree_age)
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tstats, name),
                                   getattr(jstats, name), rtol=0,
                                   atol=2 * CRITERIA_TOL, err_msg=name)
    assert _length_gap(tnj.tree.branchlength, jnj.tree.branchlength) <= 1
    for k in DEBUG:
        assert getattr(tnj.debug, k) == getattr(jnj.debug, k), k


def test_split_test_matches_jax_batched(tmp_path, monkeypatch):
    jnj, tnj = _engines(tmp_path, "jc")
    jbatched.optimize_all_branch_lengths_batched(jnj)
    _at_jax_lengths(jnj, tnj)
    for nj in (jnj, tnj):
        nj.options.n_bootstrap = 1000
    tnj.options.threads = 4
    # the ML phase's split test at -threads > 1 is the SH pass
    called = []
    monkeypatch.setattr(tml.ml_round, "sh_pass",
                        lambda nj, progress=None: called.append(1)
                        or ml_round.SHPass(nj).run().sc)
    exp = jbatched.test_splits_ml_batched(jnj)
    got = tml.ml_round.sh_pass(tnj)
    assert called
    for k in ("n_splits", "n_bad_splits", "n_constraint_violations",
              "n_bad_both"):
        assert getattr(got, k) == getattr(exp, k), k
    assert abs(got.d_worst_delta_unconstrained
               - exp.d_worst_delta_unconstrained) <= CRITERIA_TOL
    m = tnj.tree.maxnode
    nodes = np.arange(tnj.n_seqs, m)
    nodes = nodes[nodes != tnj.tree.root]
    diff = np.abs(tnj.tree.support[nodes] - jnj.tree.support[nodes])
    # at the minimum length, within the line search's tolerance of it
    opts = jnj.options
    floor = jnj.tree.branchlength[nodes] <= \
        opts.ml_min_branch_length + opts.ml_min_branch_length_tolerance
    print(f"supports within {diff[~floor].max():.3f}, at the minimum length "
          f"{diff[floor].max() if floor.any() else 0:.3f}")
    assert np.all(diff[~floor] <= 0.02)
    assert np.all(diff[floor] <= 0.06)
