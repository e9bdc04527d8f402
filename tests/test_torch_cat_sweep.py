"""The CAT fit and the tree log-likelihood over the level tables of a
TreeSweep (engine/ml_profiles.py: one posterior sweep and one tree
log-likelihood launch on the card; here, on the CPU, their plain twins).

* Against the JAX package, on one NJ tree with ME lengths (N=20, P=180; the
  port loads the JAX engine's checkpoint and store, as
  tests/test_torch_ml_store.py does), Jukes-Cantor and GTR:
  ml_site_likelihoods_by_rate's [20, P] per-site log-likelihoods atol
  1e-4 and rtol 1e-5 under Jukes-Cantor (float32 posteriors whose last
  bits differ, carried up the tree's levels, and the JAX package's float32
  sums: the tolerances and reasons of tests/test_torch_ml_store.py), rtol
  2e-5 under GTR: at the lowest rates (0.05 to 0.1) the branches fall to
  the minimum relative length, and a site whose likelihood is near 1e-14
  (log -32) is a product of character-space probabilities near 0, each a
  sum of large signed rotated terms rounded in float32; there the two
  packages part by up to 1.53e-5 relative (one site of 180, the four
  lowest rates).  Then set_ml_rates: the categories equal and the rates
  within 1e-9 relative (the mean of the chosen rates, summed in another
  order).
* Against the per-level route the port ran before the whole-tree kernels
  (chip_smoke.per_level_recompute, per_level_loglk,
  per_level_site_likelihoods: one call per tree level, level_lists'
  order), bit for bit: every row of the store after recompute_ml_profiles
  and after the tree log-likelihood, the total, the per-site sums, the CAT
  fit's per-site log-likelihoods (three of the 20 rates) and the debug
  counters; on the port's NJ tree (N=36,
  P=200) and on a caterpillar of 200 leaves (chip_smoke.shaped_tree, 197
  levels of posteriors), JC and GTR.
* The tables themselves: level_order is tree.level_lists(); a sweep whose
  targets repeat, or whose level reads a row that it or a later level
  writes, is refused; the producers are the earlier items that write each
  source.

About 30 s in one process, most of it the JAX package's compiles and the
caterpillars' 197 levels of per-level twin calls.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (ml_copy, per_level_loglk, per_level_recompute,
                        per_level_site_likelihoods, shaped_start, store_diff)
from test_torch_ml_store import GTR, _engines
from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.models import TransitionMatrix
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.ml_profiles import level_order
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.io.alignment import seqs_to_codes
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.ops import ml_kernels as mk
from veryfasttree_tpu_torch.options import Options as TOptions

CPU = torch.device("cpu")
RATES = tml.ml_site_rates(20)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_cat_fit_matches_jax(tmp_path, model):
    tm = None if model == "jc" else TransitionMatrix.gtr(*GTR)
    ttm = None if model == "jc" else TTransitionMatrix.gtr(*GTR)
    jnj, tnj = _engines(tmp_path, tm, ttm)
    jnj.ml = JMLStore(jnj, tm)
    tnj.ml = TMLStore(tnj, ttm)
    tnj.ml.load_state(*(np.asarray(a) for a in (jnj.ml.codes, jnj.ml.W,
                                                 jnj.ml.V)),
                      jnj.ml.rates_np, jnj.ml.ratecat_np)
    np.testing.assert_allclose(tml.ml_site_likelihoods_by_rate(tnj, RATES),
                               jml.ml_site_likelihoods_by_rate(jnj, RATES),
                               rtol=1e-5 if model == "jc" else 2e-5,
                               atol=1e-4)
    jml.set_ml_rates(jnj)
    tml.set_ml_rates(tnj)
    n = tnj.n_pos
    np.testing.assert_array_equal(tnj.ml.ratecat_np[:n],
                                  np.asarray(jnj.ml.ratecat_np)[:n])
    assert len(np.unique(tnj.ml.ratecat_np[:n])) > 3
    np.testing.assert_allclose(tnj.ml.rates_np, jnj.ml.rates_np, rtol=1e-9)


def _start(shape, model):
    """The port's engine on the CPU with an ML store at four CAT rates:
    its NJ tree with ME lengths (N=36, P=200), or a caterpillar of 200
    leaves (P=64)."""
    ttm = None if model == "jc" else TTransitionMatrix.gtr(*GTR)
    if shape == "caterpillar":
        nj = shaped_start(200, CPU, "caterpillar", model, p=64)
    else:
        opts = TOptions(n_codes=4, show_progress=False, n_bootstrap=0)
        opts.derive_settings()
        codes = seqs_to_codes(simulate_alignment(36, 200, seed=17,
                                                 mutation=0.12,
                                                 gap_frac=0.04), opts)
        nj = TNJ(opts, codes, None, ttm, device=CPU)
        nj.fast_nj()
        trearrange.update_branch_lengths(nj)
        nj.ml = TMLStore(nj, ttm)
    nj.ml.set_rates(tml.ml_site_rates(4),
                    ((np.arange(nj.n_pos) * 7) % 4).astype(np.int32))
    return nj


def _bits(x):
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("model", ["jc", "gtr"])
@pytest.mark.parametrize("shape", ["nj", "caterpillar"])
def test_table_route_is_the_level_route(shape, model):
    start = _start(shape, model)
    tables, levels = ml_copy(start, CPU), ml_copy(start, CPU)
    sweep = tables.ml.tree_sweep()
    if shape == "caterpillar":
        assert sweep.posteriors.n_levels == 197
    tables.ml.recompute_ml_profiles(sweep)
    per_level_recompute(levels.ml)
    assert store_diff(tables.ml, levels.ml) == []
    for want_site in (False, True):
        got = tables.ml.tree_loglk(sweep, want_site)
        want = per_level_loglk(levels, want_site)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert _bits(a.numpy()) == _bits(b.numpy())
    assert store_diff(tables.ml, levels.ml) == []
    got = tml.ml_site_likelihoods_by_rate(tables, RATES[::7])
    want = per_level_site_likelihoods(levels, RATES[::7])
    assert _bits(got) == _bits(want)
    assert store_diff(tables.ml, levels.ml) == []
    for k in ("n_lk_compute", "n_posterior_compute"):
        assert getattr(tables.debug, k) == getattr(levels.debug, k), k
    # the whole function, with its Jukes-Cantor correction, and the same
    # total with and without the per-site sums
    ll, site = tml.tree_loglk(tables, want_site_loglk=True)
    assert tml.tree_loglk(tables) == ll
    ll_l, site_l = per_level_loglk(levels, True)
    ll_l, site_l = tml._jc_correct(levels, float(ll_l),
                                   site_l.numpy().copy())
    assert ll == ll_l and _bits(site) == _bits(site_l)


def test_set_ml_rates_keeps_one_sweep():
    """set_ml_rates builds one TreeSweep for its 20 rates and the final
    recomputes (22 sweeps, 20 tree log-likelihoods), and leaves the rows
    that recompute_ml_profiles gives at the fitted rates."""
    nj = _start("nj", "gtr")
    nj.options = dataclasses.replace(nj.options, n_rate_cats=20)
    built, orig = [], TMLStore.tree_sweep
    calls = {"sweep": 0, "loglk": 0}
    sweep_fn, loglk_fn = mk.ml_posterior_sweep, mk.ml_tree_loglk

    def tree_sweep(self):
        built.append(orig(self))
        return built[-1]

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    TMLStore.tree_sweep = tree_sweep
    mk.ml_posterior_sweep = counted("sweep", sweep_fn)
    mk.ml_tree_loglk = counted("loglk", loglk_fn)
    try:
        tml.set_ml_rates(nj)
    finally:
        TMLStore.tree_sweep = orig
        mk.ml_posterior_sweep, mk.ml_tree_loglk = sweep_fn, loglk_fn
    assert len(built) == 1 and calls == {"sweep": 22, "loglk": 20}
    again = ml_copy(nj, CPU)
    per_level_recompute(again.ml)
    assert store_diff(nj.ml, again.ml) == []


def test_level_tables():
    nj = _start("nj", "jc")
    tree = nj.tree
    got, want = level_order(tree), tree.level_lists()
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    tables = mk.SweepTables.from_levels([
        ([10, 11], [0, 1], [2, 3], [0.1, 0.2], [0.3, 0.4]), ([], [], [], [],
                                                            []),
        ([12, 13], [10, 4], [5, 11], [0.1, 0.2], [0.3, 0.4])])
    np.testing.assert_array_equal(tables.offsets, [0, 2, 4])
    np.testing.assert_array_equal(tables.prod1, [-1, -1, 0, -1])
    np.testing.assert_array_equal(tables.prod2, [-1, -1, -1, 1])
    assert tables.len2.dtype == np.float32 and tables.n_items == 4
    with pytest.raises(ValueError, match="distinct"):
        mk.SweepTables.from_levels([([10], [0], [1], [.1], [.1]),
                                    ([10], [2], [3], [.1], [.1])])
    with pytest.raises(ValueError, match="later level"):
        mk.SweepTables.from_levels([([10], [11], [1], [.1], [.1]),
                                    ([11], [2], [3], [.1], [.1])])
    with pytest.raises(ValueError, match="later level"):
        mk.SweepTables.from_levels([([10, 11], [0, 10], [1, 2], [.1, .1],
                                     [.1, .1])])
