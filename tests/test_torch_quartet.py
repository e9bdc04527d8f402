"""The port's quartet optimization (MLProfiles.quartet_optimize, one
ml_quartet_opt launch per call) against the JAX package's
ml_quartet_optimize, and against the chain of single store calls it
replaces.

The JAX engine builds an NJ tree with ME branch lengths (numpy seeds,
N=48, P=200); its checkpoint carries the tree to the port's engine, and
both build their ML store (Jukes-Cantor or GTR, four CAT rates) and
recompute its posteriors.  Tolerances against the JAX package (ROADMAP
Queue 3): the five lengths within 1e-4 + 2e-3 x length, because each line
search stops within its own tolerance (ftol 1e-3 relative) on each
package's float32 objective; the quartet log-likelihood (about -300 here)
within 5e-3, because the JAX package sums the per-site logs in float32 where
the port sums in float64: 2.5e-3 measured, and the JAX package's own value
of that quartet moves by 2.0e-3 between its float32 default and its x64
setting (which tests/conftest.py turns on); per-site log-likelihoods, each
package's at its own lengths (which differ by up to 2e-3 relative), within
5e-3 + 2e-3 x |value| (5.02e-3 measured at a site of -4.73).  The star test's decision must agree.  Against the chain and between
a two-quartet call and two one-quartet calls: equal, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models import TransitionMatrix
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import constants
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import (LEN_A, LEN_B, LEN_C,
                                                       LEN_D, LEN_I, N_SCRATCH,
                                                       S_AB, S_ABC, S_ABD,
                                                       S_ACD, S_BCD, S_CD)
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.options import Options as TOptions

GTR = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])
N_NODES = 14                      # internal nodes whose quartets are compared


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(tmp_path, model, jax=True):
    """(JAX engine or None, port engine) on the same NJ tree, each with an
    ML store under `model`, four CAT rates and recomputed posteriors."""
    opts = Options(n_codes=4, show_progress=False, n_bootstrap=0)
    opts.derive_settings()
    codes = seqs_to_codes(simulate_alignment(48, 200, seed=21,
                                             mutation=0.12, gap_frac=0.04),
                          opts)
    tm = None if model == "jc" else TransitionMatrix.gtr(*GTR)
    ttm = None if model == "jc" else TTransitionMatrix.gtr(*GTR)
    jnj = JNJ(opts, codes, None, tm)
    jnj.fast_nj()
    jrearrange.update_branch_lengths(jnj)
    path = str(tmp_path / f"nj_{model}.npz")
    save_checkpoint(jnj, path, {"phase": "nj"})
    tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, ttm)
    with np.load(path) as z:
        tnj.load_state({k: z[k] for k in z.files})
    engines = ((jnj, tm, JMLStore), (tnj, ttm, TMLStore)) if jax \
        else ((tnj, ttm, TMLStore),)
    rates = jml.ml_site_rates(4)
    cats = (np.arange(jnj.n_pos) * 7) % 4
    for nj, t, store in engines:
        nj.ml = store(nj, t)
        nj.ml.set_rates(rates, cats)
        nj.ml.recompute_ml_profiles()
    return (jnj if jax else None), tnj


def _internal_nodes(nj):
    tree = nj.tree
    return [n for n in range(nj.n_seqs, tree.maxnode)
            if tree.n_child[n] == 2 and n != tree.root][:N_NODES]


@pytest.mark.parametrize("mode", ["star_test", "site_lk"])
@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_quartet_optimize_matches_jax(tmp_path, model, mode):
    jnj, tnj = _engines(tmp_path, model)
    kw = {"star_test": True} if mode == "star_test" \
        else {"want_site_lk": True}
    stars = []
    for node in _internal_nodes(jnj):
        out = []
        for nj, rmod, mlmod in ((jnj, jrearrange, jml),
                                (tnj, trearrange, tml)):
            rows4, nodes4 = rmod.setup_abcd(nj, rmod.UpProfiles(nj), node,
                                            use_ml=True)
            lengths = np.array([nj.tree.branchlength[n]
                                for n in nodes4 + [node]])
            out.append((*mlmod.ml_quartet_optimize(nj, *rows4, lengths,
                                                   **kw), lengths))
        (jll, jstar, jsite, jlen), (tll, tstar, tsite, tlen) = out
        assert tstar == jstar, node
        assert abs(tll - jll) < 5e-3, node
        assert np.all(np.abs(tlen - jlen) <= 1e-4 + 2e-3 * jlen), node
        if mode == "site_lk":
            np.testing.assert_allclose(tsite, jsite, rtol=2e-3, atol=5e-3)
        else:
            assert tsite is None and jsite is None
        stars.append(tstar)
    if mode == "star_test":          # both outcomes of the star test seen
        assert any(stars) and not all(stars), stars


@pytest.mark.parametrize("want_site_lk", [False, True])
def test_two_quartet_call_equals_two_calls(tmp_path, want_site_lk):
    _, tnj = _engines(tmp_path, "gtr", jax=False)
    ups = trearrange.UpProfiles(tnj)
    quartets = []
    for node in _internal_nodes(tnj)[:2]:
        rows4, nodes4 = trearrange.setup_abcd(tnj, ups, node, use_ml=True)
        quartets.append((rows4, np.array([tnj.tree.branchlength[n]
                                          for n in nodes4 + [node]])))
    lens2 = [q[1].copy() for q in quartets]
    both = tnj.ml.quartet_optimize([q[0] for q in quartets], lens2,
                                   want_site_lk=want_site_lk)
    for (rows4, lengths), got, got_len in zip(quartets, both, lens2):
        one = lengths.copy()
        (ll, star, site), = tnj.ml.quartet_optimize([rows4], [one],
                                                    want_site_lk=want_site_lk)
        assert (ll, star) == got[:2]
        np.testing.assert_array_equal(one, got_len)
        if want_site_lk:
            np.testing.assert_array_equal(site, got[2])
        else:
            assert site is None and got[2] is None


def _chain_quartet_optimize(ml, rows4s, lengths_list, star_test=False,
                            want_site_lk=False):
    """The quartet optimization as the sequence of single store calls
    (posterior_into, opt_branch_length, pair_loglk on the scratch rows) that
    the port made before ml_quartet_opt fused them, one quartet after the
    other."""
    opts = ml.options
    out = []
    for (rA, rB, rC, rD), lengths in zip(rows4s, lengths_list):
        for k in range(5):
            if lengths[k] < opts.ml_min_branch_length:
                lengths[k] = opts.ml_min_branch_length
        s_ab, s_cd, s_bcd, s_acd, s_abd, s_abc = (
            ml.scratch_row(s) for s in (S_AB, S_CD, S_BCD, S_ACD, S_ABD,
                                        S_ABC))
        opt = ml.opt_branch_length
        ml.posterior_into(s_ab, rA, rB, lengths[LEN_A], lengths[LEN_B])
        ml.posterior_into(s_cd, rC, rD, lengths[LEN_C], lengths[LEN_D])
        lengths[LEN_I], negloglk = opt(s_ab, s_cd, lengths[LEN_I])
        if star_test:
            loglk_star = ml.pair_loglk(s_ab, s_cd, opts.ml_min_branch_length)
            if loglk_star < -negloglk - constants.CLOSE_LOGLK_LIMIT:
                off = ml.pair_loglk(rA, rB, lengths[LEN_A] + lengths[LEN_B]) \
                    + ml.pair_loglk(rC, rD, lengths[LEN_C] + lengths[LEN_D])
                out.append((-negloglk + off, True, None))
                continue
        ml.posterior_into(s_bcd, rB, s_cd, lengths[LEN_B], lengths[LEN_I])
        lengths[LEN_A], negloglk = opt(rA, s_bcd, lengths[LEN_A])
        ml.posterior_into(s_acd, rA, s_cd, lengths[LEN_A], lengths[LEN_I])
        lengths[LEN_B], negloglk = opt(rB, s_acd, lengths[LEN_B])
        ml.posterior_into(s_ab, rA, rB, lengths[LEN_A], lengths[LEN_B])
        ml.posterior_into(s_abd, s_ab, rD, lengths[LEN_I], lengths[LEN_D])
        lengths[LEN_C], negloglk = opt(rC, s_abd, lengths[LEN_C])
        ml.posterior_into(s_abc, s_ab, rC, lengths[LEN_I], lengths[LEN_C])
        lengths[LEN_D], negloglk = opt(rD, s_abc, lengths[LEN_D])
        assert not want_site_lk          # ML NNIs ask for no site values
        out.append((-negloglk
                    + ml.pair_loglk(s_ab, rC, lengths[LEN_I] + lengths[LEN_C])
                    + ml.pair_loglk(rA, rB, lengths[LEN_A] + lengths[LEN_B]),
                    False, None))
    return out


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_nni_round_matches_the_chain(tmp_path, model):
    """One ML-NNI round through quartet_optimize (AC and AD in one call)
    against the same round through the chain of single calls: the same
    NNIs, lengths and every non-scratch row of the store."""
    runs = []
    for fused in (True, False):
        _, nj = _engines(tmp_path, model, jax=False)
        if not fused:
            nj.ml.quartet_optimize = lambda *a, ml=nj.ml, **k: \
                _chain_quartet_optimize(ml, *a, **k)
        stats = trearrange.NNIStats.init(nj)
        changes = trearrange.do_nni(nj, 0, 10, True, stats)
        runs.append((nj, changes, nj.debug.n_lk_compute,
                     nj.debug.n_posterior_compute))
    (fnj, fchanges, *fcounts), (cnj, cchanges, *ccounts) = runs
    assert fchanges == cchanges and fchanges[0] > 0
    assert fcounts == ccounts
    for name in ("parent", "children", "n_child", "branchlength"):
        np.testing.assert_array_equal(getattr(fnj.tree, name),
                                      getattr(cnj.tree, name), err_msg=name)
    lo = fnj.ml.scratch_row(0)
    keep = np.r_[0:lo, lo + N_SCRATCH:fnj.ml.codes.shape[0]]
    for name in ("codes", "W", "V"):
        np.testing.assert_array_equal(getattr(fnj.ml, name).numpy()[keep],
                                      getattr(cnj.ml, name).numpy()[keep],
                                      err_msg=name)
