"""The port's ML store against the JAX package's, on one tree.

The JAX engine builds an NJ tree with ME branch lengths (numpy seeds); its
checkpoint carries the tree and the ME store to the port's engine
(load_state).  Then, for Jukes-Cantor and GTR:

* the port's ML store built from scratch equals the JAX store (codes and
  weights equal; vectors rtol 1e-6, atol 1e-7: balanced averages in float32,
  whose matrix-mode totals are dot products summed in another order);
* MLProfiles.load_state carries the JAX store's arrays over exactly;
* after the same CAT rates, recompute_ml_profiles: codes and weights equal,
  vectors rtol 1e-6, atol 1e-4 (float32 posteriors: the libraries' exp and
  matrix products differ in the last bits, and each tree level's
  posteriors read the level below, so the differences grow up the tree,
  most where a character-space probability near 0 is a sum of signed
  rotated terms);
* tree_loglk: within 1e-3 (the port sums float32 per-site logs in float64,
  the JAX package in float32), per-site log-likelihoods (sums over the
  tree's pairs, down to -20) rtol 1e-5, atol 1e-4;
* a quartet's ml_quartet_optimize: log-likelihood within 1e-3 and the five
  lengths within 1e-2 relative (Brent's last steps follow each package's
  own float32 objective; the line search's tolerance is 1e-3 relative);
  per-site log-likelihoods, each package's at its own lengths, atol 5e-3.
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
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.options import Options as TOptions

GTR = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])


def _engines(tmp_path, tm, ttm):
    opts = Options(n_codes=4, show_progress=False, n_bootstrap=0)
    opts.derive_settings()
    codes = seqs_to_codes(simulate_alignment(20, 180, seed=13,
                                             gap_frac=0.05), opts)
    jnj = JNJ(opts, codes, None, tm)
    jnj.fast_nj()
    jrearrange.update_branch_lengths(jnj)
    path = str(tmp_path / "nj.npz")
    save_checkpoint(jnj, path, {"phase": "nj"})
    tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, ttm)
    with np.load(path) as z:
        tnj.load_state({k: z[k] for k in z.files})
    return jnj, tnj


def _same(t, j, rtol, atol):
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.W.numpy(), np.asarray(j.W))
    np.testing.assert_allclose(t.V.numpy(), np.asarray(j.V), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_ml_store_matches_jax(tmp_path, model):
    tm = None if model == "jc" else TransitionMatrix.gtr(*GTR)
    ttm = None if model == "jc" else TTransitionMatrix.gtr(*GTR)
    jnj, tnj = _engines(tmp_path, tm, ttm)
    jnj.ml = JMLStore(jnj, tm)
    tnj.ml = TMLStore(tnj, ttm)
    _same(tnj.ml, jnj.ml, 1e-6, 1e-7)

    j_arrays = [np.asarray(a) for a in (jnj.ml.codes, jnj.ml.W, jnj.ml.V)]
    tnj.ml.load_state(*j_arrays, jnj.ml.rates_np, jnj.ml.ratecat_np)
    _same(tnj.ml, jnj.ml, 0, 0)

    rates = jml.ml_site_rates(4)
    cats = (np.arange(jnj.n_pos) * 7) % 4
    for nj in (jnj, tnj):
        nj.ml.set_rates(rates, cats)
        nj.ml.recompute_ml_profiles()
    _same(tnj.ml, jnj.ml, 1e-6, 1e-4)

    assert abs(tml.tree_loglk(tnj) - jml.tree_loglk(jnj)) < 1e-3
    (tll, tsite), (jll, jsite) = (tml.tree_loglk(tnj, want_site_loglk=True),
                                  jml.tree_loglk(jnj, want_site_loglk=True))
    assert abs(tll - jll) < 1e-3
    np.testing.assert_allclose(tsite, jsite, rtol=1e-5, atol=1e-4)

    # a quartet around an internal node whose parent is not the root
    tree = jnj.tree
    node = next(n for n in range(jnj.n_seqs, tree.maxnode)
                if tree.n_child[n] == 2 and tree.parent[n] != tree.root)
    out = []
    for nj, rmod, mlmod in ((jnj, jrearrange, jml), (tnj, trearrange, tml)):
        rows4, nodes4 = rmod.setup_abcd(nj, rmod.UpProfiles(nj), node,
                                        use_ml=True)
        lengths = np.array([tree.branchlength[n] for n in nodes4 + [node]])
        ll, star, site = mlmod.ml_quartet_optimize(nj, *rows4, lengths,
                                                   want_site_lk=True)
        out.append((ll, lengths, site))
    (tll, tlen, tsite), (jll, jlen, jsite) = out[1], out[0]
    assert abs(tll - jll) < 1e-3
    np.testing.assert_allclose(tlen, jlen, rtol=1e-2)
    np.testing.assert_allclose(tsite, jsite, rtol=0, atol=5e-3)
    assert isinstance(tnj.ml.V, torch.Tensor)
