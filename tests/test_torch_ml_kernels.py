"""The port's ML ops and the plain twins of its ML kernels against the JAX
package, on rows of a real ML store.

The inputs are the rows of a JAX ML store built on a small NJ tree (numpy
seeds): leaf rows (codes with gaps) and balanced-average internal rows
(stored vectors, fractional weights), for Jukes-Cantor, GTR and JTT (20
codes), with three CAT rate categories.  Tolerances:

* per-site values (effective vectors, rate tables, Jukes-Cantor
  posteriors): atol 1e-6 (float32 arithmetic; the libraries' exp differs
  in the last bits); weights and codes equal;
* matrix posterior vectors: rtol 1e-6 and atol 5e-6 (GTR), 5e-4 (JTT).
  The port rotates in float64 and rounds once; the JAX package's float32
  matrix products round each sum, and character-space probabilities near
  0 are sums of large signed terms (JTT's rotated entries reach 5), so
  its own error reaches 2.5e-6 (GTR) and 2.5e-4 (JTT) (measured);
* pair log-likelihoods: rtol 1e-5 (the port sums the float32 per-site logs
  in float64, the JAX package in float32); per-site likelihoods rtol 1e-5,
  atol 1e-6 (float32 sums of up to 20 signed terms, in another order);
* the line search (ml_opt_branch's twin) fed the same float32 objective as
  the JAX package's _onedimenmin_device: the same x and f(x) (rtol 1e-6);
* the twin on a store's rows against _opt_branch_len: f(x) within 1e-3,
  and the twin's objective at the JAX package's x within 1e-3 of its own
  optimum.  The two objectives differ by the float32 rounding of the JAX
  package's sum over positions (up to a few 1e-4), which moves Brent's
  last steps, so x agrees only to the line search's own tolerance
  (ftol 1e-3 relative): x within 1e-2 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import ml_profiles as jmp
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models import DistanceMatrix, TransitionMatrix
from veryfasttree_tpu import constants as jconst
from veryfasttree_tpu.ops import kernels as jk
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.ops import kernels as tk
from veryfasttree_tpu_torch.ops import ml_kernels as mk

MODELS = ["jc", "gtr", "jtt"]
LENGTHS = (5e-4, 0.02, 0.3, 2.5)


@functools.lru_cache(maxsize=None)
def _store(model):
    """A JAX ML store on a 12-taxon NJ tree (balanced-average internal rows)
    and the port's MLModel of it."""
    C = 20 if model == "jtt" else 4
    opts = Options(n_codes=C, show_progress=False, n_bootstrap=0)
    opts.derive_settings()
    alpha = "ARNDCQEGHILKMFPSTWYV" if C == 20 else "ACGT"
    codes = seqs_to_codes(simulate_alignment(12, 150, alphabet=alpha,
                                             seed=31, gap_frac=0.05), opts)
    tm = {"jc": None, "jtt": TransitionMatrix.jtt92(),
          "gtr": TransitionMatrix.gtr([1.2, 3.1, 0.8, 1.1, 2.9, 1.0],
                                      [0.3, 0.2, 0.24, 0.26])}[model]
    nj = JNJ(opts, codes, DistanceMatrix.blosum45() if C == 20 else None, tm)
    nj.fast_nj()
    jrearrange.update_branch_lengths(nj)
    ml = jmp.MLProfiles(nj, tm)
    ml.set_rates(jml.ml_site_rates(3), np.arange(nj.n_pos) % 3)
    m = mk.MLModel(
        ml.jc, *(torch.from_numpy(np.array(a)) for a in (
            ml.code_freq, ml.eigenval, ml.eigeninv, ml.statinv, ml.rates,
            ml.ratecat)), nj.n_pos, float(ml.min_rel_len), ml.tol)
    # leaf-leaf, leaf-internal, internal-internal (the root's children)
    tree = nj.tree
    internal = [n for n in range(nj.n_seqs, tree.maxnode)
                if tree.n_child[n] == 2]
    pairs = [(0, 5), (3, internal[0]), (internal[1], internal[-1])]
    return ml, m, pairs, opts


def _rows(ml, r):
    return (np.asarray(ml.codes[r]), np.asarray(ml.W[r]), np.asarray(ml.V[r]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol)


@pytest.mark.parametrize("model", MODELS)
def test_ml_ops_match_jax(model):
    ml, m, pairs, _ = _store(model)
    jc = ml.jc
    cf = np.asarray(ml.code_freq)
    rates, ratecat = np.asarray(ml.rates), np.asarray(ml.ratecat)
    mask = np.asarray(ml.pos_mask)
    C = cf.shape[1]
    for length in LENGTHS:
        ln = np.float32(length)
        if jc:
            ours = tk.p_same_diff(float(ln), _t(rates))
            for a, b in zip(ours, jk.p_same_diff(ln, jnp.asarray(rates))):
                _close(a, b, rtol=1e-6)
        else:
            _close(tk.exp_eigen_rates(float(ln), _t(rates), _t(ml.eigenval),
                                      float(ml.min_rel_len)),
                   jk.exp_eigen_rates(ln, ml.rates, ml.eigenval,
                                      ml.min_rel_len), rtol=1e-6)
    for r1, r2 in pairs:
        (c1, w1, v1), (c2, w2, v2) = _rows(ml, r1), _rows(ml, r2)
        assert ((w1 > 0) & (w1 < 1)).any() or r1 < 12
        eff = {}
        for post in (False, True):
            for k, (c, w, v) in enumerate(((c1, w1, v1), (c2, w2, v2))):
                ours = tk.ml_effective(_t(c), _t(w), _t(v), _t(cf), post, jc)
                _close(ours, jk.ml_effective(c, w, v, cf, post, jc), rtol=0,
                       atol=1e-6)
                eff[post, k] = ours
        for length in LENGTHS:
            ln = np.float32(length)
            if jc:
                ps, pd = tk.p_same_diff(float(ln), _t(rates))
                ll, lk = tk.pair_loglk_jc(eff[False, 0], eff[False, 1], ps,
                                          pd, _t(ratecat).long(), _t(mask))
                jps, jpd = jk.p_same_diff(ln, jnp.asarray(rates))
                jll, jlk = jk.pair_loglk_jc(
                    np.asarray(eff[False, 0]), np.asarray(eff[False, 1]),
                    jps, jpd, ratecat, mask)
            else:
                ee = tk.exp_eigen_rates(float(ln), _t(rates), _t(ml.eigenval),
                                        float(ml.min_rel_len))
                ll, lk = tk.pair_loglk_matrix(
                    eff[False, 0], eff[False, 1], _t(w1), _t(w2), ee,
                    _t(ratecat).long(), _t(mask))
                jll, jlk = jk.pair_loglk_matrix(
                    np.asarray(eff[False, 0]), np.asarray(eff[False, 1]), w1,
                    w2, np.asarray(ee), ratecat, mask)
            _close(ll, jll, rtol=1e-5)
            _close(lk, jlk, rtol=1e-5, atol=1e-6)

            l2 = np.float32(0.1)
            f1, f2 = eff[True, 0], eff[True, 1]
            if jc:
                ours = tk.posterior_jc(f1, f2, _t(w1), _t(w2),
                                       *tk.p_same_diff(float(ln), _t(rates)),
                                       *tk.p_same_diff(float(l2), _t(rates)),
                                       _t(ratecat).long())
                ref = jk.posterior_jc(
                    np.asarray(f1), np.asarray(f2), w1, w2,
                    *jk.p_same_diff(ln, jnp.asarray(rates)),
                    *jk.p_same_diff(l2, jnp.asarray(rates)), ratecat)
            else:
                ee = [tk.exp_eigen_rates(float(x), _t(rates), _t(ml.eigenval),
                                         float(ml.min_rel_len))
                      for x in (ln, l2)]
                ours = tk.posterior_matrix(
                    f1, f2, _t(w1), _t(w2), *ee, _t(ratecat).long(),
                    _t(cf[:C]), _t(ml.eigeninv), _t(ml.statinv), ml.tol)
                ref = jk.posterior_matrix(
                    np.asarray(f1), np.asarray(f2), w1, w2,
                    *(np.asarray(e) for e in ee), ratecat, cf[:C],
                    np.asarray(ml.eigeninv), np.asarray(ml.statinv), ml.tol)
                if C == 20:
                    # the -approxml gate on the same rows: the same rough
                    # and exact counts
                    near = tuple(np.asarray(a, dtype=np.float32) for a in (
                        ml.transmat.near_p, ml.transmat.near_freq))
                    limits = (jconst.APPROX_ML_MIN_F,
                              jconst.APPROX_ML_MIN_RATIO)
                    gated = tk.posterior_matrix(
                        f1, f2, _t(w1), _t(w2), *ee, _t(ratecat).long(),
                        _t(cf[:C]), _t(ml.eigeninv), _t(ml.statinv), ml.tol,
                        (*map(_t, near), *limits))
                    jgated = jk.posterior_matrix(
                        np.asarray(f1), np.asarray(f2), w1, w2,
                        *(np.asarray(e) for e in ee), ratecat, cf[:C],
                        np.asarray(ml.eigeninv), np.asarray(ml.statinv),
                        ml.tol, (*near, *limits))
                    assert [int(x) for x in gated[2:]] == \
                        [int(x) for x in jgated[2:]]
                    _close(gated[1], jgated[1], rtol=1e-6, atol=5e-4)
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
            _close(ours[1], ref[1], rtol=1e-6,
                   atol=5e-4 if C == 20 else 5e-6 if not jc else 1e-6)
            if not jc:
                # at 20 codes the exact path counts every position that is
                # not both gaps as exact, at 4 codes nothing
                assert [int(x) for x in ours[2:]] == [int(x) for x in ref[2:]]


@pytest.mark.parametrize("x0,guess", [
    (0.13, 0.1), (0.002, 5e-4), (0.0009, 9e-4), (4.0, 1.0), (7.0, 3.0),
    (0.3, 6.0), (0.01, 0.3), (0.2, 0.01)])
def test_line_search_matches_jax_step_for_step(x0, guess):
    """onedimenmin_f32 and _onedimenmin_device on the same float32
    objective (a host function, called back from the compiled search): the
    same x and f(x)."""
    def f(x):
        x = np.float32(x)
        return np.float32((x - x0) * (x - x0) * np.float32(50.0)
                          + np.float32(0.01) / x)

    def neg(x):
        return jax.pure_callback(lambda v: np.asarray(f(v), np.float32),
                                 jax.ShapeDtypeStruct((), jnp.float32), x)

    x0 = np.float32(x0)
    args = (np.float32(guess), np.float32(5e-4), np.float32(6.0),
            np.float32(1e-3), np.float32(1e-4))
    jx, jfx = jax.jit(lambda *a: jmp._onedimenmin_device(neg, *a))(*args)
    x, fx, n_eval = mk.onedimenmin_f32(f, *args)
    _close(x, jx, rtol=1e-6)
    _close(fx, jfx, rtol=1e-6)
    assert n_eval > 3


@pytest.mark.parametrize("model", MODELS)
def test_opt_branch_twin_matches_jax(model):
    ml, m, pairs, opts = _store(model)
    store = [_t(a) for a in (ml.codes, ml.W, ml.V)] + [m]
    lims = (opts.ml_min_branch_length, 6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance)
    before = mk.ml_opt_branch.launches
    for r1, r2 in pairs:
        for guess in (opts.ml_min_branch_length, 0.05, 0.4):
            jx, jfx = jmp._opt_branch_len(
                ml.codes, ml.W, ml.V, r1, r2, np.float32(guess),
                *(np.float32(v) for v in lims), ml.rates, ml.ratecat,
                ml.eigenval, ml.code_freq, ml.pos_mask, ml.min_rel_len, ml.jc)
            x, fx, n_eval = mk.ml_opt_branch(*store, [r1], [r2], [guess],
                                             *lims)
            at_jax = -mk.ml_pair_loglk(*store, [r1], [r2], [float(jx)])[0]
            assert abs(float(fx[0]) - float(jfx)) <= 1e-3
            assert float(at_jax[0]) - float(fx[0]) <= 1e-3
            _close(x[0], jx, rtol=1e-2)
            assert int(n_eval[0]) > 3
    assert mk.ml_opt_branch.launches == before      # CPU tensors: the twin
