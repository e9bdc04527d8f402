"""One 20-code quartet optimization traced through the JAX package and the
port's plain chain, evaluation by evaluation (the 20-code counterpart of
tests/test_torch_ml_kernels.py::test_line_search_matches_jax_step_for_step).

The quartet (JTT, four CAT rates, P=120; the rows of a JAX NJ tree of
simulate_alignment(40, 120) at numpy seed 9, loaded into the port) goes
through the JAX package's ``ml_quartet_optimize``
(veryfasttree_tpu/engine/ml.py) and the port's (engine/ml.py, on the CPU
the chain of twins ``ops/ml_kernels.quartet_chain``).  Each records every
posterior it writes (the JAX store's ``posterior_into``, the port's
``ml_posterior_ref``) and every evaluation (x, f(x)) of its line searches:
the port's through ``onedimenmin_f32``; the JAX package's by the same
bracketing and Brent steps (``onedimenmin_f32`` is the JAX package's
``_onedimenmin_device`` step for step: the 4-code test above) over the JAX
package's own objective, each search checked to end where the package's
fused search ``opt_branch_length`` ends, so that the trace is the
package's.

What the trace shows (printed): the two part before the first evaluation.
The first posterior, S_AB, already differs: the JAX package rotates to
character space and back with float32 products summed in float32 in
XLA's order, the port in float64 rounded once (ops/kernels.py _rotate), so
the rotated vectors part by up to POSTERIOR_PART relative.  The first
evaluation then has the same x and an f(x) apart by the posteriors and by
the log sum, which the JAX package takes in float32, the port in float64:
fed the JAX package's own posterior rows, the port's objective still
parts from the package's by up to SUM_PART (the float32 sum alone).  Both
are the JAX package's float32 rounding, which a float32 computation in
another order (the card's, or the CPU twins') does not reproduce; the
searches then stop at lengths within their tolerances of each other, and
the criteria part by the sum of those.  ROADMAP.md Queue 3 item 2 records
this.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import ml_profiles as jmp
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models import DistanceMatrix, TransitionMatrix
from veryfasttree_tpu.ops import kernels as jk
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.models import DistanceMatrix as TDistanceMatrix
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.ops import ml_kernels as mk
from veryfasttree_tpu_torch.options import Options as TOptions

AA = "ARNDCQEGHILKMFPSTWYV"
# the first posterior's vectors part by up to this, relative to the
# vector's largest entry (read 5.9e-5: float32 against float64 rotations)
POSTERIOR_PART = 1e-4
# on the JAX package's own rows the first search's objective parts at its
# second evaluation by at most this many float32 ulps (read 2)
OBJECTIVE_ULPS = 4
# and its per-site likelihoods by at most this, relative (read 3.8e-6
# absolute at 36 of 120 positions)
SITE_PART = 1e-5


@functools.partial(jax.jit, static_argnames=("jc",))
def _jax_objective(codes, W, V, r1, r2, x, rates, ratecat, eigenval,
                   code_freq, pos_mask, min_rel_len, jc):
    """The JAX package's -loglk of the branch between rows r1 and r2 at x,
    as its fused search (ml_profiles._opt_branch_len_core) computes it."""
    f1 = jk.ml_effective(codes[r1], W[r1], V[r1], code_freq, False, jc)
    f2 = jk.ml_effective(codes[r2], W[r2], V[r2], code_freq, False, jc)
    return -jmp._loglk_of_len(f1, f2, W[r1], W[r2], x, rates, ratecat,
                              eigenval, pos_mask, min_rel_len, jc)


def _engines(tmp_path):
    """(JAX engine, port engine) on one JAX NJ tree of a protein alignment
    (BLOSUM45, ME lengths), each with a JTT ML store, four CAT rates and
    recomputed posteriors."""
    opts = Options(n_codes=20, show_progress=False, n_bootstrap=0)
    opts.derive_settings()
    codes = seqs_to_codes(simulate_alignment(40, 120, alphabet=AA, seed=9,
                                             gap_frac=0.04), opts)
    jnj = JNJ(opts, codes, DistanceMatrix.blosum45(), TransitionMatrix.jtt92())
    jnj.fast_nj()
    jrearrange.update_branch_lengths(jnj)
    path = str(tmp_path / "nj.npz")
    save_checkpoint(jnj, path, {"phase": "nj"})
    tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes,
              TDistanceMatrix.blosum45(), TTransitionMatrix.jtt92())
    with np.load(path) as z:
        tnj.load_state({k: z[k] for k in z.files})
    jnj.ml = JMLStore(jnj, jnj.transmat)
    tnj.ml = TMLStore(tnj, tnj.transmat)
    for nj in (jnj, tnj):
        nj.ml.set_rates(jml.ml_site_rates(4), np.arange(nj.n_pos) % 4)
        nj.ml.recompute_ml_profiles()
    return jnj, tnj


def _jax_trace(jnj, rows, lengths):
    """The JAX package's ml_quartet_optimize on rows with lengths, traced:
    (events, its result); events ("posterior", W, V) and ("search",
    [(x, f(x)), ...])."""
    ml, opts = jnj.ml, jnj.options
    events = []
    posterior_into, opt_branch_length = ml.posterior_into, \
        ml.opt_branch_length

    def posterior(target, r1, r2, len1, len2):
        posterior_into(target, r1, r2, len1, len2)
        events.append(("posterior", np.asarray(ml.W[target], np.float32),
                       np.asarray(ml.V[target], np.float32)))

    def search(r1, r2, guess):
        x, fx = opt_branch_length(r1, r2, guess)
        evals = []

        def neg(v):
            f = np.float32(_jax_objective(
                ml.codes, ml.W, ml.V, r1, r2, np.float32(v), ml.rates,
                ml.ratecat, ml.eigenval, ml.code_freq, ml.pos_mask,
                ml.min_rel_len, ml.jc))
            evals.append((np.float32(v), f))
            return f

        tx, tfx, _ = mk.onedimenmin_f32(
            neg, np.float32(guess), np.float32(opts.ml_min_branch_length),
            np.float32(6.0), np.float32(opts.ml_ftol_branch_length),
            np.float32(opts.ml_min_branch_length_tolerance))
        # the replay is the package's own search: the same end
        assert (np.float32(tx), np.float32(tfx)) == \
            (np.float32(x), np.float32(fx)), (tx, tfx, x, fx)
        rows = [tuple(np.array(a[r]) for a in (ml.codes, ml.W, ml.V))
                for r in (r1, r2)]
        events.append(("search", evals, rows, guess))
        return x, fx

    ml.posterior_into, ml.opt_branch_length = posterior, search
    try:
        out = jml.ml_quartet_optimize(jnj, *rows, lengths)
    finally:
        del ml.posterior_into, ml.opt_branch_length
    return events, out


def _port_trace(tnj, rows, lengths, monkeypatch):
    """The port's ml_quartet_optimize (on the CPU: quartet_chain of the
    twins) on rows with lengths, traced as _jax_trace."""
    ml = tnj.ml
    events = []
    posterior_ref, onedimenmin = mk.ml_posterior_ref, mk.onedimenmin_f32

    def posterior(codes, W, V, m, targets, *a, **k):
        posterior_ref(codes, W, V, m, targets, *a, **k)
        t = int(targets[0])
        events.append(("posterior", W[t].numpy().copy(), V[t].numpy().copy()))

    def search(neg, *a):
        evals = []

        def traced(v):
            f = neg(v)
            evals.append((np.float32(v), np.float32(f)))
            return f

        out = onedimenmin(traced, *a)
        events.append(("search", evals))
        return out

    monkeypatch.setattr(mk, "ml_posterior_ref", posterior)
    monkeypatch.setattr(mk, "onedimenmin_f32", search)
    out = tml.ml_quartet_optimize(tnj, *rows, lengths)
    monkeypatch.undo()
    assert ml.codes.device.type == "cpu"
    return events, out


def _port_search_on(tnj, rows, guess, monkeypatch):
    """The port's line search (ml_opt_branch_ref, the twin of ml_opt_branch)
    between two rows given as the JAX package's (codes, W, V) arrays, its
    evaluations recorded."""
    n_pos, opts = tnj.n_pos, tnj.options
    P = tnj.ml.W.shape[1]
    codes = tnj.ml.codes[:2].clone()
    W, V = tnj.ml.W[:2].clone(), tnj.ml.V[:2].clone()
    for k, (c, w, v) in enumerate(rows):
        codes[k, :n_pos] = torch.from_numpy(c[:n_pos])
        W[k, :n_pos] = torch.from_numpy(w[:n_pos])
        V[k, :n_pos] = torch.from_numpy(v[:n_pos])
    assert codes.shape[1] == P
    evals = []
    onedimenmin = mk.onedimenmin_f32

    def search(neg, *a):
        def traced(v):
            f = neg(v)
            evals.append((np.float32(v), np.float32(f)))
            return f
        return onedimenmin(traced, *a)

    monkeypatch.setattr(mk, "onedimenmin_f32", search)
    mk.ml_opt_branch_ref(codes, W, V, tnj.ml.model, [0], [1], [guess],
                         opts.ml_min_branch_length, 6.0,
                         opts.ml_ftol_branch_length,
                         opts.ml_min_branch_length_tolerance)
    monkeypatch.undo()
    return evals


def _first_parting(jax_events, port_events, n_pos):
    """The first posterior whose vectors differ (its index among the
    posteriors, its largest difference relative to the vector's largest
    entry) and the first evaluation whose x or f(x) differ (search index,
    evaluation index, |dx|, |df|, the JAX package's f); each None where
    none does.  The posteriors' weights are equal."""
    post = evaluation = None
    k_post = k_search = 0
    for (kind, *j), (kind_t, *t) in zip(jax_events, port_events):
        assert kind == kind_t
        if kind == "posterior":
            (wj, vj), (wt, vt) = j, t
            np.testing.assert_array_equal(wt[:n_pos], wj[:n_pos])
            rel = float(np.max(np.abs(vt[:n_pos] - vj[:n_pos])
                               / np.max(np.abs(vj[:n_pos]), axis=-1,
                                        keepdims=True)))
            if post is None and rel > 0:
                post = (k_post, rel)
            k_post += 1
        else:
            for k, ((xj, fj), (xt, ft)) in enumerate(zip(j[0], t[0])):
                if evaluation is None and (xj != xt or fj != ft):
                    evaluation = (k_search, k, float(abs(xt - xj)),
                                  float(abs(ft - fj)), float(fj))
            k_search += 1
    return post, evaluation


def test_quartet20_parts_at_the_first_posterior(tmp_path, monkeypatch):
    jnj, tnj = _engines(tmp_path)
    n = jnj.n_seqs
    # leaves 0 and 1 (code rows) against two internal nodes' posterior rows
    rows = (0, 1, n + 5, n + 11)
    start = np.array([0.12, 0.08, 0.15, 0.2, 0.05])
    jax_events, jax_out = _jax_trace(jnj, rows, jl := start.copy())
    port_events, port_out = _port_trace(tnj, rows, tl := start.copy(),
                                        monkeypatch)
    kinds = [e[0] for e in jax_events]
    assert kinds == [e[0] for e in port_events]
    assert kinds.count("posterior") == 7 and kinds.count("search") == 5
    post, evaluation = _first_parting(jax_events, port_events, jnj.n_pos)
    print(f"first posterior apart: {post}; first evaluation apart (search, "
          f"evaluation, |dx|, |df|, f): {evaluation}; quartet loglk "
          f"{port_out[0]} (JAX {jax_out[0]}), lengths {tl} (JAX {jl})")
    # the first posterior (S_AB) parts, within POSTERIOR_PART
    assert post is not None and post[0] == 0 and 0 < post[1] <= \
        POSTERIOR_PART
    # and so the first evaluation of the first search: the same x, its f
    # apart
    assert evaluation is not None and evaluation[:2] == (0, 0)
    assert evaluation[2] == 0.0 and evaluation[3] > 0
    # fed the JAX package's own rows, the port's searches still part from
    # the package's: the first at its second evaluation (the first is the
    # same), by a few float32 ulps of the objective
    partings = []
    for kind, *j in jax_events:
        if kind == "search":
            evals, rows, guess = j
            mine = _port_search_on(tnj, rows, guess, monkeypatch)
            k = next(k for k, (a, b) in enumerate(zip(evals, mine)) if a != b)
            (xj, fj), (xt, ft) = evals[k], mine[k]
            assert xj == xt
            partings.append((k, abs(float(ft) - float(fj))
                             / float(np.spacing(np.abs(fj)))))
    print(f"the port's searches on the JAX package's rows part at "
          f"(evaluation, float32 ulps of f): {partings}")
    assert partings[0][0] == 1 and 0 < partings[0][1] <= OBJECTIVE_ULPS
    # there, the per-site likelihoods (float32 exp and site sums in XLA's
    # order against the twins') and the sum of their logs (float32 in the
    # JAX package, float64 in the port) both part
    evals, rows, _ = next(j for kind, *j in jax_events if kind == "search")
    x1 = evals[1][0]
    ml, tml_ = jnj.ml, tnj.ml
    f = [jk.ml_effective(*(np.asarray(a) for a in row), ml.code_freq, False,
                         ml.jc) for row in rows]
    ee = jk.exp_eigen_rates(x1, ml.rates, ml.eigenval, ml.min_rel_len)
    ll_j, lk_j = jk.pair_loglk_matrix(f[0], f[1], rows[0][1], rows[1][1], ee,
                                      ml.ratecat, ml.pos_mask)
    n_pos = tnj.n_pos
    codes, W, V = (a[:2].clone() for a in (tml_.codes, tml_.W, tml_.V))
    for k, (c, w, v) in enumerate(rows):
        for ours, theirs in zip((codes, W, V), (c, w, v)):
            ours[k, :n_pos] = torch.from_numpy(theirs[:n_pos])
    ll_t, lk_t = mk.ml_pair_loglk_ref(codes, W, V, tml_.model, [0], [1],
                                      [float(x1)], True)
    site = np.abs(lk_t[0].numpy()[:n_pos] - np.asarray(lk_j)[:n_pos]) \
        / np.asarray(lk_j)[:n_pos]
    logs = np.log(np.maximum(np.asarray(lk_j)[:n_pos], 1e-37)).astype(
        np.float32)
    print(f"at x {x1}: per-site likelihoods apart at {int((site > 0).sum())} "
          f"of {n_pos} positions, by up to {site.max():.2e} relative; the "
          f"JAX package's loglk {float(ll_j)} (float32), the float64 sum of "
          f"its own per-site logs {float(np.sum(logs, dtype=np.float64))}, "
          f"the port's {float(ll_t[0])}")
    assert 0 < site.max() <= SITE_PART
    assert float(ll_j) != float(np.sum(logs, dtype=np.float64))
    # the quartets then part within the 20-code criteria limit
    # (chip_smoke.ML_CRITERIA_TOL_20), the star test alike
    assert abs(port_out[0] - jax_out[0]) <= 0.1
    assert port_out[1] == jax_out[1]
