"""The port's MEProfiles against the JAX package's, dense and two-tier, and an
engine carried across from a JAX checkpoint.

Both stores start from the same leaf codes (numpy seeds) and take the same
calls.  Tolerances: distances over the initial store come back in float64,
summed in different orders, so rtol 1e-12 (atol 1e-12 near zero); top-k
indices are equal; codes are equal.  Rows written by profile averages and
out-profile updates are float32 and may differ in the last bit where the
reference's compiler fuses an expression differently (rtol 1e-6; 1e-5 in
BLOSUM45 matrix mode, whose totals are float32 dot products summed in
another order), and distances from written rows are held to the same.
"""
import dataclasses

import numpy as np
import pytest
import torch

from util import simulate_alignment

from veryfasttree_tpu.engine import batched as jbatched
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.engine.profiles import MEProfiles as JStore
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models.distance_matrix import DistanceMatrix
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import batched as tbatched
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.engine.profiles import MEProfiles as TStore
from veryfasttree_tpu_torch.models import DistanceMatrix as TDistanceMatrix
from veryfasttree_tpu_torch.options import Options as TOptions

F64 = dict(rtol=1e-12, atol=1e-12)


def _codes(n_codes, n=30, p=150, seed=5):
    opts = Options(n_codes=n_codes, show_progress=False, ml_nni=0,
                   n_bootstrap=0)
    opts.derive_settings()
    alpha = "ACGT" if n_codes == 4 else "ARNDCQEGHILKMFPSTWYV"
    seqs = simulate_alignment(n, p, alphabet=alpha, seed=seed, gap_frac=0.05)
    return opts, seqs_to_codes(seqs, opts)


def _port(opts):
    """The port's own Options, with the same field values."""
    return TOptions(**dataclasses.asdict(opts))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol)


def _same_store(t, j, tol):
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    _close(t.W.numpy(), j.W, **tol)
    _close(t.U.numpy(), j.U, **tol)
    _close(t.w_out.numpy(), j.w_out, **tol)
    _close(t.f_out.numpy(), j.f_out, **tol)


@pytest.mark.parametrize("two_tier", [False, True])
@pytest.mark.parametrize("n_codes", [4, 20])
def test_store_methods_match_jax(n_codes, two_tier):
    opts, codes = _codes(n_codes)
    dmat = DistanceMatrix.blosum45() if n_codes == 20 else None
    n = len(codes)
    tdmat = TDistanceMatrix.blosum45() if n_codes == 20 else None
    js = JStore(codes, opts, dmat, 2 * n, two_tier=two_tier)
    ts = TStore(codes, _port(opts), tdmat, 2 * n, two_tier=two_tier)
    assert (ts.n_rows, ts.p_pad, tuple(ts.U.shape)) == \
        (js.n_rows, js.p_pad, tuple(js.U.shape))
    tol = dict(rtol=1e-6 if n_codes == 4 else 1e-5, atol=1e-7)
    derived = dict(rtol=tol["rtol"], atol=1e-9)
    leaves = np.zeros(2 * n, dtype=bool)
    leaves[:n] = True
    for s in (js, ts):
        s.recompute_outprofile(leaves)
    _same_store(ts, js, tol)

    rows = np.array([0, 5, 9, 17])
    for a, b in zip(ts.dist_many_vs_leaves(rows), js.dist_many_vs_leaves(rows)):
        _close(a, b, **F64)
    od = np.random.default_rng(0).uniform(0, 1, n)
    od[[3, 4]] = od[2]                    # ties in the top-k order
    (ti, td, tw), (ji, jd, jw) = (s.dist_leaves_topk(rows, od, 8)
                                  for s in (ts, js))
    np.testing.assert_array_equal(ti, ji)
    _close(td, jd, **F64)
    _close(tw, jw, **F64)

    # joins, a weighted average, out-profile upkeep
    for s in (js, ts):
        s.join(0, 1, n, -1.0)
        s.set_from_average(n + 1, 2, n, 0.3)
        s.update_outprofile(0, 1, n, n)
    _close(ts.join(3, n + 1, n + 2, -1.0), js.join(3, n + 1, n + 2, -1.0),
           **derived)
    _same_store(ts, js, tol)

    # every distance query, from a leaf and from an internal row
    js_set = np.array([0, 4, n, n + 1, n + 2, 7])
    for q in (3, n + 1):
        for a, b in zip(ts.dist_one_vs_all(q), js.dist_one_vs_all(q)):
            _close(a, b, **derived)
        for a, b in zip(ts.dist_one_vs_set(q, js_set),
                        js.dist_one_vs_set(q, js_set)):
            _close(a, b, **derived)
        for a, b in zip(ts.row_query(q), js.row_query(q)):
            _close(a.numpy(), b, **tol)
    iis, jjs = np.array([0, n, 5, n + 2]), np.array([n + 1, 3, 9, 8])
    for a, b in zip(ts.dist_pairs(iis, jjs), js.dist_pairs(iis, jjs)):
        _close(a, b, **derived)
    for a, b in zip(ts.refresh_and_pairs(js_set, iis, jjs),
                    js.refresh_and_pairs(js_set, iis, jjs)):
        _close(a, b, **derived)
    for a, b in zip(ts.dist_set_vs_out(js_set), js.dist_set_vs_out(js_set)):
        _close(a, b, **derived)
    for a, b in zip(ts.out_query(), js.out_query()):
        _close(a.numpy(), b, **tol)

    # a two-level balanced sweep (level 2 reads what level 1 wrote), then a
    # full out-profile recompute over the active rows
    levels = [([n + 3, n + 4], [4, 6], [5, 7]), ([n + 5], [n + 3], [n + 4])]
    active = leaves.copy()
    active[[0, 1, 2, 3, 4, 5, 6, 7]] = False
    active[[n + 2, n + 5]] = True
    for s in (js, ts):
        s.average_sweep(levels)
        s.recompute_outprofile(active)
    _same_store(ts, js, tol)
    for a, b in zip(ts.dist_one_vs_all(n + 5), js.dist_one_vs_all(n + 5)):
        _close(a, b, **derived)


def test_carry_across_from_jax_checkpoint(tmp_path):
    """JAX fast_nj -> save_checkpoint -> the port's load_state; then one ME
    NNI round and the batched ME branch lengths on both engines."""
    opts, codes = _codes(4, n=40, p=200, seed=9)
    jnj = JNJ(opts, codes, None, None)
    jnj.fast_nj()
    path = str(tmp_path / "nj.npz")
    save_checkpoint(jnj, path, {"phase": "nj"})
    tnj = TNJ(_port(opts), codes, None, None)
    with np.load(path) as z:
        tnj.load_state({k: z[k] for k in z.files})
    _same_store(tnj.prof, jnj.prof, dict(rtol=0, atol=0))

    for nj, rmod in ((jnj, jrearrange), (tnj, trearrange)):
        rmod.do_nni(nj, 0, 1, False, rmod.NNIStats.init(nj))
    tbatched.update_branch_lengths_batched(tnj)
    jbatched.update_branch_lengths_batched(jnj)

    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name))
    assert (tnj.tree.maxnode, tnj.tree.root) == (jnj.tree.maxnode,
                                                 jnj.tree.root)
    _close(tnj.tree.branchlength, jnj.tree.branchlength, rtol=1e-9,
           atol=1e-12)
    assert tnj.debug.n_nni == jnj.debug.n_nni
    _same_store(tnj.prof, jnj.prof, dict(rtol=1e-6, atol=1e-7))
    assert isinstance(tnj.prof.U, torch.Tensor)
