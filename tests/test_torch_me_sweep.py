"""The ME split test and the ME branch lengths as whole-tree passes
(engine/supports.test_splits_min_evo_batched, engine/batched: one sweep of
the up-profiles, one pair-distance list, one fetch; on the card the
kernels me_average_sweep and me_dists_list, here, on the CPU, their plain
twins).

* Against the JAX package's serial test_splits_min_evo on the same tree
  and store (the port's NJ tree and store, N=60, P=160, loaded into a JAX
  engine of the same alignment and options through the JAX package's
  checkpoint format), %different mode (4 codes) and matrix mode (20
  codes, BLOSUM45), dense and two-tier, with and without -pseudo:
  n_splits and n_bad_splits equal, the worst delta within 1e-9 (the ME
  NNI deltas' tolerance: the JAX package's XLA distances sum in another
  order); in matrix mode within 1e-6 relative, as the port's serial walk
  (measured 3.8e-9 for both): the two packages' matrix-mode averages round
  their float32 position totals in other orders
  (tests/test_torch_store.py), and the up-profiles carry that.  With
  -bionj, the serial walk that the pipeline takes there, within 1e-9.
* Against the port's own serial walk (test_splits_min_evo through the
  per-call twins) on the port's NJ tree (N=60, P=160): every up-profile row
  the serial walk wrote and the debug counters bit for bit, and the
  SplitCount bit for bit in %different mode; the batched ME lengths
  against rearrange.update_branch_lengths: every branch length bit for bit
  there.  In matrix mode the twins' distances are a three-way
  torch.einsum whose order on the CPU depends on the batch (the card's
  list kernel keeps each pair's thread map, so there the bits are equal:
  chip_smoke.py phase 2h), so the counts are equal and the worst delta and
  the lengths within 1e-11 relative (measured 1.6e-15 and 8.3e-12).
* The sweep's twin against the per-level twin (me_average_ref, one call
  per level): every row bit for bit, on the NJ tree's up-profiles (dense
  %different, two-tier matrix mode) and on a caterpillar of 300 leaves
  (297 levels).
* The pipeline (N=24): -noml takes the batched split test, -bionj the
  serial walk.

About 17 s in one process.
"""
import dataclasses
import functools
import io
import types

import numpy as np
import pytest
import torch

from chip_smoke import engine_copy, shaped_tree
from test_torch_slice import one_torch_thread  # noqa: F401
from util import simulate_alignment, write_fasta

from veryfasttree_tpu.engine import supports as jsupports
from veryfasttree_tpu.engine.checkpoint import load_checkpoint, \
    save_checkpoint
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models.distance_matrix import DistanceMatrix
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as torch_pipeline
from veryfasttree_tpu_torch.engine import batched as tbatched
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine import supports as tsupports
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.models import DistanceMatrix as TDistanceMatrix
from veryfasttree_tpu_torch.ops import store_kernels as st
from veryfasttree_tpu_torch.options import Options as TOptions

CPU = torch.device("cpu")
DELTA_ATOL = 1e-9
MATRIX_RTOL = 1e-6              # against the JAX package, matrix mode
TWIN_RTOL = 1e-11               # batched against serial twins, matrix mode
PROTEIN = "ARNDCQEGHILKMFPSTWYV"
# (codes, two-tier, -pseudo weight)
CASES = [(4, False, 0.0), (4, True, 0.5), (20, False, 0.5), (20, True, 0.0)]
IDS = ["nt-dense", "nt-two-tier-pseudo", "protein-dense-pseudo",
       "protein-two-tier"]


def _options(n_codes, two_tier, pseudo, **kw):
    opts = Options(n_codes=n_codes, show_progress=False, ml_nni=0,
                   n_bootstrap=0, pseudo_weight=pseudo,
                   two_tier_min=0 if two_tier else 20000, **kw)
    opts.derive_settings()
    return opts


def _codes(opts, n, p, seed):
    alpha = "ACGT" if opts.n_codes == 4 else PROTEIN
    return seqs_to_codes(simulate_alignment(n, p, alphabet=alpha, seed=seed,
                                            mutation=0.3, gap_frac=0.05),
                         opts)


N, P, SEED = 60, 160, 3


@functools.lru_cache(maxsize=None)
def _port_engine(n_codes, two_tier, pseudo, bionj=False):
    """The port's engine on the CPU after its NJ phase (one per case; the
    tests run on copies of it)."""
    opts = TOptions(**dataclasses.asdict(_options(n_codes, two_tier, pseudo,
                                                  bionj=bionj)))
    dmat = TDistanceMatrix.blosum45() if n_codes == 20 else None
    nj = TNJ(opts, _codes(opts, N, P, SEED), dmat, None, device=CPU)
    nj.fast_nj()
    return nj


def _jax_engine(tnj, opts, path):
    """A JAX engine of the port engine's alignment and options holding its
    tree and store, written in the JAX package's checkpoint format and
    loaded from it."""
    state = {k: getattr(tnj, k) for k in (
        "tree", "diameter", "var_diameter", "selfdist", "selfweight",
        "out_distances", "n_out_dist_active", "totdiam")}
    prof = types.SimpleNamespace(**{k: getattr(tnj.prof, k).numpy()
                                    for k in ("codes", "W", "U", "w_out",
                                              "f_out")})
    save_checkpoint(types.SimpleNamespace(**state, n_cons=0, prof=prof),
                    path, {"phase": "nj"})
    jnj = JNJ(opts, _codes(opts, N, P, SEED), DistanceMatrix.blosum45()
              if opts.n_codes == 20 else None, None)
    load_checkpoint(jnj, path)
    return jnj


def _rows(nj):
    prof = nj.prof
    return {k: getattr(prof, k).numpy().copy() for k in ("codes", "W", "U")}


@pytest.mark.parametrize("n_codes,two_tier,pseudo,bionj",
                         [c + (False,) for c in CASES] + [(4, False, 0.0,
                                                          True)],
                         ids=IDS + ["nt-bionj-serial"])
def test_split_test_matches_jax_serial(tmp_path, n_codes, two_tier, pseudo,
                                       bionj):
    start = _port_engine(n_codes, two_tier, pseudo, bionj)
    assert start.prof.two_tier == two_tier
    tnj = engine_copy(start, CPU)
    jnj = _jax_engine(start, _options(n_codes, two_tier, pseudo,
                                      bionj=bionj), str(tmp_path / "nj.npz"))
    assert jnj.prof.two_tier == two_tier

    want = jsupports.test_splits_min_evo(jnj)
    # what the pipeline takes (test_pipeline_picks_the_split_test)
    got = (tsupports.test_splits_min_evo if bionj
           else tsupports.test_splits_min_evo_batched)(tnj)
    assert (got.n_splits, got.n_bad_splits) == (want.n_splits,
                                                want.n_bad_splits)
    assert got.n_splits == N - 3 and got.n_bad_splits > 0
    want_delta = float(want.d_worst_delta_unconstrained)
    tol = MATRIX_RTOL * want_delta if n_codes == 20 else DELTA_ATOL
    assert abs(got.d_worst_delta_unconstrained - want_delta) <= tol


@pytest.mark.parametrize("n_codes,two_tier,pseudo", CASES, ids=IDS)
def test_batched_split_test_is_the_serial_walk(n_codes, two_tier, pseudo):
    start = _port_engine(n_codes, two_tier, pseudo)
    serial, batch = engine_copy(start, CPU), engine_copy(start, CPU)
    want = tsupports.test_splits_min_evo(serial)
    got = tsupports.test_splits_min_evo_batched(batch)
    # every row the serial walk wrote (its up-profiles), bit for bit
    before, a, b = _rows(start), _rows(serial), _rows(batch)
    lo = start.prof._leaf_rows
    written = np.flatnonzero(
        (a["codes"] != before["codes"]).any(1)
        | np.pad((a["W"] != before["W"]).any(1), (lo, 0))[:len(a["codes"])])
    assert len(written) > 10
    np.testing.assert_array_equal(b["codes"][written], a["codes"][written])
    for k in ("W", "U"):
        np.testing.assert_array_equal(b[k][written - lo], a[k][written - lo])
    assert dataclasses.asdict(batch.debug) == dataclasses.asdict(serial.debug)
    assert got.n_bad_splits > 0
    if n_codes == 4:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    else:
        assert (got.n_splits, got.n_bad_splits) == (want.n_splits,
                                                    want.n_bad_splits)
        assert got.d_worst_delta_unconstrained == pytest.approx(
            want.d_worst_delta_unconstrained, rel=TWIN_RTOL, abs=0)


@pytest.mark.parametrize("n_codes,two_tier,pseudo", CASES, ids=IDS)
def test_batched_lengths_are_the_serial_walk(n_codes, two_tier, pseudo):
    start = _port_engine(n_codes, two_tier, pseudo)
    serial, batch = engine_copy(start, CPU), engine_copy(start, CPU)
    trearrange.update_branch_lengths(serial)
    tables = tbatched.update_branch_lengths_batched(batch)
    m = start.tree.maxnode
    got, want = batch.tree.branchlength[:m], serial.tree.branchlength[:m]
    if n_codes == 4:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TWIN_RTOL, atol=1e-15)
    assert batch.debug.profile_ops == serial.debug.profile_ops
    # the split test on the lengths pass's sweep tables, as the pipeline
    # runs it, is the split test that builds its own
    assert dataclasses.astuple(tsupports.test_splits_min_evo_batched(
        batch, tables)) == dataclasses.astuple(
        tsupports.test_splits_min_evo_batched(engine_copy(start, CPU)))


def _caterpillar(n=300, p=64):
    """An engine of n leaves whose tree is a caterpillar, its node profiles
    averaged bottom-up."""
    opts = TOptions(n_codes=4, show_progress=False, ml_nni=0, n_bootstrap=0)
    opts.derive_settings()
    nj = TNJ(opts, _codes(opts, n, p, 5), None, None, device=CPU)
    shaped_tree(nj, "caterpillar")
    trearrange.recompute_profiles_levelwise(nj)
    return nj


@pytest.mark.parametrize("shape", ["nj", "nj-protein-two-tier",
                                   "caterpillar"])
def test_sweep_twin_is_the_per_level_twin(shape):
    if shape == "caterpillar":
        start = _caterpillar()
    else:
        start = _port_engine(*((20, True, 0.0) if "protein" in shape
                               else (4, False, 0.0)))
    levels = tbatched.up_profile_levels(start)
    if shape == "caterpillar":
        assert len(levels) == 297
    tables = st.AverageTables.from_levels(levels)
    assert tables.n_levels == len(levels)
    sweep, per_level = engine_copy(start, CPU), engine_copy(start, CPU)
    p = sweep.prof
    st.me_average_sweep_ref(p.codes, p.W, p.U, p.code_freq, p._et,
                            p._leaf_rows, tables, p.tol)
    p = per_level.prof
    for t, i, j in levels:
        st.me_average_ref(p.codes, p.W, p.U, p.code_freq, p._et,
                          p._leaf_rows, t, i, j, 0.5, p.tol)
    a, b = _rows(sweep), _rows(per_level)
    assert not np.array_equal(a["U"], _rows(start)["U"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_average_tables():
    tables = st.AverageTables.from_levels([
        ([10, 11], [0, 1], [2, 3]), ([], [], []), ([12, 13], [10, 4],
                                                   [5, 11])])
    np.testing.assert_array_equal(tables.offsets, [0, 2, 4])
    np.testing.assert_array_equal(tables.prod_i, [-1, -1, 0, -1])
    np.testing.assert_array_equal(tables.prod_j, [-1, -1, -1, 1])
    np.testing.assert_array_equal(tables.kernel_arrays()["rows"], [
        10, 11, 12, 13, 0, 1, 10, 4, 2, 3, 5, 11, -1, -1, 0, -1, -1, -1, -1,
        1])
    with pytest.raises(ValueError, match="distinct"):
        st.AverageTables.from_levels([([10], [0], [1]), ([10], [2], [3])])
    with pytest.raises(ValueError, match="later level"):
        st.AverageTables.from_levels([([10], [11], [1]), ([11], [2], [3])])
    with pytest.raises(ValueError, match="later level"):
        st.AverageTables.from_levels([([10, 11], [0, 10], [1, 2])])


def test_pipeline_picks_the_split_test(tmp_path, monkeypatch):
    """-noml takes the batched split test, -bionj the serial walk."""
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(24, 120, seed=11))
    calls = []
    for name in ("test_splits_min_evo", "test_splits_min_evo_batched"):
        fn = getattr(tsupports, name)

        def traced(nj, *args, fn=fn, name=name):
            calls.append((name, *(type(a).__name__ for a in args)))
            return fn(nj, *args)

        monkeypatch.setattr(tsupports, name, traced)
    for bionj in (False, True):
        opts = TOptions(**dataclasses.asdict(_options(4, False, 0.0,
                                                      bionj=bionj)))
        with open(fasta) as f:
            _, sc = torch_pipeline.run_pipeline(opts, f, io.StringIO(),
                                                device=CPU)
        assert sc.n_splits == 21
    # the batched test takes the lengths pass's sweep tables
    assert calls == [("test_splits_min_evo_batched", "AverageTables"),
                     ("test_splits_min_evo",)]
