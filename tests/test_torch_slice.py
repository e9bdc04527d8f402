"""The port's -noml pipeline against the JAX package's, both on the CPU.

Same FASTA, same options (top-hits, ME NNI rounds, two SPR rounds, ME
branch lengths, split test): the join order must be identical and the
Newick byte-identical.  Tolerance: none; the port keeps the reference's
float64 accumulation and float32 store rounding, so no decision differs.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import pipeline as jax_pipeline
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as torch_pipeline
from veryfasttree_tpu_torch.options import Options as TOptions


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loops issue tiny ops, on which intra-op threads only
    contend (the N=500 run takes 1.5x longer with 8 threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(run_pipeline, fasta, two_tier_min, bionj=False, **kw):
    opts = Options(show_progress=False, n_codes=4, ml_nni=0, n_bootstrap=0,
                   two_tier_min=two_tier_min, bionj=bionj)
    opts.derive_settings()
    if run_pipeline is torch_pipeline.run_pipeline:
        # the port's own Options, with the same field values
        opts = TOptions(**dataclasses.asdict(opts))
    out = io.StringIO()
    with open(fasta) as f:
        nj, sc = run_pipeline(opts, f, out, **kw)
    return out.getvalue(), list(nj.join_log), sc


@pytest.mark.parametrize("n,p,seed,two_tier_min", [
    (100, 300, 77, 20000),     # dense store, with SPR (as tests/test_epoch.py)
    (40, 250, 57, 0),          # two-tier store forced on
])
def test_noml_pipeline_identical_to_jax(tmp_path, n, p, seed, two_tier_min):
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(n, p, seed=seed))
    nw_j, joins_j, sc_j = _run(jax_pipeline.run_pipeline, fasta, two_tier_min)
    nw_t, joins_t, sc_t = _run(torch_pipeline.run_pipeline, fasta,
                               two_tier_min, device=torch.device("cpu"))
    assert len(joins_t) == n - 3
    assert joins_t == joins_j
    assert nw_t == nw_j
    assert (sc_t.n_splits, sc_t.n_bad_splits) == (sc_j.n_splits,
                                                  sc_j.n_bad_splits)
    assert sc_t.d_worst_delta_unconstrained == pytest.approx(
        sc_j.d_worst_delta_unconstrained, rel=1e-12)


def test_bionj_pipeline_identical_to_jax(tmp_path):
    """-nt -noml -nosupport -bionj: the BIONJ weights average the profiles
    with weights other than 0.5, which the port rounds as the JAX package's
    CPU build does."""
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(60, 240, seed=11))
    nw_j, joins_j, _ = _run(jax_pipeline.run_pipeline, fasta, 20000,
                            bionj=True)
    nw_t, joins_t, _ = _run(torch_pipeline.run_pipeline, fasta, 20000,
                            bionj=True, device=torch.device("cpu"))
    assert joins_t == joins_j
    assert nw_t == nw_j


def test_bionj_join_rows_identical_to_jax():
    """The store row of the fourth join's new node (63) under -bionj, on a
    CPU store: W and U bit for bit the JAX package's."""
    from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
    from veryfasttree_tpu_torch.io.alignment import seqs_to_codes

    seqs = simulate_alignment(60, 240, seed=11)
    opts = Options(show_progress=False, n_codes=4, ml_nni=0, n_bootstrap=0,
                   bionj=True)
    opts.derive_settings()
    codes = seqs_to_codes(seqs, opts)
    nj_j = JNJ(opts, codes, None, None)
    nj_j.fast_nj(max_joins=4)
    nj_t = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, None,
               device=torch.device("cpu"))
    nj_t.fast_nj(max_joins=4)
    assert nj_t.join_log == nj_j.join_log
    assert nj_t.tree.maxnode == 64
    for name in ("W", "U"):
        ours = getattr(nj_t.prof, name)[63].numpy()
        ref = np.asarray(getattr(nj_j.prof, name))[63]
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("flags", [dict(n_codes=20, ml_nni=-1,
                                        constraints_file="c.fasta"),
                                   dict(threads=2),
                                   dict(constraints_file="c.fasta"),
                                   dict(checkpoint_file="ckpt.npz")])
def test_unported_options_raise(flags):
    """-threads > 1, -constraints (also under protein ML, which runs:
    tests/test_torch_protein_ml.py) and -checkpoint."""
    opts = TOptions(**{"n_codes": 4, "show_progress": False, "ml_nni": 0,
                       "n_bootstrap": 0, **flags})
    opts.derive_settings()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch_pipeline.run_pipeline(opts, io.StringIO(">a\nA\n"),
                                    io.StringIO(), device=torch.device("cpu"))
