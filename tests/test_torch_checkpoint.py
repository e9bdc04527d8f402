"""The port's -checkpoint (engine/checkpoint.py) on the CPU, and its files
against the JAX package's (veryfasttree_tpu/engine/checkpoint.py).

* A round trip: every engine, store and model array comes back equal.
* A run interrupted in ML-NNI round 3 and resumed from the round-2
  checkpoint in a fresh run_pipeline prints the uninterrupted run's Newick
  byte for byte: the default -nt run, -gtr (the fitted matrix comes from
  the checkpoint, not from the options), JTT at 20 codes and -threads 4.
* Across the packages: the JAX package's load_checkpoint reads the port's
  file with every array equal to the port's state; the JAX package's
  save of that state holds the same keys, dtypes and shapes as the port's
  file; and the port resumes from the file the JAX package wrote to the
  uninterrupted run's Newick.  Tolerance: none, the arrays pass through
  both packages unchanged.
"""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu.engine import checkpoint as jcheckpoint
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as tpipeline
from veryfasttree_tpu_torch.engine import batched, checkpoint
from veryfasttree_tpu_torch.ops import ml_round
from veryfasttree_tpu_torch.options import Options as TOptions

CPU = torch.device("cpu")
AA = "ARNDCQEGHILKMFPSTWYV"

# (alignment size, seed, alphabet, option fields) of each resumed run
CASES = {
    "default": (18, 130, 14, "ACGT", {}),
    "gtr": (16, 130, 3, "ACGT", dict(use_gtr=True)),
    "jtt20": (14, 100, 5, AA, dict(n_codes=20)),
    "threads4": (18, 130, 14, "ACGT", dict(threads=4)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The host loops issue tiny ops, on which intra-op threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jopts(ckpt="", **kw):
    kw = {"n_codes": 4, "n_bootstrap": 0, "ml_nni": 6, **kw}
    o = Options(show_progress=False, checkpoint_file=ckpt, **kw)
    o.derive_settings()
    return o


def _topts(ckpt="", **kw):
    """The port's own Options, with the JAX one's field values."""
    return TOptions(**dataclasses.asdict(_jopts(ckpt, **kw)))


def _fasta(tmp_path, n, p, seed, alphabet):
    path = str(tmp_path / "t.fasta")
    write_fasta(path, simulate_alignment(n, p, alphabet=alphabet, seed=seed))
    return path


def _run(fasta, ckpt="", **kw):
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        nj, _ = tpipeline.run_pipeline(_topts(ckpt, **kw), f, out,
                                       log_fp=log, device=CPU)
    return out.getvalue(), nj, log.getvalue()


class Crash(Exception):
    pass


def _interrupted(fasta, ckpt, monkeypatch, **kw):
    """The run with its third ML-NNI round raising (after the round-2
    checkpoint was written), serial and -threads tiers alike."""
    calls = {"ml": 0}

    def bomb(orig):
        def nni(nj, i, n_rounds, *args):
            use_ml = args[0] if orig is batched_nni else True
            if use_ml:
                calls["ml"] += 1
                if calls["ml"] == 3:
                    raise Crash()
            return orig(nj, i, n_rounds, *args)
        return nni

    batched_nni = batched.do_nni_batched
    with monkeypatch.context() as m:
        m.setattr(ml_round, "ml_nni_round", bomb(ml_round.ml_nni_round))
        m.setattr(batched, "do_nni_batched", bomb(batched_nni))
        with pytest.raises(Crash):
            _run(fasta, ckpt, **kw)
    with np.load(ckpt) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
    assert (meta["phase"], meta["round"]) == ("ml_nni", 2)


def _engine_arrays(nj):
    """Every array a checkpoint keeps, from the engine (not the file)."""
    return checkpoint.state_arrays(nj, {})


def test_round_trip(tmp_path):
    fasta = _fasta(tmp_path, 16, 120, 13, "ACGT")
    _, nj, _ = _run(fasta)
    path = str(tmp_path / "state.npz")
    info = checkpoint.save_checkpoint(
        nj, path, {"phase": "test", "round": 3, "last_loglk": -12.5,
                   "converged": False}, extra={"foo": np.arange(4)})
    assert info["bytes"] > 0 and info["fetch_s"] >= 0 and info["write_s"] >= 0
    # a fresh engine from the same alignment, with no ML store yet
    _, nj2, _ = _run(fasta, ml_nni=0, nni=0, spr=0)
    assert nj2.ml is None
    meta, extra = checkpoint.load_checkpoint(nj2, path)
    assert (meta["phase"], meta["round"], meta["has_ml"]) == ("test", 3, True)
    np.testing.assert_array_equal(extra["foo"], np.arange(4))
    a, b = _engine_arrays(nj), _engine_arrays(nj2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    assert (nj2.tree.maxnode, nj2.tree.root) == (nj.tree.maxnode,
                                                 nj.tree.root)
    assert nj2.totdiam == nj.totdiam
    assert (nj2.ml.jc, nj2.ml.use_approx) == (nj.ml.jc, nj.ml.use_approx)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_mid_ml_matches_uninterrupted(tmp_path, monkeypatch, case):
    n, p, seed, alphabet, kw = CASES[case]
    fasta = _fasta(tmp_path, n, p, seed, alphabet)
    nw_full, _, _ = _run(fasta, **kw)
    ckpt = str(tmp_path / "ck.npz")
    _interrupted(fasta, ckpt, monkeypatch, **kw)
    nw, nj, log = _run(fasta, ckpt, **kw)
    assert "Resuming ML-NNI at round 3" in log
    assert nw == nw_full
    # the resumed run kept the checkpoint's rates
    assert len(nj.ml.rates_np) > 1
    if case == "gtr":
        assert not nj.ml.jc


def _jax_engine(fasta, **kw):
    """A JAX engine of the same alignment and options, before any phase."""
    from veryfasttree_tpu.io.alignment import Uniquify, read_alignment
    from veryfasttree_tpu.pipeline import build_models

    opts = _jopts(**kw)
    with open(fasta) as f:
        aln = read_alignment(f, opts, None)
    unique = Uniquify.build(aln)
    dmat, tmat = build_models(opts)
    return JNJ(opts, seqs_to_codes(unique.unique_seq, opts), dmat, tmat)


def _jax_saved(jnj, path=None, meta=None, extra=None):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = path or f"{d}/j.npz"
        jcheckpoint.save_checkpoint(jnj, path, meta or {}, extra)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["default", "gtr", "jtt20"])
def test_checkpoints_cross_the_packages(tmp_path, monkeypatch, case):
    n, p, seed, alphabet, kw = CASES[case]
    fasta = _fasta(tmp_path, n, p, seed, alphabet)
    nw_full, _, _ = _run(fasta, **kw)
    ours = str(tmp_path / "port.npz")
    _interrupted(fasta, ours, monkeypatch, **kw)
    with np.load(ours) as z:
        port = {k: z[k] for k in z.files}

    # the JAX package reads the port's file: every array the port's
    jnj = _jax_engine(fasta, **kw)
    meta, extra = jcheckpoint.load_checkpoint(jnj, ours)
    assert (meta["phase"], meta["round"]) == ("ml_nni", 2)
    theirs = str(tmp_path / "jax.npz")
    jax_file = _jax_saved(jnj, theirs, meta, extra)
    # the same keys, dtypes and shapes, and every array equal
    assert jax_file.keys() == port.keys()
    for k in port:
        assert (jax_file[k].dtype, jax_file[k].shape) == \
            (port[k].dtype, port[k].shape), k
        if k != "meta_json":
            np.testing.assert_array_equal(jax_file[k], port[k], err_msg=k)
    assert json.loads(bytes(jax_file["meta_json"]).decode()) == \
        json.loads(bytes(port["meta_json"]).decode())

    # the port resumes from the file the JAX package wrote
    nw, _, log = _run(fasta, theirs, **kw)
    assert "Resuming ML-NNI at round 3" in log
    assert nw == nw_full
