"""Protein ML in the port against the JAX package, both on the CPU.

The port runs its plain twins (``device=torch.device("cpu")``); the inputs
are made from numpy seeds; tests/conftest.py turns on jax_enable_x64.

(a) ``posterior_matrix`` at 20 codes with -approxml's rough-posterior gate,
    JTT and LG, on random profiles (peaked mixtures of rotated one-hots,
    half the positions alike in both children):
    the positions taking the rough path equal (the flips are counted and
    printed: 0 measured), the rough and exact counts equal (1,565 rough
    positions of 8,192 under JTT), the rough vectors within 1e-5 (1.4e-6
    measured: float32 arithmetic alike), the exact ones within rtol 1e-6,
    atol 5e-3 (the JAX package rotates with float32 products, the port in
    float64 rounded once: 2.1e-3 measured under JTT, 4.5e-3 under LG,
    whose rotated entries sum more cancelling terms; the vectors reach
    8).
(b) One ML lengths pass and one ML NNI round at 20 codes (JTT, four CAT
    rates) from one JAX checkpoint (N=40, P=120): through the port's twins
    (ops/ml_round) and the JAX host loops.  The tree arrays, the NNIs, the
    debug counters and the rough/exact posterior counts equal; lengths
    within 1e-4 + 1e-2 x length.  tests/test_torch_ml_round.py holds 4
    codes to 1e-4 + 2e-3 x length; here the worst length reads 2.1 times
    that (0.10814 against 0.10749), from the same cause: each package
    stops Brent's search on its own float32 objective, and the JAX
    package's JTT posteriors, rotated with float32 products, differ from
    the port's by up to 4.7e-4 (100 times the GTR error), so its
    objective does too.  The lengths follow that rounding, not the port's
    arithmetic: with the port's rotations taken as float32 products as
    well, the worst (|port - JAX| - 1e-4) / length reads 2.9e-2 after
    the pass, against 6.1e-3 with its double sums
    (scripts/compare_protein_supports.py --lengths).
(c) ``run_pipeline`` on a protein alignment (simulate_alignment with the
    package's amino-acid alphabet, N=40, P=120, seed 5) through both
    packages, the default run, ``-lg -gamma`` and ``-approxml``, each in a
    file of its own (tests/test_torch_protein_ml_{default,lg_gamma,
    approxml}.py; the JAX package's runs read from the goldens of
    scripts/make_torch_port_protein_cpu_golden.py, which
    ``test_protein_goldens_are_the_jax_packages`` here holds to the JAX
    package's sources), held
    together by tests/torch_protein_runs.py's check_pipeline: the final
    LogLk and the stats block, the decisions alike up to the first that
    flips, which must be a near tie, and where none flips RF 0 and the
    rest of check_pipeline's list.  At seed 5 each of the three runs flips one
    decision, the same quartet (rows 1, 74, 75, 66) around a branch at the
    minimum length: its criteria 8.9e-4 (JAX package) and 1.2e-5 (port)
    apart by default, 4.0e-4 and 1.6e-4 under -lg -gamma, 8.6e-4 and
    2.8e-4 under -approxml; the trees end RF 2, 2 and 4 apart, the final
    LogLks within 5.9e-5 relative.  tests/test_torch_protein_ml_agree_*.py
    run the whole list on an alignment where no decision flips.
(d) ``MLProfiles.load_state`` takes a 20-code JAX store exactly, and the
    port's own store built on the same tree agrees with it (vectors rtol
    1e-6, atol 5e-6: balanced averages in float32).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_protein_runs import (AA, CONFIGS, GOLDEN,  # noqa: F401
                                golden_meta, jax_golden, one_torch_thread)
from util import simulate_alignment

from veryfasttree_tpu import constants as jconst
from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models import DistanceMatrix, TransitionMatrix
from veryfasttree_tpu.ops import kernels as jk
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.models import DistanceMatrix as TDistanceMatrix
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.ops import kernels as tk
from veryfasttree_tpu_torch.ops import ml_round
from veryfasttree_tpu_torch.options import Options as TOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG = ("n_ml_nni", "n_star_tests", "n_lk_compute", "n_posterior_compute")


# ------------------------------------------------------------------- (a)
def _profiles(rng, cf, P):
    """[P, 20] rotated profiles: each position a one-hot, a peaked mixture
    or a flat one, rotated by code_freq."""
    C = 20
    flat = rng.dirichlet(np.full(C, 0.3), size=P)
    peaked = 0.9 * np.eye(C)[rng.integers(0, C, P)] + 0.1 * flat
    onehot = np.eye(C)[rng.integers(0, C, P)]
    pick = rng.random(P)
    d = np.where(pick[:, None] < 0.4, onehot,
                 np.where(pick[:, None] < 0.7, peaked, flat))
    return (d @ cf).astype(np.float32)


def _gated(mod, f1, f2, w1, w2, ee, ratecat, cf, tm, approx):
    """(w_out, v_out, n_rough, n_exact, rough mask) of mod.posterior_matrix:
    the mask where the gated vectors leave the exact path's."""
    f32 = np.float32
    args = [f1, f2, w1, w2, *ee, ratecat, cf, tm.eigeninv.astype(f32),
            tm.statinv.astype(f32), 1e-10]
    gate = (tm.near_p.astype(f32), tm.near_freq.astype(f32),
            jconst.APPROX_ML_MIN_F, jconst.APPROX_ML_MIN_RATIO)
    if mod is tk:
        args = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
                else a for a in args]
        args[6] = args[6].long()
        gate = (*map(torch.from_numpy, gate[:2]), *gate[2:])
    out = [np.asarray(x) for x in mod.posterior_matrix(
        *args, gate if approx else None)]
    exact = np.asarray(mod.posterior_matrix(*args, None)[1])
    return (*out, np.any(out[1] != exact, axis=-1))


@pytest.mark.parametrize("model", ["jtt92", "lg08"])
def test_posterior_gate_matches_jax(model):
    tm = getattr(TransitionMatrix, model)()
    cf = tm.code_freq[:20].astype(np.float32)
    rng = np.random.default_rng(17)
    P = 2048
    rates = np.exp(np.linspace(-np.log(3), np.log(3), 3)).astype(np.float32)
    flips = n_rough = 0
    for length in (5e-4, 0.02, 0.1, 0.3):
        f1, f2 = _profiles(rng, cf, P), _profiles(rng, cf, P)
        # close relatives: half the positions the same on both sides, where
        # most posteriors take the rough path
        same = rng.random(P) < 0.5
        f2[same] = f1[same]
        w1 = np.where(rng.random(P) < 0.05, 0.0, 1.0).astype(np.float32)
        w2 = np.where(rng.random(P) < 0.05, 0.0, 1.0).astype(np.float32)
        ratecat = rng.integers(0, 3, P).astype(np.int32)
        ee = [np.asarray(jk.exp_eigen_rates(
            np.float32(x), rates, tm.eigenval.astype(np.float32),
            np.float32(1e-4))) for x in (length, 0.05)]
        j = _gated(jk, f1, f2, w1, w2, ee, ratecat, cf, tm, True)
        t = _gated(tk, f1, f2, w1, w2, ee, ratecat, cf, tm, True)
        flips += int((j[4] != t[4]).sum())
        n_rough += int(t[2])
        np.testing.assert_array_equal(t[0], j[0])
        rough = t[4]
        np.testing.assert_allclose(t[1][rough], j[1][rough], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(t[1][~rough], j[1][~rough], rtol=1e-6,
                                   atol=5e-3)
        assert (int(t[2]), int(t[3])) == (int(j[2]), int(j[3]))
        # the exact path counts every position that is not both gaps
        e = _gated(tk, f1, f2, w1, w2, ee, ratecat, cf, tm, False)
        assert (int(e[2]), int(e[3])) == (0, int(((w1 > 0) | (w2 > 0)).sum()))
    print(f"{model}: {n_rough} rough positions, {flips} flipped decisions")
    assert flips == 0 and n_rough > 0


# -------------------------------------------------------------- (b), (d)
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


def _aa_counts(nj):
    nj.ml.flush_posterior_counters()
    return nj.debug.n_aa_posterior_rough, nj.debug.n_aa_posterior_exact


def _same_state(jnj, tnj):
    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name), err_msg=name)
    jl, tl = jnj.tree.branchlength, tnj.tree.branchlength
    assert np.all(np.abs(tl - jl) <= 1e-4 + 1e-2 * np.abs(jl))
    for k in DEBUG:
        assert getattr(tnj.debug, k) == getattr(jnj.debug, k), k
    assert _aa_counts(tnj) == _aa_counts(jnj)


def test_ml_pass_and_round_at_20_codes_match_jax(tmp_path):
    jnj, tnj = _engines(tmp_path)
    for nj in (jnj, tnj):
        nj.debug.reset()
    jml.optimize_all_branch_lengths(jnj)
    ml_round.ml_lengths_pass(tnj)
    _same_state(jnj, tnj)
    got = ml_round.ml_nni_round(tnj, 0, 1, trearrange.NNIStats.init(tnj))
    exp = jrearrange.do_nni(jnj, 0, 1, True, jrearrange.NNIStats.init(jnj))
    assert got[0] == exp[0] and tnj.debug.n_ml_nni > 0
    _same_state(jnj, tnj)
    assert tnj.debug.n_aa_posterior_exact > 0


def test_load_state_takes_a_20_code_jax_store(tmp_path):
    jnj, tnj = _engines(tmp_path)
    fresh = TMLStore(tnj, tnj.transmat)
    jfresh = JMLStore(jnj, jnj.transmat)
    np.testing.assert_array_equal(fresh.codes.numpy(),
                                  np.asarray(jfresh.codes))
    np.testing.assert_array_equal(fresh.W.numpy(), np.asarray(jfresh.W))
    np.testing.assert_allclose(fresh.V.numpy(), np.asarray(jfresh.V),
                               rtol=1e-6, atol=5e-6)
    arrays = [np.asarray(a) for a in (jnj.ml.codes, jnj.ml.W, jnj.ml.V)]
    tnj.ml.load_state(*arrays, jnj.ml.rates_np, jnj.ml.ratecat_np)
    for ours, theirs in zip((tnj.ml.codes, tnj.ml.W, tnj.ml.V), arrays):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    assert tnj.ml.V.shape[-1] == 20 and not tnj.ml.use_approx
    assert abs(jml.tree_loglk(jnj) - tml.tree_loglk(tnj)) < 1e-2


# ------------------------------------------------------------------- (c)
def test_protein_goldens_are_the_jax_packages():
    """The JAX half of (c) and of tests/test_torch_protein_ml_agree_*.py
    comes from goldens: they must have been written from the JAX package
    and the alignment generator as they are now, and hold every (seed,
    config) run."""
    spec = importlib.util.spec_from_file_location(
        "make_golden", os.path.join(REPO, "scripts",
                                    "make_torch_port_protein_cpu_golden.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    meta = golden_meta()
    assert script.source_hash() == meta["source_hash"], (
        "veryfasttree_tpu/ or tests/util.py changed since the protein "
        f"goldens tests/data/{GOLDEN}_* were written: rerun "
        "python scripts/make_torch_port_protein_cpu_golden.py")
    for seed in script.SEEDS:
        for name in CONFIGS:
            newick, log, (rough, exact), decisions = jax_golden(seed, name)
            assert newick.count("(") == 38 and "Optimize all lengths" in log
            assert rough + exact > 0 and len(decisions) > 100
            assert all(d[2].shape == (3,) for d in decisions)
