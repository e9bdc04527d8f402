"""The port's host loops under -constraints against the JAX package's, on
the CPU (the loops are the plain twins the card's constrained kernels are
held to bit for bit: chip_smoke.py phase 8).

From one alignment (N=56, P=250) and its constraint alignment
(tests/torch_constraint_runs.py constraint_columns: one column, or twelve
with '-' entries) each package runs its join loop (the JAX package's host
loop, VFT_EPOCH=0; the port's on a CPU store), then one ME NNI round and
one SPR round on its own engine; then the JAX engine's ME branch lengths
go into the port's through the JAX checkpoint format (counts included,
NeighbourJoining.load_state), and each takes an ML store (Jukes-Cantor,
one rate), one ML lengths pass and one ML NNI round, as
tests/test_torch_ml_round.py starts them.  Held: the join log, the counts after every step
and the tree after every round identical; the ME NNI round's NNIStats
ages identical, its deltas and supports within 1e-9 (measured 2.9e-10:
tests/test_torch_nni_round.py's tolerance); the ML round's decisions and NNIStats ages identical, its
deltas and supports within 1e-2 (each package's float32 line searches;
tests/test_torch_ml_round.py holds 5e-3 on its tree, here a support reads
5.7e-3), each criterion less the AB one (the difference a decision reads)
within that file's criteria limit, 2e-2 (measured 5.7e-3), and each
criterion within 1e-4 relative, the final LogLk's gate (measured 8.5e-5),
not within 2e-2 absolute: here quartet LogLks reach -1,030, and the
twelve-column case reads 5.0e-2, an offset its three criteria share.  About 40 s."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_constraint_runs as runs
from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import nj as jnj_mod
from veryfasttree_tpu.engine import rearrange as jre
from veryfasttree_tpu.engine import spr as jspr
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as tre
from veryfasttree_tpu_torch.engine import spr as tspr
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.ops import ml_round
from veryfasttree_tpu_torch.options import Options as TOptions

N, P, SEED = 56, 250, 31
# ME deltas and supports: the twins sum the pair distances in another
# order than XLA's (tests/test_torch_nni_round.py)
DELTA_TOL = 1e-9
QUARTET_TOL = 1e-2                     # deltas, supports (ML)
CRITERIA_RTOL = 1e-4                   # each ML quartet's criteria
DECIDING_TOL = 2e-2                    # ... less its AB criterion


def _same(jnj, tnj, what):
    for name in ("parent", "children", "n_child"):
        np.testing.assert_array_equal(getattr(tnj.tree, name),
                                      getattr(jnj.tree, name),
                                      err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(tnj.con_on, jnj.con_on, err_msg=what)
    np.testing.assert_array_equal(tnj.con_off, jnj.con_off, err_msg=what)


def _log(monkeypatch, mod, log):
    orig = mod.ml_quartet_nni

    def rec(nj, rows4, *args):
        out = orig(nj, rows4, *args)
        log.append((tuple(int(r) for r in rows4), int(out[0]),
                    np.array(out[1], dtype=np.float64)))
        return out

    monkeypatch.setattr(mod, "ml_quartet_nni", rec)


@pytest.fixture(scope="module", params=[1, 12], ids=["one-column",
                                                    "twelve-columns"])
def engines(request, tmp_path_factory):
    """Both packages' engines through every step, with each step's
    results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("VFT_EPOCH", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        opts = Options(n_codes=4, show_progress=False, n_bootstrap=0)
        opts.derive_settings()
        seqs = simulate_alignment(N, P, seed=SEED)
        cols = runs.constraint_columns(seqs, request.param, SEED)
        cons = tuple(np.array([[c == ch for c in row] for row in cols],
                              dtype=np.int64) for ch in "10")
        codes = seqs_to_codes(seqs, opts)
        jnj = jnj_mod.NeighbourJoining(opts, codes, None, None, cons)
        tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, None,
                  cons, device=torch.device("cpu"))
        steps = {}
        for nj in (jnj, tnj):
            nj.fast_nj()
        steps["nj"] = (list(map(tuple, jnj.join_log)),
                       list(map(tuple, tnj.join_log)),
                       jnj.con_on.copy(), tnj.con_on.copy(),
                       jnj.con_off.copy(), tnj.con_off.copy())
        jst, tst = jre.NNIStats.init(jnj), tre.NNIStats.init(tnj)
        steps["nni"] = (jre.do_nni(jnj, 0, 1, False, jst),
                        tre.do_nni(tnj, 0, 1, False, tst), jst, tst)
        _same(jnj, tnj, "ME NNI round")
        jspr.run_spr(jnj, 0, 1)
        tspr.run_spr(tnj, 0, 1)
        _same(jnj, tnj, "SPR round")
        jre.update_branch_lengths(jnj)
        steps["spr"] = (jnj.debug.n_spr, tnj.debug.n_spr)
        # the ML round from one start, as tests/test_torch_ml_round.py
        # starts it: the JAX engine's checkpoint, counts included, loaded
        # into the port's; then a lengths pass each
        path = str(tmp_path_factory.mktemp("cons") / "me.npz")
        save_checkpoint(jnj, path, {"phase": "me"})
        tnj.con_on[:] = 0
        with np.load(path) as z:
            tnj.load_state({k: z[k] for k in z.files})
        _same(jnj, tnj, "checkpoint")
        jnj.ml, tnj.ml = JMLStore(jnj, None), TMLStore(tnj, None)
        for nj in (jnj, tnj):
            nj.ml.recompute_ml_profiles()
        jml.optimize_all_branch_lengths(jnj)
        ml_round.ml_lengths_pass(tnj)
        jlog, tlog = [], []
        _log(mp, jml, jlog)
        _log(mp, tml, tlog)
        jst, tst = jre.NNIStats.init(jnj), tre.NNIStats.init(tnj)
        exp = jre.do_nni(jnj, 0, 1, True, jst)
        got = ml_round.ml_nni_round(tnj, 0, 1, tst)
        steps["ml"] = (exp, got, jst, tst, jlog, tlog)
        yield jnj, tnj, steps
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def test_join_loop_matches_jax(engines):
    _, _, steps = engines
    jlog, tlog, jon, ton, joff, toff = steps["nj"]
    assert len(tlog) == N - 3
    assert tlog == jlog
    np.testing.assert_array_equal(ton, jon)
    np.testing.assert_array_equal(toff, joff)
    assert ton[N:].any()                    # the joins wrote the counts


def test_me_rounds_match_jax(engines):
    _, _, steps = engines
    exp, got, jst, tst = steps["nni"]
    assert got[0] == exp[0]
    assert got[1] == pytest.approx(exp[1], rel=0, abs=DELTA_TOL)
    for name in ("age", "subtree_age"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name),
                                      err_msg=name)
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tst, name), getattr(jst, name),
                                   rtol=0, atol=DELTA_TOL, err_msg=name)
    n_spr_j, n_spr_t = steps["spr"]
    assert n_spr_t == n_spr_j


def test_ml_round_matches_jax(engines):
    jnj, tnj, steps = engines
    exp, got, jst, tst, jlog, tlog = steps["ml"]
    assert len(tlog) == len(jlog) > 0
    for j, t in zip(jlog, tlog):
        assert (t[0], t[1]) == (j[0], j[1])
        live = t[2] > -1e19                 # not set (a star test fired)
        gap = np.abs(t[2] - j[2])[live]
        dgap = np.abs((t[2] - t[2][0]) - (j[2] - j[2][0]))[live]
        assert np.all(gap <= CRITERIA_RTOL * np.abs(j[2][live]))
        assert np.all(dgap <= DECIDING_TOL)
    assert got[0] == exp[0]
    assert got[1] == pytest.approx(exp[1], rel=0, abs=QUARTET_TOL)
    for name in ("age", "subtree_age"):
        np.testing.assert_array_equal(getattr(tst, name), getattr(jst, name))
    for name in ("delta", "support"):
        np.testing.assert_allclose(getattr(tst, name), getattr(jst, name),
                                   rtol=0, atol=QUARTET_TOL)
    # the ML round changes no count (its profiles' recomputes leave them)
    _same(jnj, tnj, "ML NNI round")
