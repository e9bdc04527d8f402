"""The port's NJ join phase on a CPU store against the JAX package's.

On a CPU store the port's join phase is the host loop
(NeighbourJoining._join_loop_host), the plain twin of the join epoch kernel
(csrc/nj_epoch.cu), which the card tests hold bit for bit to it.  Here it is
held against the JAX package's device join epoch (engine/epoch.py run_epoch,
VFT_EPOCH=1) on the inputs and to the tolerances of tests/test_epoch.py: the
join log identical, branch lengths and diameters within 1e-12 (float64
arithmetic summed in other orders), out-distances within 1e-9 (their sums
over about N terms).  The debug counters must equal the JAX host loop's with
the unfused joins (VFT_FUSED_JOIN=0): the fused join counts the out-profile
refreshes otherwise.

Under -bionj the JAX package's epoch departs from its own host loop (at
joins 17-23 of _synth(120, 256, s) for s = 4, 5, 6: it orients a join the
other way, or picks another), so there the port is held to the JAX host
loop, to the same tolerances.  About 50 s at one worker, most of it the
JAX epoch's compiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_epoch import _synth

from veryfasttree_tpu.engine import nj as jnj_mod
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import epoch
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.engine.tophits import TopHits
from veryfasttree_tpu_torch.options import Options as TOptions

COUNTERS = ("outprofile_ops", "profile_ops", "seq_ops", "profile_avg_ops",
            "n_hill_better", "n_visible_update", "n_refresh_tophits")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(**kw):
    opts = Options(n_codes=4, show_progress=False, **kw)
    opts.derive_settings()
    return opts


def _jax(codes, monkeypatch, use_epoch, max_joins=None, **kw):
    monkeypatch.setenv("VFT_EPOCH", "1" if use_epoch else "0")
    monkeypatch.setattr(jnj_mod, "USE_FUSED_JOIN", False)
    nj = jnj_mod.NeighbourJoining(_opts(**kw), codes, None, None)
    nj.fast_nj(max_joins=max_joins)
    return nj


def _port(codes, max_joins=None, **kw):
    opts = TOptions(**dataclasses.asdict(_opts(**kw)))
    nj = TNJ(opts, codes, None, None, device=torch.device("cpu"))
    nj.fast_nj(max_joins=max_joins)
    return nj


@pytest.mark.parametrize("kw,seed", [({}, 3), ({"bionj": True}, 4),
                                     ({"two_tier_min": 0}, 3)],
                         ids=["dense", "bionj", "two-tier"])
def test_join_phase_matches_jax_epoch(kw, seed, monkeypatch):
    codes = _synth(120, 256, seed)
    nj_t = _port(codes, **kw)
    assert epoch.epoch_supported(nj_t, nj_t._tophits)
    assert nj_t.prof.two_tier == ("two_tier_min" in kw)
    nj_h = _jax(codes, monkeypatch, False, **kw)
    nj_e = nj_h if kw.get("bionj") else _jax(codes, monkeypatch, True, **kw)
    assert nj_t.join_log == nj_e.join_log
    m = nj_e.tree.maxnode
    assert nj_t.tree.maxnode == m
    np.testing.assert_allclose(nj_t.tree.branchlength[:m],
                               nj_e.tree.branchlength[:m], rtol=0, atol=1e-12)
    for name in ("diameter", "var_diameter"):
        np.testing.assert_allclose(getattr(nj_t, name), getattr(nj_e, name),
                                   rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(nj_t.out_distances, nj_e.out_distances,
                               rtol=0, atol=1e-9)
    for name in COUNTERS:
        assert getattr(nj_t.debug, name) == getattr(nj_h.debug, name), name


def test_join_phase_max_joins(monkeypatch):
    codes = _synth(120, 256, 3)
    nj_t = _port(codes, max_joins=10)
    nj_e = _jax(codes, monkeypatch, True, max_joins=10)
    assert len(nj_t.join_log) == 10
    assert nj_t.join_log == nj_e.join_log
    assert nj_t.tree.root == -1 and nj_t.tree.maxnode == 120 + 10


def test_reset_plan_is_the_host_loops():
    """The joins that end a launch of the epoch are those at which the host
    loop recomputes the out-profile (n_reset_out_profile 200: one at N=300),
    under max_joins too."""
    codes = _synth(300, 300, 1)
    opts = TOptions(**dataclasses.asdict(_opts()))
    nj = TNJ(opts, codes, None, None, device=torch.device("cpu"))
    at = []
    recompute = nj.prof.recompute_outprofile

    def record(active):
        at.append(len(nj.join_log))
        recompute(active)

    nj.prof.recompute_outprofile = record
    nj.fast_nj()
    plan = epoch.reset_plan(300, opts)
    assert plan and at == [300 - n + 1 for n in plan]
    assert epoch.reset_plan(300, opts, max_joins=at[0]) == plan[:1]
    assert epoch.reset_plan(300, opts, max_joins=at[0] - 1) == []


def test_tophits_pack_unpack_round_trip():
    codes = _synth(120, 256, 3)
    nj = _port(codes, max_joins=40)
    th = nj._tophits
    hj, hd = th.pack_state()
    assert hj.shape == (nj.maxnodes, th.m) and hj.dtype == np.int32
    back = TopHits(nj.options, nj.maxnodes, th.m)
    back.unpack_state(hj, hd)
    n_lists = 0
    for a, b, da, db in zip(th.hits_j, back.hits_j, th.hits_dist,
                            back.hits_dist):
        assert (a is None) == (b is None)
        if a is not None:
            n_lists += 1
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(da, db)
    assert 0 < n_lists < nj.maxnodes
