"""The fused join step of the host join loop (engine/fused.py,
ops/join_kernels.py) on the CPU, where the step is the kernel's plain twin.

* Join after join of the JAX package's host loop (-fastest, -2nd,
  -fastest -bionj), the port's join_step on the same state (the JAX
  engine's arrays loaded into a port engine) against the JAX package's
  fused.join_step: the same packed layout (the scalar names in order) and
  every value within 1e-12 (float64 sums in other orders; rtol and atol),
  the new node's row within 1e-6 relative (float32 averages).  Under
  -bionj the JAX package rounds the weighted average as the XLA program
  around it fuses it (ROADMAP.md, the known departures), a float32 ulp or
  so from its own per-call average and the port's: there the values that
  read the new row or the updated out-profile (from selfdist_new on) are
  held within 1e-6 relative, the join's own scalars within 1e-12.
* The port's fused loop against its own unfused loop (VFT_FUSED_JOIN=0)
  bit for bit: join log, tree, branch lengths, diameters, self- and
  out-distances, store rows, out-profile and debug counters, under
  -fastest, -2nd, -fastest -bionj, -fastest -constraints and -fastest
  with the two-tier store.
* The -nt -noml -nosupport Newick at N=60 byte-identical to the JAX
  package's (its fused join on), -fastest and -2nd; and the stats lines
  equal to the JAX package's with its unfused join (USE_FUSED_JOIN
  patched to False): the JAX fused join counts fewer profile operations
  than its own unfused loop (ROADMAP.md, Queue 3 item 1), which the port
  keeps.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import pipeline as jpipeline
from veryfasttree_tpu.engine import fused as jfused
from veryfasttree_tpu.engine import nj as jnj_mod
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as tpipeline
from veryfasttree_tpu_torch.engine import fused as tfused
from veryfasttree_tpu_torch.engine import nj as tnj_mod
from veryfasttree_tpu_torch.ops import join_kernels
from veryfasttree_tpu_torch.options import Options as TOptions

CPU = torch.device("cpu")
F64 = dict(rtol=1e-12, atol=1e-12)
COUNTERS = ("outprofile_ops", "profile_ops", "seq_ops", "profile_avg_ops",
            "n_hill_better", "n_visible_update", "n_refresh_tophits",
            "n_close_used", "n_close2_used")
MODES = {"fastest": dict(fastest=True), "2nd": dict(use_tophits_2nd=True),
         "fastest-bionj": dict(fastest=True, bionj=True)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(**kw):
    o = Options(n_codes=4, show_progress=False, ml_nni=0, n_bootstrap=0,
                **kw)
    o.derive_settings()
    return o


def _port(opts):
    return TOptions(**dataclasses.asdict(opts))


def _codes(n, p, seed):
    return seqs_to_codes(simulate_alignment(n, p, seed=seed), _opts())


def _jax_arrays(jnj):
    """The JAX engine's state under its checkpoint's names
    (veryfasttree_tpu/engine/checkpoint.py), without writing a file."""
    tree, prof = jnj.tree, jnj.prof
    return {
        "tree_parent": tree.parent.copy(), "tree_children": tree.children.copy(),
        "tree_n_child": tree.n_child.copy(),
        "tree_branchlength": tree.branchlength.copy(),
        "tree_support": tree.support.copy(),
        "tree_scal": np.array([tree.maxnode, tree.root], dtype=np.int64),
        "nj_diameter": jnj.diameter.copy(),
        "nj_var_diameter": jnj.var_diameter.copy(),
        "nj_selfdist": jnj.selfdist.copy(),
        "nj_selfweight": jnj.selfweight.copy(),
        "nj_out_distances": jnj.out_distances.copy(),
        "nj_n_out_dist_active": jnj.n_out_dist_active.copy(),
        "nj_scal": np.array([jnj.totdiam]),
        # copies: the port's store writes its rows in place
        "me_codes": np.array(prof.codes), "me_W": np.array(prof.W),
        "me_U": np.array(prof.U), "me_w_out": np.array(prof.w_out),
        "me_f_out": np.array(prof.f_out)}


def _close(name, ours, ref):
    np.testing.assert_allclose(np.asarray(ours, dtype=np.float64),
                               np.asarray(ref, dtype=np.float64),
                               err_msg=name, **F64)


def test_packed_layout_is_the_jax_packages():
    assert join_kernels.IN == jfused._IN
    assert join_kernels.OUT == jfused._SCALARS


@pytest.mark.parametrize("mode", list(MODES))
def test_join_step_matches_jax_join_after_join(monkeypatch, mode):
    codes = _codes(50, 160, 21)
    opts = _opts(**MODES[mode])
    tnj = tnj_mod.NeighbourJoining(_port(opts), codes, None, None,
                                   device=CPU)
    orig = jfused.join_step
    seen = {"steps": 0, "cand": 0, "pref": 0}

    def late(name, after_average=True):
        """The comparison of a value (see the module docstring)."""
        if opts.bionj and after_average:
            return lambda a, b: np.testing.assert_allclose(
                np.asarray(a, dtype=np.float64),
                np.asarray(b, dtype=np.float64), rtol=1e-6, atol=1e-9,
                err_msg=name)
        return lambda a, b: _close(name, a, b)

    def both(jnj, join, n_active, newnode, cand_js=None, prefetch=None):
        tnj.load_state(_jax_arrays(jnj))
        ours = tfused.join_step(tnj, join, n_active, newnode, cand_js,
                                prefetch)
        ref = orig(jnj, join, n_active, newnode, cand_js, prefetch)
        for k, name in enumerate(jfused._SCALARS):
            late(name, k >= jfused._SCALARS.index("selfdist_new"))(
                ours[name], ref[name])
        keys = [k for k in ref if k.startswith("cand_")]
        assert sorted(keys) == sorted(k for k in ours if k.startswith("cand_"))
        for k in keys:
            late(k)(ours[k], ref[k])
        np.testing.assert_allclose(tnj.prof.U[newnode].numpy(),
                                   np.asarray(jnj.prof.U)[newnode],
                                   rtol=1e-6, atol=1e-7)
        late("w_out")(tnj.prof.w_out.numpy(), jnj.prof.w_out)
        # the rows the step cached, against the JAX package's cache
        for node, (d, w) in tnj._out_raw.items():
            late(f"cached {node}")((d, w), jnj._out_raw[node])
        seen["steps"] += 1
        seen["cand"] += len(keys) > 0
        seen["pref"] += len(tnj._out_raw) > 1
        return ref

    monkeypatch.setattr(jfused, "join_step", both)
    monkeypatch.setattr(jnj_mod, "USE_FUSED_JOIN", True)
    jnj = jnj_mod.NeighbourJoining(opts, codes, None, None)
    jnj.fast_nj()
    assert seen["steps"] > 30 and seen["cand"] > 10 and seen["pref"] > 10


def _cons(n, n_cons=6, seed=3):
    rng = np.random.default_rng(seed)
    col = rng.random((n, n_cons))
    on = (col < 0.45).astype(np.int64)
    off = (col > 0.55).astype(np.int64)
    return on, off


def _port_nj(codes, opts, fused, monkeypatch, cons=None):
    monkeypatch.setattr(tnj_mod, "USE_FUSED_JOIN", fused)
    nj = tnj_mod.NeighbourJoining(_port(opts), codes, None, None, cons,
                                  device=CPU)
    nj.fast_nj()
    return nj


@pytest.mark.parametrize("mode", list(MODES) + ["fastest-constraints",
                                               "fastest-two-tier"])
def test_fused_loop_is_the_unfused_loop(monkeypatch, mode):
    codes = _codes(90, 200, 9)
    kw = dict(MODES.get(mode, MODES["fastest"]))
    if mode == "fastest-two-tier":
        kw["two_tier_min"] = 0
    cons = _cons(len(codes)) if mode == "fastest-constraints" else None
    calls = []
    step = tfused.join_step
    monkeypatch.setattr(tfused, "join_step",
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    a = _port_nj(codes, _opts(**kw), True, monkeypatch, cons)
    assert len(calls) > 60
    n_fused = len(calls)
    b = _port_nj(codes, _opts(**kw), False, monkeypatch, cons)
    assert len(calls) == n_fused
    assert a.join_log == b.join_log
    for name in ("parent", "children", "branchlength"):
        np.testing.assert_array_equal(getattr(a.tree, name),
                                      getattr(b.tree, name), err_msg=name)
    for name in ("diameter", "var_diameter", "selfdist", "selfweight",
                 "out_distances", "n_out_dist_active"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.totdiam == b.totdiam
    for name in ("codes", "W", "U", "w_out", "f_out"):
        assert torch.equal(getattr(a.prof, name), getattr(b.prof, name)), name
    if cons is not None:
        np.testing.assert_array_equal(a.con_on, b.con_on)
        np.testing.assert_array_equal(a.con_off, b.con_off)
    for name in COUNTERS:
        assert getattr(a.debug, name) == getattr(b.debug, name), name


def _pipeline(run_pipeline, fasta, kw, **extra):
    opts = _opts(verbose=2, **kw)
    if run_pipeline is tpipeline.run_pipeline:
        opts = _port(opts)
    out, log = io.StringIO(), io.StringIO()
    with open(fasta) as f:
        nj, _ = run_pipeline(opts, f, out, log_fp=log, **extra)
    stats = [line for line in log.getvalue().splitlines()
             if line.startswith(("Dist/N", "Top hits", " Hill-climb",
                                 "NNI:"))]
    return out.getvalue(), list(nj.join_log), stats


@pytest.mark.parametrize("mode", ["fastest", "2nd"])
def test_noml_newick_and_stats_match_jax(tmp_path, monkeypatch, mode):
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(60, 250, seed=23))
    kw = dict(MODES[mode], nni=4, spr=1)
    nw_t, joins_t, stats_t = _pipeline(tpipeline.run_pipeline, fasta, kw,
                                       device=CPU)
    nw_j, joins_j, _ = _pipeline(jpipeline.run_pipeline, fasta, kw)
    assert joins_t == joins_j
    assert nw_t == nw_j
    monkeypatch.setattr(jnj_mod, "USE_FUSED_JOIN", False)
    nw_u, _, stats_u = _pipeline(jpipeline.run_pipeline, fasta, kw)
    assert nw_u == nw_j
    assert len(stats_t) == 4 and stats_t == stats_u
