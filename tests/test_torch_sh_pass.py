"""The SH-like supports pass (ops/ml_round.sh_pass: list launches over all
splits; on the CPU the same launches on the plain twins) against the port's
host loop engine/ml.test_splits_ml and against the JAX package's, and the
pieces it is made of: the list twins of ml_pair_loglk and ml_posterior past
the card's old caps (256 pairs, 128 posteriors a launch), the level-wise
up-profiles, and the bootstrap counts.

The engines start from one NJ tree with ME lengths (N=36, P=200, numpy
seeds; the port loads the JAX package's checkpoint where both run), each
with an ML store under Jukes-Cantor or GTR, four CAT rates and 100
resamples.  Tolerances:

* against the port's host loop, within 1e-12: the per-split log-likelihoods
  (AB, AC, AD), the per-site likelihoods of the AB pairs and of the last AC
  and AD optimizations, choices, bad splits, SplitCount, supports and the
  debug counters.  Both sides run the same twins on the same float32 and
  float64 inputs; they agree bit for bit here (held with rtol 1e-12, where
  an ulp of a float32 per-site log in another vector lane would read 6e-11);
* against the JAX package (both from the JAX package's branch lengths, so
  that the quartets start alike): the SplitCount's counts and the debug
  counters equal, its worst delta within 2e-2 (the quartet criteria
  tolerance of tests/test_torch_ml_round.py); the supports within 0.02, and
  within 0.054 on branches at the minimum length, whose three topologies tie
  (ROADMAP.md, Queue 3);
* the list twins at K=300 (pairs) and K=200 (posteriors) against K=1 calls:
  equal (a twin's arithmetic is elementwise per item; the card holds the
  kernels to the same, tests/test_torch_cuda.py);
* the level-wise up-profile rows against the lazy UpProfiles.get's: equal;
* the bootstrap counts: the serial stream (a cycle's recurrence 37 values
  wide from the state, its first 100 values the draws) and the kernel's
  chunks (chip_smoke.resample_replay: each warp's chunk from the start
  state resample_kernels.chunk_states gives it, its recurrence 32 values
  a step as the kernel's warp runs it), replayed in numpy, against
  resample_count_matrix(resample_columns(...)): equal, at shapes whose
  draws end inside a cycle and on its edge, and with chunk boundaries inside
  a resample; the start states equal KnuthRandom's state after that many
  cycles, for chunks of several lengths, one that does not divide the
  cycle count; the plan's chunks cover every range's cycles and its
  histogram fits.

About 25 s in one process.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (resample_replay, sh_diff, sh_host_loop, sh_run,
                        sh_state)
from test_torch_quartet import one_torch_thread  # noqa: F401
from util import simulate_alignment

from veryfasttree_tpu.engine import ml as jml
from veryfasttree_tpu.engine import rearrange as jrearrange
from veryfasttree_tpu.engine.checkpoint import save_checkpoint
from veryfasttree_tpu.engine.ml_profiles import MLProfiles as JMLStore
from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
from veryfasttree_tpu.io.alignment import seqs_to_codes
from veryfasttree_tpu.models import TransitionMatrix
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles as TMLStore
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
from veryfasttree_tpu_torch.engine.supports import (resample_columns,
                                                    resample_count_matrix)
from veryfasttree_tpu_torch.models import TransitionMatrix as TTransitionMatrix
from veryfasttree_tpu_torch.ops import ml_kernels as mk
from veryfasttree_tpu_torch.ops import ml_round, resample_kernels
from veryfasttree_tpu_torch.options import Options as TOptions
from veryfasttree_tpu_torch.utils.knuth import KnuthRandom

GTR = ([1.2, 3.1, 0.8, 1.1, 2.9, 1.0], [0.3, 0.2, 0.24, 0.26])
N, P, BOOT = 36, 200, 100
SUPPORT_TOL, FLOOR_SUPPORT_TOL = 0.02, 0.054
CRITERIA_TOL = 2e-2


def _engines(tmp_path, model, jax=True):
    """(JAX engine or None, port engine) on one NJ tree with ME lengths,
    each with an ML store under `model`, four CAT rates and recomputed
    posteriors; the port's engine loads the JAX engine's checkpoint, or
    without jax builds the tree itself."""
    opts = Options(n_codes=4, show_progress=False, n_bootstrap=BOOT)
    opts.derive_settings()
    codes = seqs_to_codes(simulate_alignment(N, P, seed=17, mutation=0.12,
                                             gap_frac=0.04), opts)
    tm = None if model == "jc" else TransitionMatrix.gtr(*GTR)
    ttm = None if model == "jc" else TTransitionMatrix.gtr(*GTR)
    tnj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, ttm,
              device=torch.device("cpu"))
    if jax:
        jnj = JNJ(opts, codes, None, tm)
        jnj.fast_nj()
        jrearrange.update_branch_lengths(jnj)
        path = str(tmp_path / f"nj_{model}.npz")
        save_checkpoint(jnj, path, {"phase": "nj"})
        with np.load(path) as z:
            tnj.load_state({k: z[k] for k in z.files})
        engines = ((jnj, tm, JMLStore), (tnj, ttm, TMLStore))
    else:
        tnj.fast_nj()
        trearrange.update_branch_lengths(tnj)
        engines = ((tnj, ttm, TMLStore),)
    rates = jml.ml_site_rates(4)
    cats = (np.arange(tnj.n_pos) * 7) % 4
    for nj, t, store in engines:
        nj.ml = store(nj, t)
        nj.ml.set_rates(rates, cats)
        nj.ml.recompute_ml_profiles()
    return (jnj if jax else None), tnj


def _copy(nj):
    """nj with a tree, counters and ML store of its own (CPU)."""
    import chip_smoke

    return chip_smoke.ml_copy(nj, torch.device("cpu"))


def _close(a, b, what):
    for k in a:
        x, y = np.asarray(a[k], dtype=np.float64), \
            np.asarray(b[k], dtype=np.float64)
        assert x.shape == y.shape, (what, k)
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_sh_pass_is_the_host_loop(tmp_path, model):
    _, start = _engines(tmp_path, model, jax=False)
    tml.optimize_all_branch_lengths(start)
    states = {}
    for name in ("pass", "host loop"):
        nj = _copy(start)
        sc, record = sh_run(nj)[:2] if name == "pass" else sh_host_loop(nj)
        states[name] = sh_state(nj, sc, record)
    a, b = states["pass"], states["host loop"]
    _close(a, b, model)
    assert not sh_diff(a, b), sh_diff(a, b)             # and bit for bit
    nj = _copy(start)                    # sh_pass leaves what the pass did
    assert dataclasses.astuple(ml_round.sh_pass(nj)) == \
        tuple(a["split_count"])
    assert nj.tree.support[a["nodes"]].tobytes() == a["support"].tobytes()
    assert [nj.debug.n_lk_compute, nj.debug.n_posterior_compute] == \
        a["counters"].tolist()
    n_split = len(a["nodes"])
    assert n_split == N - 3
    assert 0 < a["bad"].sum() < n_split               # both outcomes seen
    assert 0 < np.count_nonzero(a["support"]) < n_split


def test_sh_pass_matches_jax(tmp_path):
    jnj, tnj = _engines(tmp_path, "jc")
    jml.optimize_all_branch_lengths(jnj)
    tnj.tree.branchlength[:] = jnj.tree.branchlength
    tnj.ml.recompute_ml_profiles()
    jnj.ml.recompute_ml_profiles()
    for nj in (jnj, tnj):
        nj.debug.n_lk_compute = nj.debug.n_posterior_compute = 0
    jsc = jml.test_splits_ml(jnj)
    tsc = ml_round.sh_pass(tnj)
    assert (tsc.n_splits, tsc.n_bad_splits) == \
        (jsc.n_splits, jsc.n_bad_splits)
    assert abs(tsc.d_worst_delta_unconstrained
               - jsc.d_worst_delta_unconstrained) <= CRITERIA_TOL
    for k in ("n_lk_compute", "n_posterior_compute"):
        assert getattr(tnj.debug, k) == getattr(jnj.debug, k), k
    tree = tnj.tree
    nodes = [n for n in range(tnj.n_seqs, tree.maxnode)
             if n != tree.root and tree.n_child[n] == 2]
    at_floor = tree.branchlength[nodes] <= 6e-4
    err = np.abs(tree.support[nodes] - jnj.tree.support[nodes])
    assert np.all(err <= np.where(at_floor, FLOOR_SUPPORT_TOL, SUPPORT_TOL)), \
        (err, at_floor)
    assert np.count_nonzero(tree.support[nodes]) > 0


@pytest.mark.parametrize("model", ["jc", "gtr"])
def test_list_twins_past_the_old_caps(model):
    """chip_smoke.py's random ML store (leaf rows with gaps, posterior rows
    with fractional weights, 20 CAT rates), at 600 rows of P=200."""
    from chip_smoke import ml_store_case

    gen = torch.Generator().manual_seed(5)
    store = ml_store_case(4, model, gen, torch.device("cpu"), n_rows=600,
                          P=P, n_pos=P - 8, n_leaf=300)
    rng = np.random.default_rng(3)
    r1, r2 = rng.integers(0, 400, 300), rng.integers(0, 400, 300)
    lens = rng.uniform(0.0, 0.5, 300)
    ll, lk = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True)
    for k in range(300):
        one_ll, one_lk = mk.ml_pair_loglk(*store, r1[k:k + 1], r2[k:k + 1],
                                          lens[k:k + 1], want_lk=True)
        assert one_ll.numpy().tobytes() == ll[k:k + 1].numpy().tobytes(), k
        assert one_lk.numpy().tobytes() == lk[k:k + 1].numpy().tobytes(), k
    targets = np.arange(400, 600)
    post = (r1[:200], r2[:200], lens[:200] + 5e-4, lens[100:] + 5e-4)
    mk.ml_posterior(*store, targets, *post)
    rows = [t[targets].clone() for t in store[:3]]
    for k in range(200):
        mk.ml_posterior(*store, targets[k:k + 1],
                        *(v[k:k + 1] for v in post))
    for got, want in zip((t[targets] for t in store[:3]), rows):
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_up_profile_levels_are_the_lazy_rows(tmp_path):
    _, start = _engines(tmp_path, "gtr", jax=False)
    nodes = np.array([n for n in start.tree.postorder_nodes()
                      if n >= start.n_seqs and n != start.tree.root])
    levels = ml_round._up_levels(start, nodes)
    swept, lazy = _copy(start), _copy(start)
    swept.ml.posterior_sweep(levels)
    ups = trearrange.UpProfiles(lazy)
    targets = np.concatenate([lv[0] for lv in levels])
    for row in targets:
        ups.get(int(row) - start.tree.maxnodes, use_ml=True)
    assert len(levels) > 2 and len(targets) > 10
    for k in ("codes", "W", "V"):
        got = getattr(swept.ml, k)[targets].numpy()
        want = getattr(lazy.ml, k)[targets].numpy()
        assert got.tobytes() == want.tobytes(), k


def _kernel_counts(n_pos, n_boot):
    """The serial stream, replayed in numpy: from the state, each cycle's
    draws are its first 100 values, and the next state comes from a[j] =
    a[j - 100] - a[j - 37] mod 2^30, 37 values at a time."""
    a = np.zeros(1109, dtype=np.int64)
    a[:100] = resample_kernels.knuth_state()
    counts = np.zeros((n_pos, n_boot), dtype=np.int64)
    n_draws = n_pos * n_boot
    for base in range(0, n_draws, 100):
        d = np.arange(base, min(base + 100, n_draws))
        u = 9.31322574615479e-10 * a[:len(d)].astype(np.float64)
        col = np.clip((u * n_pos).astype(np.int64), 0, n_pos - 1)
        np.add.at(counts, (col, d // n_pos), 1)
        for j in range(100, 1109, 37):
            hi = min(j + 37, 1109)
            a[j:hi] = (a[j - 100:hi - 100] - a[j - 37:hi - 37]) & ((1 << 30) - 1)
        a[:100] = a[1009:1109]
    return counts.astype(np.float64)


@pytest.mark.parametrize("n_pos,n_boot", [(37, 3), (200, 100), (50, 2),
                                          (101, 7)])
def test_resample_counts(n_pos, n_boot):
    nj = SimpleNamespace(n_pos=n_pos,
                         options=SimpleNamespace(n_bootstrap=n_boot))
    want = resample_count_matrix(resample_columns(nj), n_pos)
    np.testing.assert_array_equal(_kernel_counts(n_pos, n_boot), want)
    got = resample_kernels.sh_resample_counts(n_pos, n_boot, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() == n_pos * n_boot
    # the draws use the first 100 values of each cycle: the state itself
    rng = KnuthRandom()
    first = [rng.next_int() for _ in range(100)]
    assert first == resample_kernels.knuth_state().tolist()


@pytest.mark.parametrize("T", [1, 3, 7, 10])
def test_chunk_states_are_the_stream(T):
    """knuth_states after c T cycles (jump-ahead by powers of the cycle's
    matrix) against KnuthRandom run cycle by cycle: 23 cycles, which 3, 7
    and 10 do not divide."""
    n_cycles = 23
    rng = KnuthRandom(resample_kernels.SEED)
    stream = [rng._x.copy()]
    for _ in range(n_cycles):
        rng._ran_array(1009)
        stream.append(rng._x.copy())
    starts = np.arange(0, n_cycles + 1, T)
    got = resample_kernels.knuth_states(starts)
    np.testing.assert_array_equal(got, np.array(stream)[starts])
    # the cycle's matrix, one step: M s mod 2^30
    M = resample_kernels.cycle_matrix()
    s0 = np.array(stream[0], dtype=np.uint64)
    step = (M.astype(np.uint64) @ s0) & np.uint64(resample_kernels.MASK)
    np.testing.assert_array_equal(step.astype(np.int64), stream[1])


@pytest.mark.parametrize("n_pos,n_boot,n_sms",
                         [(37, 3, 132), (200, 100, 132), (50, 2, 132),
                          (101, 7, 132), (101, 7, 1), (333, 40, 4)])
def test_chunked_resample_counts(n_pos, n_boot, n_sms):
    """The kernel's chunks replayed in numpy equal the twin; with few
    multiprocessors (n_sms 1, 4) ranges hold several resamples and several
    chunks, whose boundaries fall inside resamples."""
    plan = resample_kernels.resample_plan(n_pos, n_boot, n_sms)
    nj = SimpleNamespace(n_pos=n_pos,
                         options=SimpleNamespace(n_bootstrap=n_boot))
    want = resample_count_matrix(resample_columns(nj), n_pos)
    np.testing.assert_array_equal(resample_replay(n_pos, n_boot, n_sms),
                                  want)
    k0, _ = plan.cycle_ranges()
    starts = (k0[:, None] + plan.T * np.arange(plan.W)).reshape(-1)
    np.testing.assert_array_equal(
        resample_kernels.chunk_states(plan).reshape(-1, 100),
        resample_kernels.knuth_states(starts))
    if n_sms < 132:
        inside = (100 * starts) % n_pos != 0
        assert plan.W > 1 and inside[1:].any()


@pytest.mark.parametrize("n_pos,n_boot", [(37, 3), (500, 1000), (5000, 1000),
                                          (20000, 1000), (100000, 1000)])
def test_resample_plan_covers_the_draws(n_pos, n_boot):
    """Every range's cycles lie in its W chunks of T; the [S, R] histogram
    and the warps' rings fit the kernel's shared memory; the slabs cover
    the columns."""
    plan = resample_kernels.resample_plan(n_pos, n_boot, 132)
    k0, k1 = plan.cycle_ranges()
    assert len(k0) == -(-n_boot // plan.R)
    assert ((k1 - k0) <= plan.W * plan.T).all()
    assert 1 <= plan.W <= resample_kernels.MAX_WARPS
    assert 4 * plan.S * plan.R <= resample_kernels.HIST_BYTES
    assert 4 * (plan.S * plan.R + 256 * plan.W) <= 227 * 1024
    assert -(-n_pos // plan.S) * plan.S >= n_pos
    assert plan.S == n_pos or plan.R == 1


def test_postorder_is_the_tree_walk(tmp_path):
    _, nj = _engines(tmp_path, "jc", jax=False)
    assert ml_round._postorder(nj.tree) == list(nj.tree.postorder_nodes())
