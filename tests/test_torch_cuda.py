"""The port on a CUDA device: kernels against their plain twins, and the
pipeline against its CPU run.  Every test carries the `cuda` marker and
skips where there is no CUDA device.  This file imports no jax, so it runs
on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and the twins both accumulate in float64, in
different orders, so values agree to rtol 1e-12 (atol 1e-12 near zero) and
the best index exactly (duplicated rows force an exact tie).  The pipeline
on the card must give the CPU run's topology (RF 0).
"""
import io

import numpy as np
import pytest
import torch

from util import rf_distance, simulate_alignment

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _dense(gen, M=1024, P=256, C=4):
    W = torch.rand((M, P), generator=gen) * 0.7 + 0.3
    W[10:12] = 0.0
    f = torch.rand((M, P, C), generator=gen)
    U = W[..., None] * (f / f.sum(-1, keepdim=True))
    outd = torch.rand(M, generator=gen, dtype=torch.float64)
    for r in (700, 900, M - 3):
        U[r], W[r] = U[40], W[40]
    outd[[40, 700, 900]] = 60.0
    outd[M - 3] = 120.0
    return (U.reshape(M, -1), W, U[9].double().reshape(-1), W[9].double(),
            outd, 300, M - 8, False)


def _codes(gen, L=3000, P=256, C=4):
    codes = torch.randint(0, C, (L, P), generator=gen, dtype=torch.int8)
    codes[torch.rand((L, P), generator=gen) < 0.05] = 127
    codes[10:12] = 127
    outd = torch.rand(L, generator=gen, dtype=torch.float64)
    for r in (1700, 2500, L - 3):
        codes[r] = codes[40]
    outd[[40, 1700, 2500]] = 60.0
    outd[L - 3] = 120.0
    G = torch.rand((C, P), generator=gen, dtype=torch.float64)
    wq = torch.rand(P, generator=gen, dtype=torch.float64)
    return codes, G, wq, outd, 300, L - 8, False


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dense", "codes"])
def test_scan_kernel_matches_twin(cuda, which):
    from veryfasttree_tpu_torch.ops import scan_kernels as sk

    gen = torch.Generator().manual_seed(0)
    if which == "dense":
        args, kernel, twin = _dense(gen), sk.nj_scan_dense, sk.nj_scan_ref
    else:
        args, kernel, twin = _codes(gen), sk.nj_scan_codes, \
            sk.nj_scan_codes_ref
    ref = twin(*args)
    before = kernel.launches
    got = kernel(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert int(got[0]) == int(ref[0]) == 40
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), **TOL)


def _store(gen, leaf_rows, n_rows=1024, P=256, C=4):
    codes = torch.randint(0, C, (n_rows, P), generator=gen, dtype=torch.int8)
    codes[torch.rand((n_rows, P), generator=gen) < 0.05] = 127
    codes[5] = 127
    n_float = n_rows - leaf_rows
    W = torch.rand((n_float, P), generator=gen) * 0.7 + 0.3
    W[torch.rand((n_float, P), generator=gen) < 0.05] = 0.0
    f = torch.rand((n_float, P, C), generator=gen)
    U = W[..., None] * (f / f.sum(-1, keepdim=True))
    return codes, W, U, torch.eye(C)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_rows", [0, 300])
def test_store_kernels_match_twins(cuda, leaf_rows):
    """me_dists to rtol 1e-12; me_average bit-identical (%different mode)."""
    from veryfasttree_tpu_torch.ops import store_kernels as st

    gen = torch.Generator().manual_seed(1)
    codes, W, U, cf = _store(gen, leaf_rows)
    rows = np.arange(0, 1024, 37)
    ii, jj = rows[:-1], rows[1:]
    q = (U[7], W[7])
    ref = st.me_dists_ref(codes, W, U, cf, None, leaf_rows, rows, *q, ii, jj)
    dev = [t.to(cuda) for t in (codes, W, U, cf)]
    got = st.me_dists(*dev, None, leaf_rows, rows, q[0].to(cuda),
                      q[1].to(cuda), ii, jj)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), **TOL)

    targets = np.arange(600, 700)
    srcs = (np.arange(0, 100) * 3, np.arange(300, 400))
    for bw in (0.5, 0.3):
        st.me_average_ref(codes, W, U, cf, None, leaf_rows, targets, *srcs,
                          bw, 1e-10)
        st.me_average(*dev, None, leaf_rows, targets, *srcs, bw, 1e-10)
        for a, b in zip(dev[:3], (codes, W, U)):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())

    # indices outside the store, or a target among the code-only leaves
    with pytest.raises(IndexError):
        st.me_dists(*dev, None, leaf_rows, [], None, None, [3], [1024])
    for target in [1024] + ([leaf_rows - 1] if leaf_rows else []):
        with pytest.raises(IndexError):
            st.me_average(*dev, None, leaf_rows, [target], [1], [2], 0.5,
                          1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("C,matrix,leaf_rows", [(4, False, 0), (4, False, 300),
                                                (20, True, 0)])
def test_me_list_and_sweep_kernels(cuda, C, matrix, leaf_rows):
    """me_dists_list: each pair bit for bit me_dists' single calls, and
    within TOL of the twin; me_average_sweep over three dependent levels:
    every row bit for bit the per-level me_average launches, and the twin's
    (rtol 1e-6 in matrix mode, as chip_smoke.check_average)."""
    from chip_smoke import store_case
    from veryfasttree_tpu_torch.ops import store_kernels as st

    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    codes, W, U, cf, ev, et = store_case(C, matrix, leaf_rows, gen, cuda,
                                         n_rows=1024, P=256)
    store = (codes, W, U, cf, ev, leaf_rows)
    rng = np.random.default_rng(C + leaf_rows)
    ii, jj = rng.integers(0, 1024, 1500), rng.integers(0, 1024, 1500)
    before = st.me_dists_list.launches
    got = st.me_dists_list(*store, ii, jj).cpu().numpy()
    assert st.me_dists_list.launches == before + 1
    one = st.me_dists(*store, [], None, None, ii, jj).cpu().numpy()
    np.testing.assert_array_equal(got, one)
    np.testing.assert_allclose(got, st.me_dists_list_ref(
        *store, ii, jj).cpu().numpy(), **TOL)
    with pytest.raises(IndexError):
        st.me_dists_list(*store, [3], [1024])

    rows = rng.permutation(np.arange(max(leaf_rows, 16), 1024))
    t0, t1, t2 = rows[:200], rows[200:260], rows[260:280]
    free = rows[280:]
    levels = [(t0, free[:200], rng.choice(np.r_[:max(leaf_rows, 16), free],
                                          200)),
              (t1, t0[:60], free[200:260]),
              (t2, t1[::3], t0[100:120])]
    levels[0][2][:5] = 5                        # NOCODE rows as sources
    tables = st.AverageTables.from_levels(levels)
    outs = []
    for run in ("sweep", "levels", "twin"):
        c, w, u = codes.clone(), W.clone(), U.clone()
        if run == "sweep":
            st.me_average_sweep(c, w, u, cf, et, leaf_rows, tables, 1e-10)
        elif run == "levels":
            for t, i, j in levels:
                st.me_average(c, w, u, cf, et, leaf_rows, t, i, j, 0.5, 1e-10)
        else:
            st.me_average_sweep_ref(c, w, u, cf, et, leaf_rows, tables,
                                    1e-10)
        outs.append([x.cpu().numpy() for x in (c, w, u)])
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][0], outs[2][0])
    tol = dict(rtol=1e-6, atol=1e-7) if matrix else dict(rtol=0, atol=0)
    for a, b in zip(outs[0][1:], outs[2][1:]):
        np.testing.assert_allclose(a, b, **tol)
    bad = st.AverageTables.from_levels([([1024], [0], [1])])
    with pytest.raises(IndexError):
        st.me_average_sweep(codes, W, U, cf, et, leaf_rows, bad, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("two_tier", [False, True])
def test_batched_split_test_on_cuda_is_the_serial_walk(cuda, two_tier):
    """The split test and the ME lengths through the sweep and the list
    kernels against the serial walks through the per-call kernels, on the
    card: the SplitCount, the counters and every branch length bit for
    bit."""
    from chip_smoke import engine_copy, spr_start
    from veryfasttree_tpu_torch.engine import batched, rearrange, supports

    start = spr_start(300, cuda, two_tier=two_tier)
    serial, batch = engine_copy(start, cuda), engine_copy(start, cuda)
    rearrange.update_branch_lengths(serial)
    batched.update_branch_lengths_batched(batch)
    m = start.tree.maxnode
    np.testing.assert_array_equal(batch.tree.branchlength[:m],
                                  serial.tree.branchlength[:m])
    want = supports.test_splits_min_evo(serial)
    got = supports.test_splits_min_evo_batched(batch)
    assert (got.n_bad_splits, got.n_splits) == (want.n_bad_splits,
                                                want.n_splits)
    assert got.d_worst_delta_unconstrained == want.d_worst_delta_unconstrained
    assert batch.debug == serial.debug


@pytest.mark.cuda
@pytest.mark.parametrize("C,matrix,leaf_rows", [(4, False, 0), (4, False, 300),
                                                (20, True, 0), (20, True, 300)])
def test_pieces_list_kernel_is_the_twin(cuda, C, matrix, leaf_rows):
    """me_dist_pieces_list: the pieces and weights bit for bit its twin's
    (the same float32 operations, csrc/me_store.cuh pieces_pos), one
    launch; a row outside the store raises before any launch."""
    from chip_smoke import store_case
    from veryfasttree_tpu_torch.ops import store_kernels as st

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    codes, W, U, cf, ev, _ = store_case(C, matrix, leaf_rows, gen, cuda,
                                        n_rows=1024, P=256)
    store = (codes, W, U, cf, ev, leaf_rows, 250)
    rng = np.random.default_rng(C + leaf_rows)
    ii, jj = rng.integers(0, 1024, 3000), rng.integers(0, 1024, 3000)
    before = st.me_dist_pieces_list.launches
    got = st.me_dist_pieces_list(*store, ii, jj)
    assert st.me_dist_pieces_list.launches == before + 1
    want = st.me_dist_pieces_list_ref(*store, ii, jj)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == (3000, 250)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    with pytest.raises(IndexError):
        st.me_dist_pieces_list(*store, [3], [1024])
    assert st.me_dist_pieces_list.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("two_tier", [False, True])
def test_local_bootstrap_list_is_the_serial_walk(cuda, two_tier):
    """The ME local bootstrap's whole-tree lists (chunks of 64 splits)
    against its serial walk of six-pair lists, on the card: every support
    and the count of suboptimal splits equal."""
    from chip_smoke import engine_copy, spr_start
    from veryfasttree_tpu_torch.engine import supports

    start = spr_start(300, cuda, two_tier=two_tier)
    start.options.n_bootstrap = 1000
    serial, listed = engine_copy(start, cuda), engine_copy(start, cuda)
    supports.reliability_nj(serial)
    stats = supports.reliability_nj_list(listed, chunk=64)
    m = start.tree.maxnode
    np.testing.assert_array_equal(listed.tree.support[:m],
                                  serial.tree.support[:m])
    assert listed.debug == serial.debug
    assert stats["splits"] == 297 and stats["launches"] == 5


def _ml_store(gen, C, jc, dev, model=None, approx=False):
    """chip_smoke.py's random ML store (leaf rows with gaps, posterior rows
    with weights 0, 1 and a few fractions, 20 CAT rates), at a small
    layout."""
    from chip_smoke import ml_store_case

    model = model or ("jc" if jc else ("jtt" if C == 20 else "gtr"))
    return ml_store_case(C, model, gen, dev, n_rows=1024, P=256, n_pos=250,
                         n_leaf=400, approx=approx)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["jtt", "lg"])
def test_posterior_gate_counts_are_the_twins(cuda, model):
    """ml_posterior at 20 codes with -approxml's rough-posterior gate, over
    200 items (leaf pairs at short lengths, where most positions take the
    rough path, and internal rows): the rows against the twin's on the
    same CUDA tensors (codes and weights equal, vectors within 1e-6), and
    the rough and exact counts equal, both nonzero; the exact path counts
    every position that is not both gaps as exact."""
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    gen = torch.Generator(device=cuda).manual_seed(11)
    store = _ml_store(gen, 20, False, cuda, model, approx=True)
    rng = np.random.default_rng(5)
    r1 = np.concatenate([rng.integers(0, 400, 150), rng.integers(400, 800, 50)])
    r2 = np.concatenate([rng.integers(0, 400, 150), rng.integers(0, 800, 50)])
    lens = np.concatenate([rng.uniform(5e-4, 0.05, 150),
                           rng.uniform(5e-4, 0.5, 50)])
    args = (np.arange(800, 1000), r1, r2, lens, lens[::-1].copy())
    m = store[3]
    ours = [t.clone() for t in store[:3]]
    mk.ml_posterior(*ours, m, *args)
    got = m.counts.clone()
    m.counts.zero_()
    mk.ml_posterior_ref(*store, *args)
    np.testing.assert_array_equal(ours[0].cpu().numpy(),
                                  store[0].cpu().numpy())
    np.testing.assert_array_equal(ours[1].cpu().numpy(),
                                  store[1].cpu().numpy())
    np.testing.assert_allclose(ours[2].cpu().numpy(), store[2].cpu().numpy(),
                               rtol=0, atol=1e-6)
    assert got.tolist() == m.counts.tolist()
    assert min(got.tolist()) > 0
    m.approx = False
    m.counts.zero_()
    mk.ml_posterior(*[t.clone() for t in store[:3]], m, *args)
    w = store[1][torch.as_tensor(np.concatenate([r1, r2]), device=cuda)]
    live = ((w[:200] > 0) | (w[200:] > 0)).sum().item()
    assert m.counts.tolist() == [0, live]


@pytest.mark.cuda
@pytest.mark.parametrize("C,jc", [(4, True), (4, False), (20, False)])
def test_ml_kernels_match_twins(cuda, C, jc):
    """ml_pair_loglk: ll and lk rtol 1e-6; ml_posterior: W, V atol 1e-6,
    codes equal; ml_opt_branch: x rtol 1e-4, -loglk at x atol 1e-3.  The
    twins run on the same CUDA tensors (the kernel and its twin round every
    float32 operation alike; sums differ in order only)."""
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    gen = torch.Generator(device=cuda).manual_seed(2 + C)
    store = _ml_store(gen, C, jc, cuda)
    rng = np.random.default_rng(C)
    r1, r2 = rng.integers(0, 1024, 40), rng.integers(0, 1024, 40)
    lens = rng.uniform(0.0, 0.5, 40)
    lens[:3] = (0.0, 5e-4, 6.0)
    ll, lk = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True)
    ll_t, lk_t = mk.ml_pair_loglk_ref(*store, r1, r2, lens, want_lk=True)
    np.testing.assert_allclose(ll.cpu().numpy(), ll_t.cpu().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(lk.cpu().numpy(), lk_t.cpu().numpy(),
                               rtol=1e-6, atol=1e-30)

    targets = np.arange(900, 940)
    args = (targets, r1 % 800, r2 % 800, lens + 5e-4, lens[::-1] + 5e-4)
    ours = [t.clone() for t in store[:3]]
    mk.ml_posterior(*ours, store[3], *args)
    mk.ml_posterior_ref(*store, *args)
    np.testing.assert_array_equal(ours[0].cpu().numpy(),
                                  store[0].cpu().numpy())
    for a, b in zip(ours[1:], store[1:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=0,
                                   atol=1e-6)

    guesses = np.concatenate([[5e-4, 9e-4, 0.1, 5.0], rng.uniform(0.01, 1, 8)])
    b1, b2 = r1[:12], r2[:12]
    opt = (b1, b2, guesses, 5e-4, 6.0, 1e-3, 1e-4)
    x, fx, n_eval = mk.ml_opt_branch(*store, *opt)
    x_t, fx_t, n_eval_t = mk.ml_opt_branch_ref(*store, *opt)
    np.testing.assert_allclose(x.cpu().numpy(), x_t.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(fx.cpu().numpy(), fx_t.cpu().numpy(), rtol=0,
                               atol=1e-3)
    assert (n_eval.cpu().numpy() > 3).all()

    with pytest.raises(IndexError):
        mk.ml_pair_loglk(*store, [3], [1024], [0.1])


@pytest.mark.cuda
@pytest.mark.parametrize("jc", [True, False])
@pytest.mark.parametrize("star_test,want_site_lk", [(True, False),
                                                    (False, True)])
def test_quartet_kernel_is_the_chain(cuda, jc, star_test, want_site_lk):
    """ml_quartet_opt equals, bit for bit, the chain of single-call kernels
    it fuses (quartet_chain on the store's rows 1000-1005), a K=1 launch
    equals its quartet's block of a K=40 launch, and the kernel leaves
    the store as it was."""
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    gen = torch.Generator(device=cuda).manual_seed(7)
    store = _ml_store(gen, 4, jc, cuda)
    rng = np.random.default_rng(3)
    rows4 = rng.integers(0, 900, (40, 4))
    lens = np.maximum(rng.uniform(0.0, 0.4, (40, 5)), 5e-4)
    args = (rows4, lens, range(1000, 1006), 5e-4, 6.0, 1e-3, 1e-4,
            star_test, want_site_lk)
    before = [t.clone() for t in store[:3]]
    rec, lk = mk.ml_quartet_opt(*store, *args)
    for a, b in zip(store[:3], before):
        assert torch.equal(a, b)
    rec_c, lk_c = mk.quartet_chain(mk.ml_posterior, mk.ml_opt_branch,
                                   mk.ml_pair_loglk, *store, *args)
    assert rec.tobytes() == rec_c.tobytes()
    if want_site_lk:
        np.testing.assert_array_equal(lk, lk_c)
    one = mk.ml_quartet_opt(*store, rows4[5:6], lens[5:6], *args[2:])
    assert one[0].tobytes() == rec[5:6].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("start_kw,tree_in_smem", [
    ({}, True), ({"two_tier": True}, True), ({}, False),
    ({"protein": True}, True), ({"protein": True}, False)],
    ids=["dense", "two-tier", "dense-tree-in-device-memory", "protein",
         "protein-tree-in-device-memory"])
def test_spr_round_kernel_is_the_host_loop(cuda, start_kw, tree_in_smem):
    """One SPR round at N=150 from one NJ start (chip_smoke.py's): through
    the host loop with the per-call kernels, and through one launch of the
    round kernel: the same tree, counters and node rows, bit for bit.  The
    cases cover the kernel's variants: a dense and a two-tier store, 4 codes
    and 20 under BLOSUM45 (matrix mode, the protein -noml run), the tree in
    shared memory and in device memory (its layout above about 4,000
    nodes)."""
    from chip_smoke import engine_copy, spr_diff, spr_start, spr_state
    from veryfasttree_tpu_torch.engine import spr
    from veryfasttree_tpu_torch.ops import spr_kernels

    start = spr_start(150, cuda, **start_kw)
    states = []
    for run in (spr.run_spr, spr_kernels.spr_round):
        nj = engine_copy(start, cuda)
        before = spr_kernels.spr_round.launches
        if run is spr.run_spr:
            run(nj, 0, 2)
        else:
            run(nj, 0, 2, tree_in_smem=tree_in_smem)
            assert spr_kernels.spr_round.launches == before + 1
        torch.cuda.synchronize()
        states.append(spr_state(nj))
    assert states[0][1]["n_spr"] > 0
    assert spr_diff(*states) == (None, 0.0)


@pytest.mark.cuda
def test_spr_round_kernel_bionj(cuda):
    """-bionj: the BIONJ weights of the profile averages pass through
    log1p, which the card and numpy may round differently in the last bit,
    so the kernel's round gives the host loop's tree and counters and its
    node rows within 1e-6 (the JAX package's tier for its device round)."""
    from chip_smoke import engine_copy, spr_diff, spr_state, synth_codes
    from veryfasttree_tpu_torch.engine import spr
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.ops import spr_kernels
    from veryfasttree_tpu_torch.options import noml_options

    start = NeighbourJoining(noml_options(bionj=True), synth_codes(150, 500),
                             None, None, device=cuda)
    start.fast_nj()
    states = []
    for run in (spr.run_spr, spr_kernels.spr_round):
        nj = engine_copy(start, cuda)
        run(nj, 0, 2)
        torch.cuda.synchronize()
        states.append(spr_state(nj))
    assert states[0][1]["n_spr"] > 0
    what, err = spr_diff(*states)
    assert what in (None, "rows") and err <= 1e-6, (what, err)


def _nni_rounds(start, dev, rounds, kernel, **kw):
    """`rounds` ME NNI rounds from a copy of `start`, the NNIStats carried
    over: through the round kernel (one launch each) or the host loop with
    the per-call kernels.  Returns chip_smoke.nni_state of the last."""
    from chip_smoke import engine_copy, nni_state
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import nni_kernels

    nj = engine_copy(start, dev)
    stats = rearrange.NNIStats.init(nj)
    for i in range(rounds):
        before = nni_kernels.nni_round.launches
        if kernel:
            result = nni_kernels.nni_round(nj, i, rounds, stats, **kw)
            assert nni_kernels.nni_round.launches == before + 1
        else:
            result = rearrange.do_nni(nj, i, rounds, False, stats)
    torch.cuda.synchronize()
    return nni_state(nj, stats, result)


@pytest.mark.cuda
@pytest.mark.parametrize("start_kw,tree_in_smem,rounds", [
    ({}, True, 1), ({"two_tier": True}, True, 1), ({}, False, 1),
    ({"protein": True}, True, 1), ({}, True, 3)],
    ids=["dense", "two-tier", "dense-tree-in-device-memory", "protein",
         "three-rounds"])
def test_nni_round_kernel_is_the_host_loop(cuda, start_kw, tree_in_smem,
                                           rounds):
    """ME NNI rounds at N=150 from one NJ start (chip_smoke.py's): through
    the host loop with the per-call kernels, and through one launch of the
    round kernel per round: the same tree, NNIStats ages, counters, n_nni
    and node rows, bit for bit, and the deltas, supports and max_delta
    within chip_smoke.NNI_DELTA_ATOL (log1p's last bit: 2.2e-16 measured
    on an H100).  The cases cover the kernel's
    variants: a dense and a two-tier store, 4 codes and 20 under BLOSUM45
    (matrix mode), the tree in shared memory and in device memory, and
    three rounds with the NNIStats carried over, whose third round takes
    the fast-NNI skip set (ages reach 2 after two rounds)."""
    from chip_smoke import NNI_DELTA_ATOL, nni_diff, spr_start

    start = spr_start(150, cuda, **start_kw)
    host = _nni_rounds(start, cuda, rounds, False)
    kern = _nni_rounds(start, cuda, rounds, True, tree_in_smem=tree_in_smem)
    assert host[1]["n_nni"] > 0
    what, err, gap = nni_diff(host, kern)
    assert what is None and err == 0.0 and gap <= NNI_DELTA_ATOL, \
        (what, err, gap)


@pytest.mark.cuda
def test_nni_round_kernel_bionj(cuda):
    """-bionj: the BIONJ weights of the profile averages pass through
    log1p, which the card and numpy may round differently in the last bit,
    so the kernel's round gives the host loop's tree, ages and counters, and
    its node rows, deltas and supports within 1e-6 (the tier of the CPU
    tests against the JAX package)."""
    from chip_smoke import nni_diff, synth_codes
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.options import noml_options

    start = NeighbourJoining(noml_options(bionj=True), synth_codes(150, 500),
                             None, None, device=cuda)
    start.fast_nj()
    host = _nni_rounds(start, cuda, 1, False)
    kern = _nni_rounds(start, cuda, 1, True)
    assert host[1]["n_nni"] > 0
    what, err, gap = nni_diff(host, kern)
    assert what in (None, "rows") and err <= 1e-6 and gap <= 1e-6, \
        (what, err, gap)


@pytest.mark.cuda
def test_ml_pipeline_on_cuda_matches_cpu(cuda):
    """The default -nt run (ML NNIs, CAT, SH supports with 100 resamples):
    the card's tree has the CPU run's topology."""
    from veryfasttree_tpu_torch.options import ml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    fasta = "".join(f">seq{i:05d}\n{s}\n"
                    for i, s in enumerate(simulate_alignment(30, 200, seed=8)))

    def run(device):
        out = io.StringIO()
        run_pipeline(ml_options(n_bootstrap=100), io.StringIO(fasta), out,
                     device=device)
        return out.getvalue()

    rf, _ = rf_distance(run(cuda), run(torch.device("cpu")))
    assert rf == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ml_nni", [0, -1], ids=["noml", "ml"])
def test_threads_pipeline_on_cuda_matches_cpu(cuda, ml_nni):
    """-threads 4 (the batched tier): the card's -noml Newick is the CPU
    run's byte for byte, the default run's topology the CPU run's (RF 0);
    neither launches a serial round kernel."""
    from veryfasttree_tpu_torch.ops import ml_round, nni_kernels, spr_kernels
    from veryfasttree_tpu_torch.options import ml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    fasta = "".join(f">seq{i:05d}\n{s}\n"
                    for i, s in enumerate(simulate_alignment(60, 250, seed=7)))
    rounds = (nni_kernels.nni_round, spr_kernels.spr_round,
              ml_round.ml_nni_round, ml_round.ml_lengths_pass)

    def run(device):
        out = io.StringIO()
        run_pipeline(ml_options(ml_nni=ml_nni, n_bootstrap=100, threads=4),
                     io.StringIO(fasta), out, device=device)
        return out.getvalue()

    before = [fn.launches for fn in rounds]
    card = run(cuda)
    assert [fn.launches for fn in rounds] == before
    cpu = run(torch.device("cpu"))
    if ml_nni == 0:
        assert card == cpu
    else:
        assert rf_distance(card, cpu)[0] == 0


@pytest.mark.cuda
def test_device_length_lists_are_the_host_lists(cuda):
    """ml_posterior and ml_opt_branch with bl= (lengths read and written on
    the card) bit for bit the same lists fed the same lengths from the
    host."""
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.io.alignment import seqs_to_codes
    from veryfasttree_tpu_torch.ops import ml_kernels as mk
    from veryfasttree_tpu_torch.options import ml_options

    opts = ml_options()
    nj = NeighbourJoining(opts, seqs_to_codes(simulate_alignment(
        80, 300, seed=4), opts), None, None, device=cuda)
    nj.fast_nj()
    rearrange.update_branch_lengths(nj)
    nj.ml = MLProfiles(nj, None)
    nj.ml.recompute_ml_profiles()
    ml, tree = nj.ml, nj.tree
    nodes = np.array([n for n in range(nj.n_seqs, tree.maxnode)
                      if n != tree.root and tree.n_child[n] == 2])
    kids, targets = tree.children[nodes], ml.scratch_rows_for(len(nodes))
    lims = (opts.ml_min_branch_length, 6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance)
    lens = tree.branchlength[: tree.maxnodes].astype(np.float32)
    lo = np.float32(ml.min_len)
    out = []
    for at in (True, False):
        if at:
            bl = ml.lengths_tensor(lens)
            mk.ml_posterior(*ml._store(), targets, kids[:, 0], kids[:, 1],
                            kids[:, 0], kids[:, 1], bl=bl, lo=float(lo))
            mk.ml_opt_branch(*ml._store(), kids[:, 0], targets, kids[:, 0],
                             *lims, bl=bl)
            got = bl.cpu().numpy()
        else:
            mk.ml_posterior(*ml._store(), targets, kids[:, 0], kids[:, 1],
                            np.maximum(lens[kids[:, 0]], lo),
                            np.maximum(lens[kids[:, 1]], lo))
            x, _, _ = mk.ml_opt_branch(*ml._store(), kids[:, 0], targets,
                                       np.maximum(lens[kids[:, 0]], lo),
                                       *lims)
            got = lens.copy()
            got[kids[:, 0]] = x.cpu().numpy()
        out.append((got, ml.V[targets].cpu().numpy()))
    (bl_at, v_at), (bl_host, v_host) = out
    assert bl_at.tobytes() == bl_host.tobytes()
    assert v_at.tobytes() == v_host.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("two_tier_min", [20000, 0])
def test_pipeline_on_cuda_matches_cpu(cuda, two_tier_min):
    from veryfasttree_tpu_torch.options import noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    fasta = "".join(f">seq{i:05d}\n{s}\n"
                    for i, s in enumerate(simulate_alignment(60, 250, seed=5)))

    def run(device):
        out = io.StringIO()
        run_pipeline(noml_options(two_tier_min=two_tier_min),
                     io.StringIO(fasta), out, device=device)
        return out.getvalue()

    rf, _ = rf_distance(run(cuda), run(torch.device("cpu")))
    assert rf == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {}, {"two_tier": True}, {"protein": True}, {"bionj": True},
    {"max_joins": 10}, {"grid": 1}, {"state_in_smem": False},
    {"lists_in_smem": False}, {"state_in_smem": False, "lists_in_smem": False},
    {"protein": True, "lists_in_smem": False}],
    ids=["dense", "two-tier", "protein", "bionj", "max-joins", "one-block",
         "state-in-device-memory", "lists-in-device-memory",
         "all-in-device-memory", "protein-lists-in-device-memory"])
def test_join_epoch_kernel_is_the_host_loop(cuda, kw):
    """The NJ phase at N=150 (chip_smoke.py's phase 2d): its joins through
    the epoch kernel and through the host loop with the per-call kernels
    leave every array bit for bit alike: the join log and tree, branch
    lengths, diameters, self-distances, out-distances and their n_active,
    the store rows and out-profile, the top-hits lists, visible and
    top-visible sets and ages, and the debug counters.  The cases cover a
    dense and a two-tier store, 4 codes and 20 under BLOSUM45, -bionj, the
    max_joins stop, one block against the full grid (the default), the
    decisions' per-node arrays in device memory (their layout past N of
    about 2,300) against shared memory (the default), and the deciding
    warp's small lists in device memory (their layout where they do not fit
    beside the per-node arrays), alone and with the per-node arrays."""
    from chip_smoke import epoch_diff, epoch_run, epoch_state
    from veryfasttree_tpu_torch.ops import epoch_kernels

    host_kw = {k: v for k, v in kw.items()
               if k not in ("grid", "state_in_smem", "lists_in_smem")}
    host = epoch_state(epoch_run(150, cuda, kernel=False, **host_kw))
    before = epoch_kernels.join_epoch.launches
    kern = epoch_state(epoch_run(150, cuda, **kw))
    assert epoch_kernels.join_epoch.launches > before
    assert len(host["join_log"]) == kw.get("max_joins", 147)
    assert epoch_diff(host, kern) == []


@pytest.mark.cuda
def test_bionj_rows_on_cuda_match_cpu(cuda):
    """-nt -noml -nosupport -bionj at N=60 (tests/test_torch_slice.py's
    case, which holds the CPU run to the JAX package's): on the card the
    same Newick and joins, and after four joins the profile rows of the
    store bit for bit the CPU run's (the averages round alike in both)."""
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
    from veryfasttree_tpu_torch.io.alignment import seqs_to_codes
    from veryfasttree_tpu_torch.options import noml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    seqs = simulate_alignment(60, 240, seed=11)
    fasta = "".join(f">seq{i:05d}\n{s}\n" for i, s in enumerate(seqs))

    def run(device):
        out = io.StringIO()
        nj, _ = run_pipeline(noml_options(bionj=True), io.StringIO(fasta),
                             out, device=device)
        return out.getvalue(), list(nj.join_log)

    (nw_card, joins_card), (nw_cpu, joins_cpu) = run(cuda), run(
        torch.device("cpu"))
    assert nw_card == nw_cpu
    # the same joins; an exact tie of a join's two orientations may break
    # the other way, as the two sum their distances in other orders
    assert [tuple(sorted(j)) for j in joins_card] == \
        [tuple(sorted(j)) for j in joins_cpu]
    opts = noml_options(bionj=True)
    rows = []
    for device in (cuda, torch.device("cpu")):
        nj = NeighbourJoining(opts, seqs_to_codes(seqs, opts), None, None,
                              device=device)
        nj.fast_nj(max_joins=4)
        rows.append([getattr(nj.prof, k)[60:64].cpu().numpy()
                     for k in ("W", "U")])
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)


def _ml_runs(start, dev, rounds, kernel, **kw):
    """An ML lengths pass, then `rounds` ML NNI rounds with the NNIStats
    carried over, from a copy of `start`: through the round kernels (one
    launch each) or the host loops with the per-call kernels.  Returns
    chip_smoke.ml_state after the pass and after the last round."""
    from chip_smoke import ml_copy, ml_state
    from veryfasttree_tpu_torch.engine import ml, rearrange
    from veryfasttree_tpu_torch.ops import ml_round

    nj = ml_copy(start, dev)
    stats = rearrange.NNIStats.init(nj)
    launches = (ml_round.ml_lengths_pass.launches,
                ml_round.ml_nni_round.launches)
    if kernel:
        ml_round.ml_lengths_pass(nj, **kw)
    else:
        ml.optimize_all_branch_lengths(nj)
    passed = ml_state(nj)
    for i in range(rounds):
        if kernel:
            result = ml_round.ml_nni_round(nj, i, rounds, stats, **kw)
        else:
            result = rearrange.do_nni(nj, i, rounds, True, stats)
    torch.cuda.synchronize()
    assert (ml_round.ml_lengths_pass.launches - launches[0],
            ml_round.ml_nni_round.launches - launches[1]) == \
        ((1, rounds) if kernel else (0, 0))
    return passed, ml_state(nj, stats, result)


@pytest.mark.cuda
@pytest.mark.parametrize("n,model,cat,tree_in_smem,rounds", [
    (150, "jc", False, True, 1), (150, "jc", True, True, 1),
    (150, "gtr", True, True, 1), (150, "jc", True, True, 3),
    (150, "jc", True, False, 1), (2000, "jc", False, True, 1)],
    ids=["jc-one-rate", "jc-cat20", "gtr-cat20", "three-rounds",
         "tree-in-device-memory", "main-path-n2000"])
def test_ml_round_kernels_are_the_host_loops(cuda, n, model, cat,
                                             tree_in_smem, rounds):
    """An ML lengths pass and ML NNI rounds from one NJ start with an ML
    store (chip_smoke.ml_start): through the round kernels
    (ml_lengths_pass, ml_nni_round, one launch each) and through the host
    loops with the per-call kernels: the same tree, branch lengths,
    NNIStats (deltas and supports included), debug counters, n_changes and
    max_delta, and every node and up-profile row of the ML store (codes,
    W, V), bit for bit.  The cases at N=150 cover one rate and 20 fitted
    CAT rates, Jukes-Cantor and GTR (matrix mode), three rounds with the
    NNIStats carried over (the third takes the fast-NNI skip set) and the
    tree in device memory; the case at the main path's N=2000 (P=512) the
    layout of the default run, asserted: the tree in block 0's shared
    memory, and no quartet piece of any of the cluster's three blocks in
    device scratch."""
    from chip_smoke import ml_diff, ml_start
    from veryfasttree_tpu_torch.ops import ml_round

    start = ml_start(n, cuda, model, cat)
    host = _ml_runs(start, cuda, rounds, False)
    kern = _ml_runs(start, cuda, rounds, True, tree_in_smem=tree_in_smem)
    for fn in (ml_round.ml_lengths_pass, ml_round.ml_nni_round):
        assert (fn.tree_layout, fn.scratch_floats) == (
            ("shared memory" if tree_in_smem else "device memory", 0))
    assert host[1][1]["n_ml_nni"] > 0
    for h, k in zip(host, kern):
        assert ml_diff(h, k) == []


@pytest.mark.cuda
@pytest.mark.parametrize("model,approx,tree_in_smem", [
    ("jtt", False, True), ("jtt", True, True), ("lg", True, False)],
    ids=["jtt", "jtt-approxml", "lg-approxml-tree-in-device-memory"])
def test_ml_round_kernels_at_20_codes_are_the_host_loops(cuda, model, approx,
                                                         tree_in_smem):
    """The round kernels at 20 codes (protein, CAT 20 rates, N=150, P=500):
    an ML lengths pass and an ML NNI round through ml_lengths_pass and
    ml_nni_round (one launch each) and through the host loops with the
    per-call kernels leave the same tree, lengths, NNIStats, debug
    counters, rough and exact posterior counts and store rows, bit for
    bit.  With the default groups of ml_round.GROUP blocks the quartet
    temporaries lie in the group blocks' shared memory: no device
    scratch."""
    from chip_smoke import ml_diff, ml_start
    from veryfasttree_tpu_torch.ops import _build, ml_round

    start = ml_start(150, cuda, model, cat=True, approx=approx)
    host = _ml_runs(start, cuda, 1, False)
    kern = _ml_runs(start, cuda, 1, True, tree_in_smem=tree_in_smem)
    P = start.ml.p_pad
    M = start.tree.maxnodes
    scratch = _build.library().vft_ml_round_scratch_floats(
        M, P, 20, int(tree_in_smem), ml_round.GROUP)
    assert scratch == 0
    for fn in (ml_round.ml_lengths_pass, ml_round.ml_nni_round):
        assert (fn.tree_layout, fn.scratch_floats) == (
            "shared memory" if tree_in_smem else "device memory", scratch)
    rough, exact = kern[1][1]["aa_counts"]
    assert exact > 0 and (rough > 0) == approx
    for h, k in zip(host, kern):
        assert ml_diff(h, k) == []


@pytest.mark.cuda
@pytest.mark.parametrize("group,p", [(1, 500), (2, 500), (4, 500),
                                     (4, 1000), (4, 1500)])
def test_ml_round_groups_at_20_codes_are_the_host_loops(cuda, group, p):
    """The 20-code round and pass with each quartet optimization's (each
    search's) positions over a group of 1, 2 or 4 blocks, at N=60 and
    P=512, where the parent's one-block workers kept their temporaries in
    device scratch, and with groups of 4 at P=1,000 (the temporaries in
    device scratch, the sums' values in shared memory) and P=1,500 (those
    values in device scratch too, the flag barrier): the tree, lengths,
    NNIStats, debug counters, rough and exact counts and store rows of one
    pass and one round are the host loops' with the per-call kernels, bit
    for bit, and the cluster is 1 + 3 groups (round) or 1 + 1 group (pass)
    of `group` blocks."""
    from chip_smoke import ml_diff, ml_start
    from veryfasttree_tpu_torch.ops import ml_round

    start = ml_start(60, cuda, "jtt", cat=True, p=p)
    assert start.ml.p_pad == (p + 127) // 128 * 128
    host = _ml_runs(start, cuda, 1, False)
    kern = _ml_runs(start, cuda, 1, True, group=group)
    assert ml_round.ml_nni_round.layout["blocks"] == 1 + 3 * group
    assert ml_round.ml_lengths_pass.layout["blocks"] == 1 + group
    for h, k in zip(host, kern):
        assert ml_diff(h, k) == []


@pytest.mark.cuda
def test_ml_round_20_codes_keeps_no_scratch_at_p512(cuda):
    """At P=512 (20 codes) a group of 2 or 4 blocks holds its share of the
    six quartet temporaries, the search vectors and the sums' values in
    its blocks' shared memory: no device scratch, round or pass, with the
    tree in shared or device memory; one block alone (the parent's
    workers' share) does not fit and takes device scratch."""
    from veryfasttree_tpu_torch.ops import ml_round

    for group in (2, 4):
        for lengths in (False, True):
            for smem_tree in (True, False):
                lay = ml_round.layout(1000, 512, 20, smem_tree, lengths,
                                      group)
                assert lay["scratch_floats"] == 0, lay
                assert lay["local_positions"] == 512 // group
                assert lay["group_smem_bytes"] <= 225 * 1024
    assert ml_round.layout(1000, 512, 20, True, False, 1)[
        "scratch_floats"] >= 3 * 6 * 512 * 21


@pytest.mark.cuda
def test_ml_round_refuses_a_group_it_cannot_launch(cuda):
    """A group size the kernels do not take (3 blocks: not a power of two;
    8: a round's cluster of 25 blocks, past the card's 16) raises, through
    the wrappers and through the C entries' layout, rather than falling
    back to another layout."""
    from chip_smoke import ml_copy, ml_start
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import _build, ml_round

    start = ml_start(60, cuda, "jtt", cat=True)
    for group in (3, 8):
        nj = ml_copy(start, cuda)
        launches = ml_round.ml_nni_round.launches
        with pytest.raises(ValueError):
            ml_round.ml_nni_round(nj, 0, 1, rearrange.NNIStats.init(nj),
                                  group=group)
        with pytest.raises(ValueError):
            ml_round.ml_lengths_pass(nj, group=group)
        assert ml_round.ml_nni_round.launches == launches
        with pytest.raises(ValueError):
            ml_round.layout(120, 512, 20, True, False, group)
        assert _build.library().vft_ml_round_scratch_floats(
            120, 512, 20, 1, group) == -2


@pytest.mark.cuda
def test_ml_round_speculation_is_discarded(cuda):
    """At N=500 the round's AC and AD optimizations start beside AB and are
    discarded where AB's star test fires: some are (the round's
    `speculative` total, one or two for each star test that fired), and
    the round still leaves the host loop's tree, lengths, NNIStats, debug
    counters (the star tests among them) and store rows, bit for bit."""
    from chip_smoke import ml_diff, ml_start
    from veryfasttree_tpu_torch.ops import ml_round

    start = ml_start(500, cuda)
    host = _ml_runs(start, cuda, 1, False)
    before = dict(ml_round.ml_nni_round.totals)
    kern = _ml_runs(start, cuda, 1, True)
    totals = {k: v - before[k]
              for k, v in ml_round.ml_nni_round.totals.items()}
    n_star = host[1][1]["n_star_tests"]
    assert n_star > 0
    assert totals["n_star_tests"] == n_star
    assert n_star <= totals["speculative"] <= 2 * n_star
    for h, k in zip(host, kern):
        assert ml_diff(h, k) == []


@pytest.mark.cuda
def test_ml_nni_round_slow_keeps_the_host_loop(cuda):
    """-slow keeps the ML NNI host loop on a CUDA store: ml_nni_round
    launches no kernel, and leaves the tree, NNIStats, counters and ML
    store rows that rearrange.do_nni with the per-call kernels leaves."""
    import dataclasses

    from chip_smoke import ml_copy, ml_diff, ml_start, ml_state
    from veryfasttree_tpu_torch.engine import rearrange
    from veryfasttree_tpu_torch.ops import ml_round

    start = ml_start(150, cuda)
    states = []
    for wrapped in (False, True):
        nj = ml_copy(start, cuda)
        nj.options = dataclasses.replace(nj.options, slow=True)
        stats = rearrange.NNIStats.init(nj)
        before = ml_round.ml_nni_round.launches
        result = (ml_round.ml_nni_round(nj, 0, 1, stats) if wrapped else
                  rearrange.do_nni(nj, 0, 1, True, stats))
        assert ml_round.ml_nni_round.launches == before
        states.append(ml_state(nj, stats, result))
    assert states[0][1]["n_ml_nni"] > 0
    assert ml_diff(*states) == []


@pytest.mark.cuda
@pytest.mark.parametrize("C,jc", [(4, True), (4, False), (20, False)])
def test_ml_list_kernels_past_the_old_caps(cuda, C, jc):
    """ml_pair_loglk over 300 pairs and ml_posterior over 200 targets in one
    launch each (past the 256 and 128 a launch took when the lists travelled
    in the launch's parameters): every item bit for bit its K=1 launch, the
    pairs alike in the store's buffers and in tensors of their own (keep);
    a row outside the store raises before anything is launched."""
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    gen = torch.Generator(device=cuda).manual_seed(7 + C)
    store = _ml_store(gen, C, jc, cuda)
    rng = np.random.default_rng(C + 1)
    r1, r2 = rng.integers(0, 800, 300), rng.integers(0, 800, 300)
    lens = rng.uniform(0.0, 0.5, 300)
    before = mk.ml_pair_loglk.launches
    ll, lk = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True, keep=True)
    ll_b, lk_b = mk.ml_pair_loglk(*store, r1, r2, lens, want_lk=True)
    assert mk.ml_pair_loglk.launches == before + 2
    assert torch.equal(ll, ll_b) and torch.equal(lk, lk_b)
    with pytest.raises(IndexError):
        mk.ml_pair_loglk(*store, r1[:2], [0, store[0].shape[0]], lens[:2])
    assert mk.ml_pair_loglk.launches == before + 2
    for k in range(300):
        one_ll, one_lk = mk.ml_pair_loglk(*store, r1[k:k + 1], r2[k:k + 1],
                                          lens[k:k + 1], want_lk=True)
        assert torch.equal(one_ll[0], ll[k]) and torch.equal(one_lk[0],
                                                             lk[k]), k

    targets = np.arange(800, 1000)
    args = (targets, r1[:200], r2[:200], lens[:200] + 5e-4,
            lens[100:] + 5e-4)
    listed = [t.clone() for t in store[:3]]
    before = mk.ml_posterior.launches
    mk.ml_posterior(*listed, store[3], *args)
    assert mk.ml_posterior.launches == before + 1
    single = [t.clone() for t in store[:3]]
    for k in range(200):
        mk.ml_posterior(*single, store[3], *(a[k:k + 1] for a in args))
    for a, b in zip(listed, single):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pos,n_boot", [(37, 3), (200, 100), (500, 1000),
                                          (5000, 1000)])
def test_sh_resample_counts_kernel_is_the_twin(cuda, n_pos, n_boot):
    """The bootstrap counts kernel against resample_count_matrix(
    resample_columns(...)): equal, where the draws end inside a cycle, on
    its edge, and at the default run's B=1000, P=500; at P=5000 against
    the kernel's chunks replayed in numpy (chip_smoke.resample_replay, held
    to the twin on the CPU by tests/test_torch_sh_pass.py), which takes
    seconds where the twin takes tens."""
    from chip_smoke import resample_replay
    from veryfasttree_tpu_torch.ops import resample_kernels as rk

    got = rk.sh_resample_counts(n_pos, n_boot, cuda)
    assert got.dtype == torch.float64 and got.device.type == "cuda"
    if n_pos * n_boot > 10 ** 6:
        n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        want = torch.from_numpy(resample_replay(n_pos, n_boot, n_sms))
    else:
        want = rk.sh_resample_counts_ref(n_pos, n_boot)
    assert torch.equal(got.cpu(), want)
    assert int(got.sum()) == n_pos * n_boot


@pytest.mark.cuda
@pytest.mark.parametrize("P,C,matrix", [(256, 4, False), (512, 20, True),
                                        (1536, 20, True)])
def test_codes_scan_is_the_lane_replay(cuda, P, C, matrix):
    """nj_scan_codes's dist, denom and crit bit for bit the numpy replay of
    its lane order (chip_smoke.codes_lane_replay), the best index equal: one
    tile of the query table and, at 20 codes and P=1536, two."""
    from chip_smoke import codes_lane_replay
    from veryfasttree_tpu_torch.ops import scan_kernels as sk

    gen = torch.Generator()
    gen.manual_seed(P + C)
    codes, G, wq, outd, n_active, l_real, _ = _codes(gen, P=P, C=C)
    args = (codes, G, wq, outd, n_active, l_real, matrix)
    got = sk.nj_scan_codes(*(a.to(cuda) if torch.is_tensor(a) else a
                             for a in args))
    want = codes_lane_replay(*args)
    assert int(got[0]) == want[0] == 40
    for g, w in zip(got[2:], want[2:]):
        assert g.cpu().numpy().tobytes() == w.tobytes()


@pytest.mark.cuda
def test_two_tier_join_epoch_at_500_is_the_host_loop(cuda):
    """The two-tier NJ phase at N=500 (chip_smoke.py phase 2d's case): the
    epoch kernel's refresh scans read the query in the code scan's layout;
    every array bit for bit the host loop with the per-call kernels."""
    from chip_smoke import epoch_diff, epoch_run, epoch_state

    host = epoch_state(epoch_run(500, cuda, kernel=False, two_tier=True))
    kern = epoch_state(epoch_run(500, cuda, two_tier=True))
    assert len(host["join_log"]) == 497
    assert epoch_diff(host, kern) == []


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["jc", "gtr", "jtt"])
def test_sh_pass_is_the_host_loop(cuda, model):
    """The SH-like supports at N=150 (chip_smoke.sh_start: CAT 20 rates,
    after a lengths pass and an NNI round, 1000 resamples): sh_pass's list
    launches and the host loop engine/ml.test_splits_ml with the per-call
    kernels leave the same per-split log-likelihoods, per-site
    likelihoods, choices, bad splits, supports, SplitCount, counters and
    store rows, bit for bit (chip_smoke.sh_diff); sh_pass itself leaves
    the pass's SplitCount and supports."""
    import dataclasses

    from chip_smoke import (ml_copy, sh_diff, sh_host_loop, sh_run,
                            sh_start, sh_state)
    from veryfasttree_tpu_torch.ops import ml_round

    start = sh_start(150, cuda, model)
    nj = ml_copy(start, cuda)
    sc, record, _ = sh_run(nj)
    got = sh_state(nj, sc, record)
    nj = ml_copy(start, cuda)
    assert dataclasses.astuple(ml_round.sh_pass(nj)) == \
        dataclasses.astuple(sc)
    assert np.array_equal(nj.tree.support[record["nodes"]],
                          record["support"])
    nj = ml_copy(start, cuda)
    want = sh_state(nj, *sh_host_loop(nj))
    assert sh_diff(got, want) == []
    assert 0 < np.count_nonzero(got["support"]) < len(got["nodes"])


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["jc", "gtr"])
@pytest.mark.parametrize("shape,n,p", [("balanced", 300, 500),
                                       ("caterpillar", 520, 128),
                                       ("wide", 9000, 128)])
def test_whole_tree_kernels_are_the_per_level_launches(cuda, shape, n, p,
                                                       model):
    """ml_posterior_sweep and ml_tree_loglk (one launch each) against the
    per-level launches of ml_posterior and ml_pair_loglk
    (chip_smoke.per_level_recompute, per_level_loglk) on a tree of n
    leaves (chip_smoke.shaped_tree) at CAT 20: a balanced tree; a
    caterpillar of at least 500 levels; and a balanced tree whose deepest
    level holds more items than the sweep's grid has blocks.  The store's
    rows bit for bit after the sweep and after the tree log-likelihood
    (the root term's row); the total and the per-site sums within 1e-12
    relative (each level's sum in list order, where the per-level path's
    torch reductions take orders of their own), and the total equal with
    and without the per-site sums."""
    from chip_smoke import (max_rel, ml_copy, per_level_loglk,
                            per_level_recompute, shaped_start, store_diff)
    from veryfasttree_tpu_torch.ops import _build
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    start = shaped_start(n, cuda, "balanced" if shape == "wide" else shape,
                         model, p=p)
    kern, levels = ml_copy(start, cuda), ml_copy(start, cuda)
    sweep = kern.ml.tree_sweep()
    widths = np.diff(sweep.posteriors.offsets)
    if shape == "caterpillar":
        assert sweep.posteriors.n_levels >= 500
    if shape == "wide":
        assert widths.max() > _build.library().vft_ml_posterior_sweep_grid(4)
    before = {fn: fn.launches for fn in (mk.ml_posterior_sweep,
                                         mk.ml_posterior, mk.ml_tree_loglk,
                                         mk.ml_pair_loglk)}
    kern.ml.recompute_ml_profiles(sweep)
    ll_k, site_k = kern.ml.tree_loglk(sweep, want_site=True)
    ll_only, _ = kern.ml.tree_loglk(sweep)
    assert {fn.__name__: fn.launches - b for fn, b in before.items()} == {
        "ml_posterior_sweep": 1, "ml_posterior": 0, "ml_tree_loglk": 2,
        "ml_pair_loglk": 0}
    per_level_recompute(levels.ml)
    ll_l, site_l = per_level_loglk(levels, want_site=True)
    assert store_diff(kern.ml, levels.ml) == []
    ll_k, ll_only, ll_l = float(ll_k), float(ll_only), float(ll_l)
    assert ll_k == ll_only
    assert max_rel(ll_k, ll_l) <= 1e-12
    assert max_rel(site_k.cpu().numpy(), site_l.cpu().numpy()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["jc", "gtr", "jtt"])
def test_cat_fit_is_the_per_level_path(cuda, model):
    """engine/ml.ml_site_likelihoods_by_rate (21 sweeps and 20 tree
    log-likelihoods over one TreeSweep, one fetch) against the per-level
    path (chip_smoke.per_level_site_likelihoods) from the port's NJ tree
    at N=300: the 20 rates' per-site log-likelihoods within 1e-12
    relative, the CAT categories they give equal, the store's rows bit for
    bit after the fit; a CUDA store runs no twin and no per-level kernel."""
    from chip_smoke import (max_rel, ml_copy, ml_start,
                            per_level_site_likelihoods, store_diff)
    from veryfasttree_tpu_torch.engine import ml
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    start = ml_start(300, cuda, model)
    rates = ml.ml_site_rates(20)
    prior = 2.0 * np.log(rates) - 3.0 * rates
    kern, levels = ml_copy(start, cuda), ml_copy(start, cuda)
    before = (mk.ml_posterior_sweep.launches, mk.ml_tree_loglk.launches,
              mk.ml_posterior.launches, mk.ml_pair_loglk.launches)
    twins = (mk.ml_posterior_sweep_ref, mk.ml_tree_loglk_ref)

    def refused(*a, **k):
        raise AssertionError("a twin ran for a CUDA store")

    mk.ml_posterior_sweep_ref = mk.ml_tree_loglk_ref = refused
    try:
        site_k = ml.ml_site_likelihoods_by_rate(kern, rates)
    finally:
        mk.ml_posterior_sweep_ref, mk.ml_tree_loglk_ref = twins
    assert (mk.ml_posterior_sweep.launches - before[0],
            mk.ml_tree_loglk.launches - before[1],
            mk.ml_posterior.launches - before[2],
            mk.ml_pair_loglk.launches - before[3]) == (21, 20, 0, 0)
    site_l = per_level_site_likelihoods(levels, rates)
    assert max_rel(site_k, site_l) <= 1e-12
    np.testing.assert_array_equal(np.argmax(site_k + prior[:, None], 0),
                                  np.argmax(site_l + prior[:, None], 0))
    assert store_diff(kern.ml, levels.ml) == []


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,p", [("balanced", 300, 500),
                                       ("caterpillar", 520, 128)])
def test_whole_tree_kernels_at_20_codes(cuda, shape, n, p):
    """ml_posterior_sweep and ml_tree_loglk at 20 codes (JTT, CAT 20,
    -approxml's gate on) against the per-level launches of ml_posterior
    and ml_pair_loglk: the rows bit for bit, the totals within 1e-12
    relative, and the rough and exact posterior counts equal."""
    from chip_smoke import (max_rel, ml_copy, per_level_loglk,
                            per_level_recompute, shaped_start, store_diff)

    start = shaped_start(n, cuda, shape, "jtt", p=p, approx=True)
    kern, levels = ml_copy(start, cuda), ml_copy(start, cuda)
    sweep = kern.ml.tree_sweep()
    kern.ml.recompute_ml_profiles(sweep)
    ll_k, site_k = kern.ml.tree_loglk(sweep, want_site=True)
    per_level_recompute(levels.ml)
    ll_l, site_l = per_level_loglk(levels, want_site=True)
    assert store_diff(kern.ml, levels.ml) == []
    assert max_rel(float(ll_k), float(ll_l)) <= 1e-12
    assert max_rel(site_k.cpu().numpy(), site_l.cpu().numpy()) <= 1e-12
    counts = kern.ml.post_counts.tolist()
    assert counts == levels.ml.post_counts.tolist()
    assert min(counts) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["jc", "jtt"])
@pytest.mark.parametrize("shape", ["caterpillar", "fan-out"])
def test_sweep_chains_against_twins(cuda, shape, model):
    """The chain sweep (csrc/ml_sweep.cu) at 4 and 20 codes (JTT with
    -approxml's gate on) on a caterpillar (one chain of n - 3 items) and
    on the SH pass's up-profile sweep over an NJ tree (top-down: a parent's
    up-profile read by two chains; its items weighted 1, 2 or 3 in turn,
    as the SH pass weights them by how often the host loop computes each):
    the rows and the rough/exact counts bit for
    bit the per-level launches' (chip_smoke.per_level_sweep), and within
    the store tolerances of the plain twin on the card
    (chip_smoke.TWIN_ROWS)."""
    from chip_smoke import (TWIN_ROWS, ml_copy, ml_start, per_level_sweep,
                            shaped_start, store_diff)
    from veryfasttree_tpu_torch.ops import ml_kernels as mk
    from veryfasttree_tpu_torch.ops.ml_round import SHPass, up_sweep_tables

    approx = model == "jtt"
    if shape == "caterpillar":
        start = shaped_start(300, cuda, "caterpillar", model, p=160,
                             approx=approx)
        tables = start.ml.tree_sweep().posteriors
        assert tables.chains.n_chains == 1
    else:
        start = ml_start(150, cuda, model, approx=approx, p=160)
        t = up_sweep_tables(start, SHPass(start).nodes)
        tables = mk.SweepTables(t.offsets, t.targets, t.r1, t.r2, t.len1,
                                t.len2, 1 + np.arange(t.n_items) % 3)
        assert tables.chains.n_slots > 0
    kern, levels, twin = (ml_copy(start, cuda) for _ in range(3))
    mk.ml_posterior_sweep(*kern.ml._store(), tables)
    per_level_sweep(levels.ml, tables)
    mk.ml_posterior_sweep_ref(*twin.ml._store(), tables)
    assert store_diff(kern.ml, levels.ml) == []
    counts = kern.ml.post_counts.tolist()
    assert counts == levels.ml.post_counts.tolist()
    if approx:
        assert min(counts) > 0
    rows = torch.as_tensor(tables.targets, device=cuda)
    for k in ("W", "V"):
        np.testing.assert_allclose(getattr(kern.ml, k)[rows].cpu().numpy(),
                                   getattr(twin.ml, k)[rows].cpu().numpy(),
                                   **TWIN_ROWS)


@pytest.mark.cuda
def test_whole_tree_kernels_refuse_rows_outside_the_store(cuda):
    """A table row outside the store raises before anything is
    launched."""
    from chip_smoke import shaped_start
    from veryfasttree_tpu_torch.ops import ml_kernels as mk

    nj = shaped_start(40, cuda, "balanced", "jc", p=128)
    n_rows = nj.ml.codes.shape[0]
    bad = mk.SweepTables.from_levels([([n_rows - 1], [0], [n_rows], [0.1],
                                       [0.1])])
    before = mk.ml_posterior_sweep.launches
    with pytest.raises(IndexError):
        mk.ml_posterior_sweep(*nj.ml._store(), bad)
    bad = mk.LoglkTables([0, 1], [0], [n_rows + 5], [0.1])
    with pytest.raises(IndexError):
        mk.ml_tree_loglk(*nj.ml._store(), bad)
    assert mk.ml_posterior_sweep.launches == before


def _fastest_nj(dev, fused, n=150, capture=None, **kw):
    """The port's NJ phase under -fastest on synth_codes(n, 500) on dev,
    its joins through the fused join step or (fused=False) the unfused
    host loop body; capture: a dict that receives clones of one join
    step's inputs (the first after join n // 2 with candidates and
    prefetch rows)."""
    from chip_smoke import synth_codes
    from veryfasttree_tpu_torch.engine import nj as nj_mod
    from veryfasttree_tpu_torch.ops import join_kernels
    from veryfasttree_tpu_torch.options import Options

    opts = Options(n_codes=4, ml_nni=0, n_bootstrap=0, show_progress=False,
                   fastest=True, **kw)
    opts.derive_settings()
    step, was = join_kernels.nj_join_step, nj_mod.USE_FUSED_JOIN
    calls = [0]

    def capturing(*args):
        calls[0] += 1
        if capture is not None and "args" not in capture \
                and calls[0] > n // 2 and len(args[14]) and len(args[15]):
            capture["args"] = [a.clone() if torch.is_tensor(a) else a
                               for a in args]
        return step(*args)

    # the wrapper counts under its module name, which names this function
    # while it stands in
    capturing.launches, capturing.grid = step.launches, step.grid
    join_kernels.nj_join_step = capturing
    nj_mod.USE_FUSED_JOIN = fused
    try:
        nj = nj_mod.NeighbourJoining(opts, synth_codes(n, 500), None, None,
                                     device=dev)
        nj.fast_nj()
        torch.cuda.synchronize()
    finally:
        step.launches, step.grid = capturing.launches, capturing.grid
        join_kernels.nj_join_step, nj_mod.USE_FUSED_JOIN = step, was
    return nj


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"bionj": True}, {"two_tier_min": 0}],
                         ids=["dense", "bionj", "two-tier"])
def test_join_step_kernel_is_the_unfused_loop_and_the_twin(cuda, kw):
    """-fastest at N=150 (chip_smoke.py's phase 10(b)): the fused loop
    through nj_join_step leaves every array of the NJ phase bit for bit as
    the unfused body with the per-call kernels does; and one captured join
    step through the kernel against the twin on the same inputs: the
    packed result within TOL (float64 sums in other orders), the new row
    and the out-profile bit for bit."""
    from chip_smoke import epoch_diff, epoch_state
    from veryfasttree_tpu_torch.ops import join_kernels

    cap = {}
    before = join_kernels.nj_join_step.launches
    fused = epoch_state(_fastest_nj(cuda, True, capture=cap, **kw))
    assert join_kernels.nj_join_step.launches > before + 100
    unfused = epoch_state(_fastest_nj(cuda, False, **kw))
    assert epoch_diff(fused, unfused) == []

    k_args = [a.clone() if torch.is_tensor(a) else a for a in cap["args"]]
    t_args = [a.clone() if torch.is_tensor(a) else a for a in cap["args"]]
    got = join_kernels.nj_join_step(*k_args)
    torch.cuda.synchronize()
    exp = join_kernels.nj_join_step_ref(*t_args)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(), **TOL)
    for k in (0, 1, 2, 7, 8):          # codes, W, U, w_out, f_out
        assert torch.equal(k_args[k], t_args[k]), k


@pytest.mark.cuda
def test_checkpoint_round_trip_and_resume_on_cuda(cuda, tmp_path):
    """-checkpoint on the card: a default ML run stopped after round 2's
    save and resumed prints the uninterrupted run's Newick; the file of a
    state, loaded into a fresh engine, gives every array back."""
    from veryfasttree_tpu_torch.engine import checkpoint
    from veryfasttree_tpu_torch.options import ml_options
    from veryfasttree_tpu_torch.pipeline import run_pipeline

    fasta = "".join(f">s{i}\n{s}\n"
                    for i, s in enumerate(simulate_alignment(40, 200, seed=8)))

    def run(ckpt="", **kw):
        out = io.StringIO()
        nj, _ = run_pipeline(ml_options(checkpoint_file=ckpt, n_bootstrap=0,
                                        **kw), io.StringIO(fasta), out,
                             device=cuda)
        return out.getvalue(), nj

    full, nj = run()
    path = str(tmp_path / "ck.npz")
    save = checkpoint.save_checkpoint

    class Stop(Exception):
        pass

    def save_then_stop(nj_, p, meta, extra=None, **kw):
        save(nj_, p, meta, extra, **kw)
        if meta["round"] == 2:
            raise Stop()

    checkpoint.save_checkpoint = save_then_stop
    try:
        with pytest.raises(Stop):
            run(path)
    finally:
        checkpoint.save_checkpoint = save
    resumed, _ = run(path)
    assert resumed == full

    state = str(tmp_path / "state.npz")
    save(nj, state, {"phase": "test", "round": 1})
    _, nj2 = run(ml_nni=0, nni=0, spr=0)
    checkpoint.load_checkpoint(nj2, state)
    a = checkpoint.state_arrays(nj, {})
    b = checkpoint.state_arrays(nj2, {})
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
