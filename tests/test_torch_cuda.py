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


def _ml_store(gen, C, jc, dev):
    """chip_smoke.py's random ML store (leaf rows with gaps, posterior rows
    with weights 0, 1 and a few fractions, 20 CAT rates), at a small
    layout."""
    from chip_smoke import ml_store_case

    return ml_store_case(C, "jc" if jc else ("jtt" if C == 20 else "gtr"),
                         gen, dev, n_rows=1024, P=256, n_pos=250, n_leaf=400)


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
