"""The port's ME local bootstrap against the JAX package's, both on the CPU.

* me_dist_pieces_list_ref (the twin of the me_dist_pieces_list kernel)
  against the JAX package's _dist_pieces: the pieces and weights bit for
  bit, dense and two-tier, %different and BLOSUM45 matrix mode.  Both
  round in float32; the twin repeats the XLA CPU build's order and fused
  multiply-adds (csrc/me_store.cuh pieces_pos), and fma_f32 is a fused
  multiply-add rounded once.
* reliability_nj_list and the serial reliability_nj against the JAX
  package's serial reliability_nj on the same NJ tree: every support and
  debug.n_suboptimal_splits equal, at 100 and 1000 resamples and under
  -bionj (the serial walk only: BIONJ-weighted up-profiles); with the
  decisions all on the device (margin 0) and all re-decided on the host.
* The -nt -noml pipeline with its default 1000 resamples: the Newick with
  supports byte-identical to the JAX package's, dense, two-tier and
  -bionj.
"""
import dataclasses
import io
from fractions import Fraction

import numpy as np
import pytest
import torch

from util import simulate_alignment, write_fasta

from veryfasttree_tpu import pipeline as jax_pipeline
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch import pipeline as torch_pipeline
from veryfasttree_tpu_torch.engine import supports as tsup
from veryfasttree_tpu_torch.ops import store_kernels as st
from veryfasttree_tpu_torch.options import Options as TOptions

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fma_f32_rounds_once():
    """fma_f32 is the exactly rounded a * b + c, where one float64 sum and
    a second rounding would miss on a float midpoint."""
    rng = np.random.default_rng(3)
    n = 3000
    a = rng.random(n).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    c = (-rng.random(n) * 2.0 ** rng.integers(-40, 2, n)).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies on the midpoint between two
    # floats; + or - 2^-70 leaves the float64 sum there, and only the tiny
    # term decides (scaled by powers of two)
    for i, (scale, sign) in enumerate([(1, 1), (1, -1), (2.0 ** -20, 1),
                                       (2.0 ** 9, -1)]):
        a[i] = b[i] = np.float32((1 + 2.0 ** -12) * scale)
        c[i] = np.float32(sign * 2.0 ** -70 * scale * scale)
    got = st.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert got[0] != twice[0] and got[2] != twice[2]
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(cands, key=lambda y: (
            abs(Fraction(float(y)) - exact),
            int(np.float32(y).view(np.uint32)) & 1))
        assert got[i] == best, i


def _store(C, two_tier, seed, n_rows=70, P=97):
    """A store of random rows: W in [0, 1), U = W times rows of a
    frequency-like matrix scaled over six decades, codes with gaps; the
    two-tier leaves (rows below 12) only as codes."""
    rng = np.random.default_rng(seed)
    W = rng.random((n_rows, P)).astype(np.float32)
    U = (rng.random((n_rows, P, C)) * W[..., None]
         * 10.0 ** rng.integers(-6, 1, (n_rows, P, C))).astype(np.float32)
    codes = rng.integers(0, C, (n_rows, P)).astype(np.int8)
    codes[rng.random((n_rows, P)) < 0.1] = 127
    leaf_rows = 12 if two_tier else 0
    return codes, W[leaf_rows:].copy(), U[leaf_rows:].copy(), leaf_rows


@pytest.mark.parametrize("C,matrix,two_tier", [
    (4, False, False), (4, False, True), (20, True, False), (20, True, True),
    (20, False, False)], ids=["nt-dense", "nt-two-tier", "blosum45-dense",
                              "blosum45-two-tier", "aa-%different"])
def test_pieces_twin_matches_jax(C, matrix, two_tier):
    import jax.numpy as jnp

    from veryfasttree_tpu.engine.profiles import _dist_pieces
    from veryfasttree_tpu_torch.models import DistanceMatrix

    codes, W, U, leaf_rows = _store(C, two_tier, seed=C + 2 * two_tier)
    if C == 20:
        dm = DistanceMatrix.blosum45()
        cf = np.asarray(dm.code_freq, np.float32)
        ev = np.asarray(dm.eigenval, np.float32)
    else:
        cf = np.eye(C, dtype=np.float32)
        ev = np.zeros(C, np.float32)
    rng = np.random.default_rng(11)
    n_rows = codes.shape[0]
    K, n_pos = 256, codes.shape[1] - 5
    iis = rng.integers(0, n_rows, K)
    jjs = rng.integers(0, n_rows, K)
    p, w = _dist_pieces(jnp.asarray(codes), jnp.asarray(W), jnp.asarray(U),
                        jnp.asarray(iis), jnp.asarray(jjs),
                        leaf_rows if two_tier else n_rows, jnp.asarray(ev),
                        jnp.asarray(cf), matrix, two_tier)
    tp, tw = st.me_dist_pieces_list(
        torch.from_numpy(codes), torch.from_numpy(W), torch.from_numpy(U),
        torch.from_numpy(cf), torch.from_numpy(ev) if matrix else None,
        leaf_rows, n_pos, iis, jjs)
    assert tp.dtype == tw.dtype == torch.float32
    assert tuple(tp.shape) == (K, n_pos)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w)[:, :n_pos])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(p)[:, :n_pos])


def _nj_pair(n, p, seed, bionj):
    """The JAX package's and the port's engines after the same NJ phase
    (no ME rounds, so some splits are not their quartet's best)."""
    from veryfasttree_tpu.engine.nj import NeighbourJoining as JNJ
    from veryfasttree_tpu_torch.engine.nj import NeighbourJoining as TNJ
    from veryfasttree_tpu_torch.io.alignment import seqs_to_codes

    seqs = simulate_alignment(n, p, seed=seed, mutation=0.3)
    opts = Options(show_progress=False, n_codes=4, ml_nni=0, bionj=bionj)
    opts.derive_settings()
    codes = seqs_to_codes(seqs, opts)

    def port():
        nj = TNJ(TOptions(**dataclasses.asdict(opts)), codes, None, None,
                 device=CPU)
        nj.fast_nj()
        return nj

    nj_j = JNJ(opts, codes, None, None)
    nj_j.fast_nj()
    return opts, nj_j, port


def _supports(nj):
    m = nj.tree.maxnode
    return nj.tree.support[:m].copy(), nj.debug.n_suboptimal_splits


@pytest.mark.parametrize("n_boot,bionj", [(100, False), (1000, False),
                                          (100, True)],
                         ids=["B100", "B1000", "bionj"])
def test_reliability_matches_jax(n_boot, bionj):
    from veryfasttree_tpu.engine import supports as jsup

    opts, nj_j, port = _nj_pair(48, 180, seed=22, bionj=bionj)
    opts.n_bootstrap = n_boot
    jsup.reliability_nj(nj_j)
    want, want_sub = _supports(nj_j)
    assert want_sub > 0                  # the comparison sees both sides

    runs = {"serial": tsup.reliability_nj} if bionj else {
        "list": tsup.reliability_nj_list}
    if n_boot == 100 and not bionj:
        runs["serial"] = tsup.reliability_nj
    for label, fn in runs.items():
        nj = port()
        nj.options.n_bootstrap = n_boot
        assert nj.join_log == list(nj_j.join_log)
        stats = fn(nj)
        got, sub = _supports(nj)
        np.testing.assert_array_equal(got, want, err_msg=label)
        assert sub == want_sub, label
        assert stats["splits"] == 45
        assert stats["launches"] == (45 if label == "serial" else 1)


@pytest.mark.parametrize("margin", [0.0, 1e300], ids=["device", "host"])
def test_reliability_either_side_decides(monkeypatch, margin):
    """With no margin the device decides every comparison but the exact
    ties; with a huge one every split is re-decided on the host by the
    reference's operations; both give the JAX package's supports."""
    from veryfasttree_tpu.engine import supports as jsup

    opts, nj_j, port = _nj_pair(40, 150, seed=5, bionj=False)
    opts.n_bootstrap = 100
    jsup.reliability_nj(nj_j)
    want, want_sub = _supports(nj_j)
    monkeypatch.setattr(tsup.LocalBootstrap, "margin", margin)
    nj = port()
    nj.options.n_bootstrap = 100
    stats = tsup.reliability_nj_list(nj, chunk=16)
    got, sub = _supports(nj)
    np.testing.assert_array_equal(got, want)
    assert sub == want_sub
    assert stats["launches"] == 3           # 37 splits in chunks of 16
    if margin:
        assert stats["redecided_splits"] == stats["splits"] == 37
        assert stats["redecided_entries"] == 37 * 101


def _run(run_pipeline, fasta, **kw):
    fields = {k: kw.pop(k) for k in list(kw) if k != "device"}
    opts = Options(show_progress=False, n_codes=4, ml_nni=0, **fields)
    opts.derive_settings()
    if run_pipeline is torch_pipeline.run_pipeline:
        opts = TOptions(**dataclasses.asdict(opts))
    out = io.StringIO()
    with open(fasta) as f:
        nj, _ = run_pipeline(opts, f, out, **kw)
    return out.getvalue(), nj


@pytest.mark.parametrize("n,p,seed,two_tier_min,bionj", [
    (36, 160, 5, 20000, False), (36, 160, 5, 0, False),
    (30, 150, 7, 20000, True)], ids=["dense", "two-tier", "bionj"])
def test_noml_pipeline_with_supports_identical_to_jax(tmp_path, n, p, seed,
                                                      two_tier_min, bionj):
    """-nt -noml with its default 1000 resamples: the Newick with supports
    byte for byte; one me_dist_pieces_list list after the split test, or
    under -bionj the serial walk's list a split."""
    fasta = str(tmp_path / "t.fasta")
    write_fasta(fasta, simulate_alignment(n, p, seed=seed))
    kw = dict(two_tier_min=two_tier_min, bionj=bionj)
    nw_j, _ = _run(jax_pipeline.run_pipeline, fasta, **kw)
    nw_t, nj = _run(torch_pipeline.run_pipeline, fasta, device=CPU, **kw)
    assert nj.options.n_bootstrap == 1000
    assert nw_t == nw_j
    assert ")1.000:" in nw_t and "boot_s" in nj.timings
    assert nj.boot_stats["splits"] == n - 3
    assert nj.boot_stats["launches"] == (n - 3 if bionj else 1)
