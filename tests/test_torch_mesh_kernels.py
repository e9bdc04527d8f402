"""The partial modes of the port's scan and pair kernels and their
finishes (ops/scan_kernels.py, ops/store_kernels.py), through their plain
twins on the CPU: at k = 1, partial then finish gives the fused calls'
results bit for bit, and over k blocks of positions the finish of the
blocks' partials is the whole store's result within float64 sum order.
The card's kernels are held to these twins by chip_smoke.py phase 11(a)."""
import numpy as np
import pytest
import torch

from veryfasttree_tpu_torch.constants import NOCODE
from veryfasttree_tpu_torch.ops import scan_kernels as sk
from veryfasttree_tpu_torch.ops import store_kernels as st

F64 = torch.float64


def _store(C, seed, n_rows=96, P=64, leaf_rows=0):
    g = np.random.default_rng(seed)
    codes = g.integers(0, C, size=(n_rows, P)).astype(np.int8)
    codes[g.uniform(size=codes.shape) < 0.1] = NOCODE
    n_float = n_rows - leaf_rows
    W = g.uniform(0.0, 1.0, size=(n_float, P)).astype(np.float32)
    V = g.dirichlet(np.ones(C), size=(n_float, P)).astype(np.float32)
    cf = np.eye(C, dtype=np.float32)
    return (torch.as_tensor(codes), torch.as_tensor(W),
            torch.as_tensor(W[..., None] * V), torch.as_tensor(cf))


def _blocks(t, k, axis):
    return torch.tensor_split(t, k, dim=axis)


@pytest.mark.parametrize("use_matrix", [False, True])
def test_scan_partial_finish(use_matrix):
    codes, W, U, cf = _store(4, 1)
    M, P, C = U.shape
    uq, wq = U[5], W[5]
    outd = torch.as_tensor(np.random.default_rng(2).uniform(0, 2, M))
    ev = torch.tensor([0.0, 1.0, 1.5, 2.0]) if use_matrix else None
    fused = sk.nj_scan(U, W, uq, wq, outd, 50, ev)
    one = sk.nj_scan(U, W, uq, wq, outd, 50, ev, exchange=lambda p: p[None])
    for a, b in zip(fused, one):
        assert torch.equal(a, b)
    # k = 2: each block's partial, stacked in rank order
    a = uq.double() * (ev.double() if use_matrix else 1.0)
    parts = torch.stack([sk.nj_scan_dense_partial(
        u.reshape(M, -1), w, a[p0:p0 + w.shape[1]].reshape(-1),
        wq.double()[p0:p0 + w.shape[1]])
        for u, w, p0 in zip(_blocks(U, 2, 1), _blocks(W, 2, 1), (0, P // 2))])
    two = sk.nj_scan_finish(parts, outd, 50, M, use_matrix)
    assert int(two[0]) == int(fused[0])
    for a, b in zip(fused[1:], two[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_two_tier_scan_partial_finish():
    codes, W, U, cf = _store(4, 3, leaf_rows=40)
    P = codes.shape[1]
    _, w, u = st.rows_cwu(codes, W, U, torch.tensor([60]), cf, 40)
    outd = torch.as_tensor(np.random.default_rng(4).uniform(0, 2, 96))
    fused = sk.nj_scan_two_tier(codes, W, U, u[0], w[0], outd, 40, 40, None,
                                cf)
    one = sk.nj_scan_two_tier(codes, W, U, u[0], w[0], outd, 40, 40, None,
                              cf, exchange=lambda p: p[None])
    for a, b in zip(fused, one):
        assert torch.equal(a, b)
    assert P % 16 == 0


@pytest.mark.parametrize("leaf_rows", [0, 32])
@pytest.mark.parametrize("matrix", [False, True])
def test_pair_partial_finish(leaf_rows, matrix):
    codes, W, U, cf = _store(4, 5, leaf_rows=leaf_rows)
    ev = torch.tensor([0.0, 1.0, 1.5, 2.0]) if matrix else None
    g = np.random.default_rng(6)
    iis, jjs = g.integers(0, 96, 20), g.integers(0, 96, 20)
    q_rows = g.integers(0, 96, 7)
    qU, qW = U[50], W[50]
    fused = st.me_dists(codes, W, U, cf, ev, leaf_rows, q_rows, qU, qW, iis,
                        jjs)
    part = st.me_dists_partial(codes, W, U, cf, ev, leaf_rows, q_rows, qU, qW,
                               iis, jjs)
    assert torch.equal(st.me_pair_finish(part[None], matrix), fused)
    lst = st.me_dists_list(codes, W, U, cf, ev, leaf_rows, iis, jjs)
    lpart = st.me_dists_list_partial(codes, W, U, cf, ev, leaf_rows, iis, jjs)
    assert torch.equal(st.me_pair_finish(lpart[None], matrix), lst)
    # k = 3 blocks of positions
    parts = torch.stack([st.me_dists_list_partial(
        c.contiguous(), w.contiguous(), u.contiguous(), cf, ev, leaf_rows,
        iis, jjs) for c, w, u in zip(_blocks(codes, 3, 1), _blocks(W, 3, 1),
                                      _blocks(U, 3, 1))])
    np.testing.assert_allclose(st.me_pair_finish(parts, matrix).numpy(),
                               lst.numpy(), rtol=1e-12, atol=1e-14)


def test_exchange_sum_order_is_rank_order():
    """Mesh.exchange_sum adds the ranks' parts in rank order (one rank here:
    the part itself)."""
    from veryfasttree_tpu_torch.parallel.mesh import Mesh

    m = Mesh(1, 1, 0, None, None)
    x = torch.tensor([1e16, 1.0, -1e16], dtype=F64)
    assert torch.equal(m.exchange_sum(x), x)
    assert m.stats["calls"] == 1
    assert m.block(200, 128) == (0, 256, 200)
    m4 = Mesh(1, 4, 3, None, None)
    assert m4.block(200, 128) == (192, 64, 8)
    assert m4.block(200, 128, 2) == (128, 64, 64)
