"""The chains of the whole-tree posterior sweep (ops/dataflow.build_chains,
check_chains; csrc/ml_sweep.cu runs one chain a unit), on the CPU.

* The chain tables of four sweeps: a balanced tree and a caterpillar
  (chip_smoke.shaped_tree), the port's NJ tree, all bottom-up
  (TreeSweep.posteriors), and the SH pass's up-profiles, top-down, where a
  parent's up-profile feeds both children's (ops/ml_round.up_sweep_tables).
  Held by a check written here item by item: every item lies in exactly
  one chain, each chain step reads the previous item's target (the side
  bits name which source), every wait points to the flag of the item that
  writes the source and that item's chain comes earlier, and the flagged
  items are exactly those an item of another chain reads.  The chains
  follow the longest paths: a caterpillar is one chain, a balanced tree's
  longest chain is its depth.
* Chains cut into segments (dataflow.build_chains' max_len) keep every
  rule.
* Misordered, cyclic and mislabelled tables raise.
* The plain twin walked in the kernel's order (chain after chain, one item
  at a time: ml_kernels.ml_posterior_sweep_chain_ref) writes the level
  order's rows bit for bit, Jukes-Cantor and GTR, on each sweep.

About 10 s.
"""
import numpy as np
import pytest
import torch

from chip_smoke import GTR, ml_copy, shaped_start, store_diff
from util import simulate_alignment

from veryfasttree_tpu_torch.engine import ml as tml
from veryfasttree_tpu_torch.engine import rearrange as trearrange
from veryfasttree_tpu_torch.engine.ml_profiles import MLProfiles
from veryfasttree_tpu_torch.engine.nj import NeighbourJoining
from veryfasttree_tpu_torch.io.alignment import seqs_to_codes
from veryfasttree_tpu_torch.models import TransitionMatrix
from veryfasttree_tpu_torch.ops import dataflow
from veryfasttree_tpu_torch.ops import ml_kernels as mk
from veryfasttree_tpu_torch.ops.ml_round import SHPass, up_sweep_tables
from veryfasttree_tpu_torch.options import Options

CPU = torch.device("cpu")


def _nj(model, n=40, p=96):
    tm = None if model == "jc" else TransitionMatrix.gtr(*GTR)
    opts = Options(n_codes=4, show_progress=False, n_bootstrap=0)
    opts.derive_settings()
    codes = seqs_to_codes(simulate_alignment(n, p, seed=23, mutation=0.12,
                                             gap_frac=0.04), opts)
    nj = NeighbourJoining(opts, codes, None, tm, device=CPU)
    nj.fast_nj()
    trearrange.update_branch_lengths(nj)
    nj.ml = MLProfiles(nj, tm)
    nj.ml.set_rates(tml.ml_site_rates(4),
                    ((np.arange(nj.n_pos) * 5) % 4).astype(np.int32))
    return nj


def _start(shape, model):
    if shape == "nj" or shape == "up":
        return _nj(model)
    return shaped_start(64 if shape == "balanced" else 90, CPU, shape, model,
                        p=48)


def _tables(nj, shape):
    if shape == "up":
        return up_sweep_tables(nj, SHPass(nj).nodes)
    return nj.ml.tree_sweep().posteriors


def _check_by_items(t):
    """The chain tables' rules, item by item."""
    ch = t.chains
    prods = (t.prod1, t.prod2)
    unit = {}
    for c in range(ch.n_chains):
        items = ch.order[ch.starts[c]:ch.starts[c + 1]].tolist()
        assert items
        for i, k in enumerate(items):
            assert k not in unit
            unit[k] = c
            prev = items[i - 1] if i else -1
            side = sum(bit for bit, p in ((1, prods[0][k]), (2, prods[1][k]))
                       if p >= 0 and p == prev)
            assert ch.side[k] == side
            if i:
                assert side, "a chain step must read the previous target"
    assert sorted(unit) == list(range(t.n_items))
    read_outside = set()
    for k in range(t.n_items):
        prev = None
        c = unit[k]
        at = ch.order.tolist().index(k)
        if at > ch.starts[c]:
            prev = ch.order[at - 1]
        for p, wait in zip(prods, (ch.wait1, ch.wait2)):
            if p[k] < 0 or p[k] == prev:
                assert wait[k] == -1
                continue
            assert unit[p[k]] < c, "a wait must point to an earlier unit"
            assert wait[k] == ch.slot[p[k]] >= 0
            read_outside.add(int(p[k]))
    assert set(np.flatnonzero(ch.slot >= 0).tolist()) == read_outside


@pytest.mark.parametrize("shape", ["balanced", "caterpillar", "nj", "up"])
def test_chain_tables(shape):
    nj = _start(shape, "jc")
    t = _tables(nj, shape)
    assert t.n_items > 10
    _check_by_items(t)
    ch = t.chains
    lengths = np.diff(ch.starts)
    if shape == "caterpillar":
        assert ch.n_chains == 1 and ch.n_slots == 0
        assert lengths[0] == t.n_levels == 90 - 3
    if shape == "balanced":
        assert lengths.max() == t.n_levels
    if shape == "up":
        # a fan-out: some items are read by two chains' items
        readers = np.bincount(np.concatenate([
            t.prod1[t.prod1 >= 0], t.prod2[t.prod2 >= 0]]),
            minlength=t.n_items)
        assert readers.max() == 2 and ch.n_slots > 0
        assert (ch.wait1 >= 0).sum() + (ch.wait2 >= 0).sum() > 0


@pytest.mark.parametrize("shape", ["caterpillar", "nj", "up"])
def test_chain_segments(shape):
    """Chains cut into segments of at most max_len items (as SweepTables
    cuts a long chain where a sweep has more than SPLIT_CHAINS chains)
    keep every rule; on a caterpillar the segments are listed bottom to
    top, each of max_len items (the last of fewer) and waiting on the flag
    of the segment before it."""
    nj = _start(shape, "jc")
    t = _tables(nj, shape)
    whole = t.chains
    t.chains = dataflow.build_chains(t.offsets, t.prod1, t.prod2, max_len=5)
    _check_by_items(t)
    lengths = np.diff(t.chains.starts)
    assert lengths.max() <= 5 and t.chains.n_chains > whole.n_chains
    if shape == "caterpillar":
        assert (lengths[:-1] == 5).all()
        np.testing.assert_array_equal(t.chains.order, whole.order)
        np.testing.assert_array_equal(
            t.chains.wait1[t.chains.order[t.chains.starts[1:-1]]]
            + t.chains.wait2[t.chains.order[t.chains.starts[1:-1]]] + 1,
            np.arange(len(lengths) - 1))


def _chains(order, starts, side, wait1, wait2, slot):
    return dataflow.Chains(order, starts, side, wait1, wait2, slot)


def test_bad_chain_tables_raise():
    # items 0, 1 leaves' posteriors; 2 reads 0; 3 reads 1 and 2
    prod1 = np.array([-1, -1, 0, 1])
    prod2 = np.array([-1, -1, -1, 2])
    good = dataflow.build_chains([0, 2, 3, 4], prod1, prod2)
    dataflow.check_chains(good, prod1, prod2)
    assert good.n_chains == 2
    # chain A = [0, 2, 3] (3 reads 2), chain B = [1] read by 3
    np.testing.assert_array_equal(good.order, [1, 0, 2, 3])
    np.testing.assert_array_equal(good.side, [0, 0, 1, 2])
    np.testing.assert_array_equal(good.wait1, [-1, -1, -1, 0])
    np.testing.assert_array_equal(good.slot, [-1, 0, -1, -1])
    bad = {
        # misordered: chain A before the chain B it waits on
        "not before": _chains([0, 2, 3, 1], [0, 3, 4], good.side, good.wait1,
                              good.wait2, good.slot),
        # an item in two chains, one in none
        "each in one chain": _chains([1, 0, 2, 2], [0, 1, 4], good.side,
                                     good.wait1, good.wait2, good.slot),
        # a chain step that does not read the previous target
        "previous": _chains([1, 0, 3, 2], [0, 1, 4], good.side, good.wait1,
                            good.wait2, good.slot),
        # side bits that name the wrong source
        "side bits": _chains(good.order, good.starts, [0, 0, 2, 2],
                             good.wait1, good.wait2, good.slot),
        # a wait left out, and a flag nobody reads
        "wait": _chains(good.order, good.starts, good.side, [-1] * 4,
                        good.wait2, good.slot),
        "flagged": _chains(good.order, good.starts, good.side, good.wait1,
                           good.wait2, [-1, 0, 1, -1]),
    }
    for match, ch in bad.items():
        with pytest.raises(ValueError, match=match):
            dataflow.check_chains(ch, prod1, prod2)
    # two chains that read each other: A = [0, 3], B = [1, 2] with 1 reading
    # 0 and 3 reading 1 (each waits on the other)
    p1 = np.array([-1, 0, 1, 0])
    p2 = np.array([-1, -1, -1, 1])
    cyc = _chains([0, 3, 1, 2], [0, 2, 4], [0, 0, 1, 1], [-1, 0, -1, -1],
                  [-1, -1, -1, 1], [0, 1, -1, -1])
    with pytest.raises(ValueError, match="not before"):
        dataflow.check_chains(cyc, p1, p2)
    # build_chains refuses an item reading an earlier item of its own chain
    with pytest.raises(ValueError, match="own chain"):
        dataflow.build_chains([0, 1, 2, 3], [-1, 0, 1], [-1, -1, 0])


@pytest.mark.parametrize("model", ["jc", "gtr"])
@pytest.mark.parametrize("shape", ["balanced", "caterpillar", "nj", "up"])
def test_chain_order_twin_is_the_level_order(shape, model):
    start = _start(shape, model)
    if shape == "up":
        start.ml.recompute_ml_profiles()
    chain_nj, level_nj = ml_copy(start, CPU), ml_copy(start, CPU)
    t = _tables(chain_nj, shape)
    mk.ml_posterior_sweep_chain_ref(*chain_nj.ml._store(), t)
    mk.ml_posterior_sweep_ref(*level_nj.ml._store(), t)
    assert store_diff(chain_nj.ml, level_nj.ml) == []
    assert torch.equal(chain_nj.ml.post_counts, level_nj.ml.post_counts)
    # the rows changed: the sweep wrote every target
    rows = torch.as_tensor(t.targets)
    assert not torch.equal(chain_nj.ml.V[rows], start.ml.V[rows])
