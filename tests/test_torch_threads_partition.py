"""The port's copy of engine/partition.py against the JAX package's
tree_partitioning, and the freshness of the -threads goldens.

tree_partitioning (ref treePartitioning tcc:5540-5750) splits a tree into
subtrees for the partitioned SPR rounds of -threads > 1.  Both packages'
functions take the same trees, joined as NJ joins them (random pairs of
the active nodes, from numpy seeds, and a caterpillar) with the penalties
the SPR rounds pass (maxSPRLength + 1) and others, at 2, 8 and 12
workers: the subtree roots must be equal, in order.
"""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from veryfasttree_tpu.engine import partition as jpartition
from veryfasttree_tpu.options import Options
from veryfasttree_tpu_torch.engine import partition as tpartition
from veryfasttree_tpu_torch.engine.state import TreeState
from veryfasttree_tpu_torch.options import Options as TOptions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def joined_tree(n, seed=None):
    """A tree of n leaves joined as NJ joins (two active nodes into a new
    one until three remain, the root's children): random pairs from a
    numpy seed, or with seed None always the last two (a caterpillar)."""
    tree = TreeState(n, 2 * n)
    rng = np.random.default_rng(seed)
    active = list(range(n))
    while len(active) > 3:
        if seed is None:
            i, j = active.pop(), active.pop()
        else:
            a, b = sorted(rng.choice(len(active), 2, replace=False))
            i, j = active.pop(b), active.pop(a)
        tree.set_children(tree.maxnode, [i, j])
        active.append(tree.maxnode)
        tree.maxnode += 1
    tree.root = tree.maxnode
    tree.set_children(tree.root, active)
    tree.maxnode += 1
    opts = TOptions(threads=8, seed=1).derive_settings()
    return SimpleNamespace(tree=tree, options=opts, n_seqs=n)


@pytest.fixture(scope="module")
def trees():
    return [joined_tree(n, seed) for n, seed in ((40, 1), (200, 2),
                                                 (1000, 3), (300, None))]


@pytest.mark.parametrize("workers", [2, 8, 12])
def test_tree_partitioning_matches_jax(trees, workers):
    for nj in trees:
        for penalty in (0, 2, nj.options.max_spr_length + 1):
            got = tpartition.tree_partitioning(nj, penalty, workers=workers)
            want = jpartition.tree_partitioning(nj, penalty, workers=workers)
            assert got == want, (nj.n_seqs, penalty)
            roots = np.array(got)
            assert len(set(got)) == len(got) and (roots >= 0).all()


def test_threads_default_partition_width(trees):
    """workers defaults to max(threads, 2) in both packages."""
    nj = trees[1]
    assert tpartition.tree_partitioning(nj, 11) == \
        jpartition.tree_partitioning(nj, 11)


def test_options_agree_on_threads():
    """The -threads rules both packages derive: the 2nd-level top hits off
    with more than one worker (ref VeryFastTree.cpp), the default 1."""
    for kw in ({}, {"threads": 4}, {"threads": 4, "use_tophits_2nd": True}):
        j, t = Options(seed=1, **kw), TOptions(seed=1, **kw)
        assert dataclasses.asdict(t.derive_settings()) == \
            dataclasses.asdict(j.derive_settings()), kw
    assert TOptions().derive_settings().threads == 1


def test_goldens_are_current():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_port_threads_cpu_golden import source_hash

    with open(os.path.join(REPO, "tests", "data",
                           "torch_port_threads_cpu.json")) as f:
        meta = json.load(f)
    assert meta["source_hash"] == source_hash(), (
        "veryfasttree_tpu/ or the tests' run helpers changed since the "
        "-threads goldens were written: rerun "
        "python scripts/make_torch_port_threads_cpu_golden.py")
