"""Level-batched minimum-evolution passes (counterpart of the ME parts of
``veryfasttree_tpu/engine/batched.py``).

All up-profiles are computed top-down in one sweep of balanced averages
(one launch of ``me_average_sweep`` on the card), and the branch lengths of
the whole tree come from one pair-distance list (one launch of
``me_dists_list``; the thread-level-1 analog of ref updateBranchLengths
tcc:6502-6598).  The tables are gathered with one numpy step per tree
level or per pass, not per node.  With -bionj off these are
value-identical to the serial walks in rearrange.py.
"""
from __future__ import annotations

import numpy as np

from ..ops.store_kernels import AverageTables
from . import rearrange
from .state import level_order

# a quartet's six pairs in QAB .. QCD order, and a leaf's three (AB, AC, BC)
QUARTET_PAIRS = ((0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3))
LEAF_PAIRS = ((0, 0, 1), (1, 2, 2))


def _me_only(use_ml: bool) -> None:
    if use_ml:
        raise NotImplementedError("the batched ML passes (-threads > 1) are "
                                  "not ported yet")


def _other_sides(nj, nodes):
    """(c, d_row) of each of `nodes` (not the root; each with a parent), as
    rearrange.setup_abcd takes them: its sibling and the row of its
    parent's up-profile; below the root, the root's other two children
    (ref rootSiblings tcc:1991-2003)."""
    tree = nj.tree
    par = tree.parent[nodes]
    ch = tree.children[par]
    sib = np.where(ch[:, 0] != nodes, ch[:, 0], ch[:, 1])
    at_root = par == tree.root
    rc = tree.children[tree.root]
    if at_root.any() and tree.n_child[tree.root] != 3:
        raise AssertionError("the root has no three children")
    first = np.where(rc[0] != nodes, rc[0], rc[1])
    second = np.where(rc[2] != nodes, rc[2], rc[1])
    return (np.where(at_root, first, sib),
            np.where(at_root, second, nj.prof.up_row(par)))


def split_nodes(nj) -> np.ndarray:
    """The internal nodes of two children but the root, in index order:
    the nodes of a split test and the internal nodes of the branch
    lengths."""
    tree = nj.tree
    n = np.arange(nj.n_seqs, tree.maxnode)
    return n[(n != tree.root) & (tree.parent[n] >= 0)
             & (tree.n_child[n] == 2)]


def up_profile_levels(nj):
    """The up-profile sweep, top-down: per tree level (level_lists' order,
    empty levels left out), (targets, c rows, d rows) of its internal
    nodes of two children but the root; up[node] = combine(C, D), C the
    node's sibling and D up[parent] (or the root's other two children)."""
    tree = nj.tree
    levels = level_order(tree)[::-1]
    nodes = np.concatenate(levels)
    level = np.repeat(np.arange(len(levels)), [len(v) for v in levels])
    keep = (nodes != tree.root) & (nodes >= nj.n_seqs) \
        & (tree.n_child[nodes] == 2)
    nodes, level = nodes[keep], level[keep]
    c, d_row = _other_sides(nj, nodes)
    cuts = np.flatnonzero(np.diff(level)) + 1
    return list(zip(*(np.split(a, cuts) for a in (nj.prof.up_row(nodes), c,
                                                   d_row)))) \
        if len(nodes) else []


def compute_up_profiles_levelwise(nj, use_ml: bool, tables=None):
    """Compute ALL up-profiles top-down in one sweep (rows maxnodes +
    node).  tables: the AverageTables of up_profile_levels of this
    topology, as an earlier call returned them, or None to build them.
    Returns the tables, for the next call while the topology stands."""
    _me_only(use_ml)
    if tables is None:
        tables = AverageTables.from_levels(up_profile_levels(nj))
    nj.prof.sweep_averages(tables)
    return tables


def quartet_rows(nj, nodes) -> np.ndarray:
    """The rows (A, B, C, D) [K, 4] of the quartet around each of `nodes`
    (internal nodes of two children but the root), D an up-profile row
    (ref setupABCD tcc:1942-1974)."""
    tree = nj.tree
    c, d_row = _other_sides(nj, nodes)
    return np.stack([tree.children[nodes, 0], tree.children[nodes, 1], c,
                     d_row], 1)


def quartet_nodes(nj, nodes) -> np.ndarray:
    """The nodes (A, B, C, D) [K, 4] of the quartet around each of `nodes`,
    as rearrange.setup_abcd gives them: D the parent, or below the root
    the root's other child after C."""
    tree = nj.tree
    c, d_row = _other_sides(nj, nodes)
    par = tree.parent[nodes]
    return np.stack([tree.children[nodes, 0], tree.children[nodes, 1], c,
                     np.where(par == tree.root, d_row, par)], 1)


def pair_list(rows, pairs):
    """The pairs of each row of `rows` [K, m] in turn: (iis, jjs), K *
    len(pairs[0]) each, a row's pairs side by side."""
    return rows[:, list(pairs[0])].ravel(), rows[:, list(pairs[1])].ravel()


def update_branch_lengths_batched(nj):
    """ME branch lengths for ALL nodes in one pair-distance list
    (thread-level-1 analog of ref updateBranchLengths tcc:6502-6598).
    Returns the up-profile sweep's AverageTables (None below three
    leaves), which a split test of the same topology takes again."""
    tree = nj.tree
    if nj.n_seqs < 2:
        return None
    if nj.n_seqs == 2:
        rearrange.update_branch_lengths(nj)
        return None
    tables = compute_up_profiles_levelwise(nj, use_ml=False)
    n = np.arange(nj.n_seqs)
    leaf_nodes = n[(n != tree.root) & (tree.parent[n] >= 0)]
    int_nodes = split_nodes(nj)
    leaf_ii, leaf_jj = pair_list(
        np.stack([leaf_nodes, *_other_sides(nj, leaf_nodes)], 1), LEAF_PAIRS)
    int_ii, int_jj = pair_list(quartet_rows(nj, int_nodes), QUARTET_PAIRS)
    iis = np.concatenate([leaf_ii, int_ii])
    jjs = np.concatenate([leaf_jj, int_jj])
    if not len(iis):
        return tables
    dist, weight = nj.prof.dist_pair_list(iis, jjs)
    dist = np.array(dist)
    nj.debug.profile_ops += len(iis)
    weight = np.where(weight > 0, weight, 0.01)
    if nj.options.pseudo_weight > 0:
        # per-node prior over its own pair group (ref correctedPairDistances)
        pw = nj.options.pseudo_weight
        off = 0
        for group in ([3] * len(leaf_nodes) + [6] * len(int_nodes)):
            d = dist[off:off + group]
            w = weight[off:off + group]
            bottom = w.sum()
            prior = (d * w).sum() / bottom if bottom > 0.01 else 3.0
            dist[off:off + group] = (d * w + prior * pw) / (w + pw)
            off += group
    if nj.options.logdist:
        dist = nj.log_corrected(dist)
    d = dist[:len(leaf_ii)].reshape(-1, 3)
    tree.branchlength[leaf_nodes] = (d[:, 0] + d[:, 1] - d[:, 2]) / 2.0
    d = dist[len(leaf_ii):].reshape(-1, 6)
    tree.branchlength[int_nodes] = (d[:, 1] + d[:, 2] + d[:, 3] + d[:, 4]) \
        / 4.0 - (d[:, 0] + d[:, 5]) / 2.0
    return tables


def tree_length_batched(nj, recompute_profiles: bool) -> float:
    if recompute_profiles:
        rearrange.recompute_profiles_levelwise(nj)
    update_branch_lengths_batched(nj)
    return float(nj.tree.branchlength[: nj.tree.maxnode].sum())
