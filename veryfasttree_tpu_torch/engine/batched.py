"""Level-batched minimum-evolution passes (counterpart of the ME parts of
``veryfasttree_tpu/engine/batched.py``).

All up-profiles are computed top-down with one store call per tree level,
and the branch lengths of the whole tree come from one gathered
pair-distance call (the thread-level-1 analog of ref updateBranchLengths
tcc:6502-6598).  With -bionj off these are value-identical to the serial
walks in rearrange.py.
"""
from __future__ import annotations

import numpy as np

from . import rearrange


def _me_only(use_ml: bool) -> None:
    if use_ml:
        raise NotImplementedError("the batched ML passes (-threads > 1) are "
                                  "not ported yet")


def compute_up_profiles_levelwise(nj, use_ml: bool) -> None:
    """Compute ALL up-profiles top-down, one batched call per level.

    up[node] = combine(C, D), where C is node's sibling and D is up[parent]
    (or the other root sibling); rows are maxnodes + node.
    """
    _me_only(use_ml)
    tree = nj.tree
    levels = []
    for level in reversed(tree.level_lists()):  # top-down
        nodes = [int(n) for n in level
                 if n != tree.root and n >= nj.n_seqs and tree.n_child[n] == 2]
        if not nodes:
            continue
        r1s, r2s, targets = [], [], []
        for node in nodes:
            par = int(tree.parent[node])
            if par == tree.root:
                c_row, d_row = tree.root_siblings(node)
            else:
                c_row = tree.sibling(node)
                d_row = nj.prof.up_row(par)
            targets.append(nj.prof.up_row(node))
            r1s.append(c_row)
            r2s.append(d_row)
        levels.append((targets, r1s, r2s))
    if levels:
        nj.prof.average_sweep(levels)


def _gather_quartets(nj, nodes, use_ml: bool):
    """rows4 + nodes4 for a batch of internal nodes (up-profiles precomputed)."""
    _me_only(use_ml)
    tree = nj.tree
    rows = np.zeros((len(nodes), 4), dtype=np.int64)
    nodes4 = np.zeros((len(nodes), 4), dtype=np.int64)
    for k, node in enumerate(nodes):
        a, b = int(tree.children[node, 0]), int(tree.children[node, 1])
        par = int(tree.parent[node])
        if par == tree.root:
            c, d = tree.root_siblings(node)
            d_row = d
        else:
            c = tree.sibling(node)
            d = par
            d_row = nj.prof.up_row(par)
        rows[k] = [a, b, c, d_row]
        nodes4[k] = [a, b, c, d]
    return rows, nodes4


def update_branch_lengths_batched(nj) -> None:
    """ME branch lengths for ALL nodes in one batched distance call
    (thread-level-1 analog of ref updateBranchLengths tcc:6502-6598)."""
    tree = nj.tree
    if nj.n_seqs < 2:
        return
    if nj.n_seqs == 2:
        rearrange.update_branch_lengths(nj)
        return
    compute_up_profiles_levelwise(nj, use_ml=False)
    leaf_nodes, leaf_rows = [], []
    int_nodes, int_rows = [], []
    for node in range(tree.maxnode):
        if node == tree.root or tree.parent[node] < 0:
            continue
        if node < nj.n_seqs:
            sib = tree.sibling(node)
            if sib == -1:
                sibs = tree.root_siblings(node)
                rows3 = [node, sibs[0], sibs[1]]
            else:
                rows3 = [node, sib, nj.prof.up_row(int(tree.parent[node]))]
            leaf_nodes.append(node)
            leaf_rows.append(rows3)
        elif tree.n_child[node] == 2:
            a, b = int(tree.children[node, 0]), int(tree.children[node, 1])
            par = int(tree.parent[node])
            if par == tree.root:
                sibs = tree.root_siblings(node)
                rows4 = [a, b, sibs[0], sibs[1]]
            else:
                rows4 = [a, b, tree.sibling(node), nj.prof.up_row(par)]
            int_nodes.append(node)
            int_rows.append(rows4)

    iis, jjs = [], []
    for rows3 in leaf_rows:  # AB, AC, BC
        for i, j in ((0, 1), (0, 2), (1, 2)):
            iis.append(rows3[i])
            jjs.append(rows3[j])
    for rows4 in int_rows:   # AB, AC, AD, BC, BD, CD
        for i, j in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            iis.append(rows4[i])
            jjs.append(rows4[j])
    if not iis:
        return
    dist, weight = nj.prof.dist_pairs(np.array(iis), np.array(jjs))
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
    off = 0
    for node in leaf_nodes:
        d = dist[off:off + 3]
        tree.branchlength[node] = (d[0] + d[1] - d[2]) / 2.0
        off += 3
    for node in int_nodes:
        d = dist[off:off + 6]
        tree.branchlength[node] = (d[1] + d[2] + d[3] + d[4]) / 4.0 \
            - (d[0] + d[5]) / 2.0
        off += 6


def tree_length_batched(nj, recompute_profiles: bool) -> float:
    if recompute_profiles:
        rearrange.recompute_profiles_levelwise(nj)
    update_branch_lengths_batched(nj)
    return float(nj.tree.branchlength[: nj.tree.maxnode].sum())
