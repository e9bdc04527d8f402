"""Tree rearrangements: up-profiles, corrected distances, ME and ML NNIs, ME
branch lengths (counterpart of the serial path of
``veryfasttree_tpu/engine/rearrange.py``).

Mirrors the reference semantics exactly:
* setupABCD / getUpProfile (ref tcc:1942-1974, 3382-3434) -- lazily computed
  "rest of tree" profiles, stored in the second half of the device profile
  array (row maxnodes+node).
* correctedPairDistances (ref tcc:1460-1488): raw profile distances +
  pseudocounts + log correction -- all 6 pairs in one batched device call.
* chooseNNI / DoNNI round (ref tcc:4836-4882, 5797-6183) with the NNIStats
  aging/skip heuristics; with use_ml the ML store keeps posterior profiles
  and each quartet is decided by ML quartet optimization (engine/ml.py).
* updateBranchLengths (ref tcc:6502-6598): leaf 3-point and internal 4-point
  formulas.
* SPR (ref tcc:1805-1879, 6185-6404): chains of NNIs with best-prefix keep.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from veryfasttree_tpu import constants

# quartet pair order, as in ref enum QuartetPair
QAB, QAC, QAD, QBC, QBD, QCD = range(6)
ABvsCD, ACvsBD, ADvsBC = range(3)


@dataclass
class NNIStats:
    """ref NNIStats (NeighbourJoining.h:53-58) as arrays."""
    age: np.ndarray
    subtree_age: np.ndarray
    delta: np.ndarray
    support: np.ndarray

    @classmethod
    def init(cls, nj):
        large = 1000000
        n = nj.tree.maxnode
        age = np.zeros(n, dtype=np.int64)
        sub = np.zeros(n, dtype=np.int64)
        leaf_or_root = np.arange(n) < nj.n_seqs
        leaf_or_root[nj.tree.root] = True
        age[leaf_or_root] = large
        sub[leaf_or_root] = large
        return cls(age, sub, np.zeros(n), np.zeros(n))


class UpProfiles:
    """Per-traversal cache of up-profile validity; data lives on device."""

    def __init__(self, nj):
        self.nj = nj
        self.valid = set()

    def reset(self, node: int) -> None:
        self.valid.discard(node)

    def reset_all(self) -> None:
        self.valid.clear()

    def row(self, node: int) -> int:
        return self.nj.prof.up_row(node)

    def get(self, node: int, use_ml: bool) -> int:
        """Compute (if needed) and return the row of node's up-profile
        (ref getUpProfile tcc:3382-3434)."""
        nj = self.nj
        tree = nj.tree
        assert node != tree.root and node >= nj.n_seqs
        if node in self.valid:
            return self.row(node)
        path = tree.path_to_root(node)
        for n in path[-2::-1]:  # from just below root down to node
            if n in self.valid:
                continue
            rows4, nodes4 = setup_abcd(nj, self, n, use_ml)
            if use_ml:
                bl = tree.branchlength
                nj.ml.posterior_into(self.row(n), rows4[2], rows4[3],
                                     bl[nodes4[2]], bl[nodes4[3]])
            else:
                # upProfile = weighted avg of (C, D); BIONJ weight from the
                # CDAB-ordered quartet (ref tcc:3421-3428)
                weight = quartet_weight(nj, [rows4[2], rows4[3], rows4[0],
                                             rows4[1]])
                nj.prof.set_from_average(self.row(n), rows4[2], rows4[3],
                                         weight)
            self.valid.add(n)
        return self.row(node)


def setup_abcd(nj, ups, node: int, use_ml: bool, rows: bool = True):
    """ref setupABCD tcc:1942-1974.  Returns (rows4 or None, nodesABCD)."""
    tree = nj.tree
    par = int(tree.parent[node])
    assert par >= 0 and tree.n_child[node] == 2
    a, b = int(tree.children[node, 0]), int(tree.children[node, 1])
    if par == tree.root:
        sibs = tree.root_siblings(node)
        c, d = sibs[0], sibs[1]
        rows4 = [a, b, c, d] if rows else None
    else:
        c = tree.sibling(node)
        d = par
        rows4 = [a, b, c, ups.get(par, use_ml)] if rows else None
    return rows4, [a, b, c, d]


def corrected_pair_distances(nj, rows, n_profiles: int):
    """ref correctedPairDistances tcc:1460-1488 -- batched over all pairs."""
    pairs = [(i, j) for i in range(n_profiles) for j in range(i + 1, n_profiles)]
    iis = [rows[i] for i, _ in pairs]
    jjs = [rows[j] for _, j in pairs]
    dist, weight = nj.prof.dist_pairs(np.array(iis), np.array(jjs))
    nj.debug.profile_ops += len(pairs)
    weight = np.where(weight > 0, weight, 0.01)
    if nj.options.pseudo_weight > 0:
        bottom = weight.sum()
        prior = (dist * weight).sum() / bottom if bottom > 0.01 else 3.0
        pw = nj.options.pseudo_weight
        dist = (dist * weight + prior * pw) / (weight + pw)
    if nj.options.logdist:
        dist = nj.log_corrected(dist)
    return dist


def quartet_weight(nj, rows4) -> float:
    """BIONJ-ish profile weighting (ref quartetWeight tcc:3541-3561)."""
    if not nj.options.bionj:
        return -1.0
    d = corrected_pair_distances(nj, rows4, 4)
    if d[QAB] < 0.01:
        return -1.0
    weight = 0.5 + ((d[QBC] + d[QBD]) - (d[QAC] + d[QAD])) / (4 * d[QAB])
    return min(max(weight, 0.0), 1.0)


def choose_nni(nj, rows4):
    """ME NNI chooser (ref chooseNNI tcc:4836-4882), without constraint
    penalties (constraints are not ported yet)."""
    d = corrected_pair_distances(nj, rows4, 4)
    criteria = np.array([d[QAB] + d[QCD], d[QAC] + d[QBD], d[QAD] + d[QBC]])
    choice = ABvsCD
    if criteria[ACvsBD] < criteria[ABvsCD] and criteria[ACvsBD] <= criteria[ADvsBC]:
        choice = ACvsBD
    elif criteria[ADvsBC] < criteria[ABvsCD] and criteria[ADvsBC] <= criteria[ACvsBD]:
        choice = ADvsBC
    return choice, criteria


def recompute_profile(nj, ups, node: int, use_ml: bool) -> None:
    """ref recomputeProfile tcc:3436-3472."""
    tree = nj.tree
    if node < nj.n_seqs or node == tree.root:
        return
    assert tree.n_child[node] == 2
    c0, c1 = int(tree.children[node, 0]), int(tree.children[node, 1])
    if use_ml:
        nj.ml.posterior_into(node, c0, c1, tree.branchlength[c0],
                             tree.branchlength[c1])
        return
    if nj.options.bionj:
        rows4, _ = setup_abcd(nj, ups, node, use_ml=False)
        weight = quartet_weight(nj, rows4)
    else:
        weight = -1.0
    nj.prof.set_from_average(node, c0, c1, weight)
    nj.debug.profile_avg_ops += 1


def update_for_nni(nj, ups, node: int, use_ml: bool) -> None:
    """ref updateForNNI tcc:1882-1927."""
    tree = nj.tree
    if nj.options.slow:
        ups.reset_all()
        ancestor = node
        while ancestor >= 0:
            recompute_profile(nj, ups, ancestor, use_ml)
            ancestor = int(tree.parent[ancestor])
        ups.reset_all()
        return
    ups.reset(node)
    for k in range(tree.n_child[node]):
        ups.reset(int(tree.children[node, k]))
    assert node != tree.root
    par = int(tree.parent[node])
    neighbors = [par, tree.sibling(node)]
    if par == tree.root:
        neighbors = tree.root_siblings(node)
    for nb in neighbors:
        ups.reset(nb)
    uncle = tree.sibling(par)
    if uncle >= 0:
        ups.reset(uncle)
    recompute_profile(nj, ups, node, use_ml)
    recompute_profile(nj, ups, par, use_ml)


def do_nni(nj, i_round: int, n_rounds: int, use_ml: bool, stats: NNIStats):
    """One round of NNIs (ref DoNNI tcc:5997-6183 + traverseNNI :5797-5995).

    Returns (n_changes, max_delta).  With use_ml, the quartets are decided
    and their branch lengths set by ML quartet optimization (engine/ml.py).
    """
    opts = nj.options
    tree = nj.tree
    support_threshold = constants.TREE_LOGLK_DELTA if use_ml \
        else opts.me_min_delta
    n_nni = 0
    d_max_delta = 0.0
    if nj.n_seqs <= 3:
        return 0, 0.0

    traversal = np.zeros(tree.maxnodes, dtype=bool)
    # skip-subtree heuristic (ref tcc:6049-6075)
    if opts.fast_nni:
        for node in range(tree.maxnode):
            if (node != tree.root and node >= nj.n_seqs
                    and stats.age[node] >= 2 and stats.subtree_age[node] >= 2
                    and stats.support[node] > support_threshold):
                _, nodes4 = setup_abcd(nj, None, node, use_ml, rows=False)
                if all(not (stats.age[nd] == 0 and stats.support[nd] > support_threshold)
                       for nd in nodes4):
                    traversal[node] = True

    ups = UpProfiles(nj)
    node = tree.root
    while True:
        node, up = tree.traverse_postorder(node, traversal, tree.root, want_up=True)
        if node is None:
            break
        if node < nj.n_seqs or node == tree.root:
            continue
        if up:
            # back up through a swapped node: repair its profile (ref :5809-5819)
            for k in range(tree.n_child[node]):
                ups.reset(int(tree.children[node, k]))
            ups.reset(node)
            recompute_profile(nj, ups, node, use_ml)
            continue

        rows4, nodes4 = setup_abcd(nj, ups, node, use_ml)
        node_a, node_b, node_c, node_d = nodes4

        if use_ml:
            from . import ml
            bl = tree.branchlength
            choice, criteria, new_len = ml.ml_quartet_nni(
                nj, rows4, np.array([bl[node_a], bl[node_b], bl[node_c],
                                     bl[node_d], bl[node]]))
        else:
            choice, criteria = choose_nni(nj, rows4)
            criteria = -criteria  # invert so higher is better, as in ML

        if choice == ACvsBD:
            tree.replace_child(node, node_b, node_c)
            tree.replace_child(int(tree.parent[node]), node_c, node_b)
        elif choice == ADvsBC:
            tree.replace_child(node, node_a, node_c)
            tree.replace_child(int(tree.parent[node]), node_c, node_a)

        if use_ml:
            # the optimized lengths onto the post-swap topology (ref
            # :5887-5917); new_len is (A, B, C, D, I) of the chosen quartet
            la, lb, lc, ld, li = new_len
            if choice == ADvsBC:
                la, lb, lc, ld = lc, ld, la, lb
                la, lc = lc, la
            elif choice == ACvsBD:
                lb, lc = lc, lb
            for nd, ln in ((node, li), (node_a, la), (node_b, lb),
                           (node_c, lc), (node_d, ld)):
                tree.branchlength[nd] = ln

        # stats updates (ref :5931-5971)
        if choice == ABvsCD:
            stats.age[node] += 1
        else:
            if use_ml:
                nj.debug.n_ml_nni += 1
            else:
                nj.debug.n_nni += 1
            n_nni += 1
            for nd in [node, node_a, node_b, node_c, node_d]:
                stats.age[nd] = 0
        stats.delta[node] = criteria[choice] - criteria[ABvsCD]
        if stats.delta[node] > d_max_delta:
            d_max_delta = stats.delta[node]
        stats.support[node] = min(criteria[choice] - criteria[k]
                                  for k in range(3) if k != choice)
        if stats.delta[node] > support_threshold:
            stats.subtree_age[node] = 0
        else:
            stats.subtree_age[node] += 1
            for k in range(2):
                ch = int(tree.children[node, k])
                if stats.subtree_age[node] > stats.subtree_age[ch]:
                    stats.subtree_age[node] = stats.subtree_age[ch]

        if choice == ABvsCD:
            for nd in [node_a, node_b, node_c]:
                ups.reset(nd)
            recompute_profile(nj, ups, node, use_ml)
            if opts.slow and use_ml:
                update_for_nni(nj, ups, node, use_ml)
        else:
            update_for_nni(nj, ups, node, use_ml)
    return n_nni, d_max_delta


# ---------------------------------------------------------------------------
# ME branch lengths & tree length
# ---------------------------------------------------------------------------


def update_branch_lengths(nj) -> None:
    """ref updateBranchLengths tcc:6502-6598."""
    tree = nj.tree
    if nj.n_seqs < 2:
        return
    if nj.n_seqs == 2:
        a, b = int(tree.children[tree.root, 0]), int(tree.children[tree.root, 1])
        d, _ = nj.prof.dist_pairs([a], [b])
        dist = nj.log_corrected(d[0]) if nj.options.logdist else d[0]
        tree.branchlength[a] = dist / 2.0
        tree.branchlength[b] = dist / 2.0
        return
    ups = UpProfiles(nj)
    for node in tree.postorder_nodes():
        if node == tree.root:
            continue
        if node < nj.n_seqs:
            sib = tree.sibling(node)
            if sib == -1:
                sibs = tree.root_siblings(node)
                rows3 = [node, sibs[0], sibs[1]]
            else:
                rows3 = [node, sib, ups.get(int(tree.parent[node]), use_ml=False)]
            d = corrected_pair_distances(nj, rows3, 3)
            tree.branchlength[node] = (d[0] + d[1] - d[2]) / 2.0
        else:
            rows4, nodes4 = setup_abcd(nj, ups, node, use_ml=False)
            d = corrected_pair_distances(nj, rows4, 4)
            tree.branchlength[node] = (d[QAC] + d[QAD] + d[QBC] + d[QBD]) / 4.0 \
                - (d[QAB] + d[QCD]) / 2.0
            ups.reset(nodes4[0])
            ups.reset(nodes4[1])


def recompute_profiles_levelwise(nj, dmat=None) -> None:
    """Bottom-up unweighted re-average of all internal profiles, one batched
    store call per tree level (ref recomputeProfiles tcc:3482-3505 via
    parallelTraverse)."""
    tree = nj.tree
    levels = []
    for level in tree.level_lists():
        nodes = [int(n) for n in level
                 if tree.n_child[n] == 2]
        if not nodes:
            continue
        iis = [int(tree.children[n, 0]) for n in nodes]
        jjs = [int(tree.children[n, 1]) for n in nodes]
        levels.append((nodes, iis, jjs))
        nj.debug.profile_avg_ops += len(nodes)
    if levels:
        nj.prof.average_sweep(levels)


def tree_length(nj, recompute_profiles: bool) -> float:
    """ref treeLength tcc:6607-6637."""
    if recompute_profiles:
        recompute_profiles_levelwise(nj)
    update_branch_lengths(nj)
    return float(nj.tree.branchlength[: nj.tree.maxnode].sum())
