"""Level-batched tree passes (counterpart of
``veryfasttree_tpu/engine/batched.py``): the ME branch lengths and split
test of every run, and the -threads > 1 tier's NNI rounds and ML lengths.

All up-profiles are computed top-down in one sweep (balanced averages, one
launch of ``me_average_sweep`` on the card; with use_ml posteriors, one
launch of ``ml_posterior_sweep``), and the branch lengths of the whole tree
come from one pair-distance list (one launch of ``me_dists_list``; the
thread-level-1 analog of ref updateBranchLengths tcc:6502-6598).  The
tables are gathered with one numpy step per tree level or per pass, not
per node.  With -bionj off these are value-identical to the serial walks
in rearrange.py.

-threads > 1 (the reference's relaxed thread-parallel modes, thread levels
1-3) re-expresses a round as whole-tree lists, as the JAX package does:
do_nni_batched decides every internal node's quartet from one list (ME:
the six pair distances of each quartet in one me_dists_list launch; ML:
the three topologies of each quartet fully optimized in one
ml_quartet_opt launch), applies the swaps on the host in node order,
skipping any that touches a node an earlier swap touched, and repairs the
profiles bottom-up in one sweep; optimize_all_branch_lengths_batched runs
the 2 x 3 line searches of a whole tree level as list launches, the
lengths staying on the device until the end of the pass.
"""
from __future__ import annotations

import numpy as np

from .. import constants
from ..ops.store_kernels import AverageTables
from . import rearrange
from .rearrange import ABvsCD, ACvsBD, ADvsBC, QAB, QAC, QAD, QBC, QBD, QCD
from .state import level_order

# a quartet's six pairs in QAB .. QCD order, and a leaf's three (AB, AC, BC)
QUARTET_PAIRS = ((0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3))
LEAF_PAIRS = ((0, 0, 1), (1, 2, 2))
LEN_A, LEN_B, LEN_C, LEN_D, LEN_I = range(5)


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
    node): balanced averages of (C, D), or with use_ml the posteriors of
    (C, D) at their branch lengths (D's the parent's own length; ref
    getUpProfile tcc:3404-3419).  tables: the AverageTables of
    up_profile_levels of this topology, as an earlier ME call returned
    them, or None to build them.  Returns the ME tables, for the next call
    while the topology stands (None with use_ml)."""
    if use_ml:
        tree = nj.tree
        bl = tree.branchlength
        levels = []
        for targets, c, d_row in up_profile_levels(nj):
            nodes = targets - nj.prof.maxnodes
            par = tree.parent[nodes]
            # D's length: the parent's branch, or below the root the root's
            # other child's (d_row is that child)
            len_d = bl[np.where(par == tree.root, d_row, par)]
            levels.append((targets, c, d_row, bl[c], len_d))
        if levels:
            nj.ml.posterior_sweep(levels)
        return None
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


# ---------------------------------------------------------------------------
# -threads > 1: level-batched NNI rounds and ML branch lengths
# ---------------------------------------------------------------------------


def nni_candidates(nj, use_ml: bool, stats) -> np.ndarray:
    """The nodes a batched NNI round decides, in index order: every
    internal node of two children but the root, less those the fastNNI
    heuristic skips (ref tcc:6049-6075: old, settled and supported, with
    no fresh supported change around them)."""
    tree = nj.tree
    opts = nj.options
    threshold = constants.TREE_LOGLK_DELTA if use_ml else opts.me_min_delta
    out = []
    for node in range(nj.n_seqs, tree.maxnode):
        if node == tree.root or tree.parent[node] < 0 \
                or tree.n_child[node] != 2:
            continue
        if opts.fast_nni and (stats.age[node] >= 2
                              and stats.subtree_age[node] >= 2
                              and stats.support[node] > threshold):
            _, nodes4 = rearrange.setup_abcd(nj, None, node, use_ml,
                                             rows=False)
            if all(not (stats.age[nd] == 0 and stats.support[nd] > threshold)
                   for nd in nodes4):
                continue
        out.append(node)
    return np.array(out, dtype=np.int64)


def me_quartet_choices(nj, rows, nodes4):
    """The ME choice [K] and criteria [K, 3] (negated: higher is better, as
    in ML) of K quartets (ref chooseNNI tcc:4836-4882): their six pair
    distances in one list launch and one fetch, then the pseudocounts, the
    log correction and the constraint penalties in float64 numpy, in the
    JAX package's order ([6, K] arrays, a quartet's sums over its six pairs
    in QAB .. QCD order)."""
    opts = nj.options
    K = len(rows)
    dist, weight = nj.prof.dist_pair_list(*pair_list(rows, QUARTET_PAIRS))
    nj.debug.profile_ops += 6 * K
    dist = np.ascontiguousarray(dist.reshape(K, 6).T)
    weight = np.ascontiguousarray(np.where(weight > 0, weight, 0.01)
                                  .reshape(K, 6).T)
    if opts.pseudo_weight > 0:
        bottom = weight.sum(axis=0)
        prior = np.where(bottom > 0.01,
                         (dist * weight).sum(axis=0) / bottom, 3.0)
        pw = opts.pseudo_weight
        dist = (dist * weight + prior[None, :] * pw) / (weight + pw)
    if opts.logdist:
        dist = nj.log_corrected(dist)
    pen = np.zeros((3, K))
    if nj.n_cons:
        for k in range(K):
            pen[:, k] = rearrange.quartet_constraint_penalties(nj, nodes4[k])
    criteria = np.stack([dist[QAB] + dist[QCD] + pen[0],
                         dist[QAC] + dist[QBD] + pen[1],
                         dist[QAD] + dist[QBC] + pen[2]], axis=1)
    better_ac = (criteria[:, ACvsBD] < criteria[:, ABvsCD]) \
        & (criteria[:, ACvsBD] <= criteria[:, ADvsBC])
    better_ad = (criteria[:, ADvsBC] < criteria[:, ABvsCD]) \
        & (criteria[:, ADvsBC] <= criteria[:, ACvsBD]) & ~better_ac
    choice = np.where(better_ac, ACvsBD, np.where(better_ad, ADvsBC, ABvsCD))
    return choice, -criteria


def do_nni_batched(nj, i_round: int, n_rounds: int, use_ml: bool, stats):
    """One NNI round over whole-tree lists (the JAX package's
    do_nni_batched; the thread-level-2 analog of ref DoNNI
    tcc:5997-6183): every up-profile in one sweep, every candidate's
    quartet decided from one list (ME: me_quartet_choices; ML:
    MLProfiles.quartet_nni_rows, the three topologies fully optimized),
    the swaps applied in node order, each skipped where it touches a node
    an earlier swap of the round touched, then every internal profile
    recomputed bottom-up in one sweep.  Returns (n_changes, max_delta)."""
    tree = nj.tree
    if nj.n_seqs <= 3:
        return 0, 0.0
    threshold = constants.TREE_LOGLK_DELTA if use_ml \
        else nj.options.me_min_delta
    compute_up_profiles_levelwise(nj, use_ml)
    nodes = nni_candidates(nj, use_ml, stats)
    if not len(nodes):
        return 0, 0.0
    rows, nodes4 = quartet_rows(nj, nodes), quartet_nodes(nj, nodes)
    new_len = None
    if use_ml:
        bl = tree.branchlength
        choice, criteria, new_len = nj.ml.quartet_nni_rows(
            rows, np.concatenate([bl[nodes4], bl[nodes][:, None]], axis=1))
    else:
        choice, criteria = me_quartet_choices(nj, rows, nodes4)

    n_nni = 0
    d_max_delta = 0.0
    touched = np.zeros(tree.maxnodes, dtype=bool)
    for k, node in enumerate(nodes.tolist()):
        ch = int(choice[k])
        a, b, c, d = (int(x) for x in nodes4[k])
        neighborhood = [node, a, b, c, d, int(tree.parent[node])]
        crit = criteria[k]
        delta = crit[ch] - crit[ABvsCD]
        if ch != ABvsCD and not any(touched[n] for n in neighborhood):
            if ch == ACvsBD:
                tree.replace_child(node, b, c)
                tree.replace_child(int(tree.parent[node]), c, b)
            else:
                tree.replace_child(node, a, c)
                tree.replace_child(int(tree.parent[node]), c, a)
            if new_len is not None:
                # the chosen topology's lengths (A, B, C, D, I in its own
                # order) onto the swapped nodes
                nl = new_len[k].copy()
                if ch == ADvsBC:
                    nl = np.array([nl[LEN_C], nl[LEN_D], nl[LEN_A],
                                   nl[LEN_B], nl[LEN_I]])
                    nl[LEN_A], nl[LEN_C] = nl[LEN_C], nl[LEN_A]
                elif ch == ACvsBD:
                    nl[LEN_B], nl[LEN_C] = nl[LEN_C], nl[LEN_B]
                tree.branchlength[node] = nl[LEN_I]
                tree.branchlength[a] = nl[LEN_A]
                tree.branchlength[b] = nl[LEN_B]
                tree.branchlength[c] = nl[LEN_C]
                tree.branchlength[d] = nl[LEN_D]
            touched[neighborhood] = True
            for nd in (node, a, b, c, d):
                stats.age[nd] = 0
            n_nni += 1
            if use_ml:
                nj.debug.n_ml_nni += 1
            else:
                nj.debug.n_nni += 1
        else:
            stats.age[node] += 1
        stats.delta[node] = delta
        d_max_delta = max(d_max_delta, delta)
        stats.support[node] = min(crit[ch] - crit[kk] for kk in range(3)
                                  if kk != ch)
        if stats.delta[node] > threshold:
            stats.subtree_age[node] = 0
        else:
            stats.subtree_age[node] += 1
            for kk in range(2):
                child = int(tree.children[node, kk])
                stats.subtree_age[node] = min(stats.subtree_age[node],
                                              stats.subtree_age[child])

    if use_ml:
        nj.ml.recompute_ml_profiles()
    else:
        rearrange.recompute_profiles_levelwise(nj)
    return n_nni, d_max_delta


def optimize_all_branch_lengths_batched(nj) -> None:
    """Level-batched ML branch lengths (the JAX package's
    optimize_all_branch_lengths_batched; the thread-level-3 analog of ref
    optimizeAllBranchLengths tcc:5006-5111): every up-profile in one
    sweep, then bottom-up, for the nodes of two or three children of each
    level, 2 x 3 rounds of one posterior list (the two other branches'
    rows into the list-pass rows) and one line-search list (the third
    branch against it), then the level's profiles recomputed for the level
    above.  The lengths stay a float32 tensor on the store's device
    through the pass, every list reading and writing them there, and come
    back in one fetch at the end, float32-rounded as the JAX package's
    are."""
    tree = nj.tree
    ml = nj.ml
    if nj.n_seqs < 2:
        return
    if nj.n_seqs == 2:
        from .ml import ml_pair_optimize
        a, b = int(tree.children[tree.root, 0]), int(tree.children[tree.root,
                                                                     1])
        _, ln = ml_pair_optimize(nj, a, b, 1.0)
        tree.branchlength[a] = ln / 2.0
        tree.branchlength[b] = ln / 2.0
        return
    compute_up_profiles_levelwise(nj, use_ml=True)
    bl = ml.lengths_tensor(tree.branchlength[: tree.maxnodes])
    kids = tree.children
    for level in level_order(tree):
        nodes = level[tree.n_child[level] >= 2]
        if not len(nodes):
            continue
        three = tree.n_child[nodes] == 3
        # the three branches of each node: its children, and its own
        # branch (the up-profile's row) where it has two
        nodes3 = np.stack([kids[nodes, 0], kids[nodes, 1],
                           np.where(three, kids[nodes, 2], nodes)], axis=1)
        rows3 = nodes3.copy()
        rows3[:, 2] = np.where(three, kids[nodes, 2],
                               nj.prof.up_row(nodes))
        scratch = ml.scratch_rows_for(len(nodes))
        for _ in range(2):
            for i in range(3):
                b1, b2 = (i + 1) % 3, (i + 2) % 3
                ml.posterior_rows_at(scratch, rows3[:, b1], rows3[:, b2],
                                     nodes3[:, b1], nodes3[:, b2], bl)
                ml.opt_branch_length_rows(rows3[:, i], scratch,
                                          nodes3[:, i], bl)
        # this level's profiles for the level above
        upd = nodes[nodes != tree.root]
        if len(upd):
            ml.posterior_rows_at(upd, kids[upd, 0], kids[upd, 1],
                                 kids[upd, 0], kids[upd, 1], bl)
        # the JAX package pads each of these lists to a power of 2 and
        # counts the padding's calls too.  The port launches no padding:
        # these counts exist only so that the debug counters (-verbose
        # statistics) read as the JAX package's
        pad = (1 << (len(nodes) - 1).bit_length()) - len(nodes)
        nj.debug.n_posterior_compute += 6 * pad + (
            (1 << (len(upd) - 1).bit_length()) - len(upd) if len(upd) else 0)
        nj.debug.n_lk_compute += 6 * 8 * pad
    tree.branchlength[: tree.maxnodes] = bl.double().cpu().numpy()
