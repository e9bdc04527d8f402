"""Partitioned, lockstep SPR rounds of the -threads > 1 tier (counterpart of
``veryfasttree_tpu/engine/spr_batched.py``; the thread-level-4 analog of
ref SPR tcc:6342-6401).

The tree is split into subtrees (tree_partitioning(maxSPRLength + 1),
engine/partition.py).  Each subtree runs the serial round's chain logic
(engine/spr.py) as a generator that yields the four rows of each quartet
it must decide and receives their six pair distances.  run_spr_batched
advances the generators in partition order, a lockstep step at a time:
one me_dists_list launch and one fetch per step over every pending
chain's six pairs, each generator then taking its six values in that
order.  The chains' lazy up-profiles and profile repairs stay single store
calls, made as each generator runs, so a chain sees the profiles the
chains before it in the same step wrote, as in the JAX package.  A serial
pass then covers the nodes the partitions skipped at their boundaries
(ref tcc:6403).
"""
from __future__ import annotations

import numpy as np

from . import rearrange
from .batched import QUARTET_PAIRS, pair_list
from .partition import tree_partitioning
from .rearrange import ABvsCD, ACvsBD, ADvsBC, QAB, QAC, QAD, QBC, QBD, QCD
from .rearrange import UpProfiles
from .spr import SprStep, find_spr_steps, unwind_spr_step


def _corrected6_from(nj, dist, weight):
    """ref correctedPairDistances tcc:1460-1488 of one quartet's six
    fetched distances and weights, in rearrange.corrected_pair_distances'
    numpy order."""
    weight = np.where(weight > 0, weight, 0.01)
    if nj.options.pseudo_weight > 0:
        pw = nj.options.pseudo_weight
        bottom = weight.sum()
        prior = (dist * weight).sum() / bottom if bottom > 0.01 else 3.0
        dist = (dist * weight + prior * pw) / (weight + pw)
    if nj.options.logdist:
        dist = nj.log_corrected(dist)
    return dist


def _criteria6(nj, d, nodes4):
    """The three topologies' criteria (ref chooseNNI tcc:4836-4882), with
    the constraint penalties of the quartet around nodes4."""
    penalty = rearrange.quartet_constraint_penalties(nj, nodes4)
    return np.array([d[QAB] + d[QCD] + penalty[0],
                     d[QAC] + d[QBD] + penalty[1],
                     d[QAD] + d[QBC] + penalty[2]])


def _spr_chain_gen(nj, ups, node_move, node_around, b_first_ac):
    """find_spr_steps as a generator: yields the rows (A, B, C, D) of each
    quartet to decide, receives their six pairs' (dist, weight), returns
    the steps (ref findSPRSteps tcc:1805-1858)."""
    tree = nj.tree
    steps = []
    for i_step in range(nj.options.max_spr_length):
        if tree.n_child[node_around] != 2:
            break
        rows4, nodes4 = rearrange.setup_abcd(nj, ups, node_around,
                                             use_ml=False)
        dist, weight = yield rows4
        nj.debug.profile_ops += 6
        criteria = _criteria6(nj, _corrected6_from(nj, dist, weight), nodes4)
        if (b_first_ac if i_step == 0
                else criteria[ACvsBD] < criteria[ADvsBC]):
            step = SprStep((nodes4[1], nodes4[2]),
                           criteria[ACvsBD] - criteria[ABvsCD])
        else:
            step = SprStep((nodes4[0], nodes4[2]),
                           criteria[ADvsBC] - criteria[ABvsCD])
        steps.append(step)
        tree.replace_child(node_around, step.nodes[0], step.nodes[1])
        tree.replace_child(int(tree.parent[node_around]), step.nodes[1],
                           step.nodes[0])
        rearrange.update_for_nni(nj, ups, node_around, use_ml=False)
        new_around = [int(tree.parent[node_move]), tree.sibling(node_move)]
        if tree.parent[node_move] == tree.root:
            new_around = tree.root_siblings(node_move)
        node_around = new_around[1] if new_around[0] == node_around \
            else new_around[0]
    return steps


def _keep_best_prefix(nj, ups, steps) -> bool:
    """Unwind the steps after the chain's best prefix (the one of least
    total delta, if below 0); True where a prefix is kept."""
    d_min, best, tot = 0.0, -1, 0.0
    for i_c, step in enumerate(steps):
        tot += step.delta_length
        if tot < d_min:
            d_min, best = tot, i_c
    for i_c in range(len(steps) - 1, best, -1):
        unwind_spr_step(nj, ups, steps[i_c])
    return best >= 0


def _around(tree, node):
    if tree.parent[node] == tree.root:
        return tree.root_siblings(node)
    return [int(tree.parent[node]), tree.sibling(node)]


def _repair_up(nj, ups, node, stop) -> None:
    """After a kept move of node: every ancestor's profile recomputed, up
    to (not including) stop."""
    tree = nj.tree
    nj.debug.n_spr += 1
    ups.reset_all()
    ancestor = int(tree.parent[node])
    while ancestor >= 0 and ancestor != stop:
        rearrange.recompute_profile(nj, ups, ancestor, use_ml=False)
        ancestor = int(tree.parent[ancestor])


def _worker_gen(nj, sub_root, processed):
    """traverseSPR over one subtree (ref tcc:6185-6313) as a generator of
    quartet rows: its nodes in postorder, less those whose parent chain
    reaches the subtree's boundary within maxSPRLength + 1 steps (marked
    in `processed` otherwise)."""
    tree = nj.tree
    max_len = nj.options.max_spr_length
    ups = UpProfiles(nj)
    root_parent = int(tree.parent[sub_root])
    for node in list(tree.postorder_nodes(sub_root)):
        if node == tree.root or node == sub_root:
            continue
        limit = int(tree.parent[node])
        reached = False
        for _ in range(max_len + 1):
            if limit == root_parent:
                reached = True
                break
            if limit < 0:
                break
            limit = int(tree.parent[limit])
        if reached:
            continue
        processed[node] = True
        node_around = _around(tree, node)
        b_changed = False
        for i_around in range(2):
            if b_changed:
                break
            for ac_first in (False, True):
                if b_changed:
                    break
                steps = yield from _spr_chain_gen(
                    nj, ups, node, node_around[i_around], ac_first)
                b_changed = _keep_best_prefix(nj, ups, steps or [])
        if b_changed:
            _repair_up(nj, ups, node, root_parent)


def run_spr_batched(nj, i_round: int, n_rounds: int) -> None:
    """One partitioned SPR round (ref SPR tcc:6315-6404 with threads):
    the subtrees of tree_partitioning(maxSPRLength + 1, workers
    max(threads, 8)) in lockstep, one me_dists_list launch per step, then
    the serial pass over the nodes they skipped.  Adds the steps and the
    launches to run_spr_batched.steps."""
    tree = nj.tree
    opts = nj.options
    if nj.n_seqs <= 3 or opts.max_spr_length < 1:
        return
    roots = tree_partitioning(nj, opts.max_spr_length + 1,
                              workers=max(opts.threads, 8))
    processed = np.zeros(tree.maxnodes, dtype=bool)
    gens, pending = [], []
    for r in roots:
        g = _worker_gen(nj, int(r), processed)
        try:
            pending.append(next(g))
            gens.append(g)
        except StopIteration:
            pass

    # lockstep: one list of six pairs per pending chain, one fetch
    while gens:
        dist, weight = nj.prof.dist_pair_list(*pair_list(
            np.asarray(pending, dtype=np.int64), QUARTET_PAIRS))
        run_spr_batched.steps += 1
        next_gens, next_pending = [], []
        for k, g in enumerate(gens):
            try:
                next_pending.append(g.send((dist[6 * k: 6 * k + 6],
                                            weight[6 * k: 6 * k + 6])))
                next_gens.append(g)
            except StopIteration:
                pass
        gens, pending = next_gens, next_pending

    # the serial pass over everything the partitions skipped (ref tcc:6403)
    ups = UpProfiles(nj)
    for node in list(tree.postorder_nodes()):
        if node == tree.root or processed[node]:
            continue
        node_around = _around(tree, node)
        b_changed = False
        for i_around in range(2):
            if b_changed:
                break
            for ac_first in (False, True):
                if b_changed:
                    break
                b_changed = _keep_best_prefix(nj, ups, find_spr_steps(
                    nj, ups, node, node_around[i_around], ac_first))
        if b_changed:
            _repair_up(nj, ups, node, -1)


# lockstep steps (each one me_dists_list launch and one fetch), summed over
# rounds
run_spr_batched.steps = 0
