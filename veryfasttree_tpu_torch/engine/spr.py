"""SPR moves: subtree-prune-regraft as chains of NNIs (counterpart of
``veryfasttree_tpu/engine/spr.py``).

ref findSPRSteps tcc:1805-1858, unwindSPRStep :1861-1879, traverseSPR
:6185-6313, SPR :6315-6404.  For each node we try moving it around its parent
and its sibling, in both initial directions, chaining up to maxSPRLength
minimum-evolution NNIs; the best prefix of the chain is kept (or the whole
chain unwound).  Quartet distance evaluations are batched store calls via
rearrange.choose_nni.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import rearrange
from .rearrange import ABvsCD, ACvsBD, ADvsBC, UpProfiles


@dataclass
class SprStep:
    nodes: tuple
    delta_length: float


def find_spr_steps(nj, ups, node_move: int, node_around: int, b_first_ac: bool):
    """Chain <= maxSPRLength NNIs away from node_move (ref tcc:1805-1858)."""
    tree = nj.tree
    steps = []
    for i_step in range(nj.options.max_spr_length):
        if tree.n_child[node_around] != 2:
            break
        rows4, nodes4 = rearrange.setup_abcd(nj, ups, node_around, use_ml=False)
        _, criteria = rearrange.choose_nni(nj, rows4, nodes4)
        if (b_first_ac if i_step == 0 else criteria[ACvsBD] < criteria[ADvsBC]):
            # swap B & C to put A-C together
            step = SprStep((nodes4[1], nodes4[2]),
                           criteria[ACvsBD] - criteria[ABvsCD])
        else:
            # swap A & C to put A-D together
            step = SprStep((nodes4[0], nodes4[2]),
                           criteria[ADvsBC] - criteria[ABvsCD])
        steps.append(step)
        tree.replace_child(node_around, step.nodes[0], step.nodes[1])
        tree.replace_child(int(tree.parent[node_around]), step.nodes[1], step.nodes[0])
        rearrange.update_for_nni(nj, ups, node_around, use_ml=False)

        new_around = [int(tree.parent[node_move]), tree.sibling(node_move)]
        if tree.parent[node_move] == tree.root:
            new_around = tree.root_siblings(node_move)
        assert node_around in new_around and new_around[0] != new_around[1]
        node_around = new_around[1] if new_around[0] == node_around else new_around[0]
    return steps


def unwind_spr_step(nj, ups, step: SprStep) -> None:
    """ref unwindSPRStep tcc:1861-1879."""
    tree = nj.tree
    parents = [int(tree.parent[step.nodes[0]]), int(tree.parent[step.nodes[1]])]
    assert parents[0] >= 0 and parents[1] >= 0 and parents[0] != parents[1]
    tree.replace_child(parents[0], step.nodes[0], step.nodes[1])
    tree.replace_child(parents[1], step.nodes[1], step.nodes[0])
    if tree.parent[parents[0]] == parents[1]:
        younger = 0
    else:
        assert tree.parent[parents[1]] == parents[0]
        younger = 1
    rearrange.update_for_nni(nj, ups, parents[younger], use_ml=False)


def run_spr(nj, i_round: int, n_rounds: int) -> None:
    """One round of SPR moves (ref SPR tcc:6315-6404 + traverseSPR :6185-6313)."""
    opts = nj.options
    tree = nj.tree
    if nj.n_seqs <= 3 or opts.max_spr_length < 1:
        return
    last_tot_len = 0.0
    if opts.slow:
        last_tot_len = rearrange.tree_length(nj, recompute_profiles=True)

    node_list = list(tree.postorder_nodes())
    ups = UpProfiles(nj)
    for idx, node in enumerate(node_list):
        if node == tree.root:
            continue
        if nj.progress is not None and idx % 100 == 0 and idx > 0:
            nj.progress.print("SPR round %3d of %3d, %d of %d nodes",
                              i_round + 1, n_rounds, idx + 1, len(node_list))
        node_around = [int(tree.parent[node]), tree.sibling(node)]
        if tree.parent[node] == tree.root:
            node_around = tree.root_siblings(node)
        b_changed = False
        for i_around in range(2):
            if b_changed:
                break
            for ac_first in (False, True):
                if b_changed:
                    break
                steps = find_spr_steps(nj, ups, node, node_around[i_around],
                                       ac_first)
                d_min_delta = 0.0
                i_c_best = -1
                d_tot = 0.0
                for i_c, step in enumerate(steps):
                    d_tot += step.delta_length
                    if d_tot < d_min_delta:
                        d_min_delta = d_tot
                        i_c_best = i_c
                for i_c in range(len(steps) - 1, i_c_best, -1):
                    unwind_spr_step(nj, ups, steps[i_c])
                while opts.slow and i_c_best >= 0:
                    expected = last_tot_len + d_min_delta
                    new_tot = rearrange.tree_length(nj, recompute_profiles=True)
                    if new_tot < last_tot_len:
                        last_tot_len = new_tot
                        break
                    unwind_spr_step(nj, ups, steps[i_c_best])
                    d_min_delta -= steps[i_c_best].delta_length
                    i_c_best -= 1
                if i_c_best >= 0:
                    b_changed = True
        if b_changed:
            nj.debug.n_spr += 1
            ups.reset_all()
            ancestor = int(tree.parent[node])
            while ancestor >= 0:
                rearrange.recompute_profile(nj, ups, ancestor, use_ml=False)
                ancestor = int(tree.parent[ancestor])
