"""Split tests (counterpart of the minimum-evolution split test of
``veryfasttree_tpu/engine/supports.py``; bootstrap supports are not ported).

testSplitsMinEvo (ref tcc:6639-6797): count splits where an NNI would
shorten the tree, using corrected quartet distances.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import rearrange
from .rearrange import QAB, QAC, QAD, QBC, QBD, QCD, UpProfiles


@dataclass
class SplitCount:
    """ref SplitCount NeighbourJoining.h:60-69, without the constraint
    counts (constraints are not ported yet)"""
    n_bad_splits: int = 0
    n_splits: int = 0
    d_worst_delta_unconstrained: float = 0.0


def test_splits_min_evo(nj) -> SplitCount:
    """ref testSplitsMinEvo tcc:6639-6797"""
    sc = SplitCount()
    tree = nj.tree
    if nj.n_seqs <= 3:
        return sc
    tol = 1e-6
    ups = UpProfiles(nj)
    for node in tree.postorder_nodes():
        if node < nj.n_seqs or node == tree.root:
            continue
        rows4, nodes4 = rearrange.setup_abcd(nj, ups, node, use_ml=False)
        d = rearrange.corrected_pair_distances(nj, rows4, 4)
        s_ab_cd = d[QAB] + d[QCD]
        s_ac_bd = d[QAC] + d[QBD]
        s_ad_bc = d[QAD] + d[QBC]
        delta = s_ab_cd - min(s_ac_bd, s_ad_bc)
        sc.n_splits += 1
        if delta > tol:
            sc.n_bad_splits += 1
            sc.d_worst_delta_unconstrained = max(
                delta, sc.d_worst_delta_unconstrained)
        ups.reset(nodes4[0])
        ups.reset(nodes4[1])
    return sc
