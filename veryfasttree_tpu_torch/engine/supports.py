"""Split tests and bootstrap resampling (counterpart of
``veryfasttree_tpu/engine/supports.py``; the minimum-evolution local
bootstrap, reliabilityNJ, is not ported yet).

* testSplitsMinEvo (ref tcc:6639-6797): count splits where an NNI would
  shorten the tree, using corrected quartet distances.
* resampleColumns (ref tcc:705-727): the Knuth-stream column picks of the
  SH-like supports, bit-identical to the reference (which never seeds the
  generator, so the default 314159 stream is used).
* The SH-like supports themselves live in engine/ml.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.knuth import KnuthRandom

from . import rearrange
from .rearrange import QAB, QAC, QAD, QBC, QBD, QCD, UpProfiles


@dataclass
class SplitCount:
    """ref SplitCount NeighbourJoining.h:60-69, without the constraint
    counts (constraints are not ported yet)"""
    n_bad_splits: int = 0
    n_splits: int = 0
    d_worst_delta_unconstrained: float = 0.0


def resample_columns(nj) -> np.ndarray:
    """col[iBoot, j] resampled position indices (ref resampleColumns
    tcc:705-727)."""
    rng = KnuthRandom()
    n_pos = nj.n_pos
    col = np.empty((nj.options.n_bootstrap, n_pos), dtype=np.int64)
    for b in range(col.shape[0]):
        for j in range(n_pos):
            col[b, j] = min(max(int(rng.next_double() * n_pos), 0), n_pos - 1)
    return col


def resample_count_matrix(col: np.ndarray, n_pos: int) -> np.ndarray:
    """[P, B] multiplicities: counts[p, b] = times position p is drawn in
    resample b."""
    counts = np.zeros((n_pos, col.shape[0]), dtype=np.float64)
    for b in range(col.shape[0]):
        np.add.at(counts[:, b], col[b], 1.0)
    return counts


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
