"""Split tests and bootstrap resampling (counterpart of
``veryfasttree_tpu/engine/supports.py``; the minimum-evolution local
bootstrap, reliabilityNJ, is not ported yet).

* testSplitsMinEvo (ref tcc:6639-6797): count splits where an NNI would
  shorten the tree, using corrected quartet distances: the serial walk
  (test_splits_min_evo, which -bionj takes), and the batched test
  (test_splits_min_evo_batched: one up-profile sweep, one pair-distance
  list, one fetch), value-identical to it with -bionj off.
* resampleColumns (ref tcc:705-727): the Knuth-stream column picks of the
  SH-like supports, bit-identical to the reference (which never seeds the
  generator, so the default 314159 stream is used).
* The SH-like supports themselves live in engine/ml.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.knuth import KnuthRandom

from . import batched, rearrange
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


def test_splits_min_evo_batched(nj, up_tables=None) -> SplitCount:
    """Level-batched testSplitsMinEvo (ref tcc:6639-6797; the JAX package's
    test_splits_min_evo_batched without the constraint counts): every
    up-profile in one sweep of balanced averages, every quartet's six pair
    distances in one list and one fetch, then the corrections and the
    counts in host numpy.  With -bionj off (plain 0.5 up-profiles) the
    SplitCount and the debug counters are the serial walk's bit for bit:
    each distance is its pair's, and each correction takes numpy's
    operations in the serial walk's order.  up_tables: the up-profile
    sweep's tables of this topology (update_branch_lengths_batched returns
    them), or None to build them."""
    sc = SplitCount()
    if nj.n_seqs <= 3:
        return sc
    tol = 1e-6
    batched.compute_up_profiles_levelwise(nj, False, up_tables)
    nodes = batched.split_nodes(nj)
    K = len(nodes)
    if not K:
        return sc
    # quartet by quartet, so that a quartet's rows are read close in time
    dist, weight = nj.prof.dist_pair_list(*batched.pair_list(
        batched.quartet_rows(nj, nodes), batched.QUARTET_PAIRS))
    nj.debug.profile_ops += 6 * K
    dist = np.ascontiguousarray(dist.reshape(K, 6).T)
    weight = np.ascontiguousarray(np.where(weight > 0, weight, 0.01)
                                  .reshape(K, 6).T)
    if nj.options.pseudo_weight > 0:
        # each quartet's sums over its six pairs in order, as the serial
        # walk's 6-element sums take them
        bottom = weight.sum(axis=0)
        prior = np.where(bottom > 0.01,
                         (dist * weight).sum(axis=0) / bottom, 3.0)
        pw = nj.options.pseudo_weight
        dist = (dist * weight + prior[None, :] * pw) / (weight + pw)
    if nj.options.logdist:
        dist = nj.log_corrected(dist)
    s_ab_cd = dist[QAB] + dist[QCD]
    s_ac_bd = dist[QAC] + dist[QBD]
    s_ad_bc = dist[QAD] + dist[QBC]
    # min(s_ac_bd, s_ad_bc) as Python's min takes it
    delta = s_ab_cd - np.where(s_ad_bc < s_ac_bd, s_ad_bc, s_ac_bd)
    bad = delta > tol
    sc.n_splits = K
    sc.n_bad_splits = int(bad.sum())
    if sc.n_bad_splits:
        sc.d_worst_delta_unconstrained = float(delta[bad].max())
    return sc
