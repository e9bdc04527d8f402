"""Split tests, the minimum-evolution local bootstrap and bootstrap
resampling (counterpart of ``veryfasttree_tpu/engine/supports.py``).

* testSplitsMinEvo (ref tcc:6639-6797): count splits where an NNI would
  shorten the tree, using corrected quartet distances: the serial walk
  (test_splits_min_evo, which -bionj takes), and the batched test
  (test_splits_min_evo_batched: one up-profile sweep, one pair-distance
  list, one fetch), value-identical to it with -bionj off.
* reliabilityNJ / splitSupport (ref tcc:608-703, 3191-3238): the local
  bootstrap of every split (LocalBootstrap): each quartet's six pairs'
  per-position distance pieces and weights in one kernel launch, their
  sums under every resample as one float64 product with the [P, B + 1]
  resample counts (and a column of ones for the plain sums), the
  decisions on the device.  The whole-tree form (reliability_nj_list: the
  split test's up-profiles and quartets, chunks of splits) is the serial
  walk's (reliability_nj, which -bionj takes) bit for bit.
* resampleColumns (ref tcc:705-727): the Knuth-stream column picks of the
  bootstraps, bit-identical to the reference (which never seeds the
  generator, so the default 314159 stream is used).
* The SH-like supports themselves live in engine/ml.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import resample_kernels
from ..utils.knuth import KnuthRandom

from . import batched, rearrange
from .rearrange import (QAB, QAC, QAD, QBC, QBD, QCD, ACvsBD, ADvsBC,
                        UpProfiles)


@dataclass
class SplitCount:
    """ref SplitCount NeighbourJoining.h:60-69"""
    n_bad_splits: int = 0
    n_constraint_violations: int = 0
    n_bad_both: int = 0
    n_splits: int = 0
    d_worst_delta_unconstrained: float = 0.0
    d_worst_delta_constrained: float = 0.0

    def count(self, delta, bad, pen, choice, violated, tol=1e-6) -> None:
        """Add splits to the counts, in order (ref testSplitsMinEvo
        tcc:6639-6797 and testSplitsML :6856-6999 after their choices):
        delta [K] the best alternative's lead, bad [K] whether it counts as
        a bad split, pen [K, 3] the constraint penalties, choice [K] the
        best alternative, violated [K] whether a constraint is violated."""
        k = np.arange(len(delta))
        self.n_splits += len(delta)
        self.n_bad_splits += int(np.count_nonzero(bad))
        self.n_constraint_violations += int(np.count_nonzero(violated))
        bad_constr = (pen[:, 0] > pen[:, 1] + tol) | (pen[:, 0] > pen[:, 2] + tol)
        self.n_bad_both += int(np.count_nonzero(bad & bad_constr))
        constrained = pen[k, choice] > pen[:, 0] + tol
        for i in np.flatnonzero(bad):
            if constrained[i]:
                self.d_worst_delta_constrained = max(
                    delta[i], self.d_worst_delta_constrained)
            else:
                self.d_worst_delta_unconstrained = max(
                    delta[i], self.d_worst_delta_unconstrained)


def split_violates_constraint(nj, nodes4, i_cons: int) -> bool:
    """ref splitViolatesConstraint tcc:1531-1563"""
    codes = []
    for nd in nodes4:
        on, off = nj.con_on[nd][i_cons], nj.con_off[nd][i_cons]
        if on + off == 0:
            return False
        codes.append(1 if (on > 0 and off == 0)
                     else (0 if off > 0 and on == 0 else -1))
    n0 = codes.count(0)
    n1 = codes.count(1)
    if n0 >= 3 or n1 >= 3:
        return False
    if n0 == 2 and n1 == 2 and codes[0] == codes[1] and codes[2] == codes[3]:
        return False
    return True


def split_constraints(nj, nodes4) -> tuple:
    """The constraint penalties [K, 3] and violations [K] (any constraint
    split_violates_constraint) of the quartets nodes4 [K, 4]; zeros and
    False without constraints."""
    K = len(nodes4)
    pen = np.zeros((K, 3))
    violated = np.zeros(K, dtype=bool)
    if nj.n_cons:
        for k, n4 in enumerate(np.asarray(nodes4).tolist()):
            pen[k] = rearrange.quartet_constraint_penalties(nj, n4)
            violated[k] = any(split_violates_constraint(nj, n4, c)
                              for c in range(nj.n_cons))
    return pen, violated


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
        pen, violated = split_constraints(nj, [nodes4])
        sc.count(np.array([delta]), np.array([delta > tol]), pen,
                 np.array([ACvsBD if s_ac_bd < s_ad_bc else ADvsBC]),
                 violated, tol)
        ups.reset(nodes4[0])
        ups.reset(nodes4[1])
    return sc


def test_splits_min_evo_batched(nj, up_tables=None) -> SplitCount:
    """Level-batched testSplitsMinEvo (ref tcc:6639-6797; the JAX package's
    test_splits_min_evo_batched): every
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
    pen, violated = split_constraints(nj, batched.quartet_nodes(nj, nodes))
    sc.count(delta, delta > tol, pen,
             np.where(s_ac_bd < s_ad_bc, ACvsBD, ADvsBC), violated, tol)
    return sc


def split_support_host(nj, pieces, weights, counts):
    """The reference's splitSupport (ref tcc:608-703; the JAX package's
    split_support after its fetch) of one split in host numpy: pieces and
    weights float64 [6, P] (QAB .. QCD), counts the [P, B] resample counts.
    Returns (suboptimal, n_support): whether the split is not the best of
    its quartet's three, and the number of resamples that support it."""
    def dists_from(totp, totw):
        d = np.where(totw > 0.01, totp / np.where(totw > 0.01, totw, 1.0), 3.0)
        if nj.options.logdist:
            d = nj.log_corrected(d)
        return d

    dists = dists_from(pieces.sum(axis=1), weights.sum(axis=1))
    support1 = dists[QAC] + dists[QBD] - dists[QAB] - dists[QCD]
    support2 = dists[QAD] + dists[QBC] - dists[QAB] - dists[QCD]
    d = dists_from(pieces @ counts, weights @ counts)
    s1 = d[QAC] + d[QBD] - d[QAB] - d[QCD]
    s2 = d[QAD] + d[QBC] - d[QAB] - d[QCD]
    return (bool(support1 < 0 or support2 < 0),
            int(((s1 > 0) & (s2 > 0)).sum()))


# unit roundoff of float64
_U64 = 2.0 ** -53


class LocalBootstrap:
    """The local bootstrap of lists of splits on the store's device
    (counterpart of the JAX package's split_support and
    reliability_nj_batched, ref splitSupport tcc:608-703).

    For a list of quartets (rows A, B, C, D): the six pairs' pieces and
    weights in one launch of store_kernels.me_dist_pieces_list, then
    tot = pieces @ [counts | 1] and the same of the weights, float64 on
    the device.  The products are exact (float32 values times small
    integers); only the order of the sums is not the reference's numpy's.
    So the device decides each comparison with zero only where it clears
    a bound of what that order, the division and log1p can move it, and
    where the 0.01 weight threshold is not in doubt; a split with any
    comparison in doubt is fetched and decided again on the host by the
    reference's own operations (split_support_host).  stats counts the
    splits, the launches and the re-decided splits and entries."""

    # how many times its bound a sum must clear zero to be decided on the
    # device (the tests set it to 0 and to a huge value to drive each side)
    margin = 2.0

    def __init__(self, nj):
        self.nj = nj
        opts = nj.options
        self.n_boot = opts.n_bootstrap
        dev = nj.prof.device
        counts = resample_kernels.sh_resample_counts(nj.n_pos, self.n_boot,
                                                     dev)
        self.counts = counts
        ones = torch.ones((nj.n_pos, 1), dtype=counts.dtype, device=dev)
        self.cx = torch.cat([counts, ones], 1)                  # [P, B + 1]
        self.cmax = self.cx.max(0).values                       # [B + 1]
        # under a mesh every rank draws the whole [P, B] matrix (the same
        # Knuth stream) and multiplies its block's pieces by its own rows;
        # the sums go through the mesh's exchange (sums_of)
        self.mesh = opts.mesh
        self.cx_block = self.cx
        if self.mesh is not None:
            lo, n_local = nj.prof.lo, nj.prof.n_local
            self.cx_block = self.cx[lo: lo + n_local]
        self._host_counts = None
        # NeighbourJoining.log_corrected's two laws
        self.nucleotide_log = opts.n_codes == 4 and not opts.use_matrix
        self.stats = {"splits": 0, "launches": 0, "redecided_splits": 0,
                      "redecided_entries": 0}

    def host_counts(self) -> np.ndarray:
        if self._host_counts is None:
            self._host_counts = self.counts.cpu().numpy()
        return self._host_counts

    def _log_corrected(self, d, ed):
        """NeighbourJoining.log_corrected's formula in torch, and the bound
        of the difference it makes of a difference of at most ed in d: its
        slope at min(d + ed, the clamp), the largest over [d - ed, d + ed];
        log1p's last bits on either side and the rounding after it."""
        if self.nucleotide_log:
            out = torch.where(d < 0.74, -0.75 * torch.log1p(
                -torch.clamp_max(d, 0.7399) * 4.0 / 3.0), 3.0)
            slope = 1.0 / (1.0 - torch.clamp_max(d + ed, 0.7399) * 4.0 / 3.0)
        else:
            out = torch.where(d < 0.99, -1.3 * torch.log1p(
                -torch.clamp_max(d, 0.9899)), 3.0)
            slope = 1.3 / (1.0 - torch.clamp_max(d + ed, 0.9899))
        out = torch.clamp_max(out, 3.0)
        return out, slope * ed * 1.01 + 1e-14 + 8.0 * _U64 * out.abs()

    def supports(self, rows):
        """(n_support [k], suboptimal [k]) numpy arrays of the k quartets
        of rows [k, 4]."""
        nj = self.nj
        k, B, P = len(rows), self.n_boot, nj.n_pos
        pieces, weights = nj.prof.dist_pieces_list(*batched.pair_list(
            np.asarray(rows), batched.QUARTET_PAIRS))
        self.stats["launches"] += 1
        self.stats["splits"] += k
        p64, w64 = pieces.double(), weights.double()
        tp, tw, pabs, wsum = self.sums_of(p64, w64)
        tp, tw = tp.view(k, 6, B + 1), tw.view(k, 6, B + 1)
        # two sums of the same P terms in any orders differ by at most
        # 2 (P - 1) u times the sum of the terms' magnitudes (under a mesh
        # too: the ranks' partials added in rank order are another order)
        gam = 2.0 * P * _U64 * 1.01 * self.cmax
        ep = gam * pabs.view(k, 6, 1)
        ew = gam * wsum.view(k, 6, 1)
        ok = tw > 0.01
        doubt = ((tw - 0.01).abs() <= ew).any(1)                 # [k, B + 1]
        d = torch.where(ok, tp / torch.where(ok, tw, 1.0), 3.0)
        ed = torch.where(ok, (ep + d.abs() * ew)
                         / torch.clamp_min(tw - ew, 1e-300)
                         + 4.0 * _U64 * d.abs(), 0.0)
        if nj.options.logdist:
            d, ed = self._log_corrected(d, ed)
        s1 = d[:, QAC] + d[:, QBD] - d[:, QAB] - d[:, QCD]
        s2 = d[:, QAD] + d[:, QBC] - d[:, QAB] - d[:, QCD]
        e1 = ed[:, QAC] + ed[:, QBD] + ed[:, QAB] + ed[:, QCD]
        e2 = ed[:, QAD] + ed[:, QBC] + ed[:, QAB] + ed[:, QCD]
        # the sums' own rounding on either side
        e1 += 8.0 * _U64 * d[:, [QAC, QBD, QAB, QCD]].abs().sum(1)
        e2 += 8.0 * _U64 * d[:, [QAD, QBC, QAB, QCD]].abs().sum(1)
        # a comparison with zero is sure where |s| clears `margin` times its
        # bound; (s1 > 0) & (s2 > 0) and (s1 < 0) | (s2 < 0) are sure where
        # either is surely negative or both surely positive
        m1, m2 = self.margin * e1, self.margin * e2
        sure = (s1 < -m1) | (s2 < -m2) | ((s1 > m1) & (s2 > m2))
        doubt |= ~sure
        n_support = ((s1[:, :B] > 0) & (s2[:, :B] > 0)).sum(1)
        subopt = (s1[:, B] < 0) | (s2[:, B] < 0)
        n_doubt = doubt.sum(1)
        out = torch.stack([n_support, subopt.long(), n_doubt]).cpu().numpy()
        n_support, subopt = out[0].copy(), out[1].astype(bool)
        again = np.flatnonzero(out[2])
        if len(again):
            self.stats["redecided_splits"] += len(again)
            self.stats["redecided_entries"] += int(out[2].sum())
            idx = torch.as_tensor(again, device=pieces.device)
            hp, hw = p64.view(k, 6, -1)[idx], w64.view(k, 6, -1)[idx]
            if self.mesh is not None:
                # the split's pieces at every position, from every rank
                align = nj.options.position_align
                hp = self.mesh.gather_positions(hp, P, align)
                hw = self.mesh.gather_positions(hw, P, align)
            hp, hw = hp.cpu().numpy(), hw.cpu().numpy()
            counts = self.host_counts()
            for i, j in enumerate(again):
                subopt[j], n_support[j] = split_support_host(
                    nj, np.ascontiguousarray(hp[i]),
                    np.ascontiguousarray(hw[i]), counts)
        return n_support, subopt

    def sums_of(self, p64, w64):
        """(pieces @ [counts | 1], weights @ [counts | 1], the pieces'
        absolute sums, the weights' sums) over every position; under a
        mesh the block's partials of all four in one exchange, added in
        rank order."""
        cx = self.cx_block
        sums = (p64 @ cx, w64 @ cx, p64.abs().sum(1), w64.sum(1))
        if self.mesh is None:
            return sums
        flat = torch.cat([sums[0], sums[1], sums[2][:, None],
                          sums[3][:, None]], 1)
        flat = self.mesh.exchange_sum(flat)
        B1 = cx.shape[1]
        return (flat[:, :B1], flat[:, B1: 2 * B1], flat[:, 2 * B1],
                flat[:, 2 * B1 + 1])


def reliability_nj(nj):
    """ME local bootstrap over all internal splits, the serial walk (ref
    reliabilityNJ tcc:3191-3238): each split's quartet from the lazily
    computed up-profiles (with -bionj their BIONJ weights), one
    LocalBootstrap list of one quartet at a time.  Sets tree.support and
    debug.n_suboptimal_splits; returns LocalBootstrap.stats, or None where
    there is nothing to do."""
    if nj.n_seqs <= 3 or nj.options.n_bootstrap <= 0:
        return None
    boot = LocalBootstrap(nj)
    tree = nj.tree
    ups = UpProfiles(nj)
    for node in tree.postorder_nodes():
        if node < nj.n_seqs or node == tree.root:
            continue
        rows4, nodes4 = rearrange.setup_abcd(nj, ups, node, use_ml=False)
        n_support, subopt = boot.supports(np.array([rows4]))
        tree.support[node] = n_support[0] / boot.n_boot
        nj.debug.n_suboptimal_splits += int(subopt[0])
        for nd in nodes4[:3]:
            ups.reset(nd)
    return boot.stats


# splits of one LocalBootstrap list: at B = 1000 its float64 sums take
# 2 x 6 x 8,192 x 1,001 x 8 bytes (0.8 GB)
BOOT_CHUNK = 8192


def reliability_nj_list(nj, swept=False, chunk=BOOT_CHUNK):
    """ME local bootstrap over all internal splits (ref reliabilityNJ
    tcc:3191-3238) as whole-tree lists: the up-profiles in one sweep (none
    where swept says the split test's sweep of this topology stands),
    every split's quartet (batched.quartet_rows), and one LocalBootstrap
    list per chunk of splits.  With -bionj off the supports and the count
    of suboptimal splits are the serial walk's bit for bit.  Returns
    LocalBootstrap.stats, or None where there is nothing to do."""
    if nj.n_seqs <= 3 or nj.options.n_bootstrap <= 0:
        return None
    boot = LocalBootstrap(nj)
    if not swept:
        batched.compute_up_profiles_levelwise(nj, False)
    nodes = batched.split_nodes(nj)
    rows = batched.quartet_rows(nj, nodes)
    for start in range(0, len(nodes), chunk):
        n_support, subopt = boot.supports(rows[start:start + chunk])
        nj.tree.support[nodes[start:start + chunk]] = n_support / boot.n_boot
        nj.debug.n_suboptimal_splits += int(subopt.sum())
    return boot.stats
