"""Profile neighbor-joining engine: criterion, out-distances, the join loop
(counterpart of ``veryfasttree_tpu/engine/nj.py``).

The sequential heuristics (join order, visible-set hill climbing, the
out-profile reset policy) run on the host exactly as in FastTree-2 (ref
src/NeighbourJoining.tcc); every distance evaluation is a batched call into
the profile store, whose one-vs-all scan (setBestHit, ref tcc:3571-3646) is
the fused CUDA scan kernel.  The join epoch (engine/epoch.py) runs the
default top-hits mode's join loop on the card; the other modes join in the
host loop, where a join that keeps the out-profile is one fused step
(engine/fused.py) unless VFT_FUSED_JOIN=0.

Determinism: every argmin over criteria breaks ties by lowest index (ref
tcc:3627-3637).
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import NOCODE
from ..utils.debug import Debug
from ..utils.trace import annotate

from . import fused
from .profiles import MEProfiles, make_store
from .state import TreeState

# The fused one-launch join step of the host loop (engine/fused.py), as the
# JAX package's switch of the same name and default
# (veryfasttree_tpu/engine/nj.py:38); VFT_FUSED_JOIN=0 keeps the unfused
# body for every join, so that the two can be compared.
USE_FUSED_JOIN = os.environ.get("VFT_FUSED_JOIN", "1") != "0"


@dataclass
class Besthit:
    i: int = -1
    j: int = -1
    weight: float = 0.0
    dist: float = 1e20
    criterion: float = 1e20


class NeighbourJoining:
    def __init__(self, options, leaf_codes: np.ndarray, dmat, transmat,
                 constraint_on_off=None, log=None, progress=None, names=None,
                 device=torch.device("cpu")):
        t0 = time.perf_counter()
        self.options = options
        self.log = log
        self.progress = progress
        n_seqs, n_pos = leaf_codes.shape
        self.n_seqs = n_seqs
        self.n_pos = n_pos
        self.maxnodes = 2 * n_seqs
        self.dmat = dmat
        # the ML model (None: Jukes-Cantor); set_ml_gtr replaces it, and the
        # ML phase builds its store in self.ml (engine/ml_profiles.py)
        self.transmat = transmat
        self.ml = None
        self.debug = options.debug if hasattr(options, "debug") else Debug()

        self.tree = TreeState(n_seqs, self.maxnodes)
        # under a mesh, the rank's block of positions (ShardedMEProfiles)
        self.prof = make_store(leaf_codes, options, dmat, self.maxnodes,
                               device=device)

        # constraints: nOn/nOff counts per node per constraint (ref
        # Profile.nOn), int64 on the host; the kernels take int32 copies
        if constraint_on_off is not None:
            self.n_cons = constraint_on_off[0].shape[1]
            self.con_on = np.zeros((self.maxnodes, self.n_cons), dtype=np.int64)
            self.con_off = np.zeros((self.maxnodes, self.n_cons), dtype=np.int64)
            self.con_on[:n_seqs] = constraint_on_off[0]
            self.con_off[:n_seqs] = constraint_on_off[1]
        else:
            self.n_cons = 0
            self.con_on = self.con_off = None

        self.diameter = np.zeros(self.maxnodes)
        self.var_diameter = np.zeros(self.maxnodes)
        self.selfdist = np.zeros(self.maxnodes)
        self.selfweight = np.zeros(self.maxnodes)
        self.selfweight[:n_seqs] = n_pos - self.prof.n_gaps
        self.totdiam = 0.0

        self.out_distances = np.zeros(self.maxnodes)
        self.n_out_dist_active = np.full(self.maxnodes, n_seqs * 10, dtype=np.int64)
        self.join_log: list = []  # (i, j) per join, for join-order parity tests

        # raw (dist, weight) against the out-profile of version
        # _out_raw_version, by node, from the fused join step's scans: a
        # refresh of a cached node is host arithmetic (apply_out_refresh),
        # with the bits the store call would give
        self._out_raw: dict = {}
        self._out_raw_version = -1

        self.prof.recompute_outprofile(self._leaf_mask())
        if self.n_cons:
            # the leaf totals: the out-profile's counts, which no join changes
            self.con_out_on = self.con_on[:n_seqs].sum(axis=0)
            self.con_out_off = self.con_off[:n_seqs].sum(axis=0)
        self.set_out_distance(np.arange(n_seqs), n_seqs)
        # host-clock seconds of the NJ phase's parts; every part ends in a
        # fetch to the host, so the device work is included
        self.timings = {"store_s": time.perf_counter() - t0}

    def load_state(self, arrays: dict) -> None:
        """Replace the engine state with arrays under the names of the
        reference's checkpoints (veryfasttree_tpu/engine/checkpoint.py):
        tree_*, nj_* and me_codes, me_W, me_U, me_w_out, me_f_out, and the
        constraint counts nj_con_on, nj_con_off, nj_con_out_on and
        nj_con_out_off where the engine has constraints and the arrays hold
        them.  The engine must have been built from the same alignment,
        options and constraints."""
        tree = self.tree
        tree.parent[:] = arrays["tree_parent"]
        tree.children[:] = arrays["tree_children"]
        tree.n_child[:] = arrays["tree_n_child"]
        tree.branchlength[:] = arrays["tree_branchlength"]
        tree.support[:] = arrays["tree_support"]
        tree.maxnode, tree.root = (int(x) for x in arrays["tree_scal"])
        self.diameter[:] = arrays["nj_diameter"]
        self.var_diameter[:] = arrays["nj_var_diameter"]
        self.selfdist[:] = arrays["nj_selfdist"]
        self.selfweight[:] = arrays["nj_selfweight"]
        self.out_distances[:] = arrays["nj_out_distances"]
        self.n_out_dist_active[:] = arrays["nj_n_out_dist_active"]
        self.totdiam = float(arrays["nj_scal"][0])
        if self.n_cons and "nj_con_on" in arrays:
            self.con_on[:] = arrays["nj_con_on"]
            self.con_off[:] = arrays["nj_con_off"]
            self.con_out_on[:] = arrays["nj_con_out_on"]
            self.con_out_off[:] = arrays["nj_con_out_off"]
        self.prof = type(self.prof).from_numpy(
            arrays, self.options, self.dmat, self.n_seqs, self.n_pos,
            self.maxnodes, two_tier=self.prof.two_tier,
            device=self.prof.device)
        self._out_raw = {}
        self._out_raw_version = -1

    # ------------------------------------------------------------------ utils
    def gaps_per_pos(self) -> np.ndarray:
        """Gap characters per alignment position across the unique leaves."""
        leaf_codes = self.prof.codes[: self.n_seqs, : self.n_pos].cpu().numpy()
        return (leaf_codes == NOCODE).sum(axis=0).astype(np.float64)

    def _leaf_mask(self):
        m = np.zeros(self.maxnodes, dtype=bool)
        m[: self.n_seqs] = True
        return m

    def active_mask(self):
        m = self.tree.parent < 0
        m[self.tree.maxnode :] = False
        return m

    def log_corrected(self, dist):
        """ref logCorrect tcc:322-330 (host scalar/array version)."""
        maxscore = 3.0
        dist = np.asarray(dist, dtype=np.float64)
        if self.options.n_codes == 4 and not self.options.use_matrix:
            out = np.where(dist < 0.74,
                           -0.75 * np.log1p(-np.minimum(dist, 0.7399) * 4.0 / 3.0),
                           maxscore)
        else:
            out = np.where(dist < 0.99,
                           -1.3 * np.log1p(-np.minimum(dist, 0.9899)), maxscore)
        return np.minimum(out, maxscore)

    # -------------------------------------------------------- constraint math
    def join_penalties_batch(self, iis, jjs):
        """ref joinConstraintPenalty tcc:559-605 (the JAX package's
        join_constraint_penalty) of each pair (iis[k], jjs[k]): the
        constrained leaves the join must move, summed over the constraints
        (the out-component's counts are the leaf totals less both
        members'), as float64, over [K, n_cons] arrays at once."""
        if not self.n_cons:
            return np.zeros(len(iis))
        iis = np.asarray(iis, dtype=np.int64)
        jjs = np.asarray(jjs, dtype=np.int64)
        on1, off1 = self.con_on[iis], self.con_off[iis]
        on2, off2 = self.con_on[jjs], self.con_off[jjs]
        on3 = self.con_out_on - on1 - on2
        off3 = self.con_out_off - off1 - off2

        def code(on, off):
            return np.where((on > 0) & (off > 0), -1, (on > 0).astype(np.int64))

        codes = [code(on1, off1), code(on2, off2), code(on3, off3)]
        n_split = sum((c == -1).astype(np.int64) for c in codes)
        n_on = sum((c == 1).astype(np.int64) for c in codes)
        active = ((on1 + off1 > 0) & (on2 + off2 > 0) & (on3 + off3 > 0)
                  & (n_split == 1) & (n_on == 1))
        on_a, off_a = on1 + on2, off1 + off2
        pen = np.where(on_a + off3 < on3 + off_a, np.minimum(on_a, off3),
                       np.minimum(on3, off_a))
        return np.where(active, pen, 0).sum(axis=1).astype(np.float64)

    # ------------------------------------------------------- out-distances
    def apply_out_refresh(self, idx: np.ndarray, dist: np.ndarray,
                          weight: np.ndarray, n_active: int) -> None:
        """Turn raw (dist, weight) vs the out-profile into fresh out-distances
        (the host half of setOutDistance, ref tcc:1012-1083)."""
        top = (n_active - 1) * (dist * weight * n_active
                                - self.selfweight[idx] * self.selfdist[idx])
        bottom = weight * n_active - self.selfweight[idx]
        pdist = np.divide(top, bottom, out=np.full_like(top, 3.0), where=bottom > 0.01)
        od = np.where(bottom > 0.01,
                      pdist - self.diameter[idx] * (n_active - 1)
                      - (self.totdiam - self.diameter[idx]), 3.0)
        self.out_distances[idx] = od
        self.n_out_dist_active[idx] = n_active

    def cache_out_raw(self, nodes, dists, weights) -> None:
        """Record raw (dist, weight) against the current out-profile for
        later host-only refreshes (invalidated when prof.out_version
        moves)."""
        if self._out_raw_version != self.prof.out_version:
            self._out_raw = {}
            self._out_raw_version = self.prof.out_version
        for n, d, w in zip(np.asarray(nodes), np.asarray(dists),
                           np.asarray(weights)):
            self._out_raw[int(n)] = (float(d), float(w))

    def _split_cached(self, idx: np.ndarray):
        """Split a refresh set into (cached_idx, d, w, uncached_idx)."""
        if self._out_raw_version != self.prof.out_version or not self._out_raw:
            return idx[:0], None, None, idx
        hit = np.array([int(n) in self._out_raw for n in idx], dtype=bool)
        if not hit.any():
            return idx[:0], None, None, idx
        cached = idx[hit]
        d = np.array([self._out_raw[int(n)][0] for n in cached])
        w = np.array([self._out_raw[int(n)][1] for n in cached])
        return cached, d, w, idx[~hit]

    def set_out_distance(self, idx: np.ndarray, n_active: int, force=False) -> None:
        """Batched setOutDistance (ref tcc:1012-1083)."""
        idx = np.asarray(idx, dtype=np.int64)
        if not force:
            idx = idx[self.n_out_dist_active[idx] != n_active]
        if len(idx) == 0:
            return
        cached, dc, wc, miss = self._split_cached(idx)
        if len(cached):
            self.debug.outprofile_ops += len(cached)
            self.apply_out_refresh(cached, dc, wc, n_active)
        if len(miss) == 0:
            return
        dist, weight = self.prof.dist_set_vs_out(miss)
        self.debug.outprofile_ops += len(miss)
        self.apply_out_refresh(miss, dist, weight, n_active)

    def set_criterion_batch(self, n_active: int, iis, jjs, dists) -> np.ndarray:
        """Batched setCriterion (ref tcc:1085-1113): refresh stale out-distances
        within the staleOutLimit allowance, scale still-stale ones, and return
        criterion = dist - (outI + outJ)/(nActive-2)."""
        iis = np.asarray(iis, dtype=np.int64)
        jjs = np.asarray(jjs, dtype=np.int64)
        n_diff_allow = int(n_active * self.options.stale_out_limit) \
            if self.options.tophits_mult > 0 else 0
        nodes = np.concatenate([iis, jjs])
        stale = nodes[self.n_out_dist_active[nodes] - n_active > n_diff_allow]
        if len(stale):
            self.set_out_distance(np.unique(stale), n_active, force=True)

        def scaled_out(nodes):
            od = self.out_distances[nodes]
            na = self.n_out_dist_active[nodes]
            return np.where(na != n_active, od * (n_active - 1) / (na - 1), od)

        return np.asarray(dists) - (scaled_out(iis) + scaled_out(jjs)) / (n_active - 2)

    def set_dist_criterion_batch(self, n_active: int, iis, jjs,
                                 refresh_neq=None, stale_extra=None):
        """Batched setDistCriterion (ref tcc:1115-1124): raw distance minus
        diameters plus the constraint penalty, then criterion.

        The out-distance refreshes implied by the criterion (the staleOutLimit
        rule over iis/jjs/stale_extra, plus the unconditional-if-not-current
        rule over refresh_neq, matching a preceding setOutDistance call) share
        one store call with the pair distances."""
        iis = np.asarray(iis, dtype=np.int64)
        jjs = np.asarray(jjs, dtype=np.int64)
        n_diff_allow = int(n_active * self.options.stale_out_limit) \
            if self.options.tophits_mult > 0 else 0
        nodes = np.concatenate([iis, jjs] if stale_extra is None else
                               [iis, jjs, np.asarray(stale_extra, dtype=np.int64)])
        refresh = nodes[self.n_out_dist_active[nodes] - n_active > n_diff_allow]
        if refresh_neq is not None:
            rn = np.asarray(refresh_neq, dtype=np.int64)
            rn = rn[self.n_out_dist_active[rn] != n_active]
            refresh = np.concatenate([refresh, rn])
        if len(refresh):
            refresh = np.unique(refresh)
            cached, dc, wc, refresh = self._split_cached(refresh)
            if len(cached):
                self.debug.outprofile_ops += len(cached)
                self.apply_out_refresh(cached, dc, wc, n_active)
        if len(refresh):
            d_out, w_o, dist, weight = self.prof.refresh_and_pairs(
                refresh, iis, jjs)
            self.debug.outprofile_ops += len(refresh)
            self.apply_out_refresh(refresh, d_out, w_o, n_active)
        else:
            dist, weight = self.prof.dist_pairs(iis, jjs)
        leafpair = (iis < self.n_seqs) & (jjs < self.n_seqs)
        self.debug.seq_ops += int(leafpair.sum())
        self.debug.profile_ops += int((~leafpair).sum())
        weight = np.where(weight > 0, weight, 0.01)
        dist = dist - (self.diameter[iis] + self.diameter[jjs])
        if self.n_cons:
            dist = dist + self.options.constraint_weight \
                * self.join_penalties_batch(iis, jjs)
        crit = self.set_criterion_batch(n_active, iis, jjs, dist)
        return dist, weight, crit

    def set_dist_criterion(self, n_active: int, hit: Besthit) -> None:
        d, w, c = self.set_dist_criterion_batch(n_active, [hit.i], [hit.j])
        hit.dist, hit.weight, hit.criterion = float(d[0]), float(w[0]), float(c[0])

    def criterion_from_raw(self, n_active: int, i_node: int, jjs, d_raw,
                           w_raw, dout, wout):
        """set_dist_criterion_batch of the pairs (i_node, jjs) from distances
        the fused join step already computed: d_raw, w_raw the pairs', dout,
        wout the candidates' against the current out-profile (for the
        staleOutLimit refreshes).  The profile-operation counts are the
        caller's (engine/tophits.py top_hit_join_fused)."""
        jjs = np.asarray(jjs, dtype=np.int64)
        n_diff_allow = int(n_active * self.options.stale_out_limit) \
            if self.options.tophits_mult > 0 else 0
        stale = self.n_out_dist_active[jjs] - n_active > n_diff_allow
        if stale.any():
            self.apply_out_refresh(jjs[stale], np.asarray(dout)[stale],
                                   np.asarray(wout)[stale], n_active)
            self.debug.outprofile_ops += int(stale.sum())
        weight = np.where(np.asarray(w_raw) > 0, w_raw, 0.01)
        dist = np.asarray(d_raw) - (self.diameter[i_node] + self.diameter[jjs])
        iis = np.full(len(jjs), i_node, dtype=np.int64)
        if self.n_cons:
            dist = dist + self.options.constraint_weight \
                * self.join_penalties_batch(iis, jjs)
        crit = self.set_criterion_batch(n_active, iis, jjs, dist)
        return dist, weight, crit

    # ------------------------------------------------------------- best hits
    def best_hit_arrays(self, node: int, dist, weight, n_active: int):
        """Host half of setBestHit given a scan over the first len(dist)
        rows: diameters, constraint penalties, criterion.  Returns the
        (dist, weight, criterion) arrays of set_best_hit(want_all=True)."""
        maxnode = len(dist)
        dist = np.array(dist, dtype=np.float64)
        weight = np.asarray(weight, dtype=np.float64)
        active = self.active_mask()[:maxnode]
        self.debug.profile_ops += int(active.sum())
        dist = dist - (self.diameter[node] + self.diameter[:maxnode])
        if self.n_cons:
            js = np.nonzero(active)[0]
            pens = self.join_penalties_batch(np.full(len(js), node), js)
            dist[js] += self.options.constraint_weight * pens
        weight = np.where(weight > 0, weight, 0.01)
        iis = np.full(maxnode, node)
        crit = np.full(maxnode, 1e20)
        js = np.nonzero(active)[0]
        crit[js] = self.set_criterion_batch(n_active, iis[js], js, dist[js])
        dist = np.where(active, dist, 1e20)
        weight = np.where(active, weight, 0.0)
        return dist, weight, crit

    def set_best_hit(self, node: int, n_active: int, want_all: bool = False):
        """One-vs-all scan (ref setBestHit tcc:3571-3646).  Returns
        (bestjoin, allhits) with allhits = (dist, weight, criterion) arrays
        over all maxnode slots (invalid entries have criterion 1e20)."""
        maxnode = self.tree.maxnode
        dist, weight = self.prof.dist_one_vs_all(node)
        dist, weight, crit = self.best_hit_arrays(node, dist[:maxnode],
                                                  weight[:maxnode], n_active)
        cand = crit.copy()
        cand[node] = 1e20  # exclude self from the best join
        bj = int(np.argmin(cand))
        best = Besthit(node, bj, float(weight[bj]), float(dist[bj]), float(cand[bj]))
        if want_all:
            return best, (dist, weight, crit)
        return best, None

    # -------------------------------------------------------------- searches
    def exhaustive_search(self, n_active: int) -> Besthit:
        """ref exhaustiveNJSearch tcc:3648-3684 -- all-pairs scan."""
        best = Besthit()
        active = np.nonzero(self.active_mask()[: self.tree.maxnode])[0]
        for i in active:
            _, all_ = self.set_best_hit(int(i), n_active, want_all=True)
            dist, weight, crit = all_
            crit = crit.copy()
            crit[: int(i) + 1] = 1e20  # only j > i, and not self
            j = int(np.argmin(crit))
            if crit[j] < best.criterion:
                best = Besthit(int(i), j, float(weight[j]), float(dist[j]), float(crit[j]))
        assert best.i >= 0
        return best

    def fast_search(self, n_active: int, visible) -> Besthit:
        """ref fastNJSearch tcc:3686-3744 -- visible set + hill-climbing."""
        best = Besthit()
        for i in range(self.tree.maxnode):
            v = visible[i]
            if v is None:
                continue
            if self.tree.parent[i] < 0 and self.tree.parent[v.j] < 0:
                crit = self.set_criterion_batch(n_active, [v.i], [v.j], [v.dist])[0]
                v.criterion = float(crit)
                if v.criterion < best.criterion:
                    best = Besthit(v.i, v.j, v.weight, v.dist, v.criterion)
        assert best.i >= 0
        if not self.options.fastest:
            while True:
                changed = False
                bi, _ = self.set_best_hit(best.i, n_active)
                visible[best.i] = bi
                if bi.j != best.j:
                    changed = True
                best = Besthit(bi.i, bi.j, bi.weight, bi.dist, bi.criterion)
                bj, _ = self.set_best_hit(best.j, n_active)
                visible[best.j] = bj
                if bj.j != best.i:
                    changed = True
                    best = Besthit(bj.j, bj.i, bj.weight, bj.dist, bj.criterion)
                if changed:
                    self.debug.n_hill_better += 1
                else:
                    break
            best = Besthit(min(best.i, best.j), max(best.i, best.j),
                           best.weight, best.dist, best.criterion)
        return best

    # ------------------------------------------------------------- join loop
    def fast_nj(self, max_joins: Optional[int] = None) -> None:
        """The main join loop (ref fastNJ tcc:2796-3155).

        max_joins: stop after this many joins leaving the tree unfinished
        (benchmark hook; None = run to the 3-star root).
        """
        opts = self.options
        tree = self.tree
        n_seqs = self.n_seqs
        assert n_seqs >= 1
        if n_seqs < 3:
            root = tree.maxnode
            tree.maxnode += 1
            tree.root = root
            tree.set_children(root, list(range(n_seqs)))
            if n_seqs == 2:
                d, _ = self.prof.dist_pairs([0], [1])
                tree.branchlength[0] = d[0] / 2.0
                tree.branchlength[1] = d[0] / 2.0
            return

        t0 = time.perf_counter()
        m = 0
        tophits = None
        visible = None
        if opts.tophits_mult > 0:
            m = int(0.5 + opts.tophits_mult * math.sqrt(n_seqs))
            if m < 4 or 2 * m >= n_seqs:
                m = 0
        with annotate("tophits"):
            if m > 0:
                from .tophits import TopHits
                tophits = TopHits(opts, self.maxnodes, m)
                self._tophits = tophits  # exposed for tests / inspection
                tophits.set_all_leaf_tophits(self)
                tophits.reset_top_visible(self, n_seqs)
            elif not opts.slow:
                visible = [None] * self.maxnodes
                for i in range(n_seqs):
                    visible[i], _ = self.set_best_hit(i, n_seqs)
        t1 = time.perf_counter()
        self.timings["tophits_s"] = t1 - t0

        from . import epoch
        with annotate("joins"):
            if tophits is not None and epoch.epoch_supported(self, tophits):
                epoch.run_epoch(self, tophits, max_joins)
            else:
                self._join_loop_host(tophits, visible, max_joins)
        if len(self.join_log) < n_seqs - 3:
            return  # max_joins stop: the tree is unfinished
        self._root_three(tree)
        self.timings["joins_s"] = time.perf_counter() - t1

    def _join_loop_host(self, tophits, visible, max_joins=None) -> None:
        """The join loop on the host (ref fastNJ tcc:2857-3105), from the
        leaf top-hits (or visible set) to three active nodes: every mode's
        loop, and the plain twin of the join epoch (engine/epoch.py), which
        a CPU store runs and the card tests hold the epoch to.  With top
        hits, a join that keeps the out-profile is one fused step
        (engine/fused.py, USE_FUSED_JOIN), the same bits as the unfused
        body.  Returns early after max_joins joins."""
        opts = self.options
        tree = self.tree
        n_seqs = self.n_seqs
        m = tophits.m if tophits is not None else 0
        n_active_out_profile_reset = n_seqs
        for n_active in range(n_seqs, 3, -1):
            if max_joins is not None and n_seqs - n_active >= max_joins:
                return
            if self.progress is not None:
                done = n_seqs - n_active
                if done > 0 and done % 100 == 0:
                    self.progress.print("Joined %6d of %6d", done, n_seqs - 3)
            if opts.slow:
                join = self.exhaustive_search(n_active)
            elif m > 0:
                join = tophits.search(self, n_active)
            else:
                join = self.fast_search(n_active, visible)
            self.join_log.append((join.i, join.j))

            newnode = tree.maxnode
            tree.maxnode += 1
            lo, hi = min(join.i, join.j), max(join.i, join.j)
            tree.set_children(newnode, [lo, hi])

            # out-profile policy for this iteration (ref tcc:3012-3037)
            changed = n_active_out_profile_reset - (n_active - 1)
            do_reset = (changed >= opts.n_reset_out_profile
                        and changed >= opts.f_reset_out_profile
                        * n_active_out_profile_reset)

            # (one card only: the fused step computes its distances inside
            # the kernel, where a mesh has no exchange)
            if m > 0 and not do_reset and USE_FUSED_JOIN \
                    and opts.mesh is None:
                # the join, the out-profile update and the top-hits merge's
                # distances in one store call and one fetch
                # (engine/fused.py), then the merge on the host
                plan = tophits.prepare_join_merge(self, newnode, n_active - 1)
                res = fused.join_step(
                    self, join, n_active, newnode,
                    plan.cand if plan.b_use else None,
                    prefetch=tophits.prefetch_rows(self, plan))
                tophits.top_hit_join_fused(self, newnode, n_active - 1, plan,
                                           res)
                continue

            # ensure fresh out-distances + criterion for the chosen join
            self.set_out_distance(np.array([join.i, join.j]), n_active)
            self.set_dist_criterion(n_active, join)

            raw_ij = join.dist + self.diameter[join.i] + self.diameter[join.j]
            dist_ij = join.dist
            delta_dist = (self.out_distances[join.i] - self.out_distances[join.j]) \
                / (n_active - 2)
            tree.branchlength[join.i] = (dist_ij + delta_dist) / 2
            tree.branchlength[join.j] = (dist_ij - delta_dist) / 2

            bionj_weight = 0.5
            var_ij = raw_ij - self.var_diameter[join.i] - self.var_diameter[join.j]
            if opts.bionj and join.weight > 0.01 and var_ij > 0.001:
                # BIONJ weighting, Gascuel 1997 eq. 9 via out-profile moments
                # (ref tcc:2918-2992)
                douts, wouts = self.prof.dist_set_vs_out(np.array([join.i, join.j]))
                self.debug.outprofile_ops += 2
                var_i_weight = n_active * wouts[0] - self.selfweight[join.i] - join.weight
                var_j_weight = n_active * wouts[1] - self.selfweight[join.j] - join.weight
                var_i_top = douts[0] * wouts[0] * n_active \
                    - self.selfdist[join.i] * self.selfweight[join.i] - raw_ij * join.weight
                var_j_top = douts[1] * wouts[1] * n_active \
                    - self.selfdist[join.j] * self.selfweight[join.j] - raw_ij * join.weight
                if var_j_weight > 0.01 and var_i_weight > 0.01:
                    d_pv_out = (n_active - 2) * (var_j_top / var_j_weight
                                                 - var_i_top / var_i_weight)
                    d_var_diam = (n_active - 2) * (self.var_diameter[join.i]
                                                   - self.var_diameter[join.j])
                    bionj_weight = 0.5 + (d_pv_out + d_var_diam) \
                        / (2 * (n_active - 2) * var_ij)
                bionj_weight = min(max(bionj_weight, 0.0), 1.0)

            self.diameter[newnode] = (
                bionj_weight * (tree.branchlength[join.i] + self.diameter[join.i])
                + (1 - bionj_weight) * (tree.branchlength[join.j] + self.diameter[join.j]))
            self.var_diameter[newnode] = (
                bionj_weight * self.var_diameter[join.i]
                + (1 - bionj_weight) * self.var_diameter[join.j]
                + bionj_weight * (1 - bionj_weight) * var_ij)

            sd, sw = self.prof.join(join.i, join.j, newnode,
                                    bionj_weight if opts.bionj else -1.0)
            self.debug.profile_avg_ops += 1
            if self.n_cons:
                # the out-totals do not change: the new node's counts are
                # its children's sum
                self.con_on[newnode] = self.con_on[join.i] + self.con_on[join.j]
                self.con_off[newnode] = self.con_off[join.i] + self.con_off[join.j]

            # out-profile: periodic full recompute vs incremental update
            # (ref tcc:3012-3037)
            if do_reset:
                active = self.active_mask()
                self.totdiam = float(self.diameter[active].sum())
                self.prof.recompute_outprofile(active)
                n_active_out_profile_reset = n_active - 1
            else:
                self.prof.update_outprofile(join.i, join.j, newnode, n_active)
                self.totdiam += self.diameter[newnode] - self.diameter[join.i] \
                    - self.diameter[join.j]

            self.selfdist[newnode] = sd
            self.selfweight[newnode] = sw

            if m > 0:
                tophits.top_hit_join(self, newnode, n_active - 1)
            elif not opts.slow:
                # refresh all out-distances, then update the visible set
                # against the new node (ref tcc:3049-3097)
                active = np.nonzero(self.active_mask()[: tree.maxnode])[0]
                self.set_out_distance(active, n_active - 1)
                bnew, all_ = self.set_best_hit(newnode, n_active - 1, want_all=True)
                visible[newnode] = bnew
                dist, weight, crit = all_
                for i in active:
                    i = int(i)
                    if i == newnode:
                        continue
                    v = visible[i]
                    old_j = v.j
                    if tree.parent[old_j] < 0:
                        v.criterion = float(self.set_criterion_batch(
                            n_active - 1, [v.i], [v.j], [v.dist])[0])
                    if tree.parent[old_j] >= 0 or crit[i] < v.criterion:
                        if tree.parent[old_j] < 0:
                            self.debug.n_visible_update += 1
                        visible[i] = Besthit(i, newnode, float(weight[i]),
                                             float(dist[i]), float(crit[i]))


    def _root_three(self, tree) -> None:
        """Root the 3 remaining nodes (ref tcc:3107-3135)."""
        top = np.nonzero(self.active_mask())[0]
        assert len(top) == 3
        root = tree.maxnode
        tree.maxnode += 1
        tree.root = root
        tree.set_children(root, [int(t) for t in top])
        d01, _ = self.prof.dist_pairs([top[0]], [top[1]])
        d02, _ = self.prof.dist_pairs([top[0]], [top[2]])
        d12, _ = self.prof.dist_pairs([top[1]], [top[2]])
        d01 = d01[0] - self.diameter[top[0]] - self.diameter[top[1]]
        d02 = d02[0] - self.diameter[top[0]] - self.diameter[top[2]]
        d12 = d12[0] - self.diameter[top[1]] - self.diameter[top[2]]
        tree.branchlength[top[0]] = (d01 + d02 - d12) / 2
        tree.branchlength[top[1]] = (d01 + d12 - d02) / 2
        tree.branchlength[top[2]] = (d02 + d12 - d01) / 2

    def total_len(self) -> float:
        return float(np.abs(self.tree.branchlength[: self.tree.maxnode]).sum())
