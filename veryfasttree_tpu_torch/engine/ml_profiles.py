"""Profile store of the maximum-likelihood phase on one torch device
(counterpart of ``veryfasttree_tpu/engine/ml_profiles.py``, serial path).

After the ME phases, profiles switch to the transition-matrix representation
(ref VeryFastTreeImpl.tcc:252-256): leaves become rotated one-hots
codeFreq[code] (the gap row for gaps), internal nodes are re-averaged
bottom-up in the rotated space, and ML operations then replace internal
profiles with posterior distributions.  The store keeps raw vectors V,
codes and weights, because the reference's gap-mixing rules differ by call
site (ops/kernels.ml_effective); positions with w == 0 hold the gap vector.

Row layout, as in the JAX store: [0, maxnodes) node profiles, [maxnodes,
2*maxnodes) up-profiles, then N_SCRATCH rows for quartet temporaries and a
block of maxnodes rows for list passes (the JAX package's batched
-threads > 1 path): here the SH-like supports pass (ops/ml_round.sh_pass)
keeps its 2S AB-quartet posteriors there (batch_row).

Every likelihood, posterior and branch-length optimization is one call of
the kernels in ops/ml_kernels.py over a list of rows and lengths; the host
loops (engine/ml.py) fetch only the values they decide on.  The recompute
of every internal profile and the tree's log-likelihood are one launch
each, over the level tables of a TreeSweep, which a caller builds once for
a tree and its branch lengths and reuses while neither changes (the 20
rates of a CAT fit, the evaluations of a GTR fit).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import NOCODE

from ..ops import kernels, ml_kernels
from ..ops.ml_kernels import MLModel

N_SCRATCH = 8
# scratch row names used by the quartet optimizer
S_AB, S_CD, S_BCD, S_ACD, S_ABD, S_ABC, S_TMP1, S_TMP2 = range(N_SCRATCH)
# the quartet optimization's temporaries, in ml_kernels.ml_quartet_opt's order
QUARTET_TEMPS = (S_AB, S_CD, S_BCD, S_ACD, S_ABD, S_ABC)
LEN_A, LEN_B, LEN_C, LEN_D, LEN_I = range(5)


class MLProfiles:
    def __init__(self, nj, transmat):
        """Build the ML store from the leaf codes and the current topology
        (the reference's profile switch, VeryFastTreeImpl.tcc:252-256)."""
        opts = nj.options
        if opts.n_codes == 20:
            raise NotImplementedError("protein ML is not ported yet")
        self.options = opts
        self.nj = nj
        me = nj.prof
        self.device = me.device
        self.n_pos = me.n_pos
        self.p_pad = me.p_pad
        self.maxnodes = me.maxnodes
        self.n_codes = opts.n_codes
        self.dtype = me.dtype
        self.tdtype = me.tdtype
        self.tol = float(opts.f_post_total_tolerance)
        self.min_len = self.dtype(opts.ml_min_branch_length)
        self.min_rel_len = self.dtype(opts.ml_min_rel_branch_length)
        self.rates_np = np.ones(1, dtype=np.float64)
        self.ratecat_np = np.zeros(self.p_pad, dtype=np.int32)
        self._set_constants(transmat)

        n_rows = 3 * self.maxnodes + N_SCRATCH
        leaf_codes = self._leaf_codes()
        n_seqs = nj.n_seqs
        codes = np.full((n_rows, self.p_pad), NOCODE, dtype=np.int8)
        codes[:n_seqs] = leaf_codes
        W = np.zeros((n_rows, self.p_pad), dtype=self.dtype)
        W[:n_seqs] = leaf_codes != NOCODE
        V = np.tile(self.gap_vec.cpu().numpy()[None, None, :],
                    (n_rows, self.p_pad, 1)).astype(self.dtype)
        V[:n_seqs] = self.code_freq.cpu().numpy()[leaf_codes.astype(np.int64)]
        self._put(codes, W, V)
        self.recompute_average_profiles()

    def _leaf_codes(self) -> np.ndarray:
        """Leaf code rows [n_seqs, p_pad] of the ME store (kept for every
        row, two-tier included)."""
        return self.nj.prof.codes[: self.nj.n_seqs].cpu().numpy()

    def _tensor(self, x, dtype=None):
        """A contiguous copy of x on the store's device."""
        return torch.tensor(np.ascontiguousarray(x), device=self.device,
                            dtype=dtype or self.tdtype)

    def _put(self, codes, W, V) -> None:
        self.codes = self._tensor(codes, torch.int8)
        self.W = self._tensor(W)
        self.V = self._tensor(V)

    def _set_constants(self, transmat) -> None:
        """Rotation constants of Jukes-Cantor (transmat None) or of a
        transition matrix."""
        self.jc = transmat is None
        self.transmat = transmat
        C = self.n_codes
        if self.jc:
            cf = np.zeros((NOCODE + 1, C))
            cf[:C] = np.eye(C)
            cf[NOCODE] = 0.25
            ev, statinv, eigeninv = np.zeros(C), np.ones(C), np.eye(C)
        else:
            cf, ev = transmat.code_freq, transmat.eigenval
            statinv, eigeninv = transmat.statinv, transmat.eigeninv
        self.code_freq = self._tensor(cf)
        self.eigenval = self._tensor(ev)
        self.statinv = self._tensor(statinv)
        self.eigeninv = self._tensor(eigeninv)
        self.eigentot = self._tensor(np.asarray(eigeninv).sum(axis=1))
        self.gap_vec = self.code_freq[NOCODE]
        self._push_model()

    def _upload(self, x, dtype):
        """x on the store's device; to a CUDA device through pinned memory,
        in stream order, so that the host does not wait for the card."""
        x = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    def _push_model(self) -> None:
        self.model = MLModel(
            jc=self.jc, code_freq=self.code_freq, eigenval=self.eigenval,
            eigeninv=self.eigeninv, statinv=self.statinv,
            rates=self._upload(self.rates_np, self.tdtype),
            ratecat=self._upload(self.ratecat_np, torch.int32),
            n_pos=self.n_pos, min_rel_len=float(self.min_rel_len),
            tol=self.tol)

    def set_transmat(self, transmat) -> None:
        """Swap in a new transition matrix (GTR refitting, ref setMLGtr
        tcc:6424): new rotation constants and leaf rows.  Also turns a
        Jukes-Cantor store into a matrix one (the -gtr path starts as JC
        until the first fit, ref VeryFastTreeImpl.tcc:261)."""
        self._set_constants(transmat)
        leaf_codes = self._leaf_codes()
        self.V[: self.nj.n_seqs] = self.code_freq[
            torch.as_tensor(leaf_codes.astype(np.int64), device=self.device)]

    def set_rates(self, rates: np.ndarray, ratecat: np.ndarray) -> None:
        self.rates_np = np.asarray(rates, dtype=np.float64)
        rc = np.zeros(self.p_pad, dtype=np.int32)
        rc[: len(ratecat)] = ratecat
        self.ratecat_np = rc
        self._push_model()

    def load_state(self, codes, W, V, rates, ratecat) -> None:
        """Replace the store's arrays (numpy, in the JAX store's layout) and
        its CAT rates.  The store must have been built for the same
        alignment and model."""
        if np.shape(codes) != tuple(self.codes.shape) \
                or np.shape(V) != tuple(self.V.shape):
            raise ValueError("arrays do not match the store layout")
        self._put(codes, W, V)
        self.set_rates(rates, np.asarray(ratecat)[: self.n_pos])

    def scratch_row(self, k: int) -> int:
        return 2 * self.maxnodes + k

    def batch_row(self, k: int) -> int:
        """Row k of the list-pass block (maxnodes rows after the scratch
        rows)."""
        if not 0 <= k < self.maxnodes:
            raise IndexError(f"batch row {k} of {self.maxnodes}")
        return 2 * self.maxnodes + N_SCRATCH + k

    # -- core ops ------------------------------------------------------------
    def _store(self):
        return self.codes, self.W, self.V, self.model

    def pair_loglk_rows(self, r1s, r2s, lengths, want_site_lk=False,
                        fetch=True):
        """Log-likelihoods of row pairs at lengths -> (ll [K], per-site lk
        [K, n_pos] or None).  fetch=False keeps both on the device, in
        tensors of their own."""
        ll, lk = ml_kernels.ml_pair_loglk(*self._store(), r1s, r2s, lengths,
                                          want_site_lk, keep=not fetch)
        self.nj.debug.n_lk_compute += len(r1s)
        if lk is not None:
            lk = lk[:, : self.n_pos]
        if not fetch:
            return ll, lk
        return (ll.cpu().numpy(),
                lk.double().cpu().numpy() if lk is not None else None)

    def pair_loglk(self, r1: int, r2: int, length: float, want_site_lk=False,
                   fetch=True):
        ll, lk = self.pair_loglk_rows([r1], [r2], [length], want_site_lk,
                                      fetch)
        lk = lk[0] if lk is not None else None
        if not fetch:
            return ll[0], lk
        if want_site_lk:
            return float(ll[0]), lk
        return float(ll[0])

    def opt_branch_length(self, r1: int, r2: int, guess: float):
        """The line search over one branch's length, in one kernel launch.
        Returns (optimal_length, neg_loglk_at_optimum) after one fetch."""
        opts = self.options
        x, fx, _ = ml_kernels.ml_opt_branch(
            *self._store(), [r1], [r2], [guess], opts.ml_min_branch_length,
            6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance)
        self.nj.debug.n_lk_compute += 8  # approximate, as the JAX store counts
        x, fx = torch.stack((x, fx)).cpu().tolist()
        return x[0], fx[0]

    def _clamped(self, lens):
        return np.maximum(np.asarray(lens, dtype=self.dtype), self.min_len)

    def posterior_rows(self, targets, r1s, r2s, len1s, len2s) -> None:
        """Posterior profiles of (r1s[k], r2s[k]) into rows targets[k]
        (enqueued, not fetched); lengths below the minimum are raised to
        it."""
        ml_kernels.ml_posterior(*self._store(), targets, r1s, r2s,
                                self._clamped(len1s), self._clamped(len2s))
        self.nj.debug.n_posterior_compute += len(targets)

    def posterior_into(self, target: int, r1: int, r2: int, len1: float,
                       len2: float) -> None:
        self.posterior_rows([target], [r1], [r2], [len1], [len2])

    def posterior_sweep(self, levels) -> None:
        """Dependency-ordered posterior level sweep: `levels` is a
        SweepTables, or a list of (targets, r1s, r2s, len1s, len2s) whose
        lengths are raised to the minimum as posterior_rows raises them,
        where level k+1 reads what level k wrote; one kernel launch in all
        on the card, ml_posterior's rows bit for bit."""
        if not isinstance(levels, ml_kernels.SweepTables):
            levels = ml_kernels.SweepTables.from_levels(
                [(t, r1, r2, self._clamped(l1), self._clamped(l2))
                 for t, r1, r2, l1, l2 in levels])
        ml_kernels.ml_posterior_sweep(*self._store(), levels)
        self.nj.debug.n_posterior_compute += levels.n_items

    def tree_sweep(self) -> "TreeSweep":
        return TreeSweep(self)

    def tree_loglk(self, sweep, want_site=False, site_out=None):
        """The tree's log-likelihood over sweep's tables, before the
        Jukes-Cantor correction (engine/ml.tree_loglk): (total [], per-site
        [n_pos] or None) float64 on the device, in one kernel launch
        (ml_kernels.ml_tree_loglk), the per-site sums in site_out when
        given; nj.debug counts the pair and posterior calls it fuses."""
        tables = sweep.loglk
        out = ml_kernels.ml_tree_loglk(*self._store(), tables, want_site,
                                       site_out)
        root = int(tables.root is not None)
        self.nj.debug.n_lk_compute += tables.n_pairs + root
        self.nj.debug.n_posterior_compute += root
        return out

    def quartet_records(self, rows4, lengths, star_test=False,
                        want_site_lk=False, keep_site=False):
        """K ML quartet optimizations (ref MLQuartetOptimize
        tcc:1650-1788) in one kernel launch: rows4 [K, 4] store rows (A, B,
        C, D), lengths [K, 5] float64 (A, B, C, D, I), raised to the
        minimum length in place.  Returns what ml_kernels.ml_quartet_opt
        returns (the records after one fetch; the per-site likelihoods on
        the host, or with keep_site on the device); nj.debug counts the
        single calls the kernel fuses.  The quartet temporaries are scratch
        rows, which nothing reads after the call without writing them
        first."""
        opts = self.options
        lo = opts.ml_min_branch_length
        lengths[lengths < lo] = lo
        rec, site = ml_kernels.ml_quartet_opt(
            *self._store(), rows4, lengths,
            [self.scratch_row(s) for s in QUARTET_TEMPS], lo, 6.0,
            opts.ml_ftol_branch_length, opts.ml_min_branch_length_tolerance,
            star_test, want_site_lk, keep_site)
        # the counts of the single calls the kernel fuses: 8 per line
        # search (as opt_branch_length counts), 1 per pair likelihood
        stars = int(rec["star"].sum())
        full = len(rec) - stars
        debug = self.nj.debug
        debug.n_posterior_compute += 2 * len(rec) + 5 * full
        debug.n_lk_compute += (8 + int(star_test)) * len(rec) + 2 * stars \
            + (32 + (3 if want_site_lk else 2)) * full
        return rec, site

    def quartet_optimize(self, rows4s, lengths_list, star_test=False,
                         want_site_lk=False):
        """quartet_records for K quartets as the host loops hold them:
        lengths_list, K float64 arrays [5] (A, B, C, D, I), set to the
        optimized lengths in place.  Returns K (quartet loglk,
        star_triggered, per-site log-likelihoods [n_pos] or None); the
        loglk is summed from the kernel's parts in the order the reference
        sums them."""
        lengths = np.stack(lengths_list)
        rec, site = self.quartet_records(rows4s, lengths, star_test,
                                         want_site_lk)
        out = []
        for k, held in enumerate(lengths_list):
            parts = [float(v) for v in rec["parts"][k]]
            found = [float(v) for v in rec["len"][k]]
            held[held < self.options.ml_min_branch_length] = \
                self.options.ml_min_branch_length
            held[LEN_I] = found[LEN_I]
            if rec["star"][k]:
                out.append((parts[0] + (parts[1] + parts[2]), True, None))
                continue
            held[:LEN_I] = found[:LEN_I]
            site_loglk = None
            if want_site_lk:
                lk = site[k][:, : self.n_pos].astype(np.float64)
                site_loglk = site_log(lk[0]) + site_log(lk[1]) \
                    + site_log(lk[2])
            out.append((parts[0] + parts[1] + parts[2], False, site_loglk))
        return out

    def recompute_average_profiles(self) -> None:
        """Balanced averaging of the internal nodes in ML space, bottom-up,
        one batch of tensor operations per level (ref
        recomputeProfiles(tmatAsDist), the JAX store's _ml_avg_sweep_impl);
        runs once per ML phase."""
        tree = self.nj.tree
        C = self.n_codes
        cf = self.code_freq[:C]
        et = None if self.jc else self.eigentot
        for level in tree.level_lists():
            nodes = [int(nd) for nd in level if tree.n_child[nd] == 2]
            if not nodes:
                continue
            t = torch.as_tensor(nodes, device=self.device)
            i = torch.as_tensor(tree.children[nodes, 0], device=self.device)
            j = torch.as_tensor(tree.children[nodes, 1], device=self.device)
            w1, w2 = self.W[i], self.W[j]
            c, w, _, f = kernels.average_profile(
                self.codes[i], w1, w1[..., None] * self.V[i], self.codes[j],
                w2, w2[..., None] * self.V[j], 0.5, cf, et, self.tol)
            self.codes[t] = c
            self.W[t] = w
            self.V[t] = torch.where(w[..., None] > 0, f, self.gap_vec)

    def recompute_ml_profiles(self, sweep=None) -> None:
        """Posterior recompute of all internal profiles bottom-up (ref
        recomputeMLProfiles tcc:3516-3539): one sweep over the tables of
        `sweep` (a TreeSweep of the current tree and branch lengths, or
        one built here)."""
        self.posterior_sweep((sweep or self.tree_sweep()).posteriors)


def level_order(tree):
    """tree.level_lists() (the levels leaves first, each level in the
    breadth-first order from the root) by a frontier walk with one numpy
    step per level, where level_lists takes a Python step per node
    (engine/state.py is a copy of the JAX package's module, kept equal to
    it)."""
    levels = []
    level = np.array([tree.root], dtype=np.int64)
    slots = np.arange(3)
    while len(level):
        levels.append(level)
        level = tree.children[level][slots < tree.n_child[level][:, None]]
    return levels[::-1]


class TreeSweep:
    """The level tables of the store's tree and branch lengths, built once
    and sent to the device once, for as long as neither changes:
    posteriors (SweepTables), the recompute of every node of two children
    from its children at their lengths, bottom-up; loglk (LoglkTables),
    the pair of the first two children of every node of two or three
    children at the sum of their lengths, and with a root of three
    children the root's 3-way term (ref treeLogLk tcc:5142-5155).  Each
    level keeps level_lists' order, so the twins' sums are those of the
    per-level loops."""

    def __init__(self, ml):
        tree = ml.nj.tree
        bl = tree.branchlength
        levels = level_order(tree)
        nodes = np.concatenate(levels)
        level = np.repeat(np.arange(len(levels)), [len(v) for v in levels])
        n_child = tree.n_child[nodes]
        two = n_child == 2
        t = nodes[two]
        i, j = tree.children[t, 0], tree.children[t, 1]
        self.posteriors = ml_kernels.SweepTables(
            ml_kernels.csr_offsets(level[two], len(levels)), t, i, j,
            ml._clamped(bl[i]), ml._clamped(bl[j]))
        pairs = n_child >= 2
        t = nodes[pairs]
        i, j = tree.children[t, 0], tree.children[t, 1]
        root = None
        if tree.n_child[tree.root] == 3:
            c0, c1, c2 = (int(c) for c in tree.children[tree.root])
            root = (ml.scratch_row(S_AB), c0, c1, c2,
                    *(float(x) for x in ml._clamped([bl[c0], bl[c1]])),
                    float(np.float32(bl[c2])))
        self.loglk = ml_kernels.LoglkTables(
            ml_kernels.csr_offsets(level[pairs], len(levels)), i, j,
            bl[i] + bl[j], root)


def site_log(lk):
    return np.log(np.maximum(lk, 1e-300))
