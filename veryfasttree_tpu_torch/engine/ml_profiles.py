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

from ..ops import dataflow, kernels, ml_kernels
from ..ops.ml_kernels import MLModel
from .state import level_order

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
        self._setup(nj)
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

    @classmethod
    def shell(cls, nj):
        """A store with the engine's layout and no arrays yet, for a
        checkpoint's arrays and model (load_state; the JAX package's
        checkpoint._init_ml_shell)."""
        self = cls.__new__(cls)
        self._setup(nj)
        return self

    def _setup(self, nj) -> None:
        """The fields that the layout and the options fix."""
        opts = nj.options
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
        # the posteriors' rough and exact positions (ref
        # nAAPosteriorRough/Exact), int64 on the device until
        # flush_posterior_counters
        self.post_counts = torch.zeros(2, dtype=torch.int64,
                                       device=self.device)

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
            near_p = near_freq = np.zeros((C, C))
        else:
            cf, ev = transmat.code_freq, transmat.eigenval
            statinv, eigeninv = transmat.statinv, transmat.eigeninv
            near_p, near_freq = transmat.near_p, transmat.near_freq
        # -approxml's rough posteriors: amino-acid matrix models only (ref
        # posteriorProfile tcc:2390-2421 sits inside the nCodes == 20
        # branch)
        use_approx = not self.options.exact_ml and C == 20 and not self.jc
        self._set_model(cf, ev, statinv, eigeninv,
                        np.asarray(eigeninv).sum(axis=1), near_p, near_freq,
                        use_approx)

    def _set_model(self, code_freq, eigenval, statinv, eigeninv, eigentot,
                   near_p, near_freq, use_approx) -> None:
        """The model's tables on the device, in the store's float type;
        every table a kernel reads (MLModel, the round kernels' staged
        tables) comes from these."""
        self.use_approx = bool(use_approx)
        self.near_p = self._tensor(near_p)
        self.near_freq = self._tensor(near_freq)
        self.code_freq = self._tensor(code_freq)
        self.eigenval = self._tensor(eigenval)
        self.statinv = self._tensor(statinv)
        self.eigeninv = self._tensor(eigeninv)
        self.eigentot = self._tensor(eigentot)
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
            tol=self.tol, near_p=self.near_p, near_freq=self.near_freq,
            approx=self.use_approx, counts=self.post_counts)

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

    def load_state(self, codes, W, V, rates, ratecat, model=None) -> None:
        """Replace the store's arrays (numpy, in the JAX store's layout) and
        its CAT rates.  Without `model` the store must have been built for
        the same alignment and model; with it (the checkpoint's ml_* model
        arrays by their names less "ml_": code_freq, eigenval, statinv,
        eigeninv, eigentot, near_p, near_freq and flags = [jc,
        use_approx]) the model comes from those arrays, a fitted GTR matrix
        included, and a shell (MLProfiles.shell) takes them too."""
        C = self.n_codes
        shape = (3 * self.maxnodes + N_SCRATCH, self.p_pad)
        if np.shape(codes) != shape or np.shape(V) != shape + (C,):
            raise ValueError("arrays do not match the store layout")
        if model is not None:
            self.jc = bool(model["flags"][0])
            self.transmat = None
            self._set_model(*(model[k] for k in (
                "code_freq", "eigenval", "statinv", "eigeninv", "eigentot",
                "near_p", "near_freq")), bool(model["flags"][1]))
        self._put(codes, W, V)
        self.set_rates(rates, np.asarray(ratecat)[: self.n_pos])

    def flush_posterior_counters(self) -> None:
        """Fetch the rough/exact posterior position counts into nj.debug's
        n_aa_posterior_rough and n_aa_posterior_exact (one fetch, before
        the stats print) and zero them.  The JAX package counts in float32
        sums, exact up to 2^24; these are int64."""
        rough, exact = self.post_counts.tolist()
        self.nj.debug.n_aa_posterior_rough += rough
        self.nj.debug.n_aa_posterior_exact += exact
        self.post_counts.zero_()

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

    # -- whole-level lists of the -threads > 1 tier (engine/batched.py) -----
    def scratch_rows_for(self, n: int) -> np.ndarray:
        """The first n rows of the list-pass block."""
        self.batch_row(n - 1)
        return self.batch_row(0) + np.arange(n, dtype=np.int64)

    def lengths_tensor(self, lengths) -> torch.Tensor:
        """Branch lengths as the float32 tensor on the store's device that
        posterior_rows_at and opt_branch_length_rows read and write (a
        copy: the caller's array is left as it is)."""
        return self._tensor(np.asarray(lengths, dtype=np.float32),
                            torch.float32)

    def posterior_rows_at(self, targets, r1s, r2s, n1s, n2s, bl) -> None:
        """posterior_rows with the lengths bl[n1s[k]], bl[n2s[k]] (raised
        to the minimum) read on the device: one ml_posterior list."""
        ml_kernels.ml_posterior(*self._store(), targets, r1s, r2s, n1s, n2s,
                                bl=bl, lo=float(self.min_len))
        self.nj.debug.n_posterior_compute += len(targets)

    def opt_branch_length_rows(self, r1s, r2s, nodes, bl) -> None:
        """The line searches over the branches between rows r1s[k] and
        r2s[k] from the guesses bl[nodes[k]] (raised to the minimum), each
        result written into bl[nodes[k]] on the device (nodes distinct):
        one ml_opt_branch list, nothing fetched."""
        opts = self.options
        ml_kernels.ml_opt_branch(
            *self._store(), r1s, r2s, nodes, opts.ml_min_branch_length, 6.0,
            opts.ml_ftol_branch_length, opts.ml_min_branch_length_tolerance,
            bl=bl)
        # 8 evaluations a search, as the JAX store counts them
        self.nj.debug.n_lk_compute += 8 * len(r1s)

    def quartet_nni_rows(self, rows, lengths):
        """K ML quartet NNIs without the star test (the JAX store's
        quartet_nni_rows, core _quartet_nni_core): each quartet's three
        topologies AB|CD, AC|BD and AD|BC fully optimized from the float32
        lengths [K, 5] (A, B, C, D, I, raised to the minimum), all 3K in one
        ml_quartet_opt launch and one fetch.  Returns (choice [K], the three
        LogLks [K, 3], the chosen topology's lengths [K, 5] in its own A, B,
        C, D, I order); a topology is chosen only where its LogLk is
        strictly the highest."""
        opts = self.options
        rows = np.asarray(rows, dtype=np.int64)
        K = len(rows)
        rows4 = np.concatenate([rows, rows[:, [0, 2, 1, 3]],
                                rows[:, [0, 3, 2, 1]]])
        lens = np.maximum(np.asarray(lengths, dtype=np.float32),
                          self.min_len)
        lens = np.concatenate([lens, lens[:, [0, 2, 1, 3, 4]],
                               lens[:, [0, 3, 2, 1, 4]]]).astype(np.float64)
        rec, _ = ml_kernels.ml_quartet_opt(
            *self._store(), rows4, lens,
            [self.scratch_row(s) for s in QUARTET_TEMPS],
            opts.ml_min_branch_length, 6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance)
        parts = rec["parts"]
        crit = (parts[:, 0] + parts[:, 1] + parts[:, 2]).reshape(3, K).T
        ab, ac, ad = crit.T
        pick_ac = (ac > ab) & (ac > ad)
        pick_ad = (ad > ab) & (ad > ac) & ~pick_ac
        choice = np.where(pick_ac, 1, np.where(pick_ad, 2, 0))
        new_len = rec["len"].astype(np.float64).reshape(3, K, 5)[
            choice, np.arange(K)]
        # the JAX store's counts of the single calls this fuses
        self.nj.debug.n_lk_compute += 3 * 5 * 8 * K
        self.nj.debug.n_posterior_compute += 3 * 6 * K
        return choice, np.ascontiguousarray(crit), new_len

    def sweep_tables(self, levels, weights=None):
        """The SweepTables of a list of (targets, r1s, r2s, len1s, len2s),
        where level k+1 reads what level k wrote, the lengths raised to the
        minimum as posterior_rows raises them, with `weights` (the times
        the host loop computes each item, in the levels' order; 1 each by
        default)."""
        tables = ml_kernels.SweepTables.from_levels(
            [(t, r1, r2, self._clamped(l1), self._clamped(l2))
             for t, r1, r2, l1, l2 in levels])
        if weights is None:
            return tables
        return ml_kernels.SweepTables(
            tables.offsets, tables.targets, tables.r1, tables.r2,
            tables.len1, tables.len2, weights)

    def posterior_sweep(self, levels, weights=None) -> None:
        """Dependency-ordered posterior level sweep: `levels` is a
        SweepTables, or a list of levels with `weights` (sweep_tables);
        one kernel launch in all on the card, ml_posterior's rows bit for
        bit.  nj.debug counts each item as often as its weight."""
        if not isinstance(levels, ml_kernels.SweepTables):
            levels = self.sweep_tables(levels, weights)
        ml_kernels.ml_posterior_sweep(*self._store(), levels)
        self.nj.debug.n_posterior_compute += int(levels.weights.sum())

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
            dataflow.csr_offsets(level[two], len(levels)), t, i, j,
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
            dataflow.csr_offsets(level[pairs], len(levels)), i, j,
            bl[i] + bl[j], root)


def site_log(lk):
    return np.log(np.maximum(lk, 1e-300))
