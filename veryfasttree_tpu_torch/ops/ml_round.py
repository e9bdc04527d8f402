"""One ML NNI round and one ML branch-length pass: the CUDA kernels of
``csrc/ml_round.cu`` and their plain twins.

The host loops ``engine/rearrange.do_nni`` (with ``use_ml``) and
``engine/ml.optimize_all_branch_lengths`` make a store call for every
posterior, line search and quartet optimization, and wait for each
search's result before the next decision: some tens of thousands of
launches and fetches per round; so does the JAX package
(``veryfasttree_tpu/engine/rearrange.py``, ``veryfasttree_tpu/engine/ml.py``),
which has no device round to port.  Here one launch runs a whole round or
pass, and it makes one upload and one fetch: the tree, the branch lengths,
the NNIStats, max_delta and the counters.  At 4 codes a round runs on a
cluster of three blocks (the walk and the AB optimizations on block 0, the
AC and AD optimizations beside them on blocks 1 and 2), a pass on one
block.  At 20 codes block 0 walks and decides, and each optimization (a
pass's each search) runs on a group of GROUP blocks that split its
positions: a round is a cluster of 1 + 3 GROUP blocks (the AB, AC and AD
groups), a pass of 1 + GROUP.

The twins are the host loops themselves on the per-call twins of
``ops/ml_kernels.py``: each wrapper runs its host loop for a store on the
CPU, and launches its kernel, or raises, for a store on a CUDA device.
``-slow`` keeps the NNI host loop on the card too: its profile repairs
recompute every ancestor, which the kernel does not.

``sh_pass`` runs the SH-like supports (``engine/ml.test_splits_ml``, the
host loop it is held to) over every split at once: the splits are
independent, because the pass changes no length and no topology, so it is
a handful of list launches of the kernels of ``ops/ml_kernels.py`` and
``ops/resample_kernels.py`` over a grid of splits, which fills the card's
132 SMs, rather than a walk on one round kernel's cluster.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .. import constants
from ..engine import rearrange
from ..engine.state import level_order
from ..engine.supports import SplitCount, split_constraints
from . import _build, me_round, ml_kernels, resample_kernels

# the kernels' int64 counters, in their order (csrc/ml_round.cu): the debug
# counters the host loops add to, then the work done (quartet
# optimizations, posteriors with the quartets' temporaries, line searches,
# their evaluations, pair log-likelihoods: the host loop's work), the
# positions of those posteriors that took the rough and the exact path (20
# codes; the store's rough/exact counts), the AC and AD optimizations a
# round started beside AB and discarded when AB's star test fired
# (speculative, in none of the others) and the fault flag
COUNTERS = ("n_ml_nni", "n_star_tests", "n_lk_compute", "n_posterior_compute",
            "quartets", "posteriors", "searches", "evals", "pairs",
            "aa_rough", "aa_exact", "speculative", "fault")
DEBUG = COUNTERS[:4]
# the blocks of a 20-code group (csrc/ml_round.cu group_ok: 1, 2 or 4); 4
# is the fastest at N=500, P=512 (PERF.md, phase 2j's timing rows)
GROUP = 4
GROUPS = (1, 2, 4)
# vft_ml_round_layout's fields
LAYOUT = ("blocks", "smem_bytes", "group_smem_bytes", "scratch_floats",
          "tree_smem", "local_positions", "group")


def ml_nni_round(nj, i_round: int, n_rounds: int, stats, *,
                 tree_in_smem: bool = True, group: int = GROUP):
    """One round of ML NNIs on nj's tree and ML store, in place (ref DoNNI
    tcc:5997-6183 with ML quartets): the host loop for a store on the CPU
    or under -slow, one launch of the kernel for a store on a CUDA device.
    Returns (n_changes, max_delta) as the host loop does; the tree arrays,
    branch lengths, `stats` (rearrange.NNIStats, updated in place), the
    store's node and up-profile rows and nj.debug's n_ml_nni,
    n_star_tests, n_lk_compute and n_posterior_compute come out as the host
    loop leaves them; under -constraints the criteria take the quartets'
    penalties (the constrained kernel, on the counts the ME phase left).
    tree_in_smem=False keeps the kernel's tree in device memory, as it does
    anyway for trees too large for shared memory; group sets the blocks of
    a 20-code group (GROUPS)."""
    if nj.ml.codes.device.type == "cpu" or nj.options.slow:
        return rearrange.do_nni(nj, i_round, n_rounds, True, stats)
    if nj.n_seqs <= 3:
        return 0, 0.0
    n = nj.tree.maxnode
    if any(len(a) != n for a in (stats.age, stats.subtree_age, stats.delta,
                                 stats.support)):
        raise ValueError(f"ml_nni_round: NNIStats of {len(stats.age)} nodes "
                         f"for a tree of {n}")
    ctr, max_delta = _launch(ml_nni_round, nj, stats, tree_in_smem, group)
    return ctr["n_ml_nni"], max_delta


def ml_lengths_pass(nj, *, tree_in_smem: bool = True,
                    group: int = GROUP) -> None:
    """One pass of ML branch-length optimization over the whole tree (ref
    optimizeAllBranchLengths tcc:5006-5111), in place: the host loop for a
    store on the CPU or a tree of fewer than three tips, one launch of the
    kernel for a store on a CUDA device.  The branch lengths, the store's
    node and up-profile rows and nj.debug's n_lk_compute and
    n_posterior_compute come out as the host loop leaves them.  group as
    for ml_nni_round."""
    if nj.ml.codes.device.type == "cpu" or nj.n_seqs < 3:
        from ..engine import ml
        return ml.optimize_all_branch_lengths(nj)
    _launch(ml_lengths_pass, nj, None, tree_in_smem, group)


def layout(M, P, C, tree_in_smem=True, lengths=False, group=GROUP) -> dict:
    """The kernel's layout of a round (or a pass) at (M, P, C): LAYOUT's
    fields.  Raises for a group the kernels do not take."""
    out = (ctypes.c_int64 * len(LAYOUT))()
    rc = _build.library().vft_ml_round_layout(M, P, C, int(tree_in_smem),
                                              int(lengths), group, out)
    me_round.raise_on(rc, "ml_round.layout")
    return dict(zip(LAYOUT, (int(v) for v in out)))


def _launch(wrapper, nj, stats, tree_in_smem, group):
    """Upload the tree, branch lengths and (an NNI round's) NNIStats, run
    the wrapper's kernel once, fetch them back; returns (the counters,
    max_delta).  Raises if the kernel found the tree broken, for a group the
    kernels do not take, and for a cluster the card refuses."""
    ml, opts, tree = nj.ml, nj.options, nj.tree
    name = wrapper.__name__
    M = tree.maxnodes
    n = 0 if stats is None else tree.maxnode
    me_round.check_tree(name, tree)
    # words: the counters, max_delta, then age, subtree_age, delta, support
    # [n] each (an NNI round's), then the branch lengths [M]
    k = len(COUNTERS) + 1
    bl_at = k + 4 * n
    state = me_round.RoundBuffer(tree, bl_at + M, n_flags=2)
    w = state.words
    if stats is not None:
        w[k: k + n] = stats.age
        w[k + n: k + 2 * n] = stats.subtree_age
        w[k + 2 * n: bl_at].view(np.float64)[:] = np.concatenate(
            [stats.delta, stats.support])
    w[bl_at:].view(np.float64)[:] = tree.branchlength
    ptr = state.upload(ml.codes.device)
    at = lambda i: ptr["words"] + 8 * i  # noqa: E731
    bound = ml_kernels._bind(ml.codes, ml.W, ml.V, ml.model)
    lib = _build.library()
    if bound.C == 20 and group not in GROUPS:
        raise ValueError(f"{name}: a group of {group} blocks (takes "
                         f"{GROUPS})")
    n_scratch = lib.vft_ml_round_scratch_floats(M, bound.P, bound.C,
                                                int(tree_in_smem), group)
    me_round.raise_on(min(n_scratch, 0), name)
    scratch = bound.buffer("round_scratch", 4 * n_scratch) if n_scratch \
        else None
    lo = opts.ml_min_branch_length
    lead = [*bound.args, ml.model.tol, lo, 6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance, lo]
    tail = [ptr["tree"], ptr["flags"], ptr["path"], ptr["words"]]
    tail_end = [scratch.data_ptr() if scratch is not None else None,
                int(tree_in_smem), group, bound.stream]
    if stats is None:
        rc = lib.vft_ml_lengths_pass_f32(
            *lead, nj.n_seqs, M, tree.root, at(bl_at), *tail, *tail_end)
    else:
        round_args = [
            *lead, int(opts.ml_accuracy), nj.n_seqs, M, tree.root,
            int(opts.fast_nni), float(constants.TREE_LOGLK_DELTA), n, at(k),
            at(k + n), at(k + 2 * n), at(k + 3 * n), at(bl_at), *tail,
            at(k - 1), *tail_end[:-1]]
        if nj.n_cons:
            # the constrained kernel, ml_nni_round_cons_kernel: the counts
            # the ME phase left, read only
            counts = me_round.Counts(nj, ml.codes.device)
            rc = lib.vft_ml_nni_round_cons_f32(*round_args, *counts.args(),
                                               tail_end[-1])
        else:
            rc = lib.vft_ml_nni_round_f32(*round_args, tail_end[-1])
    me_round.raise_on(rc, name)
    wrapper.launches += 1
    wrapper.cons_launches += bool(stats is not None and nj.n_cons)
    wrapper.tree_layout = "shared memory" if tree_in_smem and \
        lib.vft_ml_round_tree_fits_smem(M, bound.P, bound.C) \
        else "device memory"
    wrapper.scratch_floats = n_scratch
    wrapper.layout = layout(M, bound.P, bound.C, tree_in_smem,
                            stats is None, group)

    ctr, w = state.fetch(name, tree, COUNTERS)
    tree.branchlength[:] = w[bl_at:].view(np.float64)
    if stats is not None:
        stats.age[:] = w[k: k + n]
        stats.subtree_age[:] = w[k + n: k + 2 * n]
        stats.delta[:] = w[k + 2 * n: k + 3 * n].view(np.float64)
        stats.support[:] = w[k + 3 * n: bl_at].view(np.float64)
    for key in DEBUG:
        setattr(nj.debug, key, getattr(nj.debug, key) + ctr[key])
    ml.post_counts += torch.tensor([ctr["aa_rough"], ctr["aa_exact"]],
                                   device=ml.post_counts.device)
    for key in wrapper.totals:
        wrapper.totals[key] += ctr[key]
    return ctr, float(w[k - 1: k].view(np.float64)[0])


for _fn in (ml_nni_round, ml_lengths_pass):
    _fn.launches = 0
    # the launches of the constrained round kernel (ml_nni_round_cons_kernel)
    # among them; a pass makes no decision, so it has none
    _fn.cons_launches = 0
    # the kernel's counters summed over its launches (the work it did)
    _fn.totals = dict.fromkeys(COUNTERS[:-1], 0)
    # where the last launch kept the tree: "shared memory" or "device memory"
    _fn.tree_layout = None
    # the floats of device scratch the last launch took for the quartet
    # pieces its blocks' shared memory had no room for (0 at P=512)
    _fn.scratch_floats = None
    # the last launch's layout (layout())
    _fn.layout = None
del _fn


def sh_pass(nj, progress=None) -> SplitCount:
    """The SH-like supports of every internal split (ref testSplitsML
    tcc:6856-6999, SHSupport :1126-1164), value for
    value engine/ml.test_splits_ml's, in a handful of list launches on nj's
    ML store (SHPass).  Returns the SplitCount; sets tree.support (with
    -boot > 0), and nj.debug's n_lk_compute and n_posterior_compute as the
    loop leaves them."""
    if nj.n_seqs <= 3:
        return SplitCount()
    sh = SHPass(nj).run()
    if progress is not None:
        progress.print("ML split tests for %6d of %6d internal splits",
                       sh.S, nj.n_seqs - 3)
    return sh.sc


class SHPass:
    """The SH-like supports pass over the S internal splits of nj's tree,
    one method per step, in STEPS order (the kernels on a CUDA store, their
    twins on a CPU one):

    (a) draw: the bootstrap counts [P, B] (resample_kernels.
        sh_resample_counts);
    (b) up_profiles: the up-profiles the loop computes, top-down, level
        by level (_up_levels), in one ml_posterior_sweep launch;
    (c) gather: the quartets (A, B, C, D) of the splits, as setup_abcd
        gives them (_quartets);
    (d) ab_quartets: one ml_posterior launch of the AB quartets' 2S
        posteriors into the store's list-pass rows (43 MB at N=2000,
        P=512, C=4, in a block the store already holds), one ml_pair_loglk
        launch of their 3S pairs with per-site likelihoods, summed
        (ll1 + ll2) + ll3 in float64 on the device;
    (e) ac_ad_quartets: one ml_quartet_opt launch of the 2S AC and AD
        optimizations with per-site likelihoods, kept on the device;
    (f) second_pass: one fetch of the records and the AB log-likelihoods,
        the host's choice of the closer alternatives to optimize again (ref
        :6932-6945), and one ml_quartet_opt launch of those;
    (g) choices: the choices, bad splits and SplitCount (with the
        constraint penalties and violations of the host counts), on the
        host;
    (h) supports: with -boot > 0, the per-site logs and
        site_loglk3 @ counts - loglk3 in float64 on the device, best minus
        second best against delta, one fetch of the S counts; sets
        tree.support.

    Each call runs the body the loop's call runs, on the same float32 and
    float64 inputs, so the log-likelihoods and per-site likelihoods are the
    loop's bit for bit on the card.  After run(): nodes [S], loglk [S, 3]
    (AB, AC, AD), pair_lk [S, 3, n_pos] (the AB pairs), quartet_lk
    [S, 2, 3, n_pos] (the last AC and AD optimizations), choice, bad and
    support [S] (None without -boot), and sc, the SplitCount."""

    STEPS = ("draw", "up_profiles", "gather", "ab_quartets",
             "ac_ad_quartets", "second_pass", "choices", "supports")

    def __init__(self, nj):
        self.nj = nj
        tree = nj.tree
        self.nodes = np.array([n for n in _postorder(tree)
                               if n >= nj.n_seqs and n != tree.root],
                              dtype=np.int64)
        self.S = len(self.nodes)
        self.sc = SplitCount()
        self.support = None

    def run(self):
        for step in self.STEPS:
            getattr(self, step)()
        return self

    def draw(self):                                                   # (a)
        nj = self.nj
        n_boot = nj.options.n_bootstrap
        self.boot = resample_kernels.sh_resample_counts(
            nj.n_pos, n_boot, nj.ml.device) if n_boot > 0 else None

    def up_profiles(self):                                            # (b)
        nj = self.nj
        self.levels = _up_levels(nj, self.nodes)
        nj.ml.posterior_sweep(up_sweep_tables(nj, self.nodes, self.levels))

    def gather(self):                                                 # (c)
        bl = self.nj.tree.branchlength
        self.rows4, self.nodes4 = _quartets(self.nj, self.nodes)
        self.lens = np.concatenate([bl[self.nodes4], bl[self.nodes][:, None]],
                                   axis=1)

    def ab_quartets(self):                                            # (d)
        ml, S, lens = self.nj.ml, self.S, self.lens
        rA, rB, rC, rD = self.rows4.T
        s_ab = ml.batch_row(0) + np.arange(S)
        s_cd = s_ab + S
        ml.batch_row(2 * S - 1)                      # the block holds them
        ml.posterior_rows(np.concatenate([s_ab, s_cd]),
                          np.concatenate([rA, rC]), np.concatenate([rB, rD]),
                          np.concatenate([lens[:, 0], lens[:, 2]]),
                          np.concatenate([lens[:, 1], lens[:, 3]]))
        ll, pair_lk = ml.pair_loglk_rows(
            np.concatenate([rA, rC, s_ab]), np.concatenate([rB, rD, s_cd]),
            np.concatenate([lens[:, 0] + lens[:, 1], lens[:, 2] + lens[:, 3],
                            lens[:, 4]]), want_site_lk=True, fetch=False)
        self.ll_ab = (ll[:S] + ll[S:2 * S]) + ll[2 * S:]
        self.pair_lk = pair_lk.reshape(3, S, self.nj.n_pos).transpose(0, 1)

    def ac_ad_quartets(self):                                         # (e)
        rows4, lens = self.rows4, self.lens
        self.q_rows = np.concatenate([rows4[:, [0, 2, 1, 3]],
                                      rows4[:, [0, 3, 2, 1]]])
        q_lens = np.concatenate([lens[:, [0, 2, 1, 3, 4]],
                                 lens[:, [0, 3, 2, 1, 4]]])
        self.rec, self.quartet_lk = self.nj.ml.quartet_records(
            self.q_rows, q_lens, want_site_lk=True, keep_site=True)

    def second_pass(self):                                            # (f)
        nj, S, rec = self.nj, self.S, self.rec
        loglk = self.loglk = np.empty((S, 3))
        loglk[:, 0] = self.ll_ab.cpu().numpy()
        loglk[:, 1:] = _quartet_loglk(rec).reshape(2, S).T
        ac_closer = loglk[:, 1] > loglk[:, 2]
        closer = np.where(ac_closer, loglk[:, 1], loglk[:, 2])
        self.again = np.flatnonzero((nj.options.ml_accuracy > 1) | (
            closer > loglk[:, 0] - constants.CLOSE_LOGLK_LIMIT))
        self.rec2 = None
        quartet_lk = self.quartet_lk
        if len(self.again):
            which = np.where(ac_closer[self.again], 1, 2)
            qi = self.again + S * (which - 1)
            # the first pass's lengths, as the loop's arrays hold them after
            # it
            self.rec2, lk2 = nj.ml.quartet_records(
                self.q_rows[qi], rec["len"][qi].astype(np.float64),
                want_site_lk=True, keep_site=True)
            loglk[self.again, which] = _quartet_loglk(self.rec2)
            quartet_lk[torch.as_tensor(qi, device=quartet_lk.device)] = lk2
        n_pos = nj.n_pos
        self.quartet_lk = quartet_lk[..., :n_pos].reshape(2, S, 3, n_pos) \
            .transpose(0, 1)

    def choices(self):                                                # (g)
        S = self.S
        ab, ac, ad = self.loglk.T
        self.choice = np.where((ab >= ac) & (ab >= ad), 0,
                               np.where((ac >= ab) & (ac >= ad), 1, 2))
        best = self.loglk[np.arange(S), self.choice]
        self.bad = best > ab + constants.TREE_LOGLK_DELTA
        # the constraints' penalties and violations from the host counts
        pen, violated = split_constraints(self.nj, self.nodes4)
        self.sc.count(best - ab, self.bad, pen, self.choice, violated)

    def supports(self):                                               # (h)
        n_boot = self.nj.options.n_bootstrap
        if n_boot > 0:
            self.support = np.where(self.bad, 0.0, _supports(
                self.pair_lk, self.quartet_lk, self.loglk, self.boot)
                / n_boot)
            self.nj.tree.support[self.nodes] = self.support


def _postorder(tree):
    """tree.postorder_nodes() in one walk (it restarts from the root for
    each node): children in their order, each node after its subtree."""
    children, n_child = tree.children.tolist(), tree.n_child.tolist()
    out, stack = [], [(tree.root, 0)]
    while stack:
        node, k = stack.pop()
        if k < n_child[node]:
            stack.append((node, k + 1))
            stack.append((children[node][k], 0))
        else:
            out.append(node)
    return out


def _cd(nj, us):
    """(C, D, D's row) [K] of the quartets around nodes us (setup_abcd with
    every up-profile in place): C u's sibling and D its parent, whose
    up-profile row is D's row; at the root the root's other two children,
    in their order (tree.sibling, tree.root_siblings)."""
    tree = nj.tree
    us = np.asarray(us, dtype=np.int64)
    par = tree.parent[us]
    kids = tree.children[par]
    at_root = par == tree.root
    if at_root.any() and tree.n_child[tree.root] != 3:
        raise AssertionError("sh_pass: a root with other than three children")
    first = kids[:, 0] == us
    c = np.where(first, kids[:, 1], kids[:, 0])
    d_root = np.where(first | (kids[:, 1] == us), kids[:, 2], kids[:, 1])
    d = np.where(at_root, d_root, par)
    return c, d, np.where(at_root, d_root, nj.prof.up_row(par))


def _up_levels(nj, nodes):
    """The up-profiles test_splits_ml's setup_abcd asks for (those of the
    splits' parents below the root), top-down, one (targets, r1s, r2s,
    len1s, len2s) list per tree level: up[u] = posterior(C, D) at (bl[C],
    bl[D]) (_cd; ref getUpProfile tcc:3382-3434; the JAX package's
    compute_up_profiles_levelwise order)."""
    tree = nj.tree
    bl = tree.branchlength
    need = np.setdiff1d(tree.parent[nodes], [tree.root])
    levels = []
    for level in reversed(level_order(tree)):
        us = level[np.isin(level, need)]
        if len(us):
            c, d, d_row = _cd(nj, us)
            levels.append([nj.prof.up_row(us), c, d_row, bl[c], bl[d]])
    return levels


def up_sweep_tables(nj, nodes, levels=None):
    """The SweepTables of the SH pass's up-profiles over the splits
    `nodes` (_up_levels, or `levels` as it gave them), top-down: a
    parent's up-profile feeds both of its children's.  Each item counts as
    often as the host loop computes it (_lazy_up_counts)."""
    if levels is None:
        levels = _up_levels(nj, nodes)
    times = _lazy_up_counts(nj, nodes)
    return nj.ml.sweep_tables(levels, [
        times[u] for lv in levels
        for u in (np.asarray(lv[0]) - nj.prof.maxnodes).tolist()])


def _lazy_up_counts(nj, nodes) -> collections.Counter:
    """How often test_splits_ml's UpProfiles computes each node's
    up-profile over `nodes` in postorder: each get() computes the nodes
    not valid on the path from below the root down, and each split resets
    its A, B and C (engine/rearrange.UpProfiles)."""
    tree = nj.tree
    parent, root = tree.parent.tolist(), tree.root
    resets = np.concatenate([tree.children[nodes, :2],
                             _cd(nj, nodes)[0][:, None]], axis=1).tolist()
    valid, times = set(), collections.Counter()
    for node, reset in zip(nodes.tolist(), resets):
        u = parent[node]
        if u not in valid:
            while u != root:
                if u not in valid:
                    valid.add(u)
                    times[u] += 1
                u = parent[u]
        valid.difference_update(reset)
    return times


def _quartets(nj, nodes):
    """(rows4, nodes4) [S, 4] of the splits, as setup_abcd gives them with
    every up-profile in place."""
    a, b = nj.tree.children[nodes, 0], nj.tree.children[nodes, 1]
    c, d, d_row = _cd(nj, nodes)
    return np.stack([a, b, c, d_row], axis=1), np.stack([a, b, c, d], axis=1)


def _quartet_loglk(rec):
    """Each optimization's quartet LogLk, its parts summed in the host
    loop's order."""
    parts = rec["parts"]
    return parts[:, 0] + parts[:, 1] + parts[:, 2]


def _supports(pair_lk, quartet_lk, loglk, counts):
    """The resamples in which each split's best topology leads the second
    best by less than it leads in the data (engine/ml.sh_support): pair_lk
    [S, 3, n_pos] and quartet_lk [S, 2, 3, n_pos] per-site likelihoods on
    the device, loglk [S, 3] on the host, counts [n_pos, B].  Returns the
    counts [S] on the host."""
    def site_log(lk):
        return torch.log(torch.clamp_min(lk.double(), 1e-300))

    def three(lk):
        return (site_log(lk[..., 0, :]) + site_log(lk[..., 1, :])) \
            + site_log(lk[..., 2, :])

    site3 = torch.cat([three(pair_lk)[:, None], three(quartet_lk)], dim=1)
    ll3 = torch.as_tensor(loglk, device=site3.device)
    resampled = torch.matmul(site3, counts) - ll3[:, :, None]      # [S, 3, B]
    # best minus second best: np.sort's order[2] - order[1], the maximum
    # and the median of the three taken exactly by comparisons
    x, y, z = resampled.unbind(1)
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    best = torch.maximum(hi, z)
    second = torch.maximum(lo, torch.minimum(hi, z))
    delta = torch.minimum(ll3[:, 0] - ll3[:, 1], ll3[:, 0] - ll3[:, 2])
    n_support = ((best - second) < delta[:, None]).sum(1)
    return n_support.cpu().numpy()
