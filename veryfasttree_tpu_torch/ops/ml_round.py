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
the NNIStats, max_delta and the counters.  A round runs on a cluster of
three blocks (the walk and the AB optimizations on block 0, the AC and AD
optimizations beside them on blocks 1 and 2); a pass on one block.

The twins are the host loops themselves on the per-call twins of
``ops/ml_kernels.py``: each wrapper runs its host loop for a store on the
CPU, and launches its kernel, or raises, for a store on a CUDA device.
``-slow`` keeps the NNI host loop on the card too: its profile repairs
recompute every ancestor, which the kernel does not.
"""
from __future__ import annotations

import numpy as np

from .. import constants
from ..engine import rearrange
from . import _build, me_round, ml_kernels

# the kernels' int64 counters, in their order (csrc/ml_round.cu): the debug
# counters the host loops add to, then the work done (quartet
# optimizations, posteriors with the quartets' temporaries, line searches,
# their evaluations, pair log-likelihoods: the host loop's work), the AC
# and AD optimizations a round started beside AB and discarded when AB's
# star test fired (speculative, in none of the others) and the fault flag
COUNTERS = ("n_ml_nni", "n_star_tests", "n_lk_compute", "n_posterior_compute",
            "quartets", "posteriors", "searches", "evals", "pairs",
            "speculative", "fault")
DEBUG = COUNTERS[:4]


def ml_nni_round(nj, i_round: int, n_rounds: int, stats, *,
                 tree_in_smem: bool = True):
    """One round of ML NNIs on nj's tree and ML store, in place (ref DoNNI
    tcc:5997-6183 with ML quartets): the host loop for a store on the CPU
    or under -slow, one launch of the kernel for a store on a CUDA device.
    Returns (n_changes, max_delta) as the host loop does; the tree arrays,
    branch lengths, `stats` (rearrange.NNIStats, updated in place), the
    store's node and up-profile rows and nj.debug's n_ml_nni,
    n_star_tests, n_lk_compute and n_posterior_compute come out as the host
    loop leaves them.  tree_in_smem=False keeps the kernel's tree in device
    memory, as it does anyway for trees too large for shared memory."""
    if nj.ml.codes.device.type == "cpu" or nj.options.slow:
        return rearrange.do_nni(nj, i_round, n_rounds, True, stats)
    if nj.n_seqs <= 3:
        return 0, 0.0
    n = nj.tree.maxnode
    if any(len(a) != n for a in (stats.age, stats.subtree_age, stats.delta,
                                 stats.support)):
        raise ValueError(f"ml_nni_round: NNIStats of {len(stats.age)} nodes "
                         f"for a tree of {n}")
    ctr, max_delta = _launch(ml_nni_round, nj, stats, tree_in_smem)
    return ctr["n_ml_nni"], max_delta


def ml_lengths_pass(nj, *, tree_in_smem: bool = True) -> None:
    """One pass of ML branch-length optimization over the whole tree (ref
    optimizeAllBranchLengths tcc:5006-5111), in place: the host loop for a
    store on the CPU or a tree of fewer than three tips, one launch of the
    kernel for a store on a CUDA device.  The branch lengths, the store's
    node and up-profile rows and nj.debug's n_lk_compute and
    n_posterior_compute come out as the host loop leaves them."""
    if nj.ml.codes.device.type == "cpu" or nj.n_seqs < 3:
        from ..engine import ml
        return ml.optimize_all_branch_lengths(nj)
    _launch(ml_lengths_pass, nj, None, tree_in_smem)


def _launch(wrapper, nj, stats, tree_in_smem):
    """Upload the tree, branch lengths and (an NNI round's) NNIStats, run
    the wrapper's kernel once, fetch them back; returns (the counters,
    max_delta).  Raises if the kernel found the tree broken."""
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
    n_scratch = lib.vft_ml_round_scratch_floats(M, bound.P, bound.C,
                                                int(tree_in_smem))
    scratch = bound.buffer("round_scratch", 4 * n_scratch) if n_scratch \
        else None
    lo = opts.ml_min_branch_length
    lead = [*bound.args, ml.model.tol, lo, 6.0, opts.ml_ftol_branch_length,
            opts.ml_min_branch_length_tolerance, lo]
    tail = [ptr["tree"], ptr["flags"], ptr["path"], ptr["words"]]
    tail_end = [scratch.data_ptr() if scratch is not None else None,
                int(tree_in_smem), bound.stream]
    if stats is None:
        rc = lib.vft_ml_lengths_pass_f32(
            *lead, nj.n_seqs, M, tree.root, at(bl_at), *tail, *tail_end)
    else:
        rc = lib.vft_ml_nni_round_f32(
            *lead, int(opts.ml_accuracy), nj.n_seqs, M, tree.root,
            int(opts.fast_nni), float(constants.TREE_LOGLK_DELTA), n, at(k),
            at(k + n), at(k + 2 * n), at(k + 3 * n), at(bl_at), *tail,
            at(k - 1), *tail_end)
    me_round.raise_on(rc, name)
    wrapper.launches += 1
    wrapper.tree_layout = "shared memory" if tree_in_smem and \
        lib.vft_ml_round_tree_fits_smem(M, bound.P, bound.C) \
        else "device memory"
    wrapper.scratch_floats = n_scratch

    ctr, w = state.fetch(name, tree, COUNTERS)
    tree.branchlength[:] = w[bl_at:].view(np.float64)
    if stats is not None:
        stats.age[:] = w[k: k + n]
        stats.subtree_age[:] = w[k + n: k + 2 * n]
        stats.delta[:] = w[k + 2 * n: k + 3 * n].view(np.float64)
        stats.support[:] = w[k + 3 * n: bl_at].view(np.float64)
    for key in DEBUG:
        setattr(nj.debug, key, getattr(nj.debug, key) + ctr[key])
    for key in wrapper.totals:
        wrapper.totals[key] += ctr[key]
    return ctr, float(w[k - 1: k].view(np.float64)[0])


for _fn in (ml_nni_round, ml_lengths_pass):
    _fn.launches = 0
    # the kernel's counters summed over its launches (the work it did)
    _fn.totals = dict.fromkeys(COUNTERS[:-1], 0)
    # where the last launch kept the tree: "shared memory" or "device memory"
    _fn.tree_layout = None
    # the floats of device scratch the last launch took for the quartet
    # pieces its blocks' shared memory had no room for (0 at P=512)
    _fn.scratch_floats = None
del _fn
