"""One NNI round of the minimum-evolution phase: the CUDA kernel of
``csrc/me_nni.cu`` and its plain twin.

The host loop ``engine/rearrange.do_nni`` (with ``use_ml`` off) makes a
store call for every profile average and a distance call with a blocking
fetch for every quartet, some tens of thousands per round; so does the JAX
package's (``veryfasttree_tpu/engine/rearrange.py``), which has no device
round to port.  Here one launch runs the whole round, and the round makes
one fetch at its end: the counters, the NNIStats and the tree arrays.

The twin is the host loop itself on the per-call twins of
``ops/store_kernels.py``: ``nni_round`` runs it for a store on the CPU, and
launches the kernel, or raises, for a store on a CUDA device.  ``-slow``
keeps the host loop on the card too (the pipeline chooses it by the
option): its profile repairs recompute every ancestor, which the kernel
does not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine import rearrange
from . import _build, me_round

# the kernel's int64 counters, in its order (csrc/me_round.cuh)
COUNTERS = ("profile_ops", "profile_avg_ops", "n_nni", "rows_averaged",
            "quartets", "fault")


def nni_round(nj, i_round: int, n_rounds: int, stats, *,
              tree_in_smem: bool = True):
    """One round of ME NNIs on nj's tree and store, in place (ref DoNNI
    tcc:5997-6183 with ME quartets): the host loop for a store on the CPU,
    one launch of the kernel for a store on a CUDA device.  Returns
    (n_nni, max_delta) as the host loop does; the tree arrays, `stats`
    (rearrange.NNIStats, updated in place) and nj.debug's profile_ops,
    profile_avg_ops and n_nni and the constraint counts come out as the
    host loop leaves them.
    tree_in_smem=False keeps the kernel's tree in device memory, as it does
    anyway for trees too large for shared memory (N above about 3,900)."""
    prof = nj.prof
    if prof.codes.device.type == "cpu":
        return rearrange.do_nni(nj, i_round, n_rounds, False, stats)
    opts = nj.options
    if opts.slow:
        raise ValueError("me_nni_round: -slow runs the host loop "
                         "(engine/rearrange.do_nni)")
    if nj.n_seqs <= 3:
        return 0, 0.0
    tree = nj.tree
    n = tree.maxnode
    if any(len(a) != n for a in (stats.age, stats.subtree_age, stats.delta,
                                 stats.support)):
        raise ValueError(f"me_nni_round: NNIStats of {len(stats.age)} nodes "
                         f"for a tree of {n}")
    args, _alive = me_round.entry_args(nj)
    me_round.check_tree("me_nni_round", tree)
    # words: the counters, max_delta, then age, subtree_age, delta, support
    k = len(COUNTERS) + 1
    state = me_round.RoundBuffer(tree, k + 4 * n, n_flags=2)
    w = state.words
    w[k: k + n] = stats.age
    w[k + n: k + 2 * n] = stats.subtree_age
    w[k + 2 * n: k + 4 * n].view(np.float64)[:] = np.concatenate(
        [stats.delta, stats.support])
    ptr = state.upload(prof.codes.device)
    at = lambda i: ptr["words"] + 8 * i  # noqa: E731
    lead = [*args, int(opts.fast_nni), float(opts.me_min_delta), n, at(k),
            at(k + n), at(k + 2 * n), at(k + 3 * n), ptr["tree"],
            ptr["flags"], ptr["path"], ptr["words"], at(k - 1),
            int(tree_in_smem)]
    stream = torch.cuda.current_stream(prof.codes.device).cuda_stream
    lib = _build.library()
    if nj.n_cons:
        # the constrained kernel, me_nni_round_cons_kernel
        counts = me_round.Counts(nj, prof.codes.device)
        rc = lib.vft_me_nni_round_cons_f32(*lead, *counts.args(), stream)
    else:
        rc = lib.vft_me_nni_round_f32(*lead, stream)
    me_round.raise_on(rc, "me_nni_round")
    nni_round.launches += 1
    nni_round.cons_launches += bool(nj.n_cons)

    ctr, w = state.fetch("me_nni_round", tree, COUNTERS)
    if nj.n_cons:
        counts.fetch()
    stats.age[:] = w[k: k + n]
    stats.subtree_age[:] = w[k + n: k + 2 * n]
    stats.delta[:] = w[k + 2 * n: k + 3 * n].view(np.float64)
    stats.support[:] = w[k + 3 * n: k + 4 * n].view(np.float64)
    nj.debug.profile_ops += ctr["profile_ops"]
    nj.debug.profile_avg_ops += ctr["profile_avg_ops"]
    nj.debug.n_nni += ctr["n_nni"]
    for key in nni_round.totals:
        nni_round.totals[key] += ctr[key]
    return ctr["n_nni"], float(w[k - 1: k].view(np.float64)[0])


nni_round.launches = 0
# the launches of the constrained kernel (me_nni_round_cons_kernel) among them
nni_round.cons_launches = 0
# the kernel's counters summed over its rounds (the work of its launches)
nni_round.totals = dict.fromkeys(COUNTERS[:-1], 0)
