"""One SPR round of the minimum-evolution phase: the CUDA kernel of
``csrc/me_spr.cu`` and its plain twin.

The host loop ``engine/spr.run_spr`` makes a store call for every profile
average and a distance call with a blocking fetch for every chain step, some
tens of thousands per round.  The JAX package moves the round onto its
device as one dispatch per node (``veryfasttree_tpu/engine/spr_epoch.py``);
here one launch runs every node of the round's postorder snapshot, and the
round makes one fetch at its end: the tree arrays and the counters.

The twin is the host loop itself on the per-call twins of
``ops/store_kernels.py``: ``spr_round`` runs it for a store on the CPU, and
launches the kernel, or raises, for a store on a CUDA device.  ``-slow``
keeps the host loop on the card too (the pipeline chooses it by the
option): its whole-tree length checks after each move are not on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine import spr
from . import _build, me_round

MAX_CHAIN = 64      # the longest max_spr_length the kernel takes
# the kernel's int64 counters, in its order (csrc/me_round.cuh)
COUNTERS = ("profile_ops", "profile_avg_ops", "n_spr", "rows_averaged",
            "quartets", "fault")


def spr_round(nj, i_round: int, n_rounds: int, *,
              tree_in_smem: bool = True) -> None:
    """One round of SPR moves on nj's tree and store, in place (ref SPR
    tcc:6315-6404): the host loop for a store on the CPU, one launch of the
    kernel for a store on a CUDA device.  The tree arrays and nj.debug's
    profile_ops, profile_avg_ops and n_spr come out as the host loop leaves
    them, and so do the constraint counts.  tree_in_smem=False keeps the
    kernel's tree in device memory, as it does anyway for trees too large
    for shared memory (N above about 4,000)."""
    prof = nj.prof
    if prof.codes.device.type == "cpu":
        spr.run_spr(nj, i_round, n_rounds)
        return
    opts = nj.options
    if opts.slow:
        raise ValueError("me_spr_round: -slow runs the host loop "
                         "(engine/spr.run_spr)")
    if nj.n_seqs <= 3 or opts.max_spr_length < 1:
        return
    if opts.max_spr_length > MAX_CHAIN:
        raise ValueError(f"me_spr_round: chains of at most {MAX_CHAIN} "
                         f"steps, not {opts.max_spr_length}")
    tree = nj.tree
    args, _alive = me_round.entry_args(nj)
    node_list = list(tree.postorder_nodes())
    nodes = np.array([n for n in node_list if n != tree.root], dtype=np.int32)
    me_round.check_tree("me_spr_round", tree, nodes)
    state = me_round.RoundBuffer(tree, len(COUNTERS), nodes)
    ptr = state.upload(prof.codes.device)
    if nj.progress is not None:
        nj.progress.print("SPR round %3d of %3d, %d nodes", i_round + 1,
                          n_rounds, len(node_list))
    lead = [*args, opts.max_spr_length, ptr["ints"], len(nodes), ptr["tree"],
            ptr["flags"], ptr["path"], ptr["words"], int(tree_in_smem)]
    stream = torch.cuda.current_stream(prof.codes.device).cuda_stream
    lib = _build.library()
    if nj.n_cons:
        # the constrained kernel, me_spr_round_cons_kernel
        counts = me_round.Counts(nj, prof.codes.device)
        rc = lib.vft_me_spr_round_cons_f32(*lead, *counts.args(), stream)
    else:
        rc = lib.vft_me_spr_round_f32(*lead, stream)
    me_round.raise_on(rc, "me_spr_round")
    spr_round.launches += 1
    spr_round.cons_launches += bool(nj.n_cons)

    ctr, _ = state.fetch("me_spr_round", tree, COUNTERS)
    if nj.n_cons:
        counts.fetch()
    nj.debug.profile_ops += ctr["profile_ops"]
    nj.debug.profile_avg_ops += ctr["profile_avg_ops"]
    nj.debug.n_spr += ctr["n_spr"]
    ctr["nodes"] = len(nodes)
    for k in spr_round.totals:
        spr_round.totals[k] += ctr[k]


spr_round.launches = 0
# the launches of the constrained kernel (me_spr_round_cons_kernel) among them
spr_round.cons_launches = 0
# the kernel's counters summed over its rounds (the work of its launches)
spr_round.totals = dict.fromkeys(COUNTERS[:-1] + ("nodes",), 0)
