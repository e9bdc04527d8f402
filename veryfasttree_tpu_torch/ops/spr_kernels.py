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
from . import _build
from .store_kernels import _check_store

MAX_CHAIN = 64      # the longest max_spr_length the kernel takes
# the kernel's int64 counters, in its order (csrc/me_spr.cu)
COUNTERS = ("profile_ops", "profile_avg_ops", "n_spr", "rows_averaged",
            "quartets", "fault")


def _check_tree(tree, nodes):
    M = tree.maxnodes
    ok = lambda a: bool(((a >= -1) & (a < M)).all())  # noqa: E731
    if not (ok(tree.parent) and ok(tree.children)) or \
            not (0 <= tree.root < M) or (nodes < 0).any() \
            or (nodes >= tree.maxnode).any():
        raise IndexError("me_spr_round: a tree index lies outside the "
                         f"{M} nodes")


def spr_round(nj, i_round: int, n_rounds: int, *,
              tree_in_smem: bool = True) -> None:
    """One round of SPR moves on nj's tree and store, in place (ref SPR
    tcc:6315-6404): the host loop for a store on the CPU, one launch of the
    kernel for a store on a CUDA device.  The tree arrays and nj.debug's
    profile_ops, profile_avg_ops and n_spr come out as the host loop leaves
    them.  tree_in_smem=False keeps the kernel's tree in device memory, as it
    does anyway for trees too large for shared memory (N above about
    4,000)."""
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
    leaf_rows = prof._leaf_rows
    n_rows, P, C = _check_store(prof.codes, prof.W, prof.U, prof.code_freq,
                                leaf_rows)
    dev = prof.codes.device
    tree = nj.tree
    M = tree.maxnodes
    node_list = list(tree.postorder_nodes())
    nodes = np.array([n for n in node_list if n != tree.root], dtype=np.int32)
    _check_tree(tree, nodes)

    # one int32 buffer: counters (int64), parent [M], children [M, 3],
    # child counts [M], path scratch [M], the node list
    base = 2 * len(COUNTERS)
    host = np.zeros(base + 6 * M + len(nodes), dtype=np.int32)
    host[base: base + M] = tree.parent
    host[base + M: base + 4 * M] = tree.children.reshape(-1)
    host[base + 4 * M: base + 5 * M] = tree.n_child
    host[base + 6 * M:] = nodes
    buf = torch.from_numpy(host).to(dev)
    uvalid = torch.zeros(M, dtype=torch.uint8, device=dev)
    ptr = buf.data_ptr()
    tree_ptr = ptr + 4 * base
    ev = et = None
    if prof.use_matrix:
        ev = prof.eigenval.to(dtype=torch.float64).contiguous()
        et = prof.eigentot.to(dtype=torch.float32).contiguous()
    jc = opts.n_codes == 4 and not opts.use_matrix
    if nj.progress is not None:
        nj.progress.print("SPR round %3d of %3d, %d nodes", i_round + 1,
                          n_rounds, len(node_list))
    rc = _build.library().vft_me_spr_round_f32(
        prof.codes.data_ptr(), prof.W.data_ptr(), prof.U.data_ptr(),
        prof.code_freq.data_ptr(), n_rows, int(leaf_rows), P, C,
        ev.data_ptr() if ev is not None else None,
        et.data_ptr() if et is not None else None, prof.tol, nj.n_seqs, M,
        tree.root, opts.max_spr_length, int(opts.bionj), int(opts.logdist),
        int(jc), float(opts.pseudo_weight), tree_ptr + 4 * 6 * M, len(nodes),
        tree_ptr, uvalid.data_ptr(), tree_ptr + 4 * 5 * M, ptr,
        int(tree_in_smem), torch.cuda.current_stream(dev).cuda_stream)
    if rc == -2:
        raise ValueError("me_spr_round: the kernel does not take this store "
                         "or tree")
    if rc != 0:
        raise RuntimeError(f"me_spr_round: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    spr_round.launches += 1

    # the round's one fetch: the counters and the tree
    out = buf[: base + 4 * M].cpu().numpy()
    ctr = dict(zip(COUNTERS, out[:base].view(np.int64).tolist()))
    if ctr["fault"]:
        raise RuntimeError("me_spr_round: the kernel found the tree broken "
                           "(a child missing from its parent, or no path "
                           "to the root)")
    tree.parent[:] = out[base: base + M]
    tree.children[:] = out[base + M: base + 4 * M].reshape(M, 3)
    nj.debug.profile_ops += ctr["profile_ops"]
    nj.debug.profile_avg_ops += ctr["profile_avg_ops"]
    nj.debug.n_spr += ctr["n_spr"]
    ctr["nodes"] = len(nodes)
    for k in spr_round.totals:
        spr_round.totals[k] += ctr[k]


spr_round.launches = 0
# the kernel's counters summed over its rounds (the work of its launches)
spr_round.totals = dict.fromkeys(COUNTERS[:-1] + ("nodes",), 0)
