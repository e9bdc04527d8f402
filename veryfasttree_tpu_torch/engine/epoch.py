"""The NJ join phase as device launches (counterpart of
``veryfasttree_tpu/engine/epoch.py``).

The host join loop (``NeighbourJoining._join_loop_host``) makes a store
call and a blocking fetch for every step of every join: the top-visible
search, the hill-climb, the join, the top-hits merge and refresh.  The JAX
package runs the whole loop on its device in one ``lax.while_loop`` per
segment; here the kernel of ``csrc/nj_epoch.cu`` runs the joins from one
out-profile reset to the next in one launch (``ops/epoch_kernels.py``), and
the host recomputes the out-profile between launches exactly as the host
loop does.

Under -constraints the launches are the constrained kernel's
(``csrc/nj_epoch_cons.cu``): every distance a decision takes carries the
pair's join penalty, and each join writes its new node's counts.

A store on the CPU runs the host loop itself: it is the kernel's plain twin.
"""
from __future__ import annotations


def epoch_supported(nj, tophits) -> bool:
    """The modes the epoch runs: top-hits on and none of -slow, -fastest or
    -2nd (the JAX package's rule, veryfasttree_tpu/engine/epoch.py:1042),
    on one card (under a mesh every distance needs the ranks' exchange,
    which the kernel has not).  Every other mode keeps the host loop."""
    opts = nj.options
    return (tophits is not None and not opts.slow
            and not opts.fastest and not opts.use_tophits_2nd
            and tophits.q == 0 and opts.mesh is None)


def reset_plan(n_seqs: int, options, max_joins=None) -> list:
    """The n_active of every join whose out-profile step is a full
    recompute (ref tcc:3012-3037), in join order, among the joins fast_nj
    runs (at most max_joins).  Only n_active and the options decide it, so
    each such join ends a launch."""
    base = n_seqs
    out = []
    for n_active in range(n_seqs, 3, -1):
        if max_joins is not None and n_seqs - n_active >= max_joins:
            break
        changed = base - (n_active - 1)
        if (changed >= options.n_reset_out_profile
                and changed >= options.f_reset_out_profile * base):
            out.append(n_active)
            base = n_active - 1
    return out


def run_epoch(nj, tophits, max_joins=None, **launch) -> None:
    """The join phase from the leaf top-hits to three active nodes (or
    max_joins joins): launches of the epoch kernel for a store on a CUDA
    device, the host loop for a store on the CPU.  Leaves nj and tophits as
    the host loop would.  launch: grid, state_in_smem and lists_in_smem of
    ops/epoch_kernels.join_epoch."""
    from ..ops import epoch_kernels
    epoch_kernels.join_epoch(nj, tophits, max_joins, **launch)
