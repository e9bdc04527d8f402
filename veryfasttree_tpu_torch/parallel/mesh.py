"""The grid of ranks of a multi-GPU run (counterpart of
``veryfasttree_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` of shape (dp, sp) and
lets GSPMD add the collectives.  Here one process drives one card, a rank
of ``torch.distributed``; rank r sits at (r // sp, r % sp) of the dp x sp
grid, and each row of the grid (the ranks of one dp index) is a process
group along ``sp``, each column one along ``dp``.

* ``sp``, the alignment-position axis: each rank of a row holds a
  contiguous block of the positions (``block``).  Work local to a position
  (averages, the out-profile, leaf expansion, the bootstrap's pieces) needs
  no communication; a sum over positions (a profile distance's top and
  denominator, a seed wave's products, the bootstrap's resampled sums) is a
  float64 partial over the rank's block, an exchange (``exchange``: every
  rank ends with every rank's partial, in rank order), their sum in rank
  order and the same finish on every rank.
* ``dp``, the candidate-row axis: ``sharded.py`` splits rows over it; the
  pipeline's store is replicated along it (its row split is later work).

Every rank runs the identical host orchestration, so every branch reads
values that are the same on every rank: the exchanged partials are added
in one order on every rank, which gives every rank the same bits.
"""
from __future__ import annotations

import time
from datetime import timedelta

import torch
import torch.distributed as dist

# the positions of a rank's block are a multiple of this (the code scan's
# 16-code loads, csrc/nj_scan.cuh)
BLOCK_ALIGN = 16
# a process group's collectives fail after this long instead of hanging
# on a rank that stopped
TIMEOUT = timedelta(seconds=300)


def block_width(p_pad: int, n_sp: int) -> int:
    """The positions of each rank's block of a store p_pad wide over n_sp
    ranks: p_pad / n_sp rounded up to BLOCK_ALIGN (the same on every
    rank)."""
    return -(-(-(-p_pad // n_sp)) // BLOCK_ALIGN) * BLOCK_ALIGN


class Mesh:
    """A dp x sp grid of torch.distributed ranks (make_mesh builds one).

    ``stats`` counts the exchanges: calls, the bytes each rank receives,
    and the host-clock seconds spent in them (with NCCL the launch of the
    collective; gloo's return when the parts have arrived)."""

    def __init__(self, n_dp: int, n_sp: int, rank: int, sp_group, dp_group,
                 backend: str | None = None):
        self.dp, self.sp = n_dp, n_sp
        self.rank = rank
        self.dp_index, self.sp_index = divmod(rank, n_sp)
        self.sp_group, self.dp_group = sp_group, dp_group
        self.backend = backend
        self.stats = {"calls": 0, "bytes": 0, "s": 0.0}

    def block(self, n_pos: int, align: int, index: int | None = None):
        """(lo, width, n_valid) of the block of sp index `index` (the
        rank's own by default) of an alignment of n_pos positions padded to
        `align` (the store's p_pad): positions [lo, lo + n_valid) of the
        alignment, padded to `width` (p_pad / sp, rounded up to
        BLOCK_ALIGN); the same width on every rank."""
        s = self.sp_index if index is None else index
        p_pad = -(-n_pos // align) * align
        width = block_width(p_pad, self.sp)
        lo = s * width
        return lo, width, max(0, min(width, n_pos - lo))

    def _axis(self, axis):
        """(k, this rank's index, the group, the global ranks in order)."""
        if axis == "sp":
            d = self.dp_index
            return self.sp, self.sp_index, self.sp_group, \
                [d * self.sp + s for s in range(self.sp)]
        if axis == "dp":
            s = self.sp_index
            return self.dp, self.dp_index, self.dp_group, \
                [d * self.sp + s for d in range(self.dp)]
        raise ValueError(f"mesh axis {axis!r}: 'sp' or 'dp'")

    def exchange(self, part: torch.Tensor, axis: str = "sp") -> torch.Tensor:
        """Every rank's `part` along `axis`, stacked in rank order:
        [k, *part.shape], the same bits on every rank of the group (copies,
        no arithmetic).  NCCL: one all_gather_into_tensor on the card.
        gloo (the CPU, or ranks sharing one card): the parts go rank to
        rank through host memory by isend/irecv, at a fifth of gloo's
        all_reduce latency (0.5-0.7 ms against 2.5 ms a call between two
        processes of one host), and gloo's send takes no CUDA tensor."""
        k, idx, group, ranks = self._axis(axis)
        t0 = time.perf_counter()
        if k == 1:
            out = part[None]
        elif part.numel() == 0:     # the same empty shape on every rank
            out = part.new_zeros((k, *part.shape))
        elif self.backend == "nccl":
            out = part.new_empty(k * part.numel())
            dist.all_gather_into_tensor(out, part.reshape(-1).contiguous(),
                                        group=group)
            out = out.view(k, *part.shape)
        else:
            mine = part.detach().to("cpu").contiguous()
            got = [mine if r == idx else torch.empty_like(mine)
                   for r in range(k)]
            reqs = []
            for r in range(k):
                if r != idx:
                    reqs.append(dist.isend(mine, ranks[r], group=group))
                    reqs.append(dist.irecv(got[r], ranks[r], group=group))
            for q in reqs:
                q.wait()
            out = torch.stack(got).to(part.device)
        self.stats["calls"] += 1
        self.stats["bytes"] += (k - 1) * part.numel() * part.element_size()
        self.stats["s"] += time.perf_counter() - t0
        return out

    def exchange_sum(self, part: torch.Tensor, axis: str = "sp"):
        """The sum of every rank's `part` along `axis`, added in rank
        order: the same bits on every rank."""
        parts = self.exchange(part, axis)
        total = parts[0]
        for r in range(1, parts.shape[0]):
            total = total + parts[r]
        return total

    def gather_positions(self, local: torch.Tensor, n_pos: int,
                         align: int) -> torch.Tensor:
        """The alignment's [..., n_pos] from each rank's [..., n_valid]
        values at its own block's positions (every rank along sp)."""
        _, width, n_valid = self.block(n_pos, align)
        if local.shape[-1] != n_valid:
            raise ValueError(f"gather_positions: {local.shape[-1]} values, "
                             f"the block holds {n_valid}")
        padded = torch.zeros((*local.shape[:-1], width), dtype=local.dtype,
                             device=local.device)
        padded[..., :n_valid] = local
        buf = self.exchange(padded)
        return torch.cat([buf[s, ..., :self.block(n_pos, align, s)[2]]
                          for s in range(self.sp)], -1)


def make_mesh(n_sp: int | None = None, n_dp: int = 1) -> Mesh:
    """The dp x sp mesh of the initialized process group (every rank calls
    it, in the same order as every other collective).  n_sp defaults to
    world // n_dp; a grid that does not cover the world exactly raises:
    a run never carries on with fewer ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "process group (parallel.multihost.init_ranks)")
    world = dist.get_world_size()
    n_dp = n_dp or 1
    if n_sp is None:
        n_sp = max(1, world // n_dp)
    if n_sp < 1 or n_dp < 1 or n_sp * n_dp != world:
        raise ValueError(f"mesh {n_dp}x{n_sp} needs {n_sp * n_dp} ranks, the "
                         f"world has {world}")
    rank = dist.get_rank()
    sp_group = dp_group = None
    # every rank creates every group, in one order
    for d in range(n_dp):
        g = dist.new_group([d * n_sp + s for s in range(n_sp)],
                           timeout=TIMEOUT)
        if rank // n_sp == d:
            sp_group = g
    for s in range(n_sp):
        g = dist.new_group([d * n_sp + s for d in range(n_dp)],
                           timeout=TIMEOUT)
        if rank % n_sp == s:
            dp_group = g
    return Mesh(n_dp, n_sp, rank, sp_group, dp_group, dist.get_backend())


def mesh_from_options(options) -> Mesh | None:
    """The mesh -mesh-sp / -mesh-dp ask for, or None for a single-card run
    (neither flag given, or a 1 x 1 grid).  -mesh-sp defaults to the
    world's ranks over -mesh-dp."""
    sp = getattr(options, "mesh_sp", None)
    dp = getattr(options, "mesh_dp", 1) or 1
    if sp is None and dp <= 1:
        return None
    if sp is not None and sp * dp <= 1:
        return None
    return make_mesh(n_sp=sp, n_dp=dp)


def requested_ranks(options, n_devices: int) -> int:
    """The ranks the mesh flags ask for (1 without them): -mesh-sp times
    -mesh-dp, -mesh-sp defaulting to n_devices // -mesh-dp."""
    sp = getattr(options, "mesh_sp", None)
    dp = getattr(options, "mesh_dp", 1) or 1
    if sp is None and dp <= 1:
        return 1
    if sp is None:
        sp = max(1, n_devices // dp)
    return sp * dp
