"""Starting the ranks of a multi-GPU run (counterpart of
``veryfasttree_tpu/parallel/multihost.py``).

In the port one process drives one card: a rank of ``torch.distributed``
(a JAX process drives all of its host's devices).  Every rank runs the
identical host orchestration, and the collectives of the mesh's exchanges
are reached by every rank in the same order; only rank 0 writes
user-facing output.

* Across hosts: ``-coordinator host:port -n-hosts K -host-id I`` (or
  VFT_COORDINATOR / VFT_N_HOSTS / VFT_HOST_ID) counts hosts, as the JAX
  package's does: the command on host I starts one rank for each card
  that ``CUDA_VISIBLE_DEVICES`` leaves it (``cli.launch_ranks``), global
  rank I x cards + local rank, on ``cuda:<local rank>``; a default
  -mesh-sp spans every rank of every host over -mesh-dp (``rank_plan``).
  On the CPU a process is one rank, as a JAX CPU process has one device.
  ``init_process_group`` over ``tcp://host:port``.
* On one host: the command line without ``-coordinator`` starts the
  -mesh-sp x -mesh-dp rank processes itself (``cli.launch_ranks``), each
  on ``cuda:<rank>``, with a local rendezvous.
* A rank process that a launcher started reads its place from
  VFT_RANK, VFT_WORLD and VFT_LOCAL_RANK (``child_rank``).
* The tests and the smoke place ranks on devices themselves
  (``init_ranks``), the CPU's over gloo and two ranks sharing one card
  over gloo too (NCCL takes one rank per card).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import TIMEOUT


@dataclass(frozen=True)
class RankPlan:
    """The ranks of a multi-host run: `world` ranks in all; this host's
    global `ranks`, on its cards `devices` (local indices, in the same
    order); the mesh (dp, sp), or None for a single-card run on every
    rank."""

    world: int
    ranks: tuple
    devices: tuple
    mesh: tuple | None


def rank_plan(n_hosts: int, host_id: int, cards: int, mesh_sp=None,
              mesh_dp=1) -> RankPlan:
    """The plan of ``-coordinator -n-hosts K -host-id I`` on a host of
    `cards` cards (1 for a CPU process): K hosts of `cards` ranks each,
    global rank I x cards + local rank l, rank l on card l; the mesh
    -mesh-dp x -mesh-sp, -mesh-sp defaulting to every rank over -mesh-dp,
    and no mesh without either flag (each rank then runs the whole tree on
    its card, as each JAX process runs on one device).  A mesh that does
    not cover the world exactly raises ValueError."""
    if n_hosts < 1 or not 0 <= host_id < n_hosts or cards < 1:
        raise ValueError(f"-n-hosts {n_hosts} -host-id {host_id} on a host "
                         f"of {cards} card(s): need K >= 1, I in [0, K) and "
                         "a card")
    world = n_hosts * cards
    dp = mesh_dp or 1
    mesh = None
    if mesh_sp is not None or dp > 1:
        sp = mesh_sp if mesh_sp is not None else world // dp
        if sp < 1 or sp * dp != world:
            raise ValueError(f"the mesh {dp} x {sp} needs {max(sp, 0) * dp} "
                             f"ranks, and {n_hosts} host(s) of {cards} "
                             f"card(s) make {world}")
        mesh = (dp, sp)
    first = host_id * cards
    return RankPlan(world, tuple(range(first, first + cards)),
                    tuple(range(cards)), mesh)


def host_cards(device) -> int:
    """The ranks this process's host starts: every visible card for an
    unnumbered CUDA device, else 1 (a CPU process, or a card named by
    the caller)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return 1
    return max(torch.cuda.device_count(), 1)


def child_rank():
    """(address, rank, world, local rank) of a rank process that a
    launcher started (VFT_COORDINATOR, VFT_RANK, VFT_WORLD,
    VFT_LOCAL_RANK), or None."""
    if "VFT_RANK" not in os.environ:
        return None
    return (os.environ["VFT_COORDINATOR"], int(os.environ["VFT_RANK"]),
            int(os.environ["VFT_WORLD"]),
            int(os.environ.get("VFT_LOCAL_RANK", "0")))


def init_ranks(address: str, world_size: int, rank: int, device,
               backend: str | None = None) -> None:
    """Join rank `rank` of `world_size` at tcp://address: NCCL for a CUDA
    device, gloo for the CPU (or as `backend` says), every collective
    failing after mesh.TIMEOUT.  A second call does nothing."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def coordinates(options):
    """(address, n_hosts, host_id) of -coordinator, -n-hosts, -host-id (or
    the VFT_COORDINATOR, VFT_N_HOSTS, VFT_HOST_ID variables), or None
    without a coordinator."""
    coord = getattr(options, "coordinator", "") \
        or os.environ.get("VFT_COORDINATOR", "")
    if not coord:
        return None
    n_hosts = int(getattr(options, "n_hosts", 0)
                  or os.environ.get("VFT_N_HOSTS", "0"))
    host_id = getattr(options, "host_id", None)
    if host_id is None:
        host_id = int(os.environ.get("VFT_HOST_ID", "0"))
    if n_hosts < 1 or not 0 <= host_id < n_hosts:
        raise ValueError(f"-coordinator {coord} needs -n-hosts K >= 1 and "
                         f"-host-id in [0, K), got {n_hosts} and {host_id}")
    return coord, n_hosts, host_id


def maybe_init_distributed(options, device) -> bool:
    """Join the run's process group when -coordinator (or VFT_COORDINATOR)
    is given: a launcher's rank process at its place (child_rank), or a
    host of one rank (rank_plan: a CPU process, or a named card) as rank
    -host-id of -n-hosts, on `device`.  A host of several cards starts its
    ranks from the command line (cli.main), so here it raises.  Returns
    True when distributed mode is active (also after an earlier call: with
    -n > 1 the pipeline calls this once per alignment)."""
    if dist.is_initialized():
        return True
    child = child_rank()
    if child is not None:
        address, rank, world, _ = child
        init_ranks(address, world, rank, device)
        return True
    coords = coordinates(options)
    if coords is None:
        return False
    address, n_hosts, host_id = coords
    plan = rank_plan(n_hosts, host_id, host_cards(device),
                     getattr(options, "mesh_sp", None),
                     getattr(options, "mesh_dp", 1))
    if len(plan.ranks) > 1:
        raise RuntimeError(f"-coordinator on a host of {len(plan.ranks)} "
                           "cards starts one rank a card from the command "
                           "line (python -m veryfasttree_tpu_torch)")
    init_ranks(address, plan.world, plan.ranks[0], device)
    return True


def is_primary() -> bool:
    """True on the process that writes user-facing output (rank 0, or the
    only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
