"""Starting the ranks of a multi-GPU run (counterpart of
``veryfasttree_tpu/parallel/multihost.py``).

In the port one process drives one card: a rank of ``torch.distributed``
(a JAX process drives all of its host's devices).  Every rank runs the
identical host orchestration, and the collectives of the mesh's exchanges
are reached by every rank in the same order; only rank 0 writes
user-facing output.

* Across hosts: ``-coordinator host:port -n-hosts K -host-id I`` (or
  VFT_COORDINATOR / VFT_N_HOSTS / VFT_HOST_ID) on each of the K processes,
  one per card; ``init_process_group`` over ``tcp://host:port``.
* On one host: the command line without ``-coordinator`` starts the
  -mesh-sp x -mesh-dp rank processes itself (``cli.launch_local``), each
  on ``cuda:<rank>``, with a local rendezvous.
* The tests and the smoke place ranks on devices themselves
  (``init_ranks``), the CPU's over gloo and two ranks sharing one card
  over gloo too (NCCL takes one rank per card).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import TIMEOUT


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
    is given: this process is rank -host-id of -n-hosts, on `device`.
    Returns True when distributed mode is active (also after an earlier
    call: with -n > 1 the pipeline calls this once per alignment)."""
    if dist.is_initialized():
        return True
    coords = coordinates(options)
    if coords is None:
        return False
    address, n_hosts, host_id = coords
    init_ranks(address, n_hosts, host_id, device)
    return True


def is_primary() -> bool:
    """True on the process that writes user-facing output (rank 0, or the
    only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
