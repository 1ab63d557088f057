"""Multi-process initialization (port of ``neurec_tpu/parallel/distributed.py``).

One process per rank. ``initialize_multihost`` joins (or starts) the
``torch.distributed`` group that ``parallel.mesh.make_mesh`` lays its
('data', 'model') mesh over; after it, every rank runs the same program
on the full host value and takes its own slice (``parallel/mesh.py``).

The backend is NCCL where each rank of the host has a card of its own,
gloo otherwise: on the CPU, and where ranks share one card (NCCL refuses
two ranks on one device). Under gloo the collectives of ``parallel/mesh.py``
stage CUDA tensors through the host on every call.

Nothing on a machine announces a cluster to these functions: the caller
(or ``torchrun``'s ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``) gives the address, the world size and
the rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# how long a rank waits on its peers, in a collective or at the rendezvous
DEFAULT_TIMEOUT_S = 300


def default_backend(local_world: Optional[int] = None) -> str:
    """``nccl`` when CUDA is up and every rank of this host can have a card
    of its own (``local_world`` ranks, ``LOCAL_WORLD_SIZE`` when None, else
    one), ``gloo`` otherwise."""
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the process group; returns ``(rank, world)``.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there); with
    no arguments the address, world size and rank come from ``torchrun``'s
    environment, and where that is absent too the process is a world of
    one and no group is made. A no-op when a group is already up, as
    ``jax.distributed.initialize`` is. ``backend`` None: ``default_backend``.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "%s:%s" % (os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT", "29500"))
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError("a world of %d processes needs a coordinator address" % num_processes)
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs the world size and this process's rank")
    dist.init_process_group(
        backend=backend or default_backend(),
        init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    """True on rank 0, and in a process that joined no group."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
