"""Process-group lifecycle for data parallelism.

Counterpart of the process half of ``lance_distributed_training_tpu/
parallel/mesh.py`` (``maybe_initialize_distributed``, ``process_topology``,
``sync_global_devices``). JAX makes one global array over every device and
lets XLA insert the collectives; here each process owns one device, the
model is wrapped in DDP and BatchNorm all-reduces its statistics
(``models/resnet.py``). The rendezvous is explicit: a ``tcp://`` address,
the world size and this process's rank, as the JAX CLI's
``--coordinator_address/--num_processes/--process_id`` give them. The
backend is NCCL on CUDA and gloo on the CPU.

Sequence parallelism lays the ranks out as JAX's ``('data', 'seq')`` mesh
does its devices, data outermost: rank ``data_index * seq + seq_index``
(:func:`seq_topology`); :func:`new_seq_groups` creates one process group
per data index for its ring.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "process_topology",
           "sync_global_devices", "shutdown_distributed", "seq_topology",
           "new_seq_groups"]

_initialized_here = False


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device: Optional[torch.device] = None
                                 ) -> None:
    """Join the process group at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``) as rank ``process_id`` of ``num_processes``. A
    no-op without an address, and when a group already exists."""
    global _initialized_here
    if coordinator_address is None or dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id (no launcher injects them)")
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    cuda = device is not None and torch.device(device).type == "cuda"
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method=address, world_size=num_processes,
                            rank=process_id)
    _initialized_here = True


def process_topology() -> tuple[int, int]:
    """``(process_index, process_count)``: the rank and world size, or
    ``(0, 1)`` outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sync_global_devices() -> None:
    """Barrier across processes (``dist.barrier``); a no-op alone."""
    if process_topology()[1] > 1:
        dist.barrier()


def shutdown_distributed() -> None:
    """Leave the process group if :func:`maybe_initialize_distributed`
    created it."""
    global _initialized_here
    if _initialized_here and dist.is_initialized():
        dist.destroy_process_group()
    _initialized_here = False


def seq_topology(rank: int, world: int,
                 seq_parallelism: int) -> tuple[int, int, int]:
    """``(data_index, data_world, seq_index)`` of ``rank`` in a world of
    ``world`` processes laid out as ``(data, seq)``, data outermost. Raises
    as the JAX package's ``get_mesh`` does when the world does not divide."""
    if seq_parallelism < 1:
        raise ValueError(f"parallelism degrees must be >=1, got "
                         f"sp={seq_parallelism}")
    if world % seq_parallelism:
        raise ValueError(f"{world} devices not divisible by "
                         f"model*seq*pipe parallelism={seq_parallelism}")
    return (rank // seq_parallelism, world // seq_parallelism,
            rank % seq_parallelism)


def new_seq_groups(seq_parallelism: int):
    """``(group, ranks)`` of this rank's sequence ring. Every rank creates
    every ring's group, in data-index order, as ``new_group`` requires."""
    rank, world = process_topology()
    data_index = seq_topology(rank, world, seq_parallelism)[0]
    mine = None
    for index in range(world // seq_parallelism):
        ranks = list(range(index * seq_parallelism,
                           (index + 1) * seq_parallelism))
        group = dist.new_group(ranks)
        if index == data_index:
            mine = (group, ranks)
    return mine
