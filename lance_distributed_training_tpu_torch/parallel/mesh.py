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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "process_topology",
           "sync_global_devices", "shutdown_distributed"]

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
