"""Process-group lifecycle for data parallelism.

Counterpart of the process half of ``lance_distributed_training_tpu/
parallel/mesh.py`` (``maybe_initialize_distributed``, ``process_topology``,
``sync_global_devices``). JAX makes one global array over every device and
lets XLA insert the collectives; here each process owns one device, the
model is wrapped in DDP and BatchNorm all-reduces its statistics
(``models/resnet.py``). The rendezvous is explicit: a ``tcp://`` address,
the world size and this process's rank, as the JAX CLI's
``--coordinator_address/--num_processes/--process_id`` give them. The
backend is NCCL on CUDA and gloo on the CPU; ranks that share a card run
gloo and stage their CUDA tensors through the host (``parallel/comm.py``
chooses, from the cards the ranks publish in the rendezvous store).

Sequence parallelism lays the ranks out as JAX's ``('data', 'seq')`` mesh
does its devices, data outermost: rank ``data_index * seq + seq_index``
(:func:`seq_topology`, :func:`new_seq_groups`: the seq axis of
:class:`.comm.Topology`, which lays out all four axes).

:func:`make_global_batch` is the synchronous placement primitive (the
``--no_global_batch`` arm and the placement plane's bit-parity reference):
each process places its own share of the global batch on its own device,
so there is no global array to assemble, and a process's batch is its
rows, as the DDP replica reads them.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.token_pack import is_host_meta_key
from .comm import (Topology, choose_transport, device_identity,
                   reset_transport)

__all__ = ["maybe_initialize_distributed", "process_topology",
           "sync_global_devices", "shutdown_distributed", "seq_topology",
           "new_seq_groups", "PinnedStager", "indexed_device",
           "make_global_batch"]


def indexed_device(device) -> torch.device:
    """``device`` with an explicit index: a CUDA device without one names
    the calling thread's current card. A thread that copies for another
    sets this card as its own (a new thread's current card is card 0)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class PinnedStager:
    """Host numpy batch → device tensors through a ring of pinned buffers,
    with ``non_blocking`` copies on the current stream.

    Each slot holds one pinned tensor per key and the CUDA event of the copy
    that last read it; a slot is refilled (by ``Tensor.copy_``, which runs
    without the interpreter lock) only after that event completes, so a copy
    never reads a buffer being overwritten. A leaf that is a page-locked
    page of ``buffer_pool`` is copied straight from its page, which goes
    back to the pool with the batch's event. Keys with the host-meta prefix
    (``_host_*``, e.g. the pack plan's header) stay host numpy, so the
    device-side transforms read them without a sync. A slot's buffer is
    replaced when its leaf's shape or type changes (the ragged pages and
    the packed plan change from batch to batch). :attr:`last_event` is the
    event of the newest batch. One stager serves one thread."""

    depth = 2  # one slot being copied from while the next is filled

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._slots: list[dict] = [{} for _ in range(self.depth)]
        self._events: list[Optional[torch.cuda.Event]] = [None] * self.depth
        self._next = 0
        self.last_event: Optional[torch.cuda.Event] = None

    def __call__(self, batch: dict, buffer_pool=None) -> dict:
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
        slot = self._slots[i]
        out, direct = {}, []
        for name, value in batch.items():
            arr = np.asarray(value)
            if is_host_meta_key(name):
                out[name] = arr
                continue
            if (buffer_pool is not None and buffer_pool.pin_memory
                    and buffer_pool.owns(value)):
                src = torch.from_numpy(value)
                direct.append(value)
            else:
                src = slot.get(name)
                if src is None or tuple(src.shape) != arr.shape or (
                        src.numpy().dtype != arr.dtype):
                    src = torch.from_numpy(np.empty(arr.shape, arr.dtype))
                    src = src.pin_memory()
                    slot[name] = src
                if arr.flags.writeable:
                    src.copy_(torch.from_numpy(arr))
                else:  # a read-only Arrow view (a label column)
                    src.numpy()[...] = arr
            out[name] = src.to(self.device, non_blocking=True)  # ldt: ignore[LDT802] -- the placement plane's own staging copy (data/placement.py drives this stager)
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = self.last_event = event
        for page in direct:
            buffer_pool.release(page, event)
        return out


def make_global_batch(host_batch: dict, device: torch.device, *,
                      stager: Optional[PinnedStager] = None,
                      buffer_pool=None) -> dict:
    """This process's host batch → its tensors on ``device``, the
    synchronous placement primitive. On CUDA through ``stager`` (a
    :class:`PinnedStager`; a one-batch stager when ``None``) on the current
    stream; on the CPU as copies (a tensor handed to the step never aliases
    a page the pool recycles). ``_host_*`` keys stay numpy. The batch's
    ``buffer_pool`` pages go back to the pool: on the CPU at once, on CUDA
    with the copy's event."""
    device = torch.device(device)
    if device.type == "cuda":
        stager = stager if stager is not None else PinnedStager(device)
        out = stager(host_batch, buffer_pool)
    else:
        out = {k: np.asarray(v) if is_host_meta_key(k)
               else torch.from_numpy(np.array(v))
               for k, v in host_batch.items()}
    if buffer_pool is not None:
        # The pages copied on the host; those the stager read in place went
        # back with their event already.
        buffer_pool.release_batch(host_batch)
    return out

_initialized_here = False


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 device: Optional[torch.device] = None
                                 ) -> None:
    """Join the process group at ``coordinator_address`` (``host:port`` or
    ``tcp://host:port``) as rank ``process_id`` of ``num_processes``. A
    no-op without an address, and when a group already exists. On CUDA the
    backend is NCCL unless two ranks would share a card (gloo, staged
    through the host: :func:`.comm.choose_transport`)."""
    global _initialized_here
    if coordinator_address is None or dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id (no launcher injects them)")
    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(":")
    cuda = device is not None and torch.device(device).type == "cuda"
    # The rendezvous store first: each rank publishes the card it will
    # take, and the backend follows from the set (parallel/comm.py).
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=timedelta(seconds=300))
    identities = None
    if cuda:
        store.set(f"ldt/device/{process_id}", device_identity(process_id))
        identities = [store.get(f"ldt/device/{r}").decode()
                      for r in range(num_processes)]
    backend = choose_transport(identities or [], cuda)
    dist.init_process_group(backend=backend, store=store,
                            world_size=num_processes, rank=process_id)
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
    reset_transport()


def seq_topology(rank: int, world: int,
                 seq_parallelism: int) -> tuple[int, int, int]:
    """``(data_index, data_world, seq_index)`` of ``rank`` in a world of
    ``world`` processes laid out as ``(data, seq)``, data outermost
    (:class:`.comm.Topology`, whose errors are the JAX package's
    ``get_mesh``'s)."""
    topo = Topology(rank, world, seq=seq_parallelism, create_groups=False)
    return topo.index["data"], topo.size["data"], topo.index["seq"]


def new_seq_groups(seq_parallelism: int):
    """``(group, ranks)`` of this rank's sequence ring (every rank creates
    every group, :class:`.comm.Topology`)."""
    rank, world = process_topology()
    topo = Topology(rank, world, seq=seq_parallelism)
    return topo.group["seq"], topo.ranks["seq"]
