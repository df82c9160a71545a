"""Data and sequence parallelism: the process group, its topology and the
ring attention that sequence parallelism runs."""

from .mesh import (
    maybe_initialize_distributed,
    new_seq_groups,
    process_topology,
    seq_topology,
    shutdown_distributed,
    sync_global_devices,
)
from .ring_attention import (
    InProcessRing,
    ProcessRing,
    RingAttention,
    make_ring_attention,
    ring_attention,
)

__all__ = ["InProcessRing", "ProcessRing", "RingAttention",
           "make_ring_attention", "maybe_initialize_distributed",
           "new_seq_groups", "process_topology", "ring_attention",
           "seq_topology", "shutdown_distributed", "sync_global_devices"]
