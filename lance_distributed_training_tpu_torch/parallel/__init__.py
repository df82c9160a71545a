"""Parallelism: the process group, the four-axis topology and the
transport of its collectives (``comm``), the layout plan (``sharding``)
and its application (``layout``), the GPipe pipeline
(``pipeline_parallel``), the synchronous placement primitive and the ring
attention that sequence parallelism runs."""

from .mesh import (
    PinnedStager,
    make_global_batch,
    maybe_initialize_distributed,
    new_seq_groups,
    process_topology,
    seq_topology,
    shutdown_distributed,
    sync_global_devices,
)
from .comm import Topology, mesh_shape
from .layout import ShardedState, shard_model_
from .pipeline_parallel import pipeline_apply, stack_stage_params
from .ring_attention import (
    InProcessRing,
    ProcessRing,
    RingAttention,
    make_ring_attention,
    ring_attention,
)

__all__ = ["InProcessRing", "PinnedStager", "ProcessRing", "RingAttention",
           "ShardedState", "Topology", "mesh_shape", "pipeline_apply",
           "shard_model_", "stack_stage_params",
           "make_global_batch", "make_ring_attention",
           "maybe_initialize_distributed",
           "new_seq_groups", "process_topology", "ring_attention",
           "seq_topology", "shutdown_distributed", "sync_global_devices"]
