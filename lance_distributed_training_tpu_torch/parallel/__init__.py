"""Data parallelism: the process group and its topology."""

from .mesh import (
    maybe_initialize_distributed,
    process_topology,
    shutdown_distributed,
    sync_global_devices,
)

__all__ = ["maybe_initialize_distributed", "process_topology",
           "shutdown_distributed", "sync_global_devices"]
