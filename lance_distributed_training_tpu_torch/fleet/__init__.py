"""Elastic data-plane fleet — N data servers behind one coordinator.

A copy of ``lance_distributed_training_tpu/fleet/__init__.py`` for the
port.

One :class:`~..service.server.DataService` is both a decode-throughput
ceiling and a single point of failure. This package turns the single-server
plane into a *fleet* (the tf.data-service dispatcher/worker shape,
PAPERS.md):

* :mod:`.coordinator` — :class:`Coordinator`: the control plane. Tracks
  data-server membership (registration + heartbeats) and hands out
  generation-numbered **shard leases** — each live member owns a disjoint
  slice of the global fragment space, recomputed on every join / leave /
  heartbeat expiry.
* :mod:`.agent` — :class:`FleetAgent`: the server-side half. Registers a
  ``DataService`` on start, heartbeats on a daemon thread, surfaces lease
  changes back to the service (which re-plans), deregisters on stop.
* :mod:`.balancer` — :class:`FleetLoader`: the client. Discovers endpoints
  from the coordinator, stripes its shard's plan across live servers
  (protocol-v3 ``stripe_index/stripe_count`` HELLOs), and on server loss
  re-resolves membership and re-stripes from the exact resume cursor —
  preserving the no-loss / no-duplication batch-sequence contract
  ``RemoteLoader`` guarantees against one server.
* :mod:`.chaos` — deterministic fault injection (scripted kill / stall /
  partition of member servers) so failover is *tested*, not asserted.
* :mod:`.jobs` — the multi-tenant job plane (protocol v6):
  :class:`JobPlane` on each server (per-job admission, weighted-fair
  stride scheduling of produce capacity, per-job counters/cursors/SLO
  burn) and :class:`JobRegistry` on the coordinator (fleet-wide per-job
  rows aggregated from member heartbeats — ``ldt jobs``).

Everything rides the existing length-prefixed frame protocol
(:mod:`..service.protocol`); fleet metrics (``fleet_members``,
``fleet_lease_generation``, ``fleet_failovers_total``,
``fleet_rebalance_ms``) land on the same ``/metrics`` + ``/healthz``
surfaces as the rest of the stack. See README "Fleet".
"""

from .balancer import FleetLoader  # noqa: F401
from .coordinator import Coordinator, CoordinatorConfig, serve_coordinator  # noqa: F401
from .jobs import (  # noqa: F401
    AdmissionRefused,
    FairScheduler,
    JobPlane,
    JobRegistry,
    PriorityClass,
    PRIORITY_CLASSES,
)

__all__ = [
    "AdmissionRefused",
    "Coordinator",
    "CoordinatorConfig",
    "FairScheduler",
    "FleetLoader",
    "JobPlane",
    "JobRegistry",
    "PriorityClass",
    "PRIORITY_CLASSES",
    "serve_coordinator",
]
