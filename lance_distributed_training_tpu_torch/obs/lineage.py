"""Batch lineage — per-batch latency attribution across process boundaries.

A copy of ``lance_distributed_training_tpu/obs/lineage.py`` for the port.

Every batch is stamped **at creation** (the producer that decoded it) with::

    {"batch_seq": int,     # plan step — monotonic per shard stream
     "created_ns": int,    # wall-clock epoch ns (time.time_ns) at decode end
     "decode_ms": float}   # read+decode duration (monotonic clock)

and, when it crosses the service wire, the sender adds::

    {"queue_wait_ms": float,  # time spent in the per-client bounded queue
     "sent_ns": int}          # wall-clock epoch ns at send

The consumer (``service/client.py`` / ``data/pipeline.py``) closes the loop
with :func:`observe_wire_lineage` / :func:`observe_local_lineage`, producing
``lineage_*`` / ``pipeline_*`` histograms — end-to-end latency attribution
per batch: where inside the pipeline was this batch's life spent?

Clock policy: **durations** are measured on one host with a monotonic clock
(never ``time.time()`` — LDT601); **cross-process ages** necessarily compare
wall clocks (``created_ns``/``sent_ns`` are ``time.time_ns()`` stamps), so
``wire_ms``/``batch_age_ms`` inherit inter-host clock skew — fine on the
loopback/test path, a labelled approximation across real hosts. Negative
skew clamps to 0 rather than corrupting histogram buckets. The in-process
pipeline never crosses hosts, so its age uses a monotonic twin stamp
(``created_mono_ns``, stripped before the wire) — an NTP step between
decode and pickup must not corrupt ``pipeline_batch_age_ms``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

from .registry import MetricsRegistry

__all__ = [
    "make_lineage",
    "observe_wire_lineage",
    "observe_local_lineage",
]


def _as_number(value) -> Optional[float]:
    """Peer-supplied lineage values arrive as arbitrary JSON: a field that
    is not a real number is dropped (None), never raised on — a malformed
    optional-telemetry value must not kill the receive loop."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    value = float(value)
    # json.loads admits NaN/Infinity literals; one would corrupt the
    # histogram's running sum forever.
    return value if math.isfinite(value) else None


def make_lineage(batch_seq: int, decode_ms: float) -> Dict:
    """Stamp a batch at creation (the decode producer calls this)."""
    return {
        "batch_seq": int(batch_seq),
        "created_ns": time.time_ns(),
        # Monotonic twin for same-process consumers: comparable only within
        # this host/boot, so the service sender strips it before encoding.
        "created_mono_ns": time.monotonic_ns(),
        "decode_ms": round(float(decode_ms), 3),
    }


def observe_wire_lineage(
    registry: MetricsRegistry,
    lineage: Optional[Dict],
    recv_ns: Optional[int] = None,
    prefix: str = "lineage",
) -> Optional[Dict]:
    """Close the loop on a batch that crossed the service wire.

    Records ``<prefix>_batch_age_ms`` (creation → here), ``<prefix>_wire_ms``
    (send → here), and passthrough ``<prefix>_queue_wait_ms`` /
    ``<prefix>_decode_ms`` histograms. Returns the computed values (merged
    over the input) for progress lines / tests, or None for a lineage-less
    frame (an old-protocol peer) — absence is interop, not an error.

    "Here" is the receiver thread's pickup, so both ages include time a
    frame sat fully-received in the kernel socket buffer while the receiver
    was blocked handing earlier batches to a slow trainer — a wire_ms spike
    that coincides with ``svc_recv_backpressure_s`` is trainer lag, not
    network. Per-frame kernel receive timestamps would be the only way to
    split those, and are not worth a platform-specific recv path.
    """
    if not lineage:
        return None
    recv_ns = time.time_ns() if recv_ns is None else recv_ns
    out = dict(lineage)
    created = _as_number(lineage.get("created_ns"))
    if created is not None:
        age = max((recv_ns - int(created)) / 1e6, 0.0)
        out["batch_age_ms"] = round(age, 3)
        registry.histogram(f"{prefix}_batch_age_ms").observe(age)
    sent = _as_number(lineage.get("sent_ns"))
    if sent is not None:
        wire = max((recv_ns - int(sent)) / 1e6, 0.0)
        out["wire_ms"] = round(wire, 3)
        registry.histogram(f"{prefix}_wire_ms").observe(wire)
    queue_wait = _as_number(lineage.get("queue_wait_ms"))
    if queue_wait is not None:
        registry.histogram(f"{prefix}_queue_wait_ms").observe(queue_wait)
    decode = _as_number(lineage.get("decode_ms"))
    if decode is not None:
        registry.histogram(f"{prefix}_decode_ms").observe(decode)
    return out


def observe_local_lineage(
    registry: MetricsRegistry,
    lineage: Optional[Dict],
    recv_ns: Optional[int] = None,
    prefix: str = "pipeline",
) -> Optional[Dict]:
    """In-process flavour: producer and consumer share this process, so the
    age compares the monotonic twin stamp (``created_mono_ns``) — an NTP
    step between decode and pickup would corrupt a wall-clock same-host
    duration. Records ``<prefix>_batch_age_ms`` (decode end → consumer
    pickup ≈ prefetch-queue dwell) and ``<prefix>_decode_ms``. ``recv_ns``
    (tests) is a ``monotonic_ns`` instant here, unlike the wire flavour's
    wall-clock one."""
    if not lineage:
        return None
    mono = lineage.get("created_mono_ns")
    if mono is None:
        # Stamped by a producer predating the monotonic twin: wall-clock
        # attribution is the only option left. Delegate only when we'd take
        # our own "now" — a caller-supplied recv_ns here is a monotonic_ns
        # instant, which the wire flavour would misread as wall-clock.
        if recv_ns is not None:
            return None
        return observe_wire_lineage(registry, lineage, prefix=prefix)
    now = time.monotonic_ns() if recv_ns is None else recv_ns
    out = dict(lineage)
    age = max((now - int(mono)) / 1e6, 0.0)
    out["batch_age_ms"] = round(age, 3)
    registry.histogram(f"{prefix}_batch_age_ms").observe(age)
    decode = lineage.get("decode_ms")
    if decode is not None:
        registry.histogram(f"{prefix}_decode_ms").observe(float(decode))
    return out
