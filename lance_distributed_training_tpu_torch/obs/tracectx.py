"""Cross-process trace context — the causal thread a batch carries.

A copy of ``lance_distributed_training_tpu/obs/tracectx.py`` for the port.

A trace context is a tiny JSON-safe dict, W3C-trace-context shaped::

    {"trace_id": "32 hex chars",        # one per batch, born at decode
     "span_id": "16 hex chars",         # the stamping process's segment
     "parent_span_id": "16 hex chars"}  # absent on the root segment

It is stamped ONCE per plan item at decode (``DataService._produce`` /
the in-process pipeline's decode seam) and then *propagated*: the sender
ships it in the versioned batch meta next to lineage (protocol v5,
optional field — old peers interop exactly like the v1/v2 lineage
negotiation), and every receiving hop derives a :func:`child` context
whose ``parent_span_id`` is the remote segment's ``span_id``. Each hop
also attaches the context to its local :mod:`.spans` span as
``trace_id`` / ``trace_span`` / ``trace_parent`` attrs, which is what
lets ``ldt trace export`` stitch per-process JSONLs into ONE Perfetto
trace with real parent edges across decode → queue → wire → merge →
placement → step, and what ``ldt trace critical-path`` joins on.

Ids come from ``os.urandom`` — pure entropy, never a seeded RNG (the
deterministic-stream RNGs are content-bearing; trace ids must never be,
and LDT1301 would flag a seeded generator reaching the wire meta). A
trace context is telemetry: it rides the meta, it never influences plan,
batch bytes, or cursor state.

Like lineage, a context that arrives off the wire is arbitrary peer
JSON: :func:`coerce_trace` validates shape and bounds and returns
``None`` for anything malformed — a corrupt optional-telemetry field
must never kill a receive loop.
"""

from __future__ import annotations

import binascii
import os
from typing import Dict, Optional

__all__ = [
    "make_trace",
    "child",
    "coerce_trace",
    "new_trace_id",
    "new_span_id",
]

# Hex-string lengths (W3C trace-context sizes: 16-byte trace id,
# 8-byte span id).
_TRACE_ID_LEN = 32
_SPAN_ID_LEN = 16


def new_trace_id() -> str:
    """32 hex chars of pure entropy — one per batch lifetime."""
    return binascii.hexlify(os.urandom(_TRACE_ID_LEN // 2)).decode("ascii")


def new_span_id() -> str:
    """16 hex chars of pure entropy — one per process-local segment."""
    return binascii.hexlify(os.urandom(_SPAN_ID_LEN // 2)).decode("ascii")


def make_trace() -> Dict[str, str]:
    """Root context, stamped at plan-item decode (the batch's birth)."""
    return {"trace_id": new_trace_id(), "span_id": new_span_id()}


def child(trace: Dict[str, str]) -> Dict[str, str]:
    """The next hop's context: same trace, fresh segment id, parent
    edge back to the hop that handed us the batch."""
    return {
        "trace_id": trace["trace_id"],
        "span_id": new_span_id(),
        "parent_span_id": trace["span_id"],
    }


def _hex_id(value, max_len: int) -> Optional[str]:
    """A peer-supplied id: a lowercase-hex string of sane length, or
    None. Bounds first — a multi-MB "id" must not survive into span
    attrs and trace files."""
    if not isinstance(value, str) or not 1 <= len(value) <= max_len:
        return None
    try:
        int(value, 16)
    except ValueError:
        return None
    return value.lower()


def coerce_trace(obj) -> Optional[Dict[str, str]]:
    """Validate a wire-supplied trace context (arbitrary peer JSON) into
    a well-formed one, or ``None``. Mirrors lineage's ``_as_number``
    posture: malformed optional telemetry is dropped, never raised on —
    and absence is interop (an old-protocol peer), not an error."""
    if not isinstance(obj, dict):
        return None
    trace_id = _hex_id(obj.get("trace_id"), _TRACE_ID_LEN)
    span_id = _hex_id(obj.get("span_id"), _SPAN_ID_LEN)
    if trace_id is None or span_id is None:
        return None
    out = {"trace_id": trace_id, "span_id": span_id}
    parent = _hex_id(obj.get("parent_span_id"), _SPAN_ID_LEN)
    if parent is not None:
        out["parent_span_id"] = parent
    return out
