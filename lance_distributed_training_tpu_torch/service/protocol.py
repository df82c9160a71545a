"""Wire protocol for the disaggregated input-data service.

A copy of ``lance_distributed_training_tpu/service/protocol.py`` for the
port: the same bytes on the wire, so either package's loaders read either
package's servers. ``decode_batch(pool=...)`` copies into leases of the
port's :class:`~..data.buffers.BufferPool`; a ragged pair comes out as the
port's ragged page pair, the layout K3 takes.

Framing is deliberately dumb: every message is one length-prefixed frame

    u32 big-endian payload length | u8 message type | payload

so both ends can parse with two exact reads and no streaming parser state.
Control payloads (handshake, acks, errors) are small JSON dicts — never
pickle: a service port reachable by untrusted peers must not hand
``pickle.loads`` attacker bytes (arbitrary code execution via
``__reduce__``), and the control schema is plain strings/ints anyway.

Batch payloads keep the bulk data raw: a batch frame is

    u32 meta length | JSON meta {step, tensors: [[name, dtype, shape], ...]}
    | tensor 0 raw bytes | tensor 1 raw bytes | ...

with each tensor C-contiguous, so the receive path is one big
``recvmsg``-style copy per tensor straight into a numpy buffer — the
device-ready host batch the trainer feeds to ``make_global_batch`` without
another conversion (the same ``dict[str, np.ndarray]`` contract
``decode_fn`` produces for the in-process ``DataPipeline``).

The handshake is versioned: a client opens with HELLO carrying
``PROTOCOL_VERSION``; the server answers HELLO_OK (echoing its version and
the plan's step count) or ERROR — an unsupported version skew fails loudly
at connect time, never as a mid-epoch deserialisation crash. Versions are a
compatibility *range*: each side accepts peers within
[``MIN_PROTOCOL_VERSION``, ``PROTOCOL_VERSION``] and speaks the features of
``min(mine, peer)``, so a v1 peer on either end of a v2 process still
interops.

Version 2 adds the optional **lineage** field to the batch meta (an extra
JSON key — ``{batch_seq, created_ns, decode_ms, queue_wait_ms, sent_ns}``,
see :mod:`..obs.lineage`). Backward compatible by construction: a v1
decoder ignores unknown meta keys, and a v2 server simply omits the field
for v1 clients; ``decode_batch(..., with_lineage=True)`` returns ``None``
for its absence.

Version 3 adds **step striping** to the HELLO (``stripe_index`` /
``stripe_count``): the server serves only the plan steps ``s >= start_step``
with ``s % stripe_count == stripe_index``, still in increasing order — the
primitive the fleet client (:mod:`..fleet.balancer`) uses to spread one
shard's plan across N data servers and re-stripe it on failover. Striping is
NOT downgrade-safe (a v2 server would ignore the unknown keys and serve
every step — silent duplication across the fleet), so a striping client must
require the negotiated version to be >= ``STRIPE_MIN_VERSION`` instead of
downgrade-retrying. Version 3 also carries the **fleet control plane**
message types (register / heartbeat / deregister / resolve) spoken between
data servers, the coordinator, and fleet clients — same framing, small JSON
control payloads, one request/reply per connection.

Version 4 adds the **ragged token plane** (``data/token_pack.py``): the
HELLO's ``token_pack`` boolean requests variable-length token batches, and
a ragged MSG_BATCH's meta carries the ``ragged`` field — ``{column_base:
values_capacity_bucket}`` naming which tensors are flat (bucket-padded)
token pages rather than row tensors, so the receiver can validate the
values/offsets view pair against the declared capacity bucket. Packing is
NOT downgrade-safe (a v3 server would ignore ``token_pack`` and stream
padded rows while the client believes it negotiated packing), so a packing
client must require the negotiated version >= ``TOKEN_PACK_MIN_VERSION``
instead of downgrade-retrying; a v3 (or non-packing v4) peer negotiates
packing OFF and receives the exact bit-identical padded stream the
pre-r15 protocol carried.

Version 5 adds the optional **trace** field to the batch meta (a W3C-style
cross-process trace context — ``{trace_id, span_id}``, see
:mod:`..obs.tracectx`) and the optional **queue_wait_hist** field to fleet
heartbeats (mergeable histogram bucket counts the coordinator aggregates
into fleet-wide queue-wait percentiles). Both are backward compatible
exactly like the v1/v2 lineage negotiation: the sender gates the trace
field on the negotiated version (``TRACE_MIN_VERSION``) so pre-v5 peers
receive byte-identical frames, an old decoder ignores the unknown meta
key, and an old coordinator ignores the unknown heartbeat key — absence
of either field is interop, never an error.

Version 6 adds the **job plane** (:mod:`..fleet.jobs`): the HELLO's
optional ``job_id`` / ``job_priority`` strings declare which logical
tenant a session belongs to and its priority class, feeding the server's
admission/fairness layer and the coordinator's job registry. Downgrade-
SAFE, like lineage/trace: a v6 constructor emits the fields only for v6+
HELLOs (pre-v6 frames stay byte-identical), and a server maps an absent
``job_id`` — a v5 peer, or a v6 peer that declared nothing — onto the
implicit default job, so every pre-r20 exchange keeps its exact behavior.
A server MAY refuse a declared job at admission time (capacity or stall-
SLO breach) with a MSG_ERROR whose message carries
``ADMISSION_REFUSED_MARKER`` — frozen wire prose like the version-
mismatch marker, so clients can distinguish "come back later" tenancy
refusals from fatal handshake skew. Fleet RESOLVE payloads may likewise
carry the job declaration (old coordinators ignore the unknown keys) and
member heartbeats may carry a per-job ``jobs`` stats field (old
coordinators ignore it — same contract as ``queue_wait_hist``).
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Optional, Tuple

import numpy as np

from ..utils import wiretrack

__all__ = [
    "PROTOCOL_VERSION",
    "MIN_PROTOCOL_VERSION",
    "LINEAGE_MIN_VERSION",
    "STRIPE_MIN_VERSION",
    "TOKEN_PACK_MIN_VERSION",
    "TRACE_MIN_VERSION",
    "JOB_MIN_VERSION",
    "ragged_meta",
    "version_supported",
    "is_json_int",
    "hello_malformed",
    "VERSION_MISMATCH_MARKER",
    "ADMISSION_REFUSED_MARKER",
    "MSG_HELLO",
    "MSG_HELLO_OK",
    "MSG_BATCH",
    "MSG_ACK",
    "MSG_END",
    "MSG_ERROR",
    "MSG_FLEET_REGISTER",
    "MSG_FLEET_REGISTER_OK",
    "MSG_FLEET_HEARTBEAT",
    "MSG_FLEET_HEARTBEAT_OK",
    "MSG_FLEET_DEREGISTER",
    "MSG_FLEET_DEREGISTER_OK",
    "MSG_FLEET_RESOLVE",
    "MSG_FLEET_RESOLVE_OK",
    "parse_hostport",
    "send_frame",
    "recv_frame",
    "send_msg",
    "recv_msg",
    "encode_batch",
    "encode_tensors",
    "tensor_views",
    "encode_batch_meta",
    "send_batch_frame",
    "decode_batch",
    "FrameReader",
    "ProtocolError",
]

PROTOCOL_VERSION = 6
# Oldest peer version this build still speaks. v1 framing is a strict
# subset of v2 (no lineage meta key), an unstriped v3 HELLO is a strict
# subset of v2's, a pack-less v4 HELLO of v3's, a v5 exchange differs
# from v4 only by optional meta/heartbeat fields, and a job-less v6
# HELLO of v5's, so the floor stays 1.
MIN_PROTOCOL_VERSION = 1
# First version whose batch meta may carry the lineage field.
LINEAGE_MIN_VERSION = 2
# First version whose HELLO stripe_index/stripe_count are honoured. A
# striping client MUST refuse older peers (they'd ignore the unknown keys
# and serve every step — silent duplication), never downgrade-retry.
STRIPE_MIN_VERSION = 3
# First version whose HELLO token_pack is honoured and whose batch meta may
# carry the ragged field. A packing client MUST refuse older peers (they'd
# ignore the request and stream padded rows the client believes are
# packed), never downgrade-retry; non-packing peers of any version get the
# bit-identical padded stream.
TOKEN_PACK_MIN_VERSION = 4
# First version whose batch meta may carry the trace field (the
# cross-process trace context, obs/tracectx.py). Downgrade-SAFE, like
# lineage: the sender simply omits the field for older peers (their
# frames stay byte-identical) and a receiver treats absence as None.
TRACE_MIN_VERSION = 5
# First version whose HELLO may carry job_id / job_priority (the job
# plane, fleet/jobs.py). Downgrade-SAFE for the default tenant, like
# lineage/trace: the constructor omits the fields for older peers and a
# server maps their absence onto the implicit default job. A client with
# an EXPLICIT job declaration, however, must refuse older peers (they'd
# ignore the unknown keys and serve the session untenanted — silent loss
# of admission control and per-job accounting), never downgrade-retry.
JOB_MIN_VERSION = 6
# Error-message prefix every version rejection starts with — the marker the
# client's downgrade retry keys on. FROZEN wire prose: deployed v1 servers
# already say exactly "protocol version mismatch: server 1, client N", and
# a v2 client must recognize THEIR rejection, so rewording this constant
# (or a server's message) silently breaks new-client -> old-server interop.
VERSION_MISMATCH_MARKER = "protocol version mismatch"
# Error-message prefix every admission refusal starts with (v6 job
# plane). FROZEN wire prose like the version marker: a client keys on it
# to distinguish a retryable "fleet is full / SLO-protected" tenancy
# refusal from fatal handshake skew, so rewording a deployed server's
# message silently turns back-off retries into hard failures.
ADMISSION_REFUSED_MARKER = "admission refused"


def version_supported(version) -> bool:
    """Is ``version`` (a peer's HELLO/HELLO_OK claim) in this build's
    compatibility range? Non-integers are unsupported, never a crash."""
    return (
        isinstance(version, int)
        and not isinstance(version, bool)  # JSON true is not a version
        and MIN_PROTOCOL_VERSION <= version <= PROTOCOL_VERSION
    )


def is_json_int(value) -> bool:
    """Is ``value`` a JSON integer (bool excluded — JSON ``true`` is not a
    count)? The ONE predicate every peer's type check shares: the
    server's ``hello_malformed`` gate and the client/balancer echo
    validations must never diverge on the bool-is-an-int subtlety."""
    return isinstance(value, int) and not isinstance(value, bool)


# HELLO field type vocabulary: (field, predicate over a non-None value,
# human-readable expectation). Optional fields (None = undeclared) skip the
# check, like the skew checks they feed. The schema owner declares the
# types in ONE place so the server's rejection and the analyzer's golden
# corpus never drift apart.
_HELLO_FIELD_TYPES = (
    ("batch_size", is_json_int, "integer"),
    ("process_index", is_json_int, "integer"),
    ("process_count", is_json_int, "integer"),
    ("seed", is_json_int, "integer"),
    ("epoch", is_json_int, "integer"),
    ("start_step", is_json_int, "integer"),
    ("stripe_index", is_json_int, "integer"),
    ("stripe_count", is_json_int, "integer"),
    ("image_size", is_json_int, "integer"),
    ("seq_len", is_json_int, "integer"),
    ("sampler_type", lambda v: isinstance(v, str), "string"),
    ("client_id", lambda v: isinstance(v, str), "string"),
    ("task_type", lambda v: isinstance(v, str), "string"),
    ("dataset_fingerprint", lambda v: isinstance(v, str), "string"),
    ("job_id", lambda v: isinstance(v, str), "string"),
    ("job_priority", lambda v: isinstance(v, str), "string"),
    ("shuffle", lambda v: isinstance(v, bool), "boolean"),
    ("probe", lambda v: isinstance(v, bool), "boolean"),
    ("device_decode", lambda v: isinstance(v, bool), "boolean"),
    ("token_pack", lambda v: isinstance(v, bool), "boolean"),
    (
        "columns",
        lambda v: isinstance(v, list)
        and all(isinstance(c, str) for c in v),
        "list of strings",
    ),
)


def hello_malformed(req: dict) -> Optional[str]:
    """First malformed-TYPE problem in a HELLO payload, or ``None``.

    The handshake must answer a skew-style MSG_ERROR for a field of the
    wrong JSON type (a foreign or corrupted client sending
    ``image_size="abc"``): before this check, such a value reached
    ``int(size)`` inside ``decode_config_skew`` and killed the handler
    with a ValueError repr instead of a diagnosable connect-time
    rejection. Validated HERE, by the schema owner, so every field the
    skew checks or ``plan_for`` later coerce is already type-sound."""
    for field, ok, expected in _HELLO_FIELD_TYPES:
        value = req.get(field)
        if value is not None and not ok(value):
            return (
                f"malformed HELLO field {field!r}: expected {expected}, "
                f"got {type(value).__name__} {value!r}"
            )
    return None


# Message types (one byte on the wire).
MSG_HELLO = 1  # client -> server: version + shard/plan parameters
MSG_HELLO_OK = 2  # server -> client: version + num_steps + start_step
MSG_BATCH = 3  # server -> client: one plan step's decoded host batch
MSG_ACK = 4  # client -> server: cursor advance {"step": n}
MSG_END = 5  # server -> client: plan exhausted, stream complete
MSG_ERROR = 6  # either direction: {"message": str}; connection closes after

# Fleet control plane (v3+): data servers and fleet clients talk to the
# coordinator with one request/reply per short-lived connection — the
# coordinator never holds streaming state, so a wedged peer costs one
# handler thread for one deadline, not a session.
MSG_FLEET_REGISTER = 16  # server -> coord: {server_id, addr, num_fragments}
MSG_FLEET_REGISTER_OK = 17  # coord -> server: {generation, lease, ...}
MSG_FLEET_HEARTBEAT = 18  # server -> coord: {server_id, generation}
MSG_FLEET_HEARTBEAT_OK = 19  # coord -> server: {generation, lease} — the
# reply is how a member learns its lease moved (join/leave elsewhere)
MSG_FLEET_DEREGISTER = 20  # server -> coord: {server_id} (graceful leave)
MSG_FLEET_DEREGISTER_OK = 21  # coord -> server: {generation}
MSG_FLEET_RESOLVE = 22  # client -> coord: {} (membership query)
MSG_FLEET_RESOLVE_OK = 23  # coord -> client: {generation, members: [...]}

_HEADER = struct.Struct(">IB")  # frame length (excluding header) | msg type
_META_LEN = struct.Struct(">I")

# Refuse absurd frames before allocating: the largest legitimate frame is one
# decoded global batch (e.g. 1024 x 224 x 224 x 3 u8 ~ 154 MB); 2 GiB means a
# corrupt or hostile peer.
MAX_FRAME = 2**31


class ProtocolError(RuntimeError):
    """Framing/handshake violation — the connection is unusable."""


def parse_hostport(addr: str, default_host: str = "127.0.0.1") -> Tuple[str, int]:
    """``host:port`` / ``[v6]:port`` → ``(host, port)``.

    The one address parser every dialing surface shares (RemoteLoader,
    FleetLoader, the server's coordinator registration, the CLI). Bracketed
    IPv6 is the RFC 3986 form — ``[::1]:8476`` must parse as host ``::1``,
    not be misparsed by a bare ``rpartition(":")`` into host ``[::1`` — and
    an UNbracketed multi-colon literal (``::1``) is rejected as ambiguous
    rather than silently splitting at the last colon. ``:8476`` (empty
    host) means ``default_host``.
    """
    text = addr.strip()
    host, sep, port = text.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"address must be host:port or [ipv6]:port, got {addr!r}"
        )
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
        if not host:
            raise ValueError(f"empty IPv6 host in {addr!r}")
    elif ":" in host:
        raise ValueError(
            f"ambiguous IPv6 address {addr!r}: bracket the host ([::1]:port)"
        )
    return host or default_host, int(port)


def _recv_exact(
    sock: socket.socket, n: int, deadline: Optional[float] = None
) -> bytearray:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF.

    ``deadline`` (a ``time.monotonic()`` instant) bounds the WHOLE read, not
    each ``recv`` — a socket-level ``settimeout`` alone resets per received
    byte, so a peer dripping one byte per interval could hold a handshake
    open forever. The streaming hot path passes no deadline and keeps the
    zero-overhead single-recv loop."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("frame-read deadline exceeded")
            sock.settimeout(remaining)
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return buf


def send_frame(sock: socket.socket, msg_type: int, payload: bytes) -> None:
    if len(payload) >= MAX_FRAME:
        raise ProtocolError(f"frame too large: {len(payload)} bytes")
    header = _HEADER.pack(len(payload), msg_type)
    if len(payload) > 1 << 16:
        # Bulk frames (batches): two sendalls instead of concatenating —
        # header+payload would copy the whole multi-MB batch once more per
        # step per client on the server's hot path.
        sock.sendall(header)
        sock.sendall(payload)
    else:
        sock.sendall(header + payload)


def recv_frame(
    sock: socket.socket, deadline: Optional[float] = None
) -> Tuple[int, bytearray]:
    header = _recv_exact(sock, _HEADER.size, deadline)
    length, msg_type = _HEADER.unpack(header)
    if length >= MAX_FRAME:
        raise ProtocolError(f"frame too large: {length} bytes")
    return msg_type, _recv_exact(sock, length, deadline)


def send_msg(sock: socket.socket, msg_type: int, payload: dict) -> None:
    """Send a control message (JSON dict payload — never pickle: control
    frames arrive from the network before any trust is established)."""
    if wiretrack.enabled():
        # Wire witness (LDT1403's evidence half): which (msg, field)
        # tuples actually cross the wire. Two attribute loads when off.
        wiretrack.record_frame(msg_type, payload)
    send_frame(sock, msg_type, json.dumps(payload).encode("utf-8"))


def recv_msg(
    sock: socket.socket, deadline: Optional[float] = None
) -> Tuple[int, dict]:
    """Receive any frame; control payloads are JSON-decoded, batch frames
    are returned raw under ``{"raw": bytearray}`` for :func:`decode_batch`.
    ``deadline`` bounds the whole receive (see :func:`_recv_exact`) — used
    for handshake frames, never for the streaming phase."""
    msg_type, payload = recv_frame(sock, deadline)
    if msg_type == MSG_BATCH:
        if wiretrack.enabled():
            wiretrack.record_frame(msg_type, None)
        return msg_type, {"raw": payload}
    try:
        out = json.loads(bytes(payload).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(
            f"undecodable control frame type {msg_type}: {exc}"
        )
    if not isinstance(out, dict):
        raise ProtocolError(f"control frame type {msg_type} is not a dict")
    if wiretrack.enabled():
        # Receive-side recording too: a frame from a FOREIGN writer (the
        # exact blind spot the witness prunes LDT1403 with) is only ever
        # seen here.
        wiretrack.record_frame(msg_type, out)
    return msg_type, out


def ragged_meta(batch: dict) -> Optional[dict]:
    """The v4 batch-meta ``ragged`` field for a host batch, derived from
    the ragged key convention (``data/token_pack.py``): ``{column_base:
    values_capacity_bucket}`` for every ``<base>__values`` tensor, or
    ``None`` for a plain row batch (the field is then omitted — v1..v3
    frames stay byte-identical). Deriving it from the batch itself is what
    makes decode → re-encode byte-identity hold for ragged goldens with no
    extra plumbing."""
    out = {}
    for name, arr in batch.items():
        if name.endswith("__values"):
            out[name[: -len("__values")]] = int(np.asarray(arr).shape[0])
    return out or None


def encode_batch(step: int, batch: dict,
                 lineage: Optional[dict] = None,
                 trace: Optional[dict] = None) -> bytes:
    """One plan step's host batch → a MSG_BATCH payload.

    Arrays are serialised raw (C-contiguous dtype/shape + buffer), never
    pickled — the hot path moves bytes, not objects. ``lineage`` (v2+,
    :mod:`..obs.lineage`) and ``trace`` (v5+, :mod:`..obs.tracectx`) ride
    the JSON meta as extra keys: a v1 decoder reads ``step``/``tensors``
    and never sees them. Ragged token batches (v4+) additionally carry
    the derived :func:`ragged_meta` field.
    """
    metas, body = encode_tensors(batch)
    meta = encode_batch_meta(step, metas, lineage,
                             ragged=ragged_meta(batch), trace=trace)
    return b"".join([_META_LEN.pack(len(meta)), meta, body])


def encode_tensors(batch: dict) -> Tuple[list, bytes]:
    """Serialise a host batch's arrays → ``(tensor_metas, body_bytes)``.

    Legacy form: the ``b"".join`` is one full extra copy of the batch. The
    hot path uses :func:`tensor_views` + the vectored
    :func:`send_batch_frame` instead, which moves the same wire bytes with
    zero intermediate joins; this stays for :func:`encode_batch` (tests,
    tools) where a single contiguous payload is the point.
    """
    metas, buffers = [], []
    for name, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        metas.append([name, arr.dtype.str, list(arr.shape)])
        buffers.append(arr.data if arr.size else b"")
    return metas, b"".join(buffers)


def tensor_views(batch: dict) -> Tuple[list, list]:
    """Zero-join serialisation: ``(tensor_metas, [memoryview, ...])``.

    Each view is a flat ``'B'``-cast window over the array's own buffer (the
    view keeps the array alive), in meta order — handed to
    :func:`send_batch_frame`, the kernel gathers them with one vectored
    write per syscall, so a batch crosses the wire with **no** intermediate
    ``bytes`` concatenation on the send side. Wire bytes are identical to
    ``encode_tensors``'s joined body.
    """
    metas, views = [], []
    for name, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        metas.append([name, arr.dtype.str, list(arr.shape)])
        if arr.size:
            views.append(memoryview(arr).cast("B"))
    return metas, views


# iovec batching cap for sendmsg: far below any platform IOV_MAX (Linux
# 1024), far above any real batch's tensor count.
_SENDMSG_MAX_VECS = 64


def _sendmsg_all(sock: socket.socket, views: list) -> None:
    """``sendall`` semantics over a list of buffers via vectored
    ``sendmsg`` — loops on partial sends, never concatenates."""
    views = [v for v in views if v.nbytes]
    if not hasattr(sock, "sendmsg"):  # non-POSIX socket (or a test double):
        for v in views:  # same bytes, one write per buffer, still no join
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:_SENDMSG_MAX_VECS])
        i = 0
        while i < len(views) and sent >= views[i].nbytes:
            sent -= views[i].nbytes
            i += 1
        views = views[i:]
        if views and sent:
            views[0] = views[0][sent:]


def encode_batch_meta(step: int, tensor_metas: list,
                      lineage: Optional[dict] = None,
                      ragged: Optional[dict] = None,
                      trace: Optional[dict] = None) -> bytes:
    """The small JSON meta half of a MSG_BATCH payload (see
    :func:`encode_batch` for the lineage/v1 contract). ``ragged`` (v4+,
    :func:`ragged_meta`) names the batch's flat token-page tensors and
    their capacity buckets; ``trace`` (v5+, :mod:`..obs.tracectx`) is the
    batch's cross-process trace context. Each is omitted when absent, so
    pre-v5 (and pre-ragged, and pre-lineage) frames stay byte-identical."""
    header = {"step": int(step), "tensors": tensor_metas}
    if lineage is not None:
        header["lineage"] = lineage
    if ragged:
        header["ragged"] = ragged
    if trace is not None:
        header["trace"] = trace
    return json.dumps(header).encode("utf-8")


def send_batch_frame(sock: socket.socket, meta: bytes, body) -> int:
    """Send one MSG_BATCH built from :func:`tensor_views` (or legacy
    :func:`encode_tensors`) + :func:`encode_batch_meta` parts, without
    re-joining the body into a fresh payload copy. ``body`` is either the
    joined ``bytes`` or a list of memoryviews — the latter goes out as ONE
    vectored write stream (header+meta and every tensor gathered by the
    kernel), so the send path never materialises an intermediate payload.
    Wire bytes are identical to ``send_frame(sock, MSG_BATCH,
    encode_batch(...))`` either way. Returns the payload length (for
    bytes-sent accounting)."""
    if isinstance(body, (bytes, bytearray, memoryview)):
        views = [memoryview(body)] if len(body) else []
    else:
        views = list(body)
    body_len = sum(v.nbytes for v in views)
    payload_len = _META_LEN.size + len(meta) + body_len
    if payload_len >= MAX_FRAME:
        raise ProtocolError(f"frame too large: {payload_len} bytes")
    head = memoryview(
        _HEADER.pack(payload_len, MSG_BATCH) + _META_LEN.pack(len(meta)) + meta
    )
    _sendmsg_all(sock, [head] + views)
    return payload_len


def decode_batch(payload, with_lineage: bool = False,
                 pool: Optional["BufferPool"] = None,
                 with_trace: bool = False):
    """MSG_BATCH payload → ``(step, {name: np.ndarray})``, or with
    ``with_lineage=True`` → ``(step, batch, lineage_or_None)`` (``None``
    when the sender predates — or gated off — the v2 lineage field).
    ``with_trace=True`` (implies lineage) → ``(step, batch,
    lineage_or_None, trace_or_None)`` — the v5 trace field, same
    absence-is-interop contract.

    Arrays are copies (the frame buffer is reused by the receive loop), each
    materialised with one ``frombuffer`` + reshape — no element-wise work.
    With ``pool`` (a ``data.buffers.BufferPool``) the copy lands in a warm
    recycled page instead of faulting a fresh allocation; values are
    bit-identical either way, and the consumer owns the lease release.
    """
    view = memoryview(payload)
    if len(view) < _META_LEN.size:
        raise ProtocolError("batch frame shorter than its meta header")
    (meta_len,) = _META_LEN.unpack_from(view, 0)
    offset = _META_LEN.size
    if len(view) < offset + meta_len:
        raise ProtocolError("batch frame truncated inside meta")
    try:
        meta = json.loads(bytes(view[offset : offset + meta_len]))  # ldt: ignore[LDT701] -- json.loads cannot take a memoryview slice; the copy is the small control meta, never tensor payload
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"undecodable batch meta: {exc}")
    offset += meta_len
    ragged = meta.get("ragged")
    if ragged is not None and not isinstance(ragged, dict):
        raise ProtocolError("batch meta 'ragged' field is not a dict")
    out = {}
    for name, dtype_str, shape in meta["tensors"]:
        dtype = np.dtype(dtype_str)
        shape = tuple(shape)
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if len(view) < offset + nbytes:
            raise ProtocolError(f"batch frame truncated inside tensor {name!r}")
        if ragged and name.endswith("__values"):
            # Ragged view pair (v4): the declared capacity bucket must
            # match the flat page actually shipped — a disagreement means
            # a torn frame or a sender whose pool bucketing drifted from
            # the schema, and decoding it would hand the pack kernel a
            # misaligned token run.
            declared = ragged.get(name[: -len("__values")])
            if declared is not None and (
                not is_json_int(declared) or int(declared) != int(shape[0])
            ):
                raise ProtocolError(
                    f"ragged tensor {name!r}: declared capacity bucket "
                    f"{declared!r} != shipped page of {shape[0]}"
                )
        src = np.frombuffer(
            view[offset : offset + nbytes], dtype=dtype
        ).reshape(shape)
        if pool is not None and nbytes:
            dst = pool.lease(shape, dtype)
            # Ownership parks in `out` before the copy: a failed frame is
            # discarded whole, and the consumer-owned release (or the
            # pool's weakref guard) reclaims the page — never a strand.
            out[name] = dst
            np.copyto(dst, src)
        else:
            out[name] = src.copy()
        offset += nbytes
    if offset != len(view):
        raise ProtocolError(
            f"batch frame has {len(view) - offset} trailing bytes"
        )
    if with_lineage or with_trace:
        lineage = meta.get("lineage")
        lineage = lineage if isinstance(lineage, dict) else None
        if with_trace:
            trace = meta.get("trace")
            return int(meta["step"]), out, lineage, (
                trace if isinstance(trace, dict) else None
            )
        return int(meta["step"]), out, lineage
    return int(meta["step"]), out


class FrameReader:
    """Per-connection frame receiver with a reusable receive buffer.

    ``recv_frame``/``recv_msg`` allocate a fresh ``bytearray`` per frame;
    at one multi-MB batch per step per client that is a page-faulted
    allocation on every receive. This reader owns ONE growable buffer and
    ``recv_into``s every frame on top of it, so steady-state receives touch
    no allocator at all.

    Contract: the returned payload is a ``memoryview`` over the internal
    buffer, valid only until the next ``recv_msg`` call — decode it (the
    client calls :func:`decode_batch`, which copies out) before receiving
    again. Wire semantics are byte-identical to :func:`recv_msg` (tests pin
    the parity frame-for-frame).
    """

    def __init__(self, sock: socket.socket, initial_capacity: int = 1 << 16):
        self.sock = sock
        self._buf = bytearray(max(initial_capacity, _HEADER.size))

    def _recv_exact_into(
        self, view: memoryview, deadline: Optional[float] = None
    ) -> None:
        """Fill ``view`` completely (same EOF/deadline semantics as
        ``_recv_exact`` — the deadline bounds the WHOLE read)."""
        sock = self.sock
        got, n = 0, view.nbytes
        while got < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout("frame-read deadline exceeded")
                sock.settimeout(remaining)
            r = sock.recv_into(view[got:], n - got)
            if r == 0:
                raise ConnectionError("peer closed mid-frame")
            got += r

    def recv_msg(
        self, deadline: Optional[float] = None
    ) -> Tuple[int, dict]:
        """Same contract as module-level :func:`recv_msg`, but the batch
        payload under ``{"raw": ...}`` is a view into the reusable buffer
        (valid until the next call)."""
        head = memoryview(self._buf)[: _HEADER.size]
        self._recv_exact_into(head, deadline)
        length, msg_type = _HEADER.unpack(head)
        if length >= MAX_FRAME:
            raise ProtocolError(f"frame too large: {length} bytes")
        if length > len(self._buf):
            # Grow geometrically: a few early resizes, then a stable page
            # set for the rest of the stream.
            self._buf = bytearray(max(length, 2 * len(self._buf)))  # ldt: ignore[LDT1002] -- per-connection reader owned by exactly one receiver thread; instances are never shared
        payload = memoryview(self._buf)[:length]
        self._recv_exact_into(payload, deadline)
        if msg_type == MSG_BATCH:
            if wiretrack.enabled():
                wiretrack.record_frame(msg_type, None)
            return msg_type, {"raw": payload}
        try:
            out = json.loads(bytes(payload).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise ProtocolError(
                f"undecodable control frame type {msg_type}: {exc}"
            )
        if not isinstance(out, dict):
            raise ProtocolError(f"control frame type {msg_type} is not a dict")
        if wiretrack.enabled():
            wiretrack.record_frame(msg_type, out)
        return msg_type, out


def hello(
    *,
    batch_size: int,
    process_index: int,
    process_count: int,
    sampler_type: str = "batch",
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    start_step: int = 0,
    stripe_index: int = 0,
    stripe_count: int = 1,
    columns: Optional[list] = None,
    client_id: str = "",
    probe: bool = False,
    task_type: Optional[str] = None,
    image_size: Optional[int] = None,
    seq_len: Optional[int] = None,
    device_decode: Optional[bool] = None,
    token_pack: Optional[bool] = None,
    dataset_fingerprint: Optional[str] = None,
    job_id: Optional[str] = None,
    job_priority: Optional[str] = None,
    version: int = PROTOCOL_VERSION,
) -> dict:
    """Build the HELLO payload — the client's shard-of-the-plan request.

    ``version`` is the protocol version this HELLO advertises. It defaults
    to the newest this build speaks; a client re-offers
    ``MIN_PROTOCOL_VERSION`` after a v1 server (whose handshake predates
    range negotiation and rejects any version other than its own) refuses
    the first HELLO — that downgrade retry is what makes
    new-client -> old-server interop real rather than aspirational.

    ``start_step`` is the resume cursor: a reconnecting client passes
    ``last_acked + 1`` and the server serves the identical plan from there
    (no duplicated, no skipped step). ``stripe_index``/``stripe_count``
    (v3+) narrow the stream to the residue class ``step % stripe_count ==
    stripe_index`` — the fleet client's unit of spreading one shard across
    N servers; the default ``0/1`` is the whole plan and is what every
    pre-v3 exchange implicitly spoke. ``probe=True`` asks for HELLO_OK only
    (plan metadata, e.g. ``len(loader)``) with no batch stream.
    ``task_type``/``image_size``, when given, let the server reject a
    decode-config skew at connect time (a 224px server feeding a 299px
    trainer would otherwise train silently at the wrong resolution — global
    pooling accepts any spatial size).

    ``job_id``/``job_priority`` (v6+) declare the logical tenant this
    session belongs to and its priority class (fleet/jobs.py). Emitted
    only when the offered version speaks the job plane, so every pre-v6
    HELLO stays byte-identical to what a pre-r20 build produced; at v6
    the keys are always present (null = the implicit default job), like
    every other optional field above.
    """
    payload = {
        "version": int(version),
        "batch_size": int(batch_size),
        "process_index": int(process_index),
        "process_count": int(process_count),
        "sampler_type": sampler_type,
        "shuffle": bool(shuffle),
        "seed": int(seed),
        "epoch": int(epoch),
        "start_step": int(start_step),
        "stripe_index": int(stripe_index),
        "stripe_count": int(stripe_count),
        "columns": list(columns) if columns is not None else None,
        "client_id": client_id,
        "probe": bool(probe),
        "task_type": task_type,
        "image_size": int(image_size) if image_size is not None else None,
        # Text-task decode shape (r15): the padded arm's static sequence
        # length and the pack_len default. Declared, it must match the
        # server's --seq_len — a mismatch would stream batches the model's
        # max_len cannot take (a mid-epoch shape crash instead of this
        # connect-time skew rejection). None = non-text task or old caller.
        "seq_len": int(seq_len) if seq_len is not None else None,
        # None = undeclared (old callers): the server skips the check, as
        # with task_type/image_size. Declared, it must match the server's
        # pixel-vs-coefficient-page serving mode.
        "device_decode": (
            bool(device_decode) if device_decode is not None else None
        ),
        # Ragged token plane (v4+): True asks for packed variable-length
        # batches (values/offsets pages + pack plan); only honoured when
        # the negotiated version >= TOKEN_PACK_MIN_VERSION — the CLIENT
        # enforces that floor (packing is not downgrade-safe), the server
        # skew-checks the request against its own serving mode. None =
        # undeclared (old callers): padded stream, check skipped.
        "token_pack": bool(token_pack) if token_pack is not None else None,
        # Content identity of the dataset the client opened locally
        # (Dataset.fingerprint(), r13): the server rejects a mismatch —
        # serving rows from a DIFFERENT copy of "the same" path would
        # train on wrong data with a valid plan shape. None = the client
        # has no local mount (disaggregated hosts) or predates the field:
        # the check is skipped, like the decode knobs above.
        "dataset_fingerprint": (
            str(dataset_fingerprint)
            if dataset_fingerprint is not None else None
        ),
    }
    # Job plane (v6+): gated on the OFFERED version, not merely appended —
    # pre-v6 HELLOs must stay byte-identical (the golden corpus pins them)
    # and a pre-v6 server must never see keys it would treat as unknown.
    # The declared-job downgrade floor itself is enforced by the caller
    # (client/balancer), which refuses pre-v6 peers when job_id is set.
    if int(version) >= JOB_MIN_VERSION:
        payload["job_id"] = str(job_id) if job_id is not None else None
        payload["job_priority"] = (
            str(job_priority) if job_priority is not None else None
        )
    return payload
