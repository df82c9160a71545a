"""``RemoteLoader`` — the client half of the disaggregated input-data plane.

A copy of ``lance_distributed_training_tpu/service/client.py`` for the
port. Where JAX takes a ``device_put_fn``, the port takes ``device``:
``None`` yields host batches (which the placement plane places
downstream), a device places each batch through
:func:`~..parallel.mesh.make_global_batch`, whose copy event returns the
page-locked pages to the pool only once the copy has read them.

Drop-in replacement for :class:`~..data.pipeline.DataPipeline` on the
training host: iterating yields the *identical* sequence of batches the in-process
pipeline would produce for the same (dataset, sampler, batch, shard, seed,
epoch) — the server builds the same deterministic ``Plan`` — but decode ran
on the service host, so the trainer's cores stay free. Mesh-native by
construction: the HELLO carries the process's rank and world size as the
shard, so each training process streams exactly its slice of the global
batch — no redundant bytes over the wire — and the trainer wraps this
loader in the placement plane (:mod:`~..data.placement`), which copies
each batch to the card on a side stream. ``device`` remains the
synchronous escape hatch (``--no_global_batch``).

Robustness: a background receiver thread prefetches frames into the same
bounded-queue discipline ``DataPipeline`` uses; every received step is ACKed,
and a dropped connection mid-epoch reconnects (retry + exponential backoff)
with ``start_step = last_acked + 1``, resuming the plan without duplicating
or skipping a step. Stall time (consumer blocked on an empty queue = the
wire/decode is the bottleneck) accumulates in :class:`ServiceCounters`, so
``StepTimer.attach_counters`` keeps loader-stall%% attributable.
"""

from __future__ import annotations

import functools
import queue
import socket
import threading
import time
import uuid
from collections import deque
from typing import Callable, Iterator, Optional, Sequence

from ..obs.lineage import observe_wire_lineage
from ..obs.registry import MetricsRegistry, default_registry
from ..obs.spans import span
from ..obs.tracectx import child, coerce_trace
from ..tune.tunable import AdjustableQueue, Tunable, _LiveQueues
from ..utils.metrics import ServiceCounters
from ..utils.retry import RetryPolicy, retrying
from . import protocol as P

__all__ = ["RemoteLoader"]

_SENTINEL = object()


def _placer(device, buffer_pool) -> Optional[Callable[[dict], dict]]:
    """The consumer's placement of a received host batch on ``device``, or
    ``None`` when host batches are yielded as they are. On CUDA one
    :class:`~..parallel.mesh.PinnedStager` serves the iteration; the
    batch's pool pages go back with the event of the copy that read them
    (:func:`~..parallel.mesh.make_global_batch`). Torch loads here, not at
    import: a decode server imports this package and never places."""
    if device is None:
        return None
    from ..parallel.mesh import PinnedStager, indexed_device, make_global_batch

    device = indexed_device(device)
    stager = PinnedStager(device) if device.type == "cuda" else None
    return functools.partial(make_global_batch, device=device, stager=stager,
                             buffer_pool=buffer_pool)


class _VersionRedial(Exception):
    """Handshake version negotiation: redial immediately with the
    downgraded HELLO — never surfaced, never counted as a failed attempt."""


class RemoteLoader:
    """Iterate device-ready batches served by a remote :class:`DataService`.

    Parameters mirror ``make_train_pipeline`` where they overlap; decode
    parameters live server-side (the service owns the decode plane).

    Since r16 this class is the runtime engine beneath a
    :class:`~..data.graph.LoaderGraph` assembly (``LanceSource → Decode →
    ... → ServiceTransport``) — prefer composing the graph.
    """

    def __init__(
        self,
        addr: str,
        batch_size: int,
        process_index: int,
        process_count: int,
        device=None,
        *,
        sampler_type: str = "batch",
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        prefetch: int = 2,
        columns: Optional[Sequence[str]] = None,
        connect_retries: int = 5,
        backoff_s: float = 0.2,
        timeout_s: float = 120.0,
        task_type: Optional[str] = None,
        image_size: Optional[int] = None,
        seq_len: Optional[int] = None,
        device_decode: Optional[bool] = None,
        token_pack: Optional[bool] = None,
        dataset_fingerprint: Optional[str] = None,
        job_id: Optional[str] = None,
        job_priority: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
        buffer_pool=None,
    ):
        # Shared parser: accepts bracketed IPv6 ([::1]:8476) — a bare
        # rpartition(":") here used to misparse it into host "[::1".
        self.host, self.port = P.parse_hostport(addr)
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        # Where batches are placed: None yields host batches (the placement
        # plane, when there is one, places them downstream); a device places
        # each through the synchronous make_global_batch.
        self.device = device
        self.sampler_type = sampler_type
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.prefetch = max(1, prefetch)
        self.columns = list(columns) if columns is not None else None
        self.connect_retries = connect_retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        # Declared decode knobs: the server rejects a mismatch at connect
        # time (silent wrong-resolution training is the alternative).
        self.task_type = task_type
        self.image_size = image_size
        self.seq_len = seq_len
        self.device_decode = device_decode
        # Ragged token plane (v4+): True asks the server for packed
        # variable-length batches. NOT downgrade-safe — _dial_once refuses
        # peers below TOKEN_PACK_MIN_VERSION instead of downgrade-retrying
        # (a pre-v4 server would silently stream padded rows).
        self.token_pack = token_pack
        # Declared dataset identity (Dataset.fingerprint() of a locally
        # readable copy, when the trainer has one): the server rejects a
        # mismatched copy at connect time. None = undeclared, skipped.
        self.dataset_fingerprint = dataset_fingerprint
        # Job plane (v6): declared tenancy. None = implicit default job —
        # downgrade-safe (an old server simply has one tenant). An EXPLICIT
        # job_id is NOT downgrade-safe: _dial_once refuses peers below
        # JOB_MIN_VERSION instead of silently losing per-job cursors,
        # fairness and admission (the token_pack precedent).
        self.job_id = job_id
        self.job_priority = job_priority
        self.registry = registry if registry is not None else default_registry()
        self.counters = ServiceCounters(registry=self.registry)
        # Buffer plane: received tensors are copied into recycled pool
        # pages (decode_batch(pool=...)) instead of fresh allocations; the
        # consumer loop releases each batch's leases after device_put
        # dispatch (or after its yield returns for host-batch callers).
        self.buffer_pool = buffer_pool
        # Lineage loop closure: every v2 batch frame's stamps, merged with
        # the client-computed ages (batch_age_ms / wire_ms) — histograms go
        # to the registry, the raw recent window here for tests/debugging.
        self.recent_lineage: deque = deque(maxlen=1024)
        self.last_lineage: Optional[dict] = None
        # Last batch's continued trace context (v5): {trace_id, span_id,
        # parent_span_id} after this hop — tests and debuggers peek here.
        self.last_trace: Optional[dict] = None
        self.client_id = uuid.uuid4().hex
        # Version this client's HELLO advertises. Starts at the newest we
        # speak; a v1 server's equality check rejects that, so _connect
        # downgrades to MIN_PROTOCOL_VERSION and redials. Sticky: later
        # reconnects (resume-at-cursor) keep speaking the negotiated version
        # instead of re-tripping the mismatch on every drop.
        self._hello_version = P.PROTOCOL_VERSION
        self._num_steps: Optional[int] = None
        # Set by the active iteration; test/ops hook: closing it simulates a
        # connection drop and exercises the resume path. Published by the
        # receiver thread and read by the consumer's teardown — every
        # access goes through _publish_conn/_close_conn under this lock
        # (LDT1002: the handle swap and the closer's read must not tear).
        self._conn: Optional[socket.socket] = None
        self._conn_lock = threading.Lock()
        # Resume cursor (contract: data/pipeline.py): _start_step rides the
        # next iteration's HELLO as start_step — the server slices its
        # (identical, deterministic) plan there, the same mechanism
        # mid-epoch reconnects already use.
        self._start_step = 0
        self._yielded = 0
        # Autotune surface (tune/): the live prefetch queue.
        self._live = _LiveQueues()

    def set_prefetch(self, depth: int) -> int:
        """Autotune actuator: move the receive-prefetch bound, live —
        deeper buffering absorbs wire/decode jitter from the service
        without touching the stream's content or order."""
        depth = max(1, int(depth))
        self.prefetch = depth  # ldt: ignore[LDT1002] -- atomic int swap; readers take any recent value
        self._live.resize_total(depth)
        return depth

    def tunables(self):
        """Autotune registration surface (tune/)."""
        return [Tunable(
            "prefetch", lambda: self.prefetch, self.set_prefetch,
            lo=1, hi=16,
            doc="received host batches buffered ahead of the consumer",
        )]

    def state_dict(self) -> dict:
        return {"epoch": int(self.epoch), "step": int(self._yielded)}

    def load_state_dict(self, state: dict) -> None:
        if "epoch" in state:
            self.set_epoch(int(state["epoch"]))
        step = int(state.get("step", 0))
        if step < 0:
            raise ValueError(f"negative resume cursor: {step}")
        # Resume cursor: loaded between iterations, while no receiver
        # thread is live (the checkpoint-restore contract in
        # data/pipeline.py) — happens-before the next __iter__ spawn.
        self._start_step = step  # ldt: ignore[LDT1002] -- set while quiescent, before __iter__ spawns the receiver
        self._yielded = step

    # -- connection management --------------------------------------------

    def _publish_conn(self, sock: Optional[socket.socket]) -> None:
        """Expose (or retract) the active socket for a concurrent
        :meth:`_close_conn` — the teardown hook that breaks a blocked
        recv. One lock on both sides keeps the swap and the closer's read
        from interleaving."""
        with self._conn_lock:
            self._conn = sock

    def _close_conn(self) -> None:
        """Close whatever socket is currently published. The close itself
        runs OUTSIDE the lock — socket teardown is I/O, and holding a lock
        across I/O is the exact shape LDT1001 exists to keep out of this
        codebase."""
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _hello(self, start_step: int, probe: bool = False) -> dict:
        return P.hello(
            batch_size=self.batch_size,
            process_index=self.process_index,
            process_count=self.process_count,
            sampler_type=self.sampler_type,
            shuffle=self.shuffle,
            seed=self.seed,
            epoch=self.epoch,
            start_step=start_step,
            columns=self.columns,
            client_id=self.client_id,
            probe=probe,
            version=self._hello_version,
            task_type=self.task_type,
            image_size=self.image_size,
            seq_len=self.seq_len,
            device_decode=self.device_decode,
            token_pack=self.token_pack,
            dataset_fingerprint=self.dataset_fingerprint,
            job_id=self.job_id,
            job_priority=self.job_priority,
        )

    def _connect(self, start_step: int, probe: bool = False,
                 stop: Optional[threading.Event] = None):
        """Dial + handshake, with retry/backoff (the shared
        ``utils/retry.py`` policy: full jitter, 10 s cap). Returns
        ``(sock, reply)``.

        ``stop`` (the iteration's shutdown event) aborts between attempts
        and shortens backoff sleeps, so closing an iterator mid-outage
        returns promptly instead of draining the full retry schedule."""
        last: Optional[Exception] = None
        policy = RetryPolicy(
            attempts=max(1, self.connect_retries), base_s=self.backoff_s
        )
        for _attempt in retrying(
            policy, stop=stop, registry=self.registry,
            interrupt_message="loader closed during connect",
        ):
            try:
                while True:
                    try:
                        return self._dial_once(start_step, probe, stop)
                    except _VersionRedial:
                        # The server IS reachable — this is negotiation,
                        # not a failed attempt: redial immediately without
                        # consuming a retry (it happens at most once,
                        # guarded by the version floor in _dial_once).
                        continue
            except (ConnectionError, OSError) as exc:
                last = exc
                self.counters.add("connect_retries")
        raise ConnectionError(
            f"data service {self.host}:{self.port} unreachable after "
            f"{self.connect_retries} attempts: {last}"
        ) from last

    def _dial_once(self, start_step: int, probe: bool,
                   stop: Optional[threading.Event]):
        """One dial + handshake. Raises ``_VersionRedial`` after arranging a
        downgraded HELLO, ``ProtocolError`` on permanent rejections (bad
        shard, decode-config skew — retrying cannot fix them), and
        ``ConnectionError``/``OSError`` on retryable transport failures."""
        sock = None
        try:
            # Short dial timeout: create_connection cannot be interrupted
            # by the stop event, so an unreachable host must fail fast
            # (the retry loop provides persistence, not the dial).
            sock = socket.create_connection(
                (self.host, self.port),
                timeout=min(self.timeout_s, 10.0),
            )
            sock.settimeout(self.timeout_s)  # handshake recv bound
            if stop is not None:
                # Expose the in-progress socket so a concurrent iterator
                # close() can break a handshake recv out of its full
                # timeout (a half-dead server that accepts but never
                # replies would otherwise pin teardown for timeout_s).
                self._publish_conn(sock)
                if stop.is_set():
                    raise ConnectionError("loader closed during connect")
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            P.send_msg(sock, P.MSG_HELLO, self._hello(start_step, probe))
            msg_type, reply = P.recv_msg(sock)
            if msg_type == P.MSG_ERROR:
                message = str(reply.get("message", ""))
                if (P.VERSION_MISMATCH_MARKER in message
                        and self._hello_version
                        > P.MIN_PROTOCOL_VERSION):
                    # A v1 server's handshake predates range negotiation
                    # and rejects any version but its own. Re-offer the
                    # oldest version this build still speaks (lineage is
                    # already gated on the peer's echoed version, so a
                    # downgraded stream simply never carries it).
                    self._hello_version = P.MIN_PROTOCOL_VERSION
                    raise _VersionRedial()
                raise P.ProtocolError(
                    f"server rejected handshake: {message}"
                )
            if msg_type != P.MSG_HELLO_OK:
                raise P.ProtocolError(
                    f"expected HELLO_OK, got message type {msg_type}"
                )
            # An old (v1) server is fine — it just never sends lineage;
            # only a version OUTSIDE the range is a hard skew. (Servers
            # reject those at HELLO, but a v1 server predates range
            # checks, so the client re-checks its echo.)
            if not P.version_supported(reply.get("version")):
                raise P.ProtocolError(
                    f"server speaks protocol {reply.get('version')}, "
                    f"client supports {P.MIN_PROTOCOL_VERSION}.."
                    f"{P.PROTOCOL_VERSION}"
                )
            if self.token_pack and int(
                reply.get("version", 0)
            ) < P.TOKEN_PACK_MIN_VERSION:
                # Packing is not downgrade-safe: an older server ignores
                # the token_pack field and streams padded rows while this
                # client believes it negotiated the ragged plane — refuse,
                # never downgrade-retry (the striping precedent).
                raise P.ProtocolError(
                    f"data server speaks protocol {reply.get('version')} < "
                    f"{P.TOKEN_PACK_MIN_VERSION} (no token_pack support) — "
                    "upgrade it or train with --no_token_pack"
                )
            if self.job_id is not None and int(
                reply.get("version", 0)
            ) < P.JOB_MIN_VERSION:
                # An explicitly declared job is not downgrade-safe: an
                # older server drops the field and serves this client as
                # the anonymous default tenant — no per-job cursor, no
                # fairness weight, no admission gate — while the trainer
                # believes its job_id took effect. Refuse loudly (the
                # token_pack posture); an UNDECLARED job downgrades fine.
                raise P.ProtocolError(
                    f"data server speaks protocol {reply.get('version')} < "
                    f"{P.JOB_MIN_VERSION} (no job plane) — upgrade it or "
                    f"drop the explicit job_id {self.job_id!r}"
                )
            if self.job_id is not None and "job_id" in reply \
                    and reply.get("job_id") != self.job_id:
                # Echo check (LDT1401): a v6+ server echoes the admitted
                # job_id; a disagreement means this session was filed
                # under some other tenant's cursor/fairness scope.
                raise P.ProtocolError(
                    f"server echoed job_id {reply.get('job_id')!r}, "
                    f"declared {self.job_id!r} — tenancy desync"
                )
            # Cursor-echo check (LDT1401 closes the loop on every HELLO_OK
            # field): the server slices its plan at the echoed start_step —
            # an echo that disagrees with the request means the stream will
            # begin at the wrong step and every later ACK/resume cursor is
            # silently off by the difference. v1 servers echo it too, so
            # the .get default only covers a hand-rolled test double.
            echoed_start = reply.get("start_step", int(start_step))
            if not P.is_json_int(echoed_start) or \
                    echoed_start != int(start_step):
                # Type-checked (the shared JSON-int predicate), not
                # int()-coerced: a garbage echo must be THIS diagnosable
                # rejection, never a raw ValueError escaping the retry
                # loop (the handler-killing-repr class hello_malformed
                # fixes server-side).
                raise P.ProtocolError(
                    f"server echoed start_step {echoed_start!r}, "
                    f"requested {start_step} — plan-cursor desync"
                )
            self._num_steps = int(reply["num_steps"])  # ldt: ignore[LDT1002] -- idempotent plan-length cache: every writer stores the same value for a given epoch
            # Streaming phase: no recv deadline. A slow step (cold
            # decode, read retries, busy shared pool) must NOT be
            # misread as a drop — a timeout here would reconnect and
            # make the server restart the same step's decode, livelocking
            # when a step reliably exceeds the timeout. Dead peers are
            # covered by TCP keepalive + close() unblocking the recv.
            sock.settimeout(None)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            return sock, reply
        except BaseException:
            if sock is not None:
                sock.close()
            raise

    def __len__(self) -> int:
        """Step count of this shard's plan (probe handshake, cached)."""
        if self._num_steps is None:
            sock, _ = self._connect(0, probe=True)
            sock.close()
        return int(self._num_steps)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle parity with ``MapStylePipeline.set_epoch`` — the next
        ``__iter__`` requests the new epoch's plan (step count may differ
        only through the plan cache, so invalidate it)."""
        if epoch != self.epoch:
            # Epoch rollover runs between epochs, while no receiver
            # thread is live — happens-before the next __iter__ spawn.
            self.epoch = epoch  # ldt: ignore[LDT1002] -- set while quiescent, before __iter__ spawns the receiver
            self._num_steps = None  # ldt: ignore[LDT1002] -- set while quiescent, before __iter__ spawns the receiver
            # A new epoch's plan starts at its own step 0.
            self._start_step = 0  # ldt: ignore[LDT1002] -- set while quiescent, before __iter__ spawns the receiver
            self._yielded = 0

    def _release(self, batch) -> None:
        if self.buffer_pool is not None:
            self.buffer_pool.release_batch(batch)

    # -- iteration ---------------------------------------------------------

    def _receive(self, q: "queue.Queue", stop: threading.Event) -> None:
        """Receiver thread: stream frames into the bounded queue, ACK each
        received step, reconnect at the cursor on connection loss."""
        # Resume cursor: first step not yet enqueued. Starts at the loaded
        # checkpoint cursor (0 on a fresh epoch) — a restarted trainer's
        # first HELLO asks for exactly the next unconsumed step, the same
        # server-side plan slice mid-epoch reconnects use.
        next_step = self._start_step
        sock: Optional[socket.socket] = None
        try:
            sock, _ = self._connect(next_step, stop=stop)
            self._publish_conn(sock)
            # Reusable receive buffer (FrameReader): every frame recv_into's
            # the same pages; decode_batch copies out (into pool leases)
            # before the next receive reuses them.
            reader = P.FrameReader(sock)
            while not stop.is_set():
                try:
                    msg_type, payload = reader.recv_msg()
                except (ConnectionError, OSError) as exc:
                    if stop.is_set():
                        return
                    # Mid-epoch drop: resume at the cursor. The already-
                    # enqueued steps [0, next_step) are safe in q, so the
                    # stream stays exactly-once end to end.
                    self.counters.add("reconnects")
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock, _ = self._connect(next_step, stop=stop)
                    self._publish_conn(sock)
                    reader = P.FrameReader(sock)
                    continue
                if msg_type == P.MSG_BATCH:
                    # Arrival stamp BEFORE deserialisation: wire_ms must
                    # measure send→arrival, not send→decoded — on large
                    # frames the frombuffer copies cost real ms and would
                    # misattribute CPU time to the network.
                    recv_ns = time.time_ns()
                    with span("client.decode", step=next_step) as sp_attrs:
                        step, batch, lineage, trace = P.decode_batch(
                            payload["raw"], with_lineage=True,
                            with_trace=True, pool=self.buffer_pool,
                        )
                        # Continue the server's causal chain (v5): this
                        # receive hop becomes a CHILD of the remote send
                        # span, so `ldt trace export` can draw the real
                        # parent edge across processes.
                        trace = coerce_trace(trace)
                        if trace is not None:
                            hop = child(trace)
                            sp_attrs.update(
                                trace_id=hop["trace_id"],
                                trace_parent=hop["parent_span_id"],
                                trace_span=hop["span_id"],
                            )
                            self.last_trace = hop
                    if step != next_step:
                        raise P.ProtocolError(
                            f"out-of-order step {step}, expected {next_step}"
                        )
                    # Close the lineage loop: batch_age_ms (creation→here),
                    # wire_ms (send→here), queue_wait/decode passthrough —
                    # lineage_* histograms per received batch. None (a v1
                    # server, or lineage gated off) is interop, not error.
                    observed = observe_wire_lineage(
                        self.registry, lineage, recv_ns
                    )
                    if observed is not None:
                        self.last_lineage = observed
                        self.recent_lineage.append(observed)
                    next_step += 1
                    try:
                        P.send_msg(sock, P.MSG_ACK, {"step": step})
                    except (ConnectionError, OSError):
                        pass  # the next recv sees the drop and reconnects
                    self.counters.add("batches_received")
                    t0 = time.perf_counter()
                    q.put(batch)
                    # Receiver blocked = trainer slower than the service.
                    self.counters.add(
                        "recv_backpressure_s", time.perf_counter() - t0
                    )
                elif msg_type == P.MSG_END:
                    q.put(_SENTINEL)
                    return
                elif msg_type == P.MSG_ERROR:
                    raise RuntimeError(
                        f"data service error: {payload.get('message')}"
                    )
                else:
                    raise P.ProtocolError(f"unexpected message {msg_type}")
        except BaseException as exc:  # surface to the consumer
            q.put(exc)
        finally:
            self._publish_conn(None)
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = AdjustableQueue(self.prefetch)
        self._live.install([q])
        stop = threading.Event()
        receiver = threading.Thread(
            target=self._receive, args=(q, stop), daemon=True,
            name="ldt-remote-loader",
        )
        receiver.start()
        self._yielded = self._start_step
        place = _placer(self.device, self.buffer_pool)
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                # Consumer blocked on an empty queue: the wire (or the
                # service's decode) is the bottleneck — the client-side
                # stall the progress lines attribute via attach_counters.
                self.counters.add("client_stall_s", time.perf_counter() - t0)
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                self._yielded += 1
                host = item
                if place is not None:
                    # The copy's event returns the pages to the pool: a
                    # page-locked page recycles only after the copy that
                    # reads it has run.
                    item = place(host)
                    host = None
                yield item
                if host is not None:
                    # Host-batch consumers: release after their turn.
                    self._release(host)
        finally:
            stop.set()
            self._live.clear()
            # recv_msg may be blocked on a healthy-but-idle socket;
            # closing it unblocks the receiver thread immediately.
            self._close_conn()
            while receiver.is_alive():
                try:
                    # Drained items are undelivered host batches — return
                    # their pool leases on the way out.
                    self._release(q.get_nowait())
                except queue.Empty:
                    receiver.join(timeout=0.1)
