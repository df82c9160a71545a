"""``FleetLoader`` — one trainer shard striped across N data servers.

A copy of ``lance_distributed_training_tpu/fleet/balancer.py`` for the
port, placing as the port's ``RemoteLoader`` does (``device`` in place of
JAX's ``device_put_fn``).

Drop-in replacement for :class:`~..service.client.RemoteLoader` that takes a
*coordinator* address instead of a server address: it resolves the live
membership, takes THIS training process's deterministic slice of it
(:func:`members_for_process` — fleet stripes map onto
the process's rank, so each host fetches exactly its shard of the
global batch and no server ships redundant bytes to two hosts), opens one
protocol-v3 stream per assigned member with ``stripe_index/stripe_count``
HELLOs (member ``i`` of ``n`` serves exactly the plan steps ``s % n == i``),
and merges the streams back into plan order — so the yielded batch sequence
is **bit-identical** to a single ``RemoteLoader`` against one server, while
decode bandwidth scales with the fleet.

Failover model (the reason this class exists): the merge loop owns a single
global cursor — the first step not yet handed to the consumer. When any
stripe's connection dies (server crash, network cut), the whole round is
torn down (buffered-but-unyielded batches released back to the pool),
membership is re-resolved with the dead address excluded, and a fresh set
of stripes is opened with ``start_step = cursor`` over the survivors. Every
step below the cursor was already delivered exactly once; every step at or
above it is served exactly once by the new striping — no loss, no
duplication, the ``RemoteLoader`` contract preserved across server loss.

A *stall* is not a failure: mid-stream receives carry no deadline (same
policy as ``RemoteLoader`` — a slow decode must not be misread as a dead
peer), so a stalled server just holds its stripe's consumer until TCP or a
real disconnect says otherwise.

Coordinator loss degrades discovery, not the stream in flight: resolution
is only needed at iteration start and at failover, and both retry with
backoff.
"""

from __future__ import annotations

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
from ..service import protocol as P
from ..service.client import _placer

__all__ = ["FleetLoader", "members_for_process", "resolve_fleet"]


def resolve_fleet(coordinator_addr: str, timeout_s: float = 10.0,
                  job_id: Optional[str] = None,
                  job_priority: Optional[str] = None) -> dict:
    """One RESOLVE round-trip: the coordinator's membership payload —
    generation, stripe table, per-member heartbeat-reported pressure,
    per-job registry rows, and the scale recommendation. Shared by
    :class:`FleetLoader`, ``ldt fleet recommend`` and ``ldt jobs`` (the
    operator's views of the same answer). ``job_id``/``job_priority``
    ride the RESOLVE request (v6: they declare the caller's job to the
    coordinator's registry; null = undeclared, and pre-v6 coordinators
    ignore unknown fields, so the declaration is downgrade-safe by
    construction)."""
    host, port = P.parse_hostport(coordinator_addr)
    timeout_s = min(float(timeout_s), 10.0)
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        P.send_msg(sock, P.MSG_FLEET_RESOLVE, {
            "job_id": job_id,
            "job_priority": job_priority,
        })
        msg_type, reply = P.recv_msg(
            sock, deadline=time.monotonic() + timeout_s
        )
    if msg_type != P.MSG_FLEET_RESOLVE_OK:
        raise P.ProtocolError(
            f"coordinator answered message type {msg_type}: "
            f"{reply.get('message', '')}"
        )
    return reply

_SENTINEL = object()
_STRIPE_END = object()


def members_for_process(members: list, process_index: int,
                        process_count: int) -> list:
    """Deterministic, disjoint member→training-process assignment.

    Multi-host training used to have every training process stripe over the
    WHOLE fleet: with P hosts and N servers, each server decoded and
    shipped P different shards' stripes — P× the connections and redundant
    wire bytes per member. Instead, process ``p`` of ``P`` takes a
    contiguous balanced slice of the ``server_id``-sorted member list, so
    each host fetches exactly its shard of the global batch from its own
    members and no server serves two hosts (when ``len(members) >= P``).

    Properties (pinned by ``tests/test_placement.py``): deterministic in
    the sorted member order; slices are disjoint and cover every member;
    sizes differ by at most one. With fewer members than processes the
    fleet cannot be partitioned — processes then share members round-robin
    (correctness holds: each process still requests only its own shard's
    plan in the HELLO, a shared member just serves two plans).
    """
    n = len(members)
    if n == 0 or process_count <= 1:
        return list(members)
    if n < process_count:
        return [members[process_index % n]]
    base, extra = divmod(n, process_count)
    start = process_index * base + min(process_index, extra)
    stop = start + base + (1 if process_index < extra else 0)
    return list(members[start:stop])


class _StripeFailure(Exception):
    """A member's data stream failed (connect or mid-stream) — the signal
    that triggers a failover round, never surfaced to the consumer."""

    def __init__(self, addr: str, cause: Exception):
        super().__init__(f"{addr}: {cause}")
        self.addr = addr
        self.cause = cause


class _StripeRound:
    """One striping of the plan's remaining steps over a member list.

    Owns one socket + pump thread + bounded queue per member; the merge
    loop (:meth:`next_batch`) pops step ``s`` from queue ``s % n``. Lives
    until the plan completes, a stripe fails, or the loader closes.
    """

    def __init__(self, loader: "FleetLoader", members: list, cursor: int,
                 stop: threading.Event):
        self.loader = loader
        self.members = members
        self.cursor = cursor
        self.stop = stop
        self.count = len(members)
        self.queues = [
            queue.Queue(maxsize=max(1, loader.stripe_queue_depth))
            for _ in members
        ]
        self.threads: list = []
        self.socks: list = []
        self.failed = threading.Event()
        # Published BEFORE failed.set(); consumers read it only after
        # failed.is_set() — the Event's set/is_set pair orders the write
        # against every read (the same handoff discipline LDT1002 wants).
        self.failed_addr: Optional[str] = None
        self.closed = threading.Event()  # teardown flag: close() → pumps

    def connect(self) -> None:
        """Dial every member's stripe. Raises :class:`_StripeFailure` (all
        opened sockets closed) when any member is unreachable — the caller
        excludes that address and re-stripes."""
        for i, member in enumerate(self.members):
            try:
                sock = self.loader._dial_member(
                    member["addr"], self.cursor, i, self.count, self.stop
                )
            except (ConnectionError, OSError) as exc:
                self.close()
                raise _StripeFailure(member["addr"], exc)
            self.socks.append(sock)
        for i, (member, sock) in enumerate(zip(self.members, self.socks)):
            t = threading.Thread(
                target=self._pump, args=(i, member["addr"], sock),
                daemon=True, name=f"ldt-fleet-stripe-{i}",
            )
            t.start()
            self.threads.append(t)

    def _fail(self, addr: str) -> None:
        if not self.failed.is_set():
            self.failed_addr = addr  # ldt: ignore[LDT1002] -- published before failed.set(); readers gate on is_set(), so the Event orders this write
            self.failed.set()

    def _pump(self, i: int, addr: str, sock: socket.socket) -> None:
        """Receiver thread for stripe ``i``: frames → bounded queue, ACK
        each step. A connection error marks the round failed (failover); a
        protocol/server error is fatal and rides the queue to the merge
        loop."""
        loader = self.loader
        # First step of this stripe at or above the round's cursor.
        expected = self.cursor + (i - self.cursor) % self.count
        reader = P.FrameReader(sock)
        try:
            while not self.stop.is_set():
                try:
                    msg_type, payload = reader.recv_msg()
                except (ConnectionError, OSError) as exc:
                    if not (self.closed.is_set() or self.stop.is_set()):
                        self._fail(addr)
                    return
                if msg_type == P.MSG_BATCH:
                    recv_ns = time.time_ns()
                    with span("fleet.recv", step=expected,
                              stripe=i) as sp_attrs:
                        step, batch, lineage, trace = P.decode_batch(
                            payload["raw"], with_lineage=True,
                            with_trace=True, pool=loader.buffer_pool,
                        )
                        # Continue the member's causal chain (v5) — same
                        # child-hop stamping as RemoteLoader, so a merged
                        # export draws the member→merge parent edge.
                        trace = coerce_trace(trace)
                        if trace is not None:
                            hop = child(trace)
                            sp_attrs.update(
                                trace_id=hop["trace_id"],
                                trace_parent=hop["parent_span_id"],
                                trace_span=hop["span_id"],
                            )
                            loader.last_trace = hop
                    if step != expected:
                        raise P.ProtocolError(
                            f"stripe {i}/{self.count}: out-of-order step "
                            f"{step}, expected {expected}"
                        )
                    observed = observe_wire_lineage(
                        loader.registry, lineage, recv_ns
                    )
                    if observed is not None:
                        loader.last_lineage = observed
                        loader.recent_lineage.append(observed)
                    expected += self.count
                    try:
                        P.send_msg(sock, P.MSG_ACK, {"step": step})
                    except (ConnectionError, OSError):
                        pass  # the next recv sees the drop
                    loader.counters.add("batches_received")
                    t0 = time.perf_counter()
                    self._put(i, (step, batch))
                    loader.counters.add(
                        "recv_backpressure_s", time.perf_counter() - t0
                    )
                elif msg_type == P.MSG_END:
                    self._put(i, _STRIPE_END)
                    return
                elif msg_type == P.MSG_ERROR:
                    raise RuntimeError(
                        f"data server {addr}: {payload.get('message')}"
                    )
                else:
                    raise P.ProtocolError(f"unexpected message {msg_type}")
        except BaseException as exc:  # fatal: surface through the merge loop
            self._put(i, exc)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _put(self, i: int, item) -> None:
        """Bounded put that a close() can always unblock (the queue is
        drained on teardown, so a blocked pump exits within one timeout)."""
        while not (self.closed.is_set() or self.stop.is_set()):
            try:
                self.queues[i].put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def next_batch(self, step: int):
        """Blocking pop of ``step`` from its owner stripe. Returns the host
        batch, raises :class:`_StripeFailure` on a member loss, re-raises
        fatal pump errors, and returns ``None`` when the loader closed."""
        q = self.queues[step % self.count]
        while not self.stop.is_set():
            try:
                item = q.get(timeout=0.25)
            except queue.Empty:
                if self.failed.is_set():
                    raise _StripeFailure(
                        self.failed_addr or "?",
                        ConnectionError("stripe connection lost"),
                    )
                continue
            if item is _STRIPE_END:
                # The owner of an unserved step ended early: the server's
                # plan disagrees with ours — fatal, not a failover.
                raise P.ProtocolError(
                    f"stripe ended before step {step} was served"
                )
            if isinstance(item, _StripeFailure):
                raise item
            if isinstance(item, BaseException):
                raise item
            got, batch = item
            if got != step:
                raise P.ProtocolError(
                    f"merge expected step {step}, stripe delivered {got}"
                )
            return batch
        return None

    def close(self) -> None:
        """Tear the round down and RELEASE every buffered-but-unyielded
        batch's pool leases (a failover drops up to
        ``n * stripe_queue_depth`` decoded batches — they must go back to
        the pool, not strand)."""
        self.closed.set()
        for sock in self.socks:
            try:
                # shutdown BEFORE close: a pump blocked in recv holds the
                # last kernel reference, so a bare close() would neither
                # wake it nor send FIN — the same fd-close-vs-blocked-recv
                # trap _ClientSession.close() documents server-side.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for q, t in zip(self.queues, self.threads):
            while t.is_alive():
                try:
                    self._release_item(q.get_nowait())
                except queue.Empty:
                    t.join(timeout=0.1)
        for q in self.queues:  # pumps gone: drain the leftovers
            while True:
                try:
                    self._release_item(q.get_nowait())
                except queue.Empty:
                    break

    def _release_item(self, item) -> None:
        if isinstance(item, tuple) and len(item) == 2:
            self.loader._release(item[1])


class FleetLoader:
    """Iterate device-ready batches served by a fleet of data servers.

    Parameters mirror :class:`~..service.client.RemoteLoader` where they
    overlap; ``coordinator_addr`` replaces the single server address.

    Since r16 this class is the runtime engine beneath a
    :class:`~..data.graph.LoaderGraph` assembly (``LanceSource → Decode →
    ... → FleetTransport``) — prefer composing the graph.
    """

    def __init__(
        self,
        coordinator_addr: str,
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
        connect_retries: int = 3,
        resolve_retries: int = 10,
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
        stripe_queue_depth: int = 2,
        exclusion_ttl_s: float = 10.0,
    ):
        self.coordinator_host, self.coordinator_port = P.parse_hostport(
            coordinator_addr
        )
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
        self.connect_retries = max(1, connect_retries)
        self.resolve_retries = max(1, resolve_retries)
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.task_type = task_type
        self.image_size = image_size
        self.seq_len = seq_len
        self.device_decode = device_decode
        # Ragged token plane (v4+): like striping, packing is not
        # downgrade-safe — every dialed member must speak
        # TOKEN_PACK_MIN_VERSION (checked next to the stripe floor).
        self.token_pack = token_pack
        # Declared dataset identity (see RemoteLoader): every member of
        # the fleet must serve the SAME dataset content — a stale-mirror
        # member is rejected at its handshake, not silently striped in.
        self.dataset_fingerprint = dataset_fingerprint
        # Job plane (v6): declared tenancy, carried on every member HELLO
        # and on RESOLVE (the coordinator's registry learns the job even
        # before any member admits it). An EXPLICIT job_id shares
        # striping's no-downgrade rule — every member must speak
        # JOB_MIN_VERSION (checked next to the stripe floor); None = the
        # implicit default job, fine against any member.
        self.job_id = job_id
        self.job_priority = job_priority
        self.registry = registry if registry is not None else default_registry()
        self.counters = ServiceCounters(prefix="fleet", registry=self.registry)
        self.buffer_pool = buffer_pool
        self.stripe_queue_depth = stripe_queue_depth
        self.exclusion_ttl_s = exclusion_ttl_s
        self.recent_lineage: deque = deque(maxlen=1024)
        self.last_lineage: Optional[dict] = None
        # Last batch's continued trace context (v5), as in RemoteLoader.
        self.last_trace: Optional[dict] = None
        self.client_id = uuid.uuid4().hex
        self.generation: int = 0  # last resolved lease generation
        self._num_steps: Optional[int] = None
        # addr -> monotonic deadline: members excluded from striping after a
        # failure, until the TTL lapses (a recovered server rejoins rounds).
        self._excluded: dict = {}
        # Resume cursor (contract: data/pipeline.py): the merge loop's
        # global cursor starts here — the same mechanism failover restriping
        # uses, so a checkpoint resume IS a restripe from the saved step.
        self._start_step = 0
        self._yielded = 0
        # Autotune surface (tune/): live merge-queue bound + stripe width.
        self._live = _LiveQueues()
        # 0 = stripe over every assigned member (the fixed-knob default,
        # unchanged behavior); >0 caps the round at the first N of THIS
        # process's member slice. Width changes apply at the next round
        # boundary — _restripe asks the orchestrator to end the current
        # round at the cursor, the exact move failover already makes, so
        # the stream stays bit-identical through a re-stripe.
        self.stripe_width = 0
        self._last_round_width = 1
        # This process's assigned membership size at the last round open
        # (pre-cap; 0 = no round yet): the effective-width ceiling a width
        # change is judged against, so growing past live membership never
        # churns a round it cannot change.
        self._last_assigned = 0
        self._restripe = threading.Event()

    def set_prefetch(self, depth: int) -> int:
        """Autotune actuator: the merged-stream prefetch bound, live."""
        depth = max(1, int(depth))
        self.prefetch = depth  # ldt: ignore[LDT1002] -- atomic int swap; readers take any recent value
        self._live.resize_total(depth)
        return depth

    def set_stripe_width(self, width: int) -> int:
        """Autotune actuator: re-stripe the plan over ``width`` members.
        Signals the orchestrator to end the current round at its cursor and
        open a fresh striping — the same cursor-preserving move failover
        makes, so no step is lost, duplicated, or reordered. The effective
        width is capped by live membership at round-open time, and a change
        that cannot alter the effective count (growing past the members
        this process has) records the request WITHOUT churning the round —
        ending a healthy merge early buys nothing."""
        width = max(1, int(width))
        assigned = self._last_assigned
        old = self.stripe_width or assigned or self._last_round_width
        self.stripe_width = width  # ldt: ignore[LDT1002] -- atomic int swap read at round-open
        if assigned:
            old = min(old, assigned)
            width = min(width, assigned)
        if width != old:
            self._restripe.set()
        return self.stripe_width

    def tunables(self):
        """Autotune registration surface (tune/)."""
        return [
            Tunable(
                "prefetch", lambda: self.prefetch, self.set_prefetch,
                lo=1, hi=16,
                doc="merged host batches buffered ahead of the consumer",
            ),
            Tunable(
                "stripe_width",
                lambda: self.stripe_width or self._last_round_width,
                self.set_stripe_width,
                lo=1, hi=32,
                doc="fleet members this shard's plan stripes across",
            ),
        ]

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

    # -- coordinator --------------------------------------------------------

    def _resolve_once(self) -> dict:
        # Re-bracket IPv6 for the shared parser (parse_hostport rejects a
        # bare "::1:port" as ambiguous, by design).
        host = self.coordinator_host
        if ":" in host:
            host = f"[{host}]"
        # Declare the job at resolve time: the registry row (priority,
        # cursor) exists even while no member session is admitted yet.
        return resolve_fleet(
            f"{host}:{self.coordinator_port}", timeout_s=self.timeout_s,
            job_id=self.job_id, job_priority=self.job_priority,
        )

    def _resolve_members(
        self, stop: Optional[threading.Event] = None,
    ) -> list:
        """Membership with retry/backoff (an empty fleet keeps retrying —
        members may still be booting). Returns THIS process's slice of the
        member list sorted by ``server_id`` (:func:`members_for_process` —
        every training host stripes over its own disjoint members, so no
        server ships redundant bytes to two hosts), with recently-failed
        addresses excluded — unless exclusion would empty the slice, in
        which case the exclusions are dropped (a possibly-recovered server
        beats certain starvation)."""
        last: Optional[Exception] = None
        policy = RetryPolicy(
            attempts=self.resolve_retries, base_s=self.backoff_s, cap_s=2.0
        )
        for _attempt in retrying(
            policy, stop=stop, registry=self.registry,
            interrupt_message="loader closed during resolve",
        ):
            try:
                reply = self._resolve_once()
            except (ConnectionError, OSError, P.ProtocolError) as exc:
                last = exc
                self.counters.add("resolve_errors")
                continue
            self.counters.add("resolves")
            self.generation = int(reply.get("generation", 0))
            self.counters.gauge("lease_generation", self.generation)
            members = sorted(
                reply.get("members", []),
                key=lambda m: str(m.get("server_id", "")),
            )
            self.counters.gauge("members", len(members))
            # Slice BEFORE exclusion: the process→member mapping must
            # stay stable across failover rounds (an exclusion on host
            # A must not shift host B's stripes onto new servers).
            mine = members_for_process(
                members, self.process_index, self.process_count
            )
            self.counters.gauge("members_assigned", len(mine))
            now = time.monotonic()
            self._excluded = {
                a: t for a, t in self._excluded.items() if t > now
            }
            live = [
                m for m in mine
                if m.get("addr") not in self._excluded
            ]
            if not live:
                live = mine  # all excluded: try everyone again
            if live:
                return live
            last = ConnectionError("fleet has no registered members")
        raise ConnectionError(
            f"fleet coordinator {self.coordinator_host}:"
            f"{self.coordinator_port}: no usable membership after "
            f"{self.resolve_retries} attempts: {last}"
        ) from last

    # -- data servers -------------------------------------------------------

    def _hello(self, start_step: int, stripe_index: int, stripe_count: int,
               probe: bool = False) -> dict:
        return P.hello(
            batch_size=self.batch_size,
            process_index=self.process_index,
            process_count=self.process_count,
            sampler_type=self.sampler_type,
            shuffle=self.shuffle,
            seed=self.seed,
            epoch=self.epoch,
            start_step=start_step,
            stripe_index=stripe_index,
            stripe_count=stripe_count,
            columns=self.columns,
            client_id=self.client_id,
            probe=probe,
            task_type=self.task_type,
            image_size=self.image_size,
            seq_len=self.seq_len,
            device_decode=self.device_decode,
            token_pack=self.token_pack,
            dataset_fingerprint=self.dataset_fingerprint,
            job_id=self.job_id,
            job_priority=self.job_priority,
        )

    def _dial_member(self, addr: str, start_step: int, stripe_index: int,
                     stripe_count: int, stop: Optional[threading.Event],
                     probe: bool = False):
        """Dial + v3 handshake with one member. ConnectionError after the
        quick per-member retries means *this member* is down (failover
        material); a handshake rejection is fatal — a fleet whose servers
        reject our plan parameters cannot be failed over to."""
        host, port = P.parse_hostport(addr)
        last: Optional[Exception] = None
        policy = RetryPolicy(
            attempts=self.connect_retries, base_s=self.backoff_s, cap_s=2.0
        )
        for _attempt in retrying(
            policy, stop=stop, registry=self.registry,
            interrupt_message="loader closed during connect",
        ):
            try:
                sock = socket.create_connection(
                    (host, port), timeout=min(self.timeout_s, 10.0)
                )
                try:
                    sock.settimeout(self.timeout_s)  # handshake recv bound
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
                    P.send_msg(sock, P.MSG_HELLO, self._hello(
                        start_step, stripe_index, stripe_count, probe
                    ))
                    msg_type, reply = P.recv_msg(sock)
                    if msg_type == P.MSG_ERROR:
                        raise P.ProtocolError(
                            f"data server {addr} rejected handshake: "
                            f"{reply.get('message', '')}"
                        )
                    if msg_type != P.MSG_HELLO_OK:
                        raise P.ProtocolError(
                            f"expected HELLO_OK, got message type {msg_type}"
                        )
                    # Striping is NOT downgrade-safe: a pre-v3 server would
                    # ignore the stripe fields and serve EVERY step — silent
                    # duplication across the fleet. Unlike RemoteLoader there
                    # is no version-downgrade retry here, by design.
                    if int(reply.get("version", 0)) < P.STRIPE_MIN_VERSION:
                        raise P.ProtocolError(
                            f"data server {addr} speaks protocol "
                            f"{reply.get('version')} < "
                            f"{P.STRIPE_MIN_VERSION} "
                            "(no stripe support) — upgrade it before "
                            "fleeting"
                        )
                    # Packing shares striping's no-downgrade rule: a
                    # member that cannot speak the ragged plane would
                    # silently stripe PADDED rows into a packed stream.
                    if self.token_pack and int(
                        reply.get("version", 0)
                    ) < P.TOKEN_PACK_MIN_VERSION:
                        raise P.ProtocolError(
                            f"data server {addr} speaks protocol "
                            f"{reply.get('version')} < "
                            f"{P.TOKEN_PACK_MIN_VERSION} (no token_pack "
                            "support) — upgrade it or train with "
                            "--no_token_pack"
                        )
                    # An explicit job shares the same no-downgrade rule: a
                    # pre-v6 member would drop the job fields and stripe
                    # this stream under the anonymous default tenant — no
                    # per-job cursor, fairness or admission — while the
                    # trainer believes its job_id took effect fleet-wide.
                    if self.job_id is not None and int(
                        reply.get("version", 0)
                    ) < P.JOB_MIN_VERSION:
                        raise P.ProtocolError(
                            f"data server {addr} speaks protocol "
                            f"{reply.get('version')} < "
                            f"{P.JOB_MIN_VERSION} (no job plane) — "
                            "upgrade it or drop the explicit job_id "
                            f"{self.job_id!r}"
                        )
                    # Stripe-echo check: the HELLO_OK carries back the
                    # residue class the server will actually serve. A
                    # server that accepted the handshake but mis-parsed,
                    # DROPPED, or ignored the stripe fields would stream
                    # the wrong class — duplicated steps on one stripe,
                    # holes on another — with every frame individually
                    # valid. The echo is REQUIRED (every v3 server has
                    # sent it since striping existed): defaulting a
                    # missing echo to the requested values would pass the
                    # exact server this check exists to catch. Fatal like
                    # the version floor above: a fleet serving wrong
                    # residue classes cannot be failed over to.
                    echoed = (
                        reply.get("stripe_index"),
                        reply.get("stripe_count"),
                    )
                    if not all(
                        P.is_json_int(e) and e == want
                        for e, want in zip(
                            echoed, (stripe_index, stripe_count)
                        )
                    ):
                        raise P.ProtocolError(
                            f"data server {addr} echoed stripe "
                            f"{echoed[0]!r}/{echoed[1]!r}, requested "
                            f"{stripe_index}/{stripe_count} — it would "
                            "serve the wrong residue class"
                        )
                    # Job-echo check (the RemoteLoader posture): a v6
                    # member echoes the admitted job_id; disagreement
                    # means this stripe was filed under another tenant.
                    if self.job_id is not None and "job_id" in reply \
                            and reply.get("job_id") != self.job_id:
                        raise P.ProtocolError(
                            f"data server {addr} echoed job_id "
                            f"{reply.get('job_id')!r}, declared "
                            f"{self.job_id!r} — tenancy desync"
                        )
                    self._num_steps = int(reply["num_steps"])  # ldt: ignore[LDT1002] -- idempotent plan-length cache: every writer stores the same value for a given epoch
                    sock.settimeout(None)  # streaming: no recv deadline
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE,
                                    1)
                    return sock
                except BaseException:
                    # EVERY failure after the dial closes the socket here —
                    # the previous typed handlers (ProtocolError,
                    # ConnectionError/OSError) let a malformed reply
                    # (KeyError/ValueError) escape with the fd open
                    # (LDT1201's exception-edge leak).
                    sock.close()
                    raise
            except (ConnectionError, OSError) as exc:
                last = exc
                self.counters.add("connect_retries")
        raise ConnectionError(
            f"data server {addr} unreachable after "
            f"{self.connect_retries} attempts: {last}"
        ) from last

    # -- plan metadata ------------------------------------------------------

    def __len__(self) -> int:
        """Step count of this shard's plan (probe handshake against any
        live member, cached)."""
        if self._num_steps is None:
            members = self._resolve_members()
            last: Optional[Exception] = None
            for m in members:
                try:
                    sock = self._dial_member(
                        m["addr"], 0, 0, 1, None, probe=True
                    )
                    sock.close()
                    break
                except (ConnectionError, OSError) as exc:
                    last = exc
            else:
                raise ConnectionError(
                    f"no fleet member reachable for probe: {last}"
                ) from last
        return int(self._num_steps)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle parity with ``RemoteLoader.set_epoch``."""
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

    # -- iteration ----------------------------------------------------------

    def _receive(self, q: "queue.Queue", stop: threading.Event) -> None:
        """Orchestrator thread: stripe rounds → merged plan-order stream
        into the bounded queue, restriping from the cursor on member loss."""
        # First step not yet handed to the consumer. Starts at the loaded
        # checkpoint cursor: resume after a trainer restart is the same
        # restripe-from-cursor move failover already makes mid-run.
        cursor = self._start_step
        try:
            if self._num_steps is None:
                self.__len__()  # probe via any member (retries inside)
            num_steps = int(self._num_steps)
            while cursor < num_steps and not stop.is_set():
                members = self._resolve_members(stop)
                # Autotune stripe width: cap the round at the first N of
                # this process's slice (0 = all, the fixed-knob default).
                # Clearing the restripe flag here (not when it is noticed)
                # makes a width change that lands mid-round-open coalesce
                # into the round it is about to shape.
                self._restripe.clear()
                self._last_assigned = len(members)  # ldt: ignore[LDT1002] -- advisory ceiling for set_stripe_width; torn reads impossible for an int
                width = self.stripe_width
                if width and width < len(members):
                    members = members[:width]
                self._last_round_width = len(members)  # ldt: ignore[LDT1002] -- advisory gauge for the tunable getter; torn reads impossible for an int
                t0 = time.perf_counter()
                rnd = _StripeRound(self, members, cursor, stop)
                try:
                    rnd.connect()
                except _StripeFailure as f:
                    self._failover(f, cursor)
                    continue
                self.counters.gauge("stripes", rnd.count)
                if cursor > self._start_step:
                    # Failover restripe cost, dial-to-streaming. The initial
                    # stripe setup is not a REbalance and stays out.
                    self.counters.observe(
                        "rebalance_ms", (time.perf_counter() - t0) * 1e3
                    )
                try:
                    while cursor < num_steps and not stop.is_set():
                        if self._restripe.is_set():
                            # Width change: end this round at the cursor —
                            # the outer loop re-resolves and re-stripes from
                            # exactly here (failover's move, minus the
                            # exclusion), so the merged stream is unbroken.
                            self.counters.add("restripes")
                            break
                        batch = rnd.next_batch(cursor)
                        if batch is None:  # loader closed
                            return
                        q.put(batch)
                        cursor += 1
                except _StripeFailure as f:
                    self._failover(f, cursor)
                    continue  # the finally below tears the round down
                finally:
                    rnd.close()
            if cursor >= num_steps:
                q.put(_SENTINEL)
        except BaseException as exc:  # surface to the consumer
            q.put(exc)

    def _failover(self, failure: _StripeFailure, cursor: int) -> None:
        """A member was lost: exclude its address for a TTL (the next
        resolve stripes over the survivors) and count the event."""
        self._excluded[failure.addr] = (
            time.monotonic() + self.exclusion_ttl_s
        )
        self.counters.add("failovers_total")
        self.counters.gauge("resume_cursor", cursor)

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = AdjustableQueue(self.prefetch)
        self._live.install([q])
        stop = threading.Event()
        receiver = threading.Thread(
            target=self._receive, args=(q, stop), daemon=True,
            name="ldt-fleet-loader",
        )
        receiver.start()
        self._yielded = self._start_step
        place = _placer(self.device, self.buffer_pool)
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                # Consumer blocked on an empty queue: the fleet (wire or
                # decode) is the bottleneck — attributable via
                # StepTimer.attach_counters, same as RemoteLoader.
                self.counters.add("client_stall_s", time.perf_counter() - t0)
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                self._yielded += 1
                host = item
                if place is not None:
                    # Pages go back with the copy's event (see RemoteLoader).
                    item = place(host)
                    host = None
                yield item
                if host is not None:
                    self._release(host)
        finally:
            stop.set()
            self._live.clear()
            while receiver.is_alive():
                try:
                    # Drained items are undelivered host batches — return
                    # their pool leases on the way out.
                    drained = q.get_nowait()
                    if not (drained is _SENTINEL
                            or isinstance(drained, BaseException)):
                        self._release(drained)
                except queue.Empty:
                    receiver.join(timeout=0.1)
