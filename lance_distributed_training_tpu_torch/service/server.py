"""``DataService`` — the server half of the disaggregated input-data plane.

A copy of ``lance_distributed_training_tpu/service/server.py`` for the
port. A server is a host process and never touches a card: its page pool
is the unpinned one (page-locking would create a CUDA context), and
nothing it loads places a tensor.

The in-process pipeline (``data/pipeline.py``) confines decode parallelism
to the training host: a training host with a handful of cores caps
decode throughput no matter how many cards sit behind it. This service moves the
whole "read plan → decode → host batch" stage onto independently-scaled CPU
hosts (the tf.data-service disaggregation argument): a ``DataService``
process opens the columnar dataset by URI, builds the *same* epoch ``Plan``
the in-process pipeline builds (``data/samplers.py`` — so batches are
bit-identical to local training on the same seed), fans decode out over its
local :class:`~..data.workers.WorkerPool` (or the native decoder's thread
pool), and streams *per-client-shard, plan-ordered, device-ready host
batches* over TCP.

Robustness model (the r04/r05 outage history is the motivation):

* every client gets a **bounded queue** — one slow trainer never buffers
  unbounded memory server-side, and backpressure propagates to decode;
* clients ACK each received step; a client that reconnects resumes at
  ``last_acked + 1`` of the identical deterministic plan — no duplicated,
  no skipped step (the server is stateless across reconnects: the cursor
  lives in the HELLO);
* dataset reads retry with exponential backoff before the error frame is
  sent — a transient storage blip does not kill the epoch.

Run it with ``ldt serve-data --dataset_path … --port …`` on CPU hosts and
point trainers at it with ``--data_service host:port``.

Thread & queue policy (enforced by ``ldt check`` LDT201/LDT202/LDT203):
every thread is ``daemon=True`` — a hung decode or a dead peer must never
block interpreter exit — and every thread that can block on a bounded-queue
``put()`` is torn down by the drain-then-join pattern (pop until the stop
flag is observable, then ``join`` with a timeout). Per-client queues are
always bounded (``queue_depth``, clamped ≥ 1), which is what makes
backpressure propagate from a slow trainer back into decode instead of
buffering the remaining epoch server-side. Handshake receives carry a
deadline (``handshake_timeout_s``); streaming receives deliberately do not —
an idle-but-alive peer is normal mid-epoch, and close() unblocks them.
"""

from __future__ import annotations

import dataclasses
import queue
import socket
import threading
import time
from typing import Optional

from ..data.cache import item_fingerprint
from ..data.format import Dataset
from ..data.graph import LanceSource
from ..fleet.jobs import AdmissionRefused, JobPlane
from ..obs.costs import cost_context, default_ledger
from ..obs.lineage import make_lineage
from ..obs.spans import span
from ..obs.tracectx import make_trace
from ..utils.metrics import ServiceCounters
from . import protocol as P

__all__ = ["ServeConfig", "DataService", "serve"]


@dataclasses.dataclass
class ServeConfig:
    """Server-side knobs. Plan parameters (sampler, batch size, shard, seed,
    epoch) come from each client's handshake — the server is a decode plane,
    not a training-config owner."""

    dataset_path: str
    host: str = "0.0.0.0"
    port: int = 8476  # 0 = ephemeral (the bound port is DataService.port)
    task_type: str = "classification"  # selects the decode hook
    image_size: int = 224
    num_workers: int = 0  # >0: decode in N spawned worker processes
    shm_workers: bool = True  # worker batches ride shared-memory ring slots
    # (data/buffers.py) instead of being pickled across the IPC boundary;
    # False = legacy pickle transport (A/B control; auto-fallback when
    # POSIX shm is unavailable)
    sched_lookahead: int = 0  # >0: straggler-aware dispatch at the
    # worker-pool decode seam (data/schedule.py): dispatch reorders
    # predicted-heaviest-first within this many buffered plan items (cost
    # model warm-started from LDT_COST_PATH); yield order stays plan
    # order, so every client stream is bit-identical to the unscheduled
    # one. 0 = off; needs num_workers > 0 to have a dispatch to reorder.
    sched_heavy_share: int = 0  # percent of decode workers reserved as a
    # dedicated heavy lane for predicted stragglers (0 = single lane)
    buffer_pool: bool = True  # recycle decode/copy-out pages through the
    # process BufferPool (bufpool_* metrics show hit/miss on /metrics);
    # False = fault a fresh allocation per batch (the pre-r6 behavior)
    device_decode: bool = False  # serve half-decoded JPEG coefficient
    # pages (data/device_decode.py) instead of finished pixels: this host
    # does only the entropy half of decode and clients run the dense back
    # half as their device kernel K2 (ops/jpeg_device.py). Both sides
    # must agree — the HELLO's device_decode field is skew-checked like
    # task_type/image_size. Classification only.
    token_pack: bool = False  # ragged token plane (data/token_pack.py,
    # text tasks): serve variable-length token batches as values/offsets
    # pages + a deterministic pack plan; clients finish them with the
    # pack kernel K3 (ops/token_device.py). Per-SESSION negotiated:
    # a v4 client whose HELLO asks token_pack gets the ragged stream;
    # any other peer (v3, or a v4 padded client) gets the bit-identical
    # padded stream this server always served — so one packing server
    # keeps every old trainer working. A packing CLIENT against a
    # non-packing server is rejected at connect (skew), like device_decode.
    seq_len: int = 128  # padded sequence length for the text tasks (the
    # padded arm's static shape, and the default pack_len cap); must match
    # the trainer's --seq_len — decode config, like image_size
    pack_len: int = 0  # packed slot-length cap; 0 = seq_len
    pack_rows_multiple: int = 8  # packed row-count rounding quantum
    batch_cache: bool = False  # epoch-coherent decoded-batch cache
    # (data/cache.py): hits are served straight into the sender path — a
    # second epoch, a reconnected/restarted trainer, or a SECOND client
    # streaming the same plan skips fragment read + decode entirely.
    # Content-keyed (dataset fingerprint + decode config + plan item), so
    # sharing across clients can only add hits, never wrong bytes; the
    # stream stays bit-identical to the uncached path.
    cache_ram_budget_mb: int = 512  # RAM ring budget (BufferPool-leased
    # pages; evictions spill to disk, then release the leases)
    cache_disk_budget_mb: int = 2048  # local-disk spill budget (atomic
    # sha256-verified segment files; survives restarts)
    cache_dir: Optional[str] = None  # spill directory (default:
    # ~/.cache/<pkg>/batch-cache — stable, so restarts start warm)
    queue_depth: int = 4  # per-client bounded batch queue
    handshake_timeout_s: float = 30.0  # HELLO recv deadline per connection
    read_retries: int = 3  # dataset-read attempts before ERROR
    retry_backoff_s: float = 0.05  # doubles per attempt
    log_every_s: float = 0.0  # >0: periodic stats line to stdout
    metrics_port: Optional[int] = None  # serve /metrics (Prometheus text) +
    # /healthz on this port (0 = ephemeral, bound one on
    # DataService.metrics_port; None = exporter off)
    metrics_host: str = "127.0.0.1"  # exporter bind address; /healthz leaks
    # dataset paths + peer addresses unauthenticated, so non-loopback
    # (0.0.0.0 behind a scrape network) is an explicit opt-in
    coordinator_addr: Optional[str] = None  # host:port of a fleet
    # Coordinator (`ldt coordinator`): register on start, heartbeat on a
    # daemon thread, re-plan on lease changes, deregister on stop — this
    # server becomes one stripe of an elastic fleet (README "Fleet").
    # None = standalone single-server plane, exactly the pre-fleet behavior.
    advertise_addr: Optional[str] = None  # the address CLIENTS dial, as
    # registered with the coordinator. Defaults to host:bound-port, with a
    # wildcard host replaced by this machine's hostname — set it explicitly
    # whenever NAT/containers make the bind address undialable.
    server_id: Optional[str] = None  # stable fleet identity; default is
    # advertise_addr plus a random suffix (a restart is a new member)
    heartbeat_interval_s: float = 0.0  # 0 = use the coordinator-advertised
    # interval (CoordinatorConfig.heartbeat_interval_s)
    admission_max_jobs: int = 0  # job-plane admission cap (fleet/jobs.py):
    # at most this many non-read-only jobs admitted at once; a NEW job
    # beyond the cap gets a diagnosable ADMISSION_REFUSED_MARKER
    # MSG_ERROR. Read-only classes (inference probes) are exempt — the
    # cap protects bulk decode capacity. 0 = unlimited (the pre-r20
    # behavior: every tenant admitted).
    admission_max_stall_pct: float = 0.0  # refuse NEW jobs while this
    # server's windowed stall exceeds the ceiling — admitting another
    # tenant into a decode plane already starving its clients would
    # breach the stall SLO for every admitted job. Reconnects of
    # already-admitted jobs always succeed. 0 = gate off.


class _ClientSession:
    """One connected trainer shard: handshake → producer → sender."""

    def __init__(self, service: "DataService", sock: socket.socket,
                 peer: str):
        self.service = service
        self.sock = sock
        self.peer = peer
        self.alive = True
        self.last_acked = -1
        self.client_id = ""
        self.peer_version = P.PROTOCOL_VERSION  # refined by the HELLO
        # Job-plane identity (v6): resolved from the HELLO during the
        # handshake; pre-v6 peers (and undeclared v6 ones) land on the
        # implicit default job. _admitted flips once the plane accepted
        # the session, so close() releases exactly what admit() counted.
        self.job_id = ""
        self.job_priority = ""
        self._admitted = False
        # Session decode hook: the padded decoder until the handshake
        # negotiates the ragged stream (v4 + token_pack HELLO).
        self.decode_fn = service.decode_fn_padded
        # Clamp to >=1: maxsize=0 would mean UNBOUNDED, silently voiding the
        # backpressure guarantee (one stalled trainer buffering the whole
        # remaining epoch server-side).
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, service.config.queue_depth)
        )
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> None:
        """Handler-thread entry: handshake, then stream the plan."""
        svc = self.service
        try:
            # Handshake deadline: a peer that connects and never sends a
            # complete HELLO (port scanner, wedged client, byte-dripping
            # half-open connection) must not pin this handler thread
            # forever. The deadline bounds the WHOLE frame read (recv_msg
            # shrinks the socket timeout between chunks), then is cleared —
            # streaming recv (ACKs) has different semantics: an
            # idle-but-alive trainer is normal there (ldt check LDT203).
            timeout = svc.config.handshake_timeout_s
            deadline = time.monotonic() + timeout if timeout > 0 else None
            msg_type, req = P.recv_msg(self.sock, deadline=deadline)
            self.sock.settimeout(None)  # clear what _recv_exact left set
            if msg_type != P.MSG_HELLO:
                raise P.ProtocolError(
                    f"expected HELLO, got message type {msg_type}"
                )
            if not P.version_supported(req.get("version")):
                P.send_msg(
                    self.sock, P.MSG_ERROR,
                    {"message": (
                        f"{P.VERSION_MISMATCH_MARKER}: server supports "
                        f"{P.MIN_PROTOCOL_VERSION}..{P.PROTOCOL_VERSION}, "
                        f"client {req.get('version')}"
                    )},
                )
                return
            # Speak the intersection: v2 features (lineage meta) are gated
            # on the peer also being v2+.
            self.peer_version = min(
                int(req["version"]), P.PROTOCOL_VERSION
            )
            # Field-TYPE validation before anything coerces a value: a
            # malformed field (image_size="abc") must answer a skew-style
            # MSG_ERROR at connect time, not kill this handler with the
            # ValueError `int()` would raise inside decode_config_skew or
            # plan_for (the rejection a mixed-version or corrupted peer
            # can actually diagnose).
            bad = P.hello_malformed(req)
            if bad:
                svc.counters.add("proto_malformed_hello")
                P.send_msg(self.sock, P.MSG_ERROR, {"message": bad})
                return
            self.client_id = req.get("client_id", "")  # ldt: ignore[LDT1002] -- set during the handshake, before _stream spawns the ack reader that reads it; happens-before
            skew = svc.decode_config_skew(req)
            if skew:
                P.send_msg(self.sock, P.MSG_ERROR, {"message": skew})
                return
            # Ragged-stream negotiation (v4+): the token_pack request is
            # honoured only at TOKEN_PACK_MIN_VERSION or newer — an older
            # peer cannot have asked (the field is v4 vocabulary), and a
            # v4 peer that did not ask keeps the padded stream. The skew
            # check above already rejected a packing client against a
            # non-packing server.
            if (
                self.peer_version >= P.TOKEN_PACK_MIN_VERSION
                and bool(req.get("token_pack"))
            ):
                self.decode_fn = svc.decode_fn  # ldt: ignore[LDT1002] -- set during the handshake, before _stream spawns the producer that reads it; happens-before
            # Job plane (v6): resolve the declared tenant (absence → the
            # implicit default job, which is every pre-v6 peer) and ask
            # admission. A refusal is a diagnosable marker MSG_ERROR at
            # connect time — the tenancy sibling of the skew rejections
            # above, and the only gate that can say "come back later".
            self.job_id, self.job_priority = JobPlane.resolve(  # ldt: ignore[LDT1002] -- set during the handshake, before _stream spawns the threads that read them; happens-before
                req.get("job_id"), req.get("job_priority")
            )
            try:
                svc.job_plane.admit(
                    self.job_id, self.job_priority, self.peer
                )
            except AdmissionRefused as exc:
                P.send_msg(self.sock, P.MSG_ERROR, {"message": str(exc)})
                return
            self._admitted = True  # ldt: ignore[LDT1002] -- handshake-phase write, read by close(); happens-before
            plan = svc.plan_for(req)
            svc.job_plane.note_plan(self.job_id, (
                req["sampler_type"], int(req["batch_size"]),
                int(req["process_count"]), bool(req.get("shuffle")),
                int(req.get("seed", 0)), int(req.get("epoch", 0)),
            ))
            start = int(req.get("start_step", 0))
            if not 0 <= start <= len(plan):
                P.send_msg(
                    self.sock, P.MSG_ERROR,
                    {"message": (
                        f"start_step {start} outside plan of {len(plan)} "
                        "steps"
                    )},
                )
                return
            # Striping (v3+): serve only the residue class
            # step % stripe_count == stripe_index of [start, len(plan)) —
            # the fleet client's unit of spreading one shard over N
            # servers. Refused below STRIPE_MIN_VERSION: a client that
            # thinks it striped against a server that ignored the fields
            # would receive every step — silent fleet-wide duplication.
            stripe_count = int(req.get("stripe_count") or 1)
            stripe_index = int(req.get("stripe_index") or 0)
            if stripe_count < 1 or not 0 <= stripe_index < stripe_count:
                P.send_msg(
                    self.sock, P.MSG_ERROR,
                    {"message": (
                        f"invalid stripe {stripe_index} of {stripe_count}"
                    )},
                )
                return
            if (stripe_count > 1
                    and self.peer_version < P.STRIPE_MIN_VERSION):
                P.send_msg(
                    self.sock, P.MSG_ERROR,
                    {"message": (
                        "striping needs protocol >= "
                        f"{P.STRIPE_MIN_VERSION}, negotiated "
                        f"{self.peer_version}"
                    )},
                )
                return
            steps = [
                s for s in range(start, len(plan))
                if s % stripe_count == stripe_index
            ]
            self.last_acked = start - 1  # ldt: ignore[LDT1002] -- initialized before _stream spawns the ack-reader; happens-before
            # Echo the NEGOTIATED version, not this build's ceiling: a
            # vN+1 server answering a vN client must echo vN (what the
            # stream actually speaks), or the client's range check on
            # the echo rejects a connection the server just accepted.
            # num_steps is the FULL plan length — the stripe's share is
            # the client's arithmetic (it owns the merge).
            reply = {"version": self.peer_version, "num_steps": len(plan),
                     "start_step": start, "stripe_index": stripe_index,
                     "stripe_count": stripe_count}
            if "job_id" in req:
                # Echo the RESOLVED job only to a peer that spoke the job
                # vocabulary (a v6 HELLO always carries the key, null or
                # not) — pre-v6 replies stay byte-identical, and a
                # declaring client validates the echo like start_step.
                reply["job_id"] = self.job_id
            P.send_msg(self.sock, P.MSG_HELLO_OK, reply)
            if req.get("probe") or not steps:
                # Metadata-only connect (len(loader)), or a cursor/stripe
                # with nothing left to serve: confirm completion, no stream.
                if not req.get("probe"):
                    P.send_msg(self.sock, P.MSG_END, {})
                return
            if start > 0:
                svc.counters.add("resumes")
            self._stream(plan, steps, req)
        except (ConnectionError, OSError, P.ProtocolError) as exc:
            # Client vanished or spoke garbage — count it, move on. Quiet
            # when the session (or the whole service) is already tearing
            # down: the ack-reader noticing the drop makes the sender's
            # subsequent EPIPE expected cleanup, not an event — and the
            # stray print lands at unpredictable times from a daemon
            # thread (mid-shutdown, between tests).
            svc.counters.add("client_errors")
            if not (self._stop.is_set() or svc._stopped.is_set()):
                svc._log(f"client {self.peer}: {exc}")
        except Exception as exc:  # decode/plan errors: tell the client
            svc.counters.add("server_errors")
            svc._log(f"client {self.peer}: {exc!r}")
            try:
                P.send_msg(self.sock, P.MSG_ERROR, {"message": repr(exc)})
            except OSError:
                pass
        finally:
            self.close()

    def close(self) -> None:
        self.alive = False
        self._stop.set()
        try:
            # shutdown BEFORE close: with the ack-reader (or sender) still
            # blocked in a syscall on this fd, a bare close() only drops the
            # fd-table entry — the kernel keeps the struct file alive for
            # the blocked thread and never sends FIN, so the remote peer
            # waits forever (exactly the server-crash path fleet failover
            # must notice promptly). shutdown() signals the peer and wakes
            # the blocked thread regardless of outstanding references.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._admitted:
            # Idempotent (release() discards a set member): the session's
            # slot leaves the tenant table, but the job itself — cursor,
            # metric scope, priority class — survives for the reconnect.
            self.service.job_plane.release(self.job_id, self.peer)
        self.service._forget(self)

    # -- streaming ---------------------------------------------------------

    def _stream(self, plan, steps, req: dict) -> None:
        svc = self.service
        # Per-job metric scope (svc_job_<slug>_*): the tenant-resolved
        # twin of the service-wide counters this loop already feeds.
        jc = svc.job_plane.counters_for(self.job_id)
        producer = threading.Thread(
            target=self._produce, args=(plan, steps, req), daemon=True,
            name=f"ldt-svc-produce-{self.peer}",
        )
        producer.start()
        acker = threading.Thread(
            target=self._read_acks, daemon=True,
            name=f"ldt-svc-ack-{self.peer}",
        )
        acker.start()
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    # Bounded wait, not a bare get(): when the client drops
                    # with the queue empty, the producer exits on the stop
                    # flag WITHOUT enqueuing a sentinel — a blocking get
                    # would strand this thread (and its session) forever.
                    item = self._q.get(timeout=0.25)
                except queue.Empty:
                    waited = time.perf_counter() - t0
                    svc.counters.add("queue_empty_s", waited)
                    if jc is not None:
                        jc.add("queue_empty_s", waited)
                    continue
                # Sender idle = decode is the bottleneck for this client.
                waited = time.perf_counter() - t0
                svc.counters.add("queue_empty_s", waited)
                if jc is not None:
                    jc.add("queue_empty_s", waited)
                if item is None:  # producer finished the plan
                    P.send_msg(self.sock, P.MSG_END, {})
                    return
                if isinstance(item, BaseException):
                    raise item
                step, metas, views, batch, lineage, trace, enq_ns = item
                # Queue dwell = how long this client's consumption lagged
                # decode; stamped HERE (not in the producer) so the value
                # covers the whole wait and can still ride the frame.
                queue_wait_ms = (time.monotonic_ns() - enq_ns) / 1e6
                svc.counters.observe("queue_wait_ms", queue_wait_ms)
                # The body was serialised by the producer (overlapping this
                # thread's previous sendall); only the small meta is built
                # here so it can carry send-time stamps — nothing heavy
                # runs between sent_ns and the socket write, so encode CPU
                # never masquerades as wire latency (mirror of the client
                # stamping recv_ns before decode).
                # Fault injection (fleet/chaos.py): the hook runs IN this
                # send path so a scripted kill/stall lands on an exact
                # batch count — determinism tests depend on it. None in
                # production.
                hook = svc.chaos
                if hook is not None:
                    hook("send", self.peer, step)
                with span("svc.send", step=step, peer=self.peer,
                          trace_id=trace["trace_id"],
                          trace_span=trace["span_id"]):
                    if self.peer_version >= P.LINEAGE_MIN_VERSION:
                        lineage = dict(
                            lineage,
                            queue_wait_ms=round(queue_wait_ms, 3),
                            sent_ns=time.time_ns(),  # wall stamp
                        )
                        # Host-local stamp: meaningless on the peer's clock.
                        lineage.pop("created_mono_ns", None)
                    else:  # v1 peer: omit the field (bit-identical v1)
                        lineage = None
                    # Trace context (v5): like lineage, simply omitted for
                    # older peers — their frames stay byte-identical.
                    if self.peer_version < P.TRACE_MIN_VERSION:
                        trace = None
                    # Ragged view declaration (v4): derived from the batch
                    # itself — None (field omitted) for every padded
                    # stream, so pre-ragged frames stay byte-identical.
                    meta = P.encode_batch_meta(
                        step, metas, lineage, ragged=P.ragged_meta(batch),
                        trace=trace,
                    )
                    sent = P.send_batch_frame(self.sock, meta, views)
                svc.counters.add("batches_sent")
                svc.counters.add("bytes_sent", sent)
                if jc is not None:
                    jc.add("batches_sent")
                    jc.add("bytes_sent", sent)
                # Frame is on the wire: the views die with `item`, so the
                # pooled decode pages can recycle into the next batch.
                if svc.buffer_pool is not None:
                    svc.buffer_pool.release_batch(batch)
                del item, views, batch
        finally:
            self._stop.set()
            # Unblock a producer waiting on a full queue so it can exit —
            # and RELEASE the drained batches' pool leases: a disconnect
            # mid-epoch must return up to queue_depth decoded batches to
            # the pool, not strand them (reconnects are routine, so this
            # path runs often in a long-lived serve-data).
            while producer.is_alive():
                try:
                    self._release_item(self._q.get_nowait())
                except queue.Empty:
                    producer.join(timeout=0.1)
            while True:  # producer gone: drain whatever it left behind
                try:
                    self._release_item(self._q.get_nowait())
                except queue.Empty:
                    break

    def _release_item(self, item) -> None:
        """Give a drained sender-queue item's pooled pages back."""
        pool = self.service.buffer_pool
        if pool is not None and isinstance(item, tuple) and len(item) == 7:
            pool.release_batch(item[3])

    def _produce(self, plan, steps, req: dict) -> None:
        """Decode the plan's ``steps`` (this session's cursor tail — or its
        stripe's residue class of it) into the bounded queue, in order.

        Each batch is stamped at creation (``make_lineage``): plan step as
        ``batch_seq``, wall-clock ``created_ns``, and the measured
        ``decode_ms`` (on the worker-pool path that is the pipelined
        result-arrival gap, not pure decode CPU — still the per-stage wait
        the lineage attributes). The sender finalises queue/send stamps.
        """
        svc = self.service
        try:
            items = [plan[s] for s in steps]
            columns = req.get("columns")
            # Batch-cache binding for this session's plan (None when the
            # cache is off): hits skip read+decode and serve straight into
            # the sender queue — the epoch-2 / second-client / reconnect
            # fast path. Worker-pool decode gets only the probed misses
            # (imap stays plan-ordered over that miss list); a probed hit
            # evicted before its fetch decodes inline, never off the
            # iterator — consuming a pool result for a skipped item would
            # shift every later step (silent reorder).
            cache = svc.plan_cache_for(req, self.decode_fn)
            miss_iter = None
            probed = None
            # The worker pool was built around the server's PRIMARY
            # decoder; a padded-fallback session of a token_pack server
            # decodes inline instead (old-peer traffic is the compat tail,
            # not the hot path).
            if svc.workers is not None and self.decode_fn is svc.decode_fn:
                to_decode = items
                if cache is not None:
                    probed = [cache.contains(item) for item in items]
                    to_decode = [
                        i for i, hit in zip(items, probed) if not hit
                    ]
                if svc.scheduler is not None:
                    # Straggler-aware dispatch: same plan-order yield
                    # contract, dispatch reordered by predicted cost.
                    miss_iter = iter(
                        svc.scheduler.imap(svc.workers, to_decode)
                    )
                else:
                    miss_iter = iter(svc.workers.imap(to_decode))
            for off, step in enumerate(steps):
                if self._stop.is_set():
                    return
                # Weighted-fair pacing across tenants (fleet/jobs.py):
                # under contention the scheduler grants produce steps by
                # priority-class weight, and preempting classes (inference
                # single-batch fetches) go first. Capacity-only — bounded
                # wait, plan order and batch bytes untouched (LDT1301).
                svc.job_plane.begin_step(self.job_id)
                item = items[off]
                # Trace context is born HERE, with the plan item — every
                # downstream hop (send, client merge, train step) descends
                # from this root so the exported flow has real parent
                # edges. The ids come from os.urandom (tracectx) and never
                # touch batch content (LDT1301).
                trace = make_trace()
                key = item_fingerprint(item)
                cache_hit = False
                t0 = time.monotonic_ns()
                with cost_context(key, ledger=svc.cost_ledger,
                                  step=step) as cost, \
                     span("svc.decode", step=step,
                          trace_id=trace["trace_id"],
                          trace_span=trace["span_id"],
                          item=key) as sp_attrs:
                    if miss_iter is not None and not (
                        probed is not None and probed[off]
                    ):
                        batch = next(miss_iter)
                        if cache is not None:
                            # A probed miss never went through get():
                            # count it for an honest hit rate.
                            cache.note_miss()
                            cache.put(item, batch)
                    else:
                        batch = None
                        if cache is not None:
                            batch = cache.get(item, pool=svc.buffer_pool)
                            cache_hit = batch is not None
                        if batch is None:
                            batch = self.decode_fn(
                                svc.read_item(item, columns)
                            )
                            if cache is not None:
                                cache.put(item, batch)
                    if cache_hit:
                        sp_attrs["cache_hit"] = True
                    decode_ms = (time.monotonic_ns() - t0) / 1e6
                    cost.note(
                        decode_ms=round(decode_ms, 3),
                        cache_hit=cache_hit,
                        bytes=sum(
                            getattr(v, "nbytes", 0)
                            for v in batch.values()
                        ),
                    )
                svc.counters.observe("decode_ms", decode_ms)
                if cache is not None:
                    # Per-job hit accounting: a second same-config tenant
                    # streaming decode-free shows up as ITS hits, not an
                    # anonymous cache aggregate.
                    svc.job_plane.note_cache(self.job_id, cache_hit)
                lineage = make_lineage(step, decode_ms)
                # Zero-join serialisation: flat views over the batch's own
                # buffers (tensor_views) ride the queue; the sender's
                # vectored write gathers them straight from the decode
                # pages — no intermediate body copy anywhere. The batch
                # dict rides along so the sender can release its pooled
                # pages once the frame is out.
                metas, views = P.tensor_views(batch)
                t1 = time.perf_counter()
                self._q.put((step, metas, views, batch, lineage, trace,
                             time.monotonic_ns()))
                # Producer blocked = this client consumes slower than decode.
                svc.counters.add("queue_full_s", time.perf_counter() - t1)
                svc.counters.gauge("queue_depth", self._q.qsize())
            self._q.put(None)
        except BaseException as exc:  # surface to the sender loop
            self._q.put(exc)

    def _read_acks(self) -> None:
        """Drain client ACKs; EOF here means the client is gone."""
        try:
            while not self._stop.is_set():
                msg_type, msg = P.recv_msg(self.sock)
                if msg_type == P.MSG_ACK:
                    # Sole streaming-phase writer; GIL-atomic int swap
                    # read only by /healthz reporting.
                    self.last_acked = max(  # ldt: ignore[LDT1002] -- monotonic cursor, single writer after handshake; torn reads impossible under the GIL
                        self.last_acked, int(msg["step"])
                    )
                    self.service.counters.gauge(
                        "last_acked", self.last_acked
                    )
                    # Per-job resume cursor: the registry-visible answer
                    # to "where was this tenant?" — an observed ACK, so
                    # cursor COMPUTATION stays client-owned (LDT1301).
                    self.service.job_plane.note_cursor(
                        self.job_id, self.client_id or self.peer,
                        self.last_acked,
                    )
                elif msg_type == P.MSG_ERROR:
                    self.service._log(
                        f"client {self.peer} error: {msg.get('message')}"
                    )
                    break
        except (ConnectionError, OSError, P.ProtocolError):
            pass
        finally:
            # Sender may be blocked in sendall on a dead peer; closing the
            # socket breaks it out.
            self._stop.set()
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class DataService:
    """Serve plan-ordered decoded batches to remote trainers over TCP."""

    def __init__(self, config: ServeConfig):
        from ..data.decode import decoder_for_task

        self.config = config
        self.dataset = Dataset(config.dataset_path)
        # Buffer plane: decode output pages and worker copy-out pages
        # recycle through the process pool; the sender releases each
        # batch's leases after its frame is on the wire.
        self.buffer_pool = None
        if config.buffer_pool:
            from ..data.buffers import default_buffer_pool

            # Unpinned: page-locking memory creates a CUDA context, and a
            # decode server never touches the card.
            self.buffer_pool = default_buffer_pool(pin_memory=False)
        # The SAME dispatch the trainer uses — the bit-identical-batches
        # guarantee depends on both sides binding one decoder implementation.
        text_task = config.task_type in (
            "masked_lm", "causal_lm", "contrastive"
        )
        tp_cfg = None
        if config.token_pack:
            if not text_task:
                raise ValueError(
                    "token_pack packs token columns and needs a text "
                    f"task_type, got {config.task_type!r}"
                )
            from ..data.token_pack import TokenPackConfig

            tp_cfg = TokenPackConfig(
                pack_len=config.pack_len or config.seq_len,
                rows_multiple=config.pack_rows_multiple,
            )
        self.decode_fn = decoder_for_task(
            config.task_type, image_size=config.image_size,
            buffer_pool=self.buffer_pool,
            device_decode=config.device_decode,
            token_pack=tp_cfg,
            seq_len=config.seq_len if text_task else None,
        )
        # Per-session padded fallback: v3 peers (and v4 clients that did
        # not ask for packing) negotiate packing OFF and stream the exact
        # padded bytes a non-packing server serves — one server, both arms.
        self.decode_fn_padded = self.decode_fn
        if tp_cfg is not None:
            self.decode_fn_padded = decoder_for_task(
                config.task_type, image_size=config.image_size,
                buffer_pool=self.buffer_pool,
                device_decode=config.device_decode,
                seq_len=config.seq_len,
            )
        self.counters = ServiceCounters()
        # Epoch-coherent batch cache (ServeConfig.batch_cache): one tiered
        # RAM/disk cache shared by every client session — the tf.data
        # service "cache the materialized batches behind the plan key"
        # lever, server-side so RemoteLoader AND FleetLoader inherit it.
        self.batch_cache = None
        if config.batch_cache:
            from ..data.cache import BatchCache

            self.batch_cache = BatchCache(
                cache_dir=config.cache_dir,
                ram_budget_mb=config.cache_ram_budget_mb,
                disk_budget_mb=config.cache_disk_budget_mb,
                buffer_pool=self.buffer_pool,
            )
        self.workers = None
        if config.num_workers > 0:
            from ..data.workers import WorkerPool, columnar_spec

            self.workers = WorkerPool(
                columnar_spec(config.dataset_path),
                self.decode_fn,
                config.num_workers,
                columns=getattr(self.decode_fn, "required_columns", None),
                read_retries=config.read_retries,
                retry_backoff_s=config.retry_backoff_s,
                transport="shm" if config.shm_workers else "pickle",
                buffer_pool=self.buffer_pool,
            )
        # Straggler-aware dispatch (data/schedule.py), shared by every
        # client session: one cost model accumulates observations across
        # sessions (concurrent updates race benignly — predictions are
        # capacity-only advice; yield order never depends on them).
        self.scheduler = None
        if self.workers is not None and config.sched_lookahead > 0:
            from ..data.schedule import CostModel, DecodeScheduler

            self.scheduler = DecodeScheduler(
                CostModel.from_env(),
                lookahead=config.sched_lookahead,
                heavy_share=config.sched_heavy_share,
            )
        self._plans: dict = {}  # handshake params -> per-process plans
        self._plans_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._sessions: set = set()
        self._sessions_lock = threading.Lock()
        self._stopped = threading.Event()
        self.port: Optional[int] = None
        self._metrics = None  # MetricsHTTPServer when metrics_port is set
        self.metrics_port: Optional[int] = None  # bound exporter port
        self.fleet_agent = None  # FleetAgent when coordinator_addr is set
        # Test-only fault-injection hook (fleet/chaos.py): called by every
        # sender thread as chaos("send", peer, step) before each batch
        # frame. None (the production value) costs one attribute load.
        self.chaos = None
        # Pressure window anchor (autotune fleet half): previous counter
        # snapshot + its monotonic stamp. Touched only by pressure(), whose
        # single caller is the fleet agent's heartbeat thread.
        self._pressure_prev: tuple = ({}, time.monotonic())
        # Per-item cost ledger (obs/costs.py): decode paths record into the
        # process-wide singleton so `ldt costs` and /metrics see one view.
        self.cost_ledger = default_ledger()
        # SLO plane (obs/slo.py): burn-rate tracker over declared
        # objectives, started with the metrics exporter. Its stall_pct
        # probe keeps its OWN window anchor — pressure()'s anchor belongs
        # to the heartbeat thread (single-caller contract above).
        self._slo = None
        self._slo_prev: tuple = ({}, time.monotonic())
        # Admission-gate stall window: its OWN anchor (admit() calls are
        # rare and must not shorten the pressure/SLO windows above).
        self._admission_prev: tuple = ({}, time.monotonic())
        # Job plane (fleet/jobs.py): tenant table + fairness + admission.
        # With both knobs at their 0 defaults every session is admitted
        # onto the implicit default job — the exact pre-r20 behavior.
        self.job_plane = JobPlane(
            counters=self.counters,
            registry=self.counters.registry,
            max_jobs=config.admission_max_jobs,
            max_stall_pct=config.admission_max_stall_pct,
            stall_fn=self._admission_stall_pct,
        )

    def pressure(self) -> dict:
        """Windowed pressure since the previous call — what this member
        reports in fleet heartbeats so the Coordinator can aggregate a
        scale-up/drain recommendation (tune/, the fleet half).

        ``stall_pct`` is the decode-starvation share: the fraction of the
        window's (wall × active sessions) that sender threads spent waiting
        on empty batch queues. High = this member's decode plane cannot
        keep its clients fed (the scale-UP signal); near zero with clients
        attached = capacity to spare (a drain candidate). Single-caller
        contract: the heartbeat thread owns the window anchor."""
        now = time.monotonic()
        snap = self.counters.snapshot()
        prev, prev_t = self._pressure_prev
        self._pressure_prev = (snap, now)
        window_s = max(now - prev_t, 1e-6)

        def d(key: str) -> float:
            key = f"svc_{key}"
            return snap.get(key, 0.0) - prev.get(key, 0.0)

        with self._sessions_lock:
            active = len(self._sessions)
        stall_pct = 0.0
        if active:
            stall_pct = min(
                100.0,
                100.0 * d("queue_empty_s") / (window_s * active),
            )
        return {
            "stall_pct": round(stall_pct, 2),
            "active_clients": active,
            "queue_depth": snap.get("svc_queue_depth", 0.0),
            "batches_sent": d("batches_sent"),
            "window_s": round(window_s, 3),
        }

    def queue_wait_hist(self) -> Optional[dict]:
        """Mergeable queue-wait histogram payload for fleet heartbeats
        (protocol v5, version-gated by the agent like ``pressure``): the
        ``svc_queue_wait_ms`` bucket counts + sum + count, which the
        Coordinator sums across members to publish fleet-wide percentiles
        (``fleet_queue_wait_p99_ms``). None until a batch has waited."""
        hist = self.counters.registry.get("svc_queue_wait_ms")
        if hist is None:
            return None
        counts, total_sum, count = hist.snapshot()
        if not count:
            return None
        return {"counts": counts, "sum": total_sum, "count": count}

    def _slo_stall_pct(self) -> float:
        """SLO probe: windowed decode-starvation share, like pressure()'s
        ``stall_pct`` but over this probe's own anchor (the SLO tick
        thread), so neither caller shortens the other's window."""
        now = time.monotonic()
        snap = self.counters.snapshot()
        prev, prev_t = self._slo_prev
        self._slo_prev = (snap, now)
        window_s = max(now - prev_t, 1e-6)
        with self._sessions_lock:
            active = len(self._sessions)
        if not active:
            return 0.0
        d = (snap.get("svc_queue_empty_s", 0.0)
             - prev.get("svc_queue_empty_s", 0.0))
        return min(100.0, 100.0 * d / (window_s * active))

    def _slo_queue_wait_p99(self) -> float:
        hist = self.counters.registry.get("svc_queue_wait_ms")
        if hist is None:
            return float("nan")  # no traffic yet: probe skipped
        return hist.percentile(99)

    def _admission_stall_pct(self) -> float:
        """Stall share since the previous ADMISSION check (own anchor —
        single caller is JobPlane.admit under its lock). Long windows
        between arrivals only smooth the signal."""
        now = time.monotonic()
        snap = self.counters.snapshot()
        prev, prev_t = self._admission_prev
        self._admission_prev = (snap, now)
        window_s = max(now - prev_t, 1e-6)
        with self._sessions_lock:
            active = len(self._sessions)
        if not active:
            return 0.0
        d = (snap.get("svc_queue_empty_s", 0.0)
             - prev.get("svc_queue_empty_s", 0.0))
        return min(100.0, 100.0 * d / (window_s * active))

    def job_stats(self) -> Optional[dict]:
        """Per-job stats for fleet heartbeats (the optional ``jobs``
        field — omitted while no tenant is admitted, so heartbeats to an
        old coordinator stay byte-identical until the plane is used)."""
        stats = self.job_plane.stats()
        return stats or None

    # -- data plane --------------------------------------------------------

    def read_item(self, item, columns=None):
        """One plan item (list of ReadRange) → Arrow table (the pipeline's
        own range-read helper), with retry + exponential backoff on
        transient storage failures. The worker-pool path retries inside the
        workers (WorkerPool(read_retries=…)) with the same policy."""
        from ..data.format import read_ranges
        from ..data.workers import RETRYABLE_READ_ERRORS

        cfg = self.config
        retries = max(1, cfg.read_retries)
        last: Optional[Exception] = None
        for attempt in range(retries):
            try:
                return read_ranges(self.dataset, item, columns=columns)
            except RETRYABLE_READ_ERRORS as exc:
                last = exc
                self.counters.add("read_retries")
                if attempt + 1 < retries:  # no sleep after the final failure
                    time.sleep(cfg.retry_backoff_s * (2**attempt))
        raise RuntimeError(
            f"dataset read failed after {retries} attempts: {last}"
        ) from last

    def decode_config_skew(self, req: dict) -> Optional[str]:
        """Reject decode-config mismatches at connect time. A 224px server
        feeding a 299px trainer trains silently at the wrong resolution
        (global pooling accepts any spatial size), so when the client
        declares its decode knobs they must match this server's."""
        cfg = self.config
        task = req.get("task_type")
        if task is not None and task != cfg.task_type:
            return (
                f"decode-config skew: server serves task_type="
                f"{cfg.task_type!r}, client expects {task!r}"
            )
        size = req.get("image_size")
        if (
            size is not None
            and cfg.task_type in ("classification", "contrastive")
            and int(size) != cfg.image_size
        ):
            return (
                f"decode-config skew: server decodes image_size="
                f"{cfg.image_size}, client expects {size}"
            )
        dd = req.get("device_decode")
        if dd is not None and bool(dd) != bool(cfg.device_decode):
            # A pixel client fed coefficient pages has no kernel to finish
            # them; a coefficient client fed pixels silently trains on a
            # differently-decoded stream. Reject, like the knobs above.
            return (
                "decode-config skew: server serves "
                f"device_decode={bool(cfg.device_decode)}, client expects "
                f"{bool(dd)}"
            )
        sl = req.get("seq_len")
        if (
            sl is not None
            and cfg.task_type in ("masked_lm", "causal_lm", "contrastive")
            and int(sl) != cfg.seq_len
        ):
            # The text twin of the image_size check: a seq_len-64 trainer
            # fed (B, 128) padded batches crashes mid-epoch on the model's
            # max_len (or silently trains a differently-packed layout) —
            # reject at connect time like every other decode knob.
            return (
                f"decode-config skew: server pads/packs to seq_len="
                f"{cfg.seq_len}, client expects {sl}"
            )
        if bool(req.get("token_pack")) and not cfg.token_pack:
            # Asymmetric by design: a packing CLIENT needs the ragged
            # stream this server is not configured to produce — reject.
            # The converse (padded client, packing server) is fine: the
            # session falls back to the padded decoder, bit-identical to
            # a non-packing server's stream.
            return (
                "decode-config skew: client requests token_pack but this "
                "server serves padded token batches (restart serve-data "
                "with --token_pack)"
            )
        fp = req.get("dataset_fingerprint")
        if fp is not None and str(fp) != self.dataset.fingerprint():
            # The client opened the dataset locally and declared its
            # content identity: a server reading a DIFFERENT copy of "the
            # same" path (stale mirror, mid-rewrite snapshot) would stream
            # rows from the wrong data with a perfectly valid plan shape.
            # Reject at connect time, like the decode knobs. None = the
            # client has no local mount (or an old peer): skipped.
            return (
                "dataset skew: server dataset fingerprint "
                f"{self.dataset.fingerprint()[:12]}..., client declares "
                f"{str(fp)[:12]}..."
            )
        return None

    def plan_cache_for(self, req: dict, decode_fn=None):
        """This handshake's :class:`~..data.cache.PlanCache` binding of the
        shared batch cache (``None`` when the cache is off). The scope
        carries the decode fingerprint + column projection; plan items are
        content-hashed, so two clients (or two epochs, or a reconnect)
        asking for the same rows share entries. ``decode_fn`` is the
        SESSION's negotiated decoder (packed vs padded sessions of one
        token_pack server must never share cache entries — their bytes
        differ; the fingerprint keeps them disjoint and also re-scopes on
        live pack-knob moves, the bucket-edge aliasing guard)."""
        if self.batch_cache is None:
            return None
        from ..data.cache import (
            PlanCache,
            decode_fingerprint,
            plan_fingerprint,
        )

        fn = decode_fn if decode_fn is not None else self.decode_fn
        columns = req.get("columns")
        cols = list(columns) if columns is not None else None
        return PlanCache(
            self.batch_cache,
            self.dataset.fingerprint(),
            # Callable: re-evaluated per key, so live decoder knob moves
            # re-scope later entries instead of aliasing old-geometry ones.
            lambda: plan_fingerprint(
                decode=decode_fingerprint(fn), columns=cols,
            ),
        )

    def plan_for(self, req: dict):
        """This shard's epoch plan — identical to the in-process pipeline's
        (the same :meth:`~..data.graph.LanceSource.shard_plans` pure
        function, same equal-step validation across ALL shards so the
        collective-deadlock guard still runs even though training happens
        elsewhere)."""
        key = (
            req["sampler_type"], int(req["batch_size"]),
            int(req["process_count"]), bool(req.get("shuffle")),
            int(req.get("seed", 0)), int(req.get("epoch", 0)),
        )
        pidx = int(req["process_index"])
        pcount = int(req["process_count"])
        if not 0 <= pidx < pcount:
            raise ValueError(f"invalid shard {pidx} of {pcount}")
        if req["sampler_type"] in ("full", "full_scan") and pcount > 1:
            # Mirror make_train_pipeline's refusal — every shard would get
            # the identical whole-dataset plan and multi-process training
            # would silently duplicate every row process_count times.
            raise ValueError(
                "sampler_type='full' is not DP-aware (every process scans "
                f"the whole dataset) and cannot serve {pcount} processes; "
                "use sampler_type='batch' or 'fragment'"
            )
        with self._plans_lock:
            plans = self._plans.get(key)
            if plans is None:
                sampler, bs, count, shuffle, seed, epoch = key
                # The graph's source node is the ONE home of plan
                # construction: the server asks it for every shard's plan
                # exactly as the in-process compile does, so client and
                # server can never drift.
                plans = LanceSource(
                    self.dataset, sampler, bs, 0, count,
                    shuffle=shuffle, seed=seed, epoch=epoch,
                ).shard_plans()
                if len(self._plans) >= 8:  # old epochs: evict oldest entry
                    self._plans.pop(next(iter(self._plans)))
                self._plans[key] = plans
        return plans[pidx]

    # -- control plane -----------------------------------------------------

    def start(self) -> "DataService":
        """Bind + listen + accept in a background thread. Returns self; the
        bound port (for ``port=0``) is ``self.port``."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.config.host, self.config.port))
            sock.listen(64)
        except BaseException:
            # A failed bind (port in use) must not leak the listener fd —
            # EMFILE from repeated start() retries is the slow-kill class
            # LDT1201 exists for.
            sock.close()
            raise
        self._sock = sock
        self.port = sock.getsockname()[1]
        if self.config.metrics_port is not None:
            from ..obs.http import MetricsHTTPServer

            # Before the accept thread: an exporter bind failure must not
            # leave a half-initialized service accepting clients. The
            # counters' registry (the process default unless injected):
            # svc_* counters/gauges + decode/queue-wait histograms — and, in
            # a loopback process, any client-side lineage_* histograms too.
            try:
                self._metrics = MetricsHTTPServer(
                    self.counters.registry,
                    port=self.config.metrics_port,
                    host=self.config.metrics_host,
                    healthz_fn=self._healthz,
                ).start()
            except BaseException:
                # Any exporter-start failure (not just a bind OSError)
                # must retract the listener: the caller has no handle to
                # a half-initialized service, so the fd would leak.
                sock.close()
                self._sock = None
                raise
            self.metrics_port = self._metrics.port
            self._log(
                f"metrics on :{self.metrics_port} (/metrics, /healthz)"
            )
            # SLO burn-down rides the metrics surface: no exporter, no
            # consumer for the gauges, so no tick thread either.
            from ..obs.slo import SLOTracker

            self._slo = SLOTracker(
                probes={
                    "stall_pct": self._slo_stall_pct,
                    "queue_wait_p99_ms": self._slo_queue_wait_p99,
                },
                registry=self.counters.registry,
            ).start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ldt-svc-accept"
        )
        self._accept_thread.start()
        self._log(
            f"serving {self.config.dataset_path} on "
            f"{self.config.host}:{self.port}"
        )
        if self.config.coordinator_addr:
            # Fleet membership: register AFTER the listener is live (the
            # advertised address must be dialable the moment the
            # coordinator hands it to a client). The agent retries forever
            # in the background — a coordinator that is still booting
            # delays discovery, never this server.
            from ..fleet.agent import FleetAgent

            self.fleet_agent = FleetAgent(
                self.config.coordinator_addr,
                self._advertise_addr(),
                server_id=self.config.server_id,
                num_fragments=len(self.dataset.fragment_rows()),
                on_lease_change=self._on_lease_change,
                counters=self.counters,
                heartbeat_interval_s=self.config.heartbeat_interval_s,
                # Autotune fleet half: every heartbeat carries this
                # member's windowed stall/occupancy so the coordinator can
                # recommend scale-up/drain (README "Autotune").
                pressure_fn=self.pressure,
                # v5 fleet half of the SLO plane: mergeable queue-wait
                # bucket counts, aggregated coordinator-side into
                # fleet_queue_wait_p{50,95,99}_ms.
                hist_fn=self.queue_wait_hist,
                # v6 job plane: per-job stats ride heartbeats into the
                # coordinator's JobRegistry (old coordinators ignore the
                # unknown field, like hist_fn's).
                jobs_fn=self.job_stats,
            ).start()
            self._log(
                f"fleet member {self.fleet_agent.server_id} -> "
                f"coordinator {self.config.coordinator_addr}"
            )
        return self

    def _advertise_addr(self) -> str:
        """The address clients dial, as registered with the coordinator.
        The bind host works unless it's a wildcard, where the machine's
        hostname is the best guess — NAT/container setups should pass
        ``advertise_addr`` explicitly."""
        if self.config.advertise_addr:
            return self.config.advertise_addr
        host = self.config.host
        if host in ("", "0.0.0.0", "::"):
            host = socket.gethostname()
        return f"{host}:{self.port}"

    def _on_lease_change(self, lease: dict) -> None:
        """Heartbeat/registration reported a new lease generation: the
        fleet's membership moved, so this server's stripe of the fragment
        space may have. Re-plan: drop the cached epoch plans (they rebuild
        lazily per handshake — plan_for is a pure function, so streams in
        flight are untouched) and publish the lease on the metrics
        surface."""
        with self._plans_lock:
            self._plans.clear()
        self.counters.gauge("lease_generation", lease.get("generation", 0))
        self.counters.gauge("lease_stripe", lease.get("stripe_index", 0))
        self.counters.gauge(
            "lease_stripe_count", lease.get("stripe_count", 0)
        )
        self._log(
            f"lease moved: generation {lease.get('generation')}, stripe "
            f"{lease.get('stripe_index')}/{lease.get('stripe_count')}, "
            f"fragments [{lease.get('fragment_lo')}, "
            f"{lease.get('fragment_hi')})"
        )

    def _healthz(self) -> dict:
        """Liveness extras for ``/healthz``: queue depths + client liveness
        per connected session — the at-a-glance 'which trainer is behind'
        view."""
        with self._sessions_lock:
            sessions = list(self._sessions)
        stopped = self._stopped.is_set()
        fleet = None
        agent = self.fleet_agent  # snapshot: stop() nulls it concurrently
        if agent is not None:
            fleet = {
                "coordinator": self.config.coordinator_addr,
                "server_id": agent.server_id,
                "registered": agent.registered.is_set(),
                "lease": agent.lease,
                "generation": agent.generation,
                # Coordinator-advertised expiry horizon: an operator can
                # spot a heartbeat interval configured too close to it.
                "lease_ttl_s": agent.lease_ttl_s,
            }
        from ..obs.http import build_info

        slo = self._slo  # snapshot: stop() nulls it concurrently
        return {
            # Non-"ok" serves as HTTP 503 (obs.http): a probe pointed here
            # sees the wind-down while the exporter thread lingers.
            "status": "degraded" if stopped else "ok",
            "dataset": self.config.dataset_path,
            "port": self.port,
            "build": build_info(),
            "slo": slo.status() if slo is not None else None,
            "active_clients": len(sessions),
            "stopped": stopped,
            "fleet": fleet,
            # Per-tenant view (fleet/jobs.py): sessions, cursor, cache
            # hits, SLO burn per admitted job — {} until a v6 session (or
            # any default-job session) lands.
            "jobs": self.job_plane.stats(),
            "sessions": [
                {
                    "peer": s.peer,
                    "client_id": s.client_id,
                    "protocol_version": s.peer_version,
                    "job_id": s.job_id,
                    "last_acked": s.last_acked,
                    "queue_depth": s._q.qsize(),
                }
                for s in sessions
            ],
        }

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stopped.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:  # listener closed by stop()
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            session = _ClientSession(self, conn, f"{addr[0]}:{addr[1]}")
            with self._sessions_lock:
                self._sessions.add(session)
            self.counters.gauge("active_clients", len(self._sessions))
            threading.Thread(
                target=session.run, daemon=True,
                name=f"ldt-svc-client-{addr[1]}",
            ).start()

    def _forget(self, session: _ClientSession) -> None:
        with self._sessions_lock:
            self._sessions.discard(session)
        self.counters.gauge("active_clients", len(self._sessions))

    def serve_forever(self) -> None:
        """Blocking serve (the ``ldt serve-data`` entry): start if needed,
        then wait for stop()/SIGTERM/KeyboardInterrupt, optionally logging
        stats. SIGTERM (``docker stop``, k8s preemption) only sets the stop
        flag; the ``finally`` here runs the real drain — sessions closed,
        fleet lease deregistered, worker shm reaped, final counters
        flushed — exactly as Ctrl-C always did."""
        from ..utils.signals import install_sigterm_handler

        if self._sock is None:
            self.start()
        install_sigterm_handler(self._stopped.set)
        try:
            interval = self.config.log_every_s
            while not self._stopped.wait(interval if interval > 0 else 3600.0):
                if interval > 0:
                    self._log(str(self.counters.snapshot()))
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            # The final cursor/metrics flush an orchestrated shutdown used
            # to skip: last-acked cursors per session are gone with the
            # sockets, but the totals say what was served.
            self._log(f"final {self.counters.snapshot()}")

    def stop(self) -> None:
        self._stopped.set()
        if self._slo is not None:
            self._slo.stop()
            self._slo = None
        if self.fleet_agent is not None:
            # Graceful leave first: the coordinator reassigns the lease
            # now, not at TTL expiry, so clients restripe immediately.
            self.fleet_agent.stop()
            self.fleet_agent = None
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None
        if self._sock is not None:
            try:
                # Wake a concurrently-blocked accept() (see session close():
                # a bare close can leave the kernel-side listener alive
                # while the accept syscall holds the last reference, so
                # in-flight dials would land in a backlog nobody drains).
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._sessions_lock:
            sessions = list(self._sessions)
        for s in sessions:
            s.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        if self.workers is not None:
            self.workers.shutdown()
            self.workers = None
        if self.batch_cache is not None:
            # After the sessions are closed: no producer can be mid-get.
            # Releases the RAM ring's pool leases; the disk tier stays
            # (it is the restart-warm path).
            self.batch_cache.close()
        # Last: per-job SLO tickers are daemon threads reading counters
        # the sessions above were still feeding.
        self.job_plane.stop()

    def __enter__(self) -> "DataService":
        return self.start() if self._sock is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _log(self, msg: str) -> None:
        print(f"[data-service] {msg}", flush=True)


def serve(config: ServeConfig) -> None:
    """Module-level convenience for the CLI."""
    DataService(config).serve_forever()
