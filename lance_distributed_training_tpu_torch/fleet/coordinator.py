"""``Coordinator`` — the fleet's control plane.

A copy of ``lance_distributed_training_tpu/fleet/coordinator.py`` for the
port.

Tracks data-server membership and owns the **shard leases**: every live
member holds a generation-numbered lease naming its stripe of the fleet and
its slice of the global fragment space. The lease table is recomputed —
generation bumped — on every membership change (register, deregister,
heartbeat expiry), and members learn their new lease in the next heartbeat
reply; clients learn the new layout from ``RESOLVE``. The coordinator never
touches batch data: the data plane stays strictly client↔server
(``FleetLoader`` stripes v3 HELLOs across the members it resolves here), so
a coordinator crash degrades discovery, not the streams in flight.

Division of authority (read this before "improving" either half): the
**stripe_index/stripe_count** in a lease and in RESOLVE is what clients
stripe by — it is the correctness-bearing part, enforced end-to-end by the
client's plan-order merge. The **fragment_lo/fragment_hi** slice is
*advisory*: servers stay stateless decode planes that can serve any step of
any plan (that statelessness is exactly what makes failover a pure client
re-stripe), so the fragment slice does not gate what a server will serve.
It exists for operators (capacity math on /healthz: which member owns how
much of the dataset at the current generation) and for locality-aware
read-ahead, and a lease *change* is the signal members key cache
invalidation on (``DataService._on_lease_change`` drops its plan cache).

Protocol: the fleet message types of :mod:`..service.protocol` — one
request, one reply, per short-lived connection. No streaming state means a
wedged peer costs one handler thread for one ``handshake_timeout_s``
deadline, nothing more.

Thread & queue policy (``ldt check`` LDT201/LDT203): every thread is
``daemon=True``; every control recv carries a deadline. The coordinator has
no queues — its whole state is the lease table under one lock.

Lock discipline (LDT1001/LDT1002 audit, r9): ``_lock`` guards the member
table and generation counter across seven sites — the four request
handlers, the expiry sweep, ``_healthz``, and the ``serve_forever`` status
line — and is NEVER held across socket I/O or logging. Every handler
builds its reply dict *inside* the critical section and sends it *after*
release (``_handle_conn`` owns the ``send_msg``); ``_expire_loop`` and the
handlers log after releasing. A heartbeat reply sent under the lease-table
lock would serialize the whole control plane behind one slow peer's TCP
window — the cross-module lock model keeps that shape a lint failure, not
a code-review hope. The registry counter/gauge calls inside
``_rebalance_locked`` do nest the registry's internal lock under ``_lock``
(a ``coordinator._lock → registry._lock`` edge in ``ldt graph``); that
order is acyclic program-wide because the registry never calls back out.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from typing import Optional

from ..obs.registry import (
    DEFAULT_MS_BUCKETS,
    MetricsRegistry,
    default_registry,
    percentile_from_counts,
)
from ..obs.spans import span
from ..service import protocol as P
from .jobs import JobRegistry

__all__ = ["CoordinatorConfig", "Coordinator", "serve_coordinator",
           "UNKNOWN_MEMBER_MARKER"]

# Error-message prefix a heartbeat from an expired/unknown member gets back.
# The agent keys its re-register path on this marker (wire prose — frozen,
# same contract as VERSION_MISMATCH_MARKER).
UNKNOWN_MEMBER_MARKER = "unknown fleet member"


@dataclasses.dataclass
class CoordinatorConfig:
    """Control-plane knobs. The data servers and trainers bring their own
    config — the coordinator only owns membership and leases."""

    host: str = "0.0.0.0"
    port: int = 8470  # 0 = ephemeral (the bound port is Coordinator.port)
    heartbeat_interval_s: float = 2.0  # advertised to members at register
    lease_ttl_s: float = 6.0  # heartbeat silence after which a member is
    # expired and its lease reassigned (>= 2-3 heartbeat intervals, so one
    # dropped packet never churns the lease table)
    handshake_timeout_s: float = 10.0  # per-connection request deadline
    log_every_s: float = 0.0  # >0: periodic membership line to stdout
    metrics_port: Optional[int] = None  # /metrics + /healthz (same contract
    # as ServeConfig.metrics_port: None = off, 0 = ephemeral)
    metrics_host: str = "127.0.0.1"  # loopback default; /healthz lists
    # member addresses unauthenticated, so non-loopback is an opt-in
    scale_up_stall_pct: float = 50.0  # a member heartbeat reporting a
    # windowed stall above this flips the fleet recommendation to
    # "scale_up" (decode-starved clients — add a member)
    scale_down_stall_pct: float = 5.0  # every member below this (with >1
    # members and clients attached) makes the fleet a "drain_candidate"
    # (capacity to spare — an operator may drain one member)
    stale_pressure_ttl_s: float = 0.0  # how long an EXPIRED member's last
    # pressure window stays on the books (tagged stale) before the
    # recommendation may trust the survivors alone; 0 = auto
    # (5 × lease_ttl_s, floor 10s). A member that stalled hot and then
    # blipped out must not flip the fleet to drain_candidate the moment
    # its lease expires — scale-down on loss-of-evidence is the one
    # direction a dropped heartbeat must never push.


class _Member:
    """One registered data server and its current lease."""

    __slots__ = ("server_id", "addr", "num_fragments", "last_heartbeat",
                 "stripe_index", "fragment_lo", "fragment_hi", "pressure",
                 "acked_generation", "queue_wait_hist", "jobs")

    def __init__(self, server_id: str, addr: str, num_fragments: int):
        self.server_id = server_id
        self.addr = addr
        self.num_fragments = num_fragments
        self.last_heartbeat = time.monotonic()
        self.stripe_index = 0
        self.fragment_lo = 0
        self.fragment_hi = 0
        # Last generation this member REPORTED in a heartbeat: lagging the
        # table's generation means the member has not yet acted on its
        # newest lease (the propagation-delay signal /healthz surfaces).
        self.acked_generation = 0
        # Latest heartbeat-reported windowed pressure ({"stall_pct": …,
        # "active_clients": …}; None until a pressure-carrying heartbeat —
        # pre-r9 members never send one and simply stay None).
        self.pressure: Optional[dict] = None
        # Latest mergeable queue-wait histogram ({"counts": [...], "sum",
        # "count"}, protocol v5) — None for pre-v5 members, exactly like
        # pressure. Bucket bounds are DEFAULT_MS_BUCKETS on both sides.
        self.queue_wait_hist: Optional[dict] = None
        # Latest per-job stats this member reported (v6 job plane) —
        # None for pre-v6 members, exactly like pressure.
        self.jobs: Optional[dict] = None

    def lease(self, generation: int, stripe_count: int) -> dict:
        return {
            "generation": generation,
            "stripe_index": self.stripe_index,
            "stripe_count": stripe_count,
            "fragment_lo": self.fragment_lo,
            "fragment_hi": self.fragment_hi,
        }


class Coordinator:
    """Serve fleet membership + shard leases over TCP until :meth:`stop`."""

    def __init__(self, config: CoordinatorConfig,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config
        self.registry = registry if registry is not None else default_registry()
        self._members: dict[str, _Member] = {}
        self._lock = threading.Lock()
        self.generation = 0
        # Fleet-wide job view (v6): declared via RESOLVE payloads, fed by
        # heartbeat `jobs` stats. Own (leaf) lock — safe to call under
        # `_lock` (same acyclic shape as the registry gauges).
        self.jobs = JobRegistry()
        # Expired members' last pressure windows, tagged stale (guarded
        # by `_lock`): server_id -> pressure dict + "expired_at"
        # monotonic stamp. Retained for stale_pressure_ttl_s so a hot
        # member's heartbeat blip cannot flip the recommendation to
        # drain_candidate on loss of evidence; pruned by the expiry
        # sweep, replaced by fresh evidence on re-register.
        self._stale_pressure: dict[str, dict] = {}
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._expiry_thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.port: Optional[int] = None
        self._metrics = None
        self.metrics_port: Optional[int] = None

    # -- lease table --------------------------------------------------------

    def _rebalance_locked(self) -> None:
        """Recompute every member's lease (caller holds ``_lock``): stripes
        by sorted server_id (deterministic across coordinator restarts), the
        fragment space split into contiguous near-equal slices. Bumps the
        generation — the one number every cache keys on."""
        t0 = time.perf_counter()
        self.generation += 1
        members = sorted(self._members.values(), key=lambda m: m.server_id)
        count = len(members)
        total_fragments = max(
            (m.num_fragments for m in members), default=0
        )
        for i, m in enumerate(members):
            m.stripe_index = i
            if count and total_fragments:
                lo = (total_fragments * i) // count
                hi = (total_fragments * (i + 1)) // count
            else:
                lo = hi = 0
            m.fragment_lo, m.fragment_hi = lo, hi
        self.registry.gauge("fleet_members").set(count)
        self.registry.gauge("fleet_lease_generation").set(self.generation)
        self.registry.histogram("fleet_rebalance_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )

    def _queue_wait_merged_locked(self) -> Optional[dict]:
        """Fleet-wide queue-wait percentiles from the members' v5
        heartbeat histograms (caller holds ``_lock``): sum the bucket
        count vectors — histograms with shared bounds merge exactly, the
        property per-member p99 gauges don't have — then interpolate.
        None before any well-formed report."""
        n = len(DEFAULT_MS_BUCKETS) + 1  # finite bounds + the +Inf slot
        summed = [0] * n
        members = total = 0
        for m in self._members.values():
            h = m.queue_wait_hist
            if not isinstance(h, dict):
                continue
            counts = h.get("counts")
            # Shape guard: a foreign/els future member whose bucket layout
            # differs cannot be merged — skip it rather than corrupt the
            # fleet aggregate.
            if not isinstance(counts, list) or len(counts) != n:
                continue
            try:
                counts = [int(c) for c in counts]
            except (TypeError, ValueError):
                continue
            members += 1
            total += sum(counts)
            for j, c in enumerate(counts):
                summed[j] += c
        if not members or total <= 0:
            return None
        return {
            "members": members,
            "count": total,
            "p50_ms": round(percentile_from_counts(
                DEFAULT_MS_BUCKETS, summed, total, 50), 3),
            "p95_ms": round(percentile_from_counts(
                DEFAULT_MS_BUCKETS, summed, total, 95), 3),
            "p99_ms": round(percentile_from_counts(
                DEFAULT_MS_BUCKETS, summed, total, 99), 3),
        }

    def _members_payload_locked(self) -> dict:
        now = time.monotonic()
        members = sorted(self._members.values(), key=lambda m: m.server_id)
        return {
            "generation": self.generation,
            "stripe_count": len(members),
            "members": [
                {
                    "server_id": m.server_id,
                    "addr": m.addr,
                    "stripe_index": m.stripe_index,
                    "fragment_lo": m.fragment_lo,
                    "fragment_hi": m.fragment_hi,
                    "heartbeat_age_s": round(now - m.last_heartbeat, 3),
                    "acked_generation": m.acked_generation,
                    "pressure": m.pressure,
                }
                for m in members
            ],
            "queue_wait_ms": self._queue_wait_merged_locked(),
            "recommendation": self._recommend_locked(),
            # v6 job plane: fleet-wide per-job rows (additive key — old
            # clients ignore it, like every RESOLVE extension).
            "jobs": self.jobs.payload(),
            # Expired members whose last pressure window is still on the
            # books (see _expire_loop) — the evidence the recommendation
            # refuses to scale down against.
            "stale_members": [
                {
                    "server_id": sid,
                    "pressure": {
                        k: v for k, v in entry.items() if k != "expired_at"
                    },
                    "stale_age_s": round(
                        now - entry.get("expired_at", now), 3
                    ),
                }
                for sid, entry in sorted(self._stale_pressure.items())
            ],
        }

    def _recommend_locked(self) -> dict:
        """Aggregate the members' heartbeat-reported pressure into one
        scale recommendation (caller holds ``_lock``). Advisory by design —
        the coordinator never spawns or kills members; an operator (or a
        later PR's autoscaler) acts on ``ldt fleet recommend`` /
        ``/healthz`` / the ``fleet_scale_recommendation`` gauge.

        * any member's windowed stall >= ``scale_up_stall_pct`` →
          ``scale_up`` (its clients are decode-starved; add a member),
        * every reporting member <= ``scale_down_stall_pct`` with clients
          attached and >1 members → ``drain_candidate`` (capacity to
          spare),
        * otherwise (or before any pressure report) → ``ok``.
        """
        reported = [
            m for m in self._members.values()
            if isinstance(m.pressure, dict)
        ]
        if not reported:
            return {"action": "ok", "code": 0,
                    "reason": "no pressure reports yet"}
        worst = max(reported,
                    key=lambda m: m.pressure.get("stall_pct", 0.0))
        worst_stall = float(worst.pressure.get("stall_pct", 0.0))
        cfg = self.config
        if worst_stall >= cfg.scale_up_stall_pct:
            return {
                "action": "scale_up", "code": 1,
                "member": worst.server_id,
                "stall_pct": worst_stall,
                "reason": (
                    f"member {worst.server_id} stall "
                    f"{worst_stall:.1f}% >= {cfg.scale_up_stall_pct:.1f}%"
                ),
            }
        serving = [
            m for m in reported
            if m.pressure.get("active_clients", 0)
        ]
        if (
            len(self._members) > 1
            and serving
            and worst_stall <= cfg.scale_down_stall_pct
        ):
            # Loss-of-evidence guard: an EXPIRED member whose last window
            # was hotter than the drain band blocks drain_candidate while
            # its stale pressure is retained. The survivors looking calm
            # right after a hot member blipped out is exactly when the
            # fleet must NOT shed capacity — expiry already shrank it.
            stale_hot = sorted(
                sid for sid, entry in self._stale_pressure.items()
                if float(entry.get("stall_pct", 0.0))
                > cfg.scale_down_stall_pct
            )
            if stale_hot:
                return {
                    "action": "ok", "code": 0,
                    "stall_pct": worst_stall,
                    "reason": (
                        f"drain withheld: expired member(s) {stale_hot} "
                        "last reported stall above "
                        f"{cfg.scale_down_stall_pct:.1f}% — evidence "
                        "stale, not absent"
                    ),
                }
            return {
                "action": "drain_candidate", "code": -1,
                "stall_pct": worst_stall,
                "reason": (
                    f"all members <= {cfg.scale_down_stall_pct:.1f}% "
                    "stall with clients attached — capacity to spare"
                ),
            }
        return {"action": "ok", "code": 0, "stall_pct": worst_stall,
                "reason": "pressure within band"}

    # -- request handlers ---------------------------------------------------

    def _handle_register(self, req: dict) -> tuple:
        server_id = str(req.get("server_id") or "")
        addr = str(req.get("addr") or "")
        if not server_id or not addr:
            return P.MSG_ERROR, {"message": "register needs server_id + addr"}
        P.parse_hostport(addr)  # reject an undialable advertise addr loudly
        num_fragments = int(req.get("num_fragments") or 0)
        with self._lock:
            known = self._members.get(server_id)
            if known is not None and known.addr == addr:
                # Idempotent re-register (agent retry, partition heal with
                # nothing else changed): refresh liveness, same lease table.
                known.last_heartbeat = time.monotonic()
                known.num_fragments = num_fragments or known.num_fragments
            else:
                self._members[server_id] = _Member(
                    server_id, addr, num_fragments
                )
                # Fresh member, fresh evidence: its live heartbeats
                # supersede any stale window it left behind on expiry.
                self._stale_pressure.pop(server_id, None)
                self._rebalance_locked()
            member = self._members[server_id]
            reply = {
                "generation": self.generation,
                "heartbeat_interval_s": self.config.heartbeat_interval_s,
                "lease_ttl_s": self.config.lease_ttl_s,
                "lease": member.lease(self.generation, len(self._members)),
            }
        self.registry.counter("fleet_registrations_total").inc()
        self._log(f"member {server_id} registered at {addr} "
                  f"(generation {reply['generation']})")
        return P.MSG_FLEET_REGISTER_OK, reply

    def _handle_heartbeat(self, req: dict) -> tuple:
        server_id = str(req.get("server_id") or "")
        # Field-TYPE validation BEFORE any state moves (the same
        # discipline protocol.hello_malformed gives the HELLO): a
        # malformed heartbeat must neither refresh the member's liveness
        # nor die as a ValueError repr — answer a diagnosable rejection
        # and leave the lease clock untouched.
        gen = req.get("generation")
        if gen is not None and not P.is_json_int(gen):
            return P.MSG_ERROR, {"message": (
                "malformed heartbeat field 'generation': expected "
                f"integer, got {type(gen).__name__} {gen!r}"
            )}
        with self._lock:
            member = self._members.get(server_id)
            if member is None:
                # Expired (or a coordinator restart lost the table): the
                # agent re-registers on this marker instead of beating into
                # the void forever.
                return P.MSG_ERROR, {
                    "message": f"{UNKNOWN_MEMBER_MARKER}: {server_id!r} — "
                               "re-register"
                }
            member.last_heartbeat = time.monotonic()
            if gen is not None:
                # The generation the member is acting on: a lag against
                # self.generation means its lease reply is still in
                # flight (or it is re-planning) — visible per member on
                # /healthz. A heartbeat WITHOUT the field (a minimal
                # foreign peer) keeps the last known value rather than
                # fabricating a permanent generation-0 stuck-lease
                # signal.
                member.acked_generation = int(gen)
            pressure = req.get("pressure")
            if isinstance(pressure, dict):
                member.pressure = dict(pressure)
            hist = req.get("queue_wait_hist")
            if isinstance(hist, dict):
                # Stored as-reported; shape-validated at merge time so one
                # malformed member degrades to "not reporting", never to a
                # poisoned aggregate.
                member.queue_wait_hist = dict(hist)
            jobs = req.get("jobs")
            if isinstance(jobs, dict):
                # v6 job plane: stored as-reported (shape-guarded by the
                # JobRegistry on absorption, same degrade-to-not-reporting
                # posture as the histogram above).
                member.jobs = dict(jobs)
            recommendation = self._recommend_locked()
            stalls = [
                float(m.pressure.get("stall_pct", 0.0))
                for m in self._members.values()
                if isinstance(m.pressure, dict)
            ]
            queue_wait = self._queue_wait_merged_locked()
            reply = {
                "generation": self.generation,
                "lease": member.lease(self.generation, len(self._members)),
            }
        self.registry.counter("fleet_heartbeats_total").inc()
        # Pressure surface (autotune fleet half): scraped series an
        # operator's alerting keys on, refreshed per heartbeat. Set outside
        # the lock — the registry has its own.
        if stalls:
            self.registry.gauge("fleet_pressure_stall_pct_max").set(
                max(stalls)
            )
            self.registry.gauge("fleet_pressure_stall_pct_mean").set(
                sum(stalls) / len(stalls)
            )
        if queue_wait is not None:
            # Fleet SLO surface (v5): exact cross-member percentiles from
            # summed bucket counts — same outside-the-lock discipline as
            # the pressure gauges above.
            for q in (50, 95, 99):
                self.registry.gauge(f"fleet_queue_wait_p{q}_ms").set(
                    queue_wait[f"p{q}_ms"]
                )
        self.registry.gauge("fleet_scale_recommendation").set(
            recommendation.get("code", 0)
        )
        if isinstance(jobs, dict):
            # Outside `_lock` (the JobRegistry lock is a leaf of its own).
            self.jobs.observe_member(server_id, jobs)
        return P.MSG_FLEET_HEARTBEAT_OK, reply

    def _handle_deregister(self, req: dict) -> tuple:
        server_id = str(req.get("server_id") or "")
        with self._lock:
            if self._members.pop(server_id, None) is not None:
                # A graceful leave is EVIDENCE, not a blip: no stale
                # pressure retained (contrast _expire_loop).
                self._stale_pressure.pop(server_id, None)
                self._rebalance_locked()
            generation = self.generation
        self.jobs.drop_member(server_id)
        self.registry.counter("fleet_deregistrations_total").inc()
        self._log(f"member {server_id} deregistered "
                  f"(generation {generation})")
        return P.MSG_FLEET_DEREGISTER_OK, {"generation": generation}

    def _handle_resolve(self, req: dict) -> tuple:
        # v6 job plane: a resolving client may declare its job so the
        # registry lists the tenant before any member has served it.
        # Unknown/absent fields are simply ignored (a pre-v6 client's
        # empty payload is the common case) — declare() validates types.
        self.jobs.declare(req.get("job_id"), req.get("job_priority"))
        with self._lock:
            payload = self._members_payload_locked()
        self.registry.counter("fleet_resolves_total").inc()
        return P.MSG_FLEET_RESOLVE_OK, payload

    # -- expiry -------------------------------------------------------------

    def _stale_pressure_ttl(self) -> float:
        """Retention horizon for an expired member's last pressure window
        (``stale_pressure_ttl_s``; 0 = 5 heartbeat-expiry TTLs, floor
        10s — long enough for an operator or autoscaler poll cycle to
        see the withheld-drain reason, short enough that a genuinely
        departed member stops haunting the recommendation)."""
        cfg = self.config
        if cfg.stale_pressure_ttl_s > 0:
            return float(cfg.stale_pressure_ttl_s)
        return max(5.0 * cfg.lease_ttl_s, 10.0)

    def _expire_loop(self) -> None:
        ttl = self.config.lease_ttl_s
        poll = max(min(ttl / 4.0, 1.0), 0.05)
        while not self._stopped.wait(poll):
            now = time.monotonic()
            expired = []
            with self._lock:
                for server_id, m in list(self._members.items()):
                    if now - m.last_heartbeat > ttl:
                        expired.append(server_id)
                        # Retain the last pressure window, tagged stale,
                        # before the member record dies: expiry used to
                        # drop it silently, and the survivors' calm would
                        # flip the recommendation to drain_candidate on
                        # the very blip that just shrank the fleet (the
                        # _recommend_locked loss-of-evidence guard).
                        if isinstance(m.pressure, dict):
                            self._stale_pressure[server_id] = dict(
                                m.pressure, stale=True, expired_at=now
                            )
                        del self._members[server_id]
                retention = self._stale_pressure_ttl()
                for server_id in [
                    sid for sid, entry in self._stale_pressure.items()
                    if now - entry.get("expired_at", now) > retention
                ]:
                    del self._stale_pressure[server_id]
                if expired:
                    self._rebalance_locked()
                    generation = self.generation
            for server_id in expired:
                self.jobs.drop_member(server_id)
            if expired:
                self.registry.counter("fleet_expirations_total").inc(
                    len(expired)
                )
                self._log(
                    f"expired {expired} after {ttl}s heartbeat silence "
                    f"(generation {generation})"
                )

    # -- control plane ------------------------------------------------------

    def start(self) -> "Coordinator":
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.config.host, self.config.port))
            sock.listen(64)
        except BaseException:
            # A failed bind (port in use) must not leak the listener fd
            # (LDT1201: the caller retries start(), each leak is forever).
            sock.close()
            raise
        self._sock = sock
        self.port = sock.getsockname()[1]
        if self.config.metrics_port is not None:
            from ..obs.http import MetricsHTTPServer

            try:
                self._metrics = MetricsHTTPServer(
                    self.registry,
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
            self._log(f"metrics on :{self.metrics_port} (/metrics, /healthz)")
        # Gauges exist from second zero — a scrape of an empty fleet reads
        # 0 members / generation 0, not absent series.
        self.registry.gauge("fleet_members").set(0)
        self.registry.gauge("fleet_lease_generation").set(self.generation)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ldt-fleet-accept"
        )
        self._accept_thread.start()
        self._expiry_thread = threading.Thread(
            target=self._expire_loop, daemon=True, name="ldt-fleet-expiry"
        )
        self._expiry_thread.start()
        self._log(f"coordinating on {self.config.host}:{self.port}")
        return self

    def _healthz(self) -> dict:
        with self._lock:
            payload = self._members_payload_locked()
        stopped = self._stopped.is_set()
        payload["status"] = "degraded" if stopped else "ok"
        payload["lease_ttl_s"] = self.config.lease_ttl_s
        payload["heartbeat_interval_s"] = self.config.heartbeat_interval_s
        from ..obs.http import build_info

        payload["build"] = build_info()
        return payload

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._stopped.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:  # listener closed by stop()
                return
            threading.Thread(
                target=self._handle_conn, args=(conn, f"{addr[0]}:{addr[1]}"),
                daemon=True, name=f"ldt-fleet-conn-{addr[1]}",
            ).start()

    def _handle_conn(self, conn: socket.socket, peer: str) -> None:
        """One request, one reply, close — the control-plane handshake. The
        deadline bounds the whole request read (a silent peer is dropped,
        LDT203), and any reply-side error just abandons the connection."""
        try:
            timeout = self.config.handshake_timeout_s
            deadline = time.monotonic() + timeout if timeout > 0 else None
            msg_type, req = P.recv_msg(conn, deadline=deadline)
            handler = {
                P.MSG_FLEET_REGISTER: self._handle_register,
                P.MSG_FLEET_HEARTBEAT: self._handle_heartbeat,
                P.MSG_FLEET_DEREGISTER: self._handle_deregister,
                P.MSG_FLEET_RESOLVE: self._handle_resolve,
            }.get(msg_type)
            if handler is None:
                reply_type, reply = P.MSG_ERROR, {
                    "message": f"unexpected fleet message type {msg_type}"
                }
            else:
                try:
                    # Spanned so a coordinator run with LDT_TRACE_PATH set
                    # appears on the merged fleet timeline (the control
                    # plane's track next to the data-plane flows).
                    with span("coord.handle", msg_type=msg_type, peer=peer):
                        reply_type, reply = handler(req)
                except (ValueError, TypeError, KeyError) as exc:
                    reply_type, reply = P.MSG_ERROR, {"message": repr(exc)}
            P.send_msg(conn, reply_type, reply)
        except (ConnectionError, OSError, P.ProtocolError):
            pass  # dead/garbage peer: nothing to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        """Blocking serve (the ``ldt coordinator`` entry). SIGTERM (docker
        stop, k8s preemption) and KeyboardInterrupt both drain through
        :meth:`stop` — the lease table dies with the process, members
        re-register against a successor."""
        from ..utils.signals import install_sigterm_handler

        if self._sock is None:
            self.start()
        install_sigterm_handler(self._stopped.set)
        try:
            interval = self.config.log_every_s
            while not self._stopped.wait(interval if interval > 0 else 3600.0):
                if interval > 0:
                    with self._lock:
                        line = self._members_payload_locked()
                    self._log(f"generation {line['generation']}, "
                              f"{line['stripe_count']} members")
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stopped.set()
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None
        if self._sock is not None:
            try:
                # shutdown wakes a concurrently-blocked accept(); a bare
                # close can leave the kernel listener alive while the
                # syscall holds the last reference (see DataService.stop).
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        if self._expiry_thread is not None:
            self._expiry_thread.join(timeout=2.0)

    def __enter__(self) -> "Coordinator":
        return self.start() if self._sock is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _log(self, msg: str) -> None:
        print(f"[coordinator] {msg}", flush=True)


def serve_coordinator(config: CoordinatorConfig) -> None:
    """Module-level convenience for the CLI."""
    Coordinator(config).serve_forever()
