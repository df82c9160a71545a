"""``FleetAgent`` — a data server's membership half.

A copy of ``lance_distributed_training_tpu/fleet/agent.py`` for the port.

Owned by :class:`~..service.server.DataService` when
``ServeConfig.coordinator_addr`` is set: registers the server's advertise
address with the :class:`~.coordinator.Coordinator` at start, heartbeats on
a daemon thread, surfaces lease changes (generation bumps) back to the
service through ``on_lease_change``, and deregisters on stop so a graceful
shutdown reassigns the lease immediately instead of waiting out the TTL.

Failure discipline: the agent never takes the data plane down. A missing or
crashed coordinator means retry-with-backoff forever (members keep serving
the clients they have; discovery degrades, streams don't), and an
``unknown fleet member`` heartbeat answer — expiry while partitioned, or a
coordinator restart that lost the table — triggers re-registration, not an
error.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import Callable, Optional

from ..service import protocol as P
from .coordinator import UNKNOWN_MEMBER_MARKER

__all__ = ["FleetAgent"]


class FleetAgent:
    """Register + heartbeat one data server against a coordinator."""

    def __init__(
        self,
        coordinator_addr: str,
        advertise_addr: str,
        *,
        server_id: Optional[str] = None,
        num_fragments: int = 0,
        on_lease_change: Optional[Callable[[dict], None]] = None,
        counters=None,  # a ServiceCounters (optional): fleet_* keys
        heartbeat_interval_s: float = 0.0,  # 0 = coordinator-advertised
        dial_timeout_s: float = 5.0,
        backoff_s: float = 0.2,  # doubles per failure, capped at ~5s
        pressure_fn: Optional[Callable[[], dict]] = None,  # windowed
        # stall/occupancy this member reports per heartbeat (the
        # coordinator's scale-recommendation input; None = no pressure
        # field, pre-r9 heartbeat shape)
        hist_fn: Optional[Callable[[], Optional[dict]]] = None,  # v5:
        # mergeable queue-wait histogram ({counts, sum, count}) per
        # heartbeat — the coordinator sums bucket counts across members
        # into fleet-wide percentiles. None (or a None return) omits the
        # field, so pre-v5 coordinators see the exact old payload.
        jobs_fn: Optional[Callable[[], Optional[dict]]] = None,  # v6 job
        # plane: this member's per-job stats (JobPlane.stats) per
        # heartbeat, absorbed into the coordinator's JobRegistry. None
        # (or a None/empty return) omits the field — pre-v6 coordinators
        # and job-less members keep the exact old payload.
    ):
        self.coordinator_host, self.coordinator_port = P.parse_hostport(
            coordinator_addr
        )
        self.advertise_addr = advertise_addr
        self.server_id = server_id or (
            f"{advertise_addr}#{uuid.uuid4().hex[:8]}"
        )
        self.num_fragments = num_fragments
        self.on_lease_change = on_lease_change
        self.counters = counters
        self.pressure_fn = pressure_fn
        self.hist_fn = hist_fn
        self.jobs_fn = jobs_fn
        self.heartbeat_interval_s = heartbeat_interval_s
        self.dial_timeout_s = dial_timeout_s
        self.backoff_s = backoff_s
        self.lease: Optional[dict] = None
        self.generation: int = 0
        # Coordinator-advertised expiry horizon (REGISTER_OK lease_ttl_s):
        # how long this member may go silent before its lease is reaped.
        # Surfaced on /healthz so an operator can spot a heartbeat
        # interval configured dangerously close to the TTL.
        self.lease_ttl_s: float = 0.0
        self.registered = threading.Event()  # tests/healthz wait on this
        self._stop = threading.Event()
        self._paused = threading.Event()  # chaos: heartbeats held, not dead
        self._thread: Optional[threading.Thread] = None

    # -- coordinator RPC ----------------------------------------------------

    def _call(self, msg_type: int, payload: dict) -> tuple:
        """One request/reply exchange on a fresh connection — the fleet
        control plane's whole wire contract. The reply read is
        deadline-bounded (a wedged coordinator must not pin the heartbeat
        thread past a dial timeout)."""
        with socket.create_connection(
            (self.coordinator_host, self.coordinator_port),
            timeout=self.dial_timeout_s,
        ) as sock:
            P.send_msg(sock, msg_type, payload)
            return P.recv_msg(
                sock, deadline=time.monotonic() + self.dial_timeout_s
            )

    def _count(self, key: str) -> None:
        if self.counters is not None:
            self.counters.add(key)

    def _apply_lease(self, reply: dict) -> None:
        generation = int(reply.get("generation", 0))
        lease = reply.get("lease")
        changed = generation != self.generation
        self.generation = generation
        if isinstance(lease, dict):
            self.lease = lease
        if changed and self.on_lease_change is not None and self.lease:
            self.on_lease_change(dict(self.lease))

    def _register(self) -> bool:
        try:
            msg_type, reply = self._call(P.MSG_FLEET_REGISTER, {
                "server_id": self.server_id,
                "addr": self.advertise_addr,
                "num_fragments": self.num_fragments,
            })
        except (ConnectionError, OSError, P.ProtocolError):
            self._count("fleet_register_errors")
            return False
        if msg_type != P.MSG_FLEET_REGISTER_OK:
            self._count("fleet_register_errors")
            return False
        if self.heartbeat_interval_s <= 0:
            self.heartbeat_interval_s = float(
                reply.get("heartbeat_interval_s") or 2.0
            )
        self.lease_ttl_s = float(reply.get("lease_ttl_s") or 0.0)
        self._apply_lease(reply)
        self._count("fleet_registrations")
        self.registered.set()
        return True

    def _heartbeat_once(self) -> None:
        payload = {
            "server_id": self.server_id,
            "generation": self.generation,
        }
        if self.pressure_fn is not None:
            try:
                payload["pressure"] = self.pressure_fn()
            except Exception:  # noqa: BLE001 — telemetry must never kill
                pass  # the heartbeat that keeps the lease alive
        if self.hist_fn is not None:
            try:
                hist = self.hist_fn()
                if hist is not None:
                    payload["queue_wait_hist"] = hist
            except Exception:  # noqa: BLE001 — same contract as pressure
                pass
        if self.jobs_fn is not None:
            try:
                jobs = self.jobs_fn()
                if jobs:  # None/empty → field omitted (old payload shape)
                    payload["jobs"] = jobs
            except Exception:  # noqa: BLE001 — same contract as pressure
                pass
        try:
            msg_type, reply = self._call(P.MSG_FLEET_HEARTBEAT, payload)
        except (ConnectionError, OSError, P.ProtocolError):
            self._count("fleet_heartbeat_errors")
            return
        if msg_type == P.MSG_FLEET_HEARTBEAT_OK:
            self._count("fleet_heartbeats")
            self._apply_lease(reply)
        elif (
            msg_type == P.MSG_ERROR
            and UNKNOWN_MEMBER_MARKER in str(reply.get("message", ""))
        ):
            # Expired while partitioned, or the coordinator restarted and
            # lost the table — rejoin rather than beat into the void.
            self.registered.clear()
            self._register()
        else:
            self._count("fleet_heartbeat_errors")

    # -- lifecycle ----------------------------------------------------------

    def _run(self) -> None:
        backoff = self.backoff_s
        while not self._stop.is_set():
            if not self.registered.is_set():
                if self._register():
                    backoff = self.backoff_s
                else:
                    # Coordinator missing/unreachable: keep serving, keep
                    # retrying — discovery degrades, the data plane doesn't.
                    if self._stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, 5.0)
                    continue
            interval = self.heartbeat_interval_s or 2.0
            if self._stop.wait(interval):
                return
            if self._paused.is_set():  # chaos partition: alive but silent
                continue
            self._heartbeat_once()

    def start(self) -> "FleetAgent":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ldt-fleet-agent"
        )
        self._thread.start()
        return self

    def stop(self, deregister: bool = True) -> None:
        """Graceful leave: halt the loop, then best-effort DEREGISTER so the
        lease reassigns now instead of at TTL expiry."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if deregister and self.registered.is_set():
            try:
                msg_type, reply = self._call(
                    P.MSG_FLEET_DEREGISTER, {"server_id": self.server_id}
                )
                if msg_type == P.MSG_FLEET_DEREGISTER_OK:
                    if self.counters is not None:
                        # The post-leave generation: what the lease table
                        # became because we left — the last fleet fact a
                        # draining member can report (a gauge, not
                        # self.generation: the heartbeat thread owns that
                        # attribute).
                        self.counters.gauge(
                            "fleet_leave_generation",
                            int(reply.get("generation") or 0),
                        )
                    self._count("fleet_deregistrations")
                else:
                    # An ERROR answer (or a future coordinator speaking a
                    # frame type this build does not know) means the lease
                    # may NOT have been released — it will go the hard way,
                    # at TTL expiry. Count it so the drain path's
                    # best-effort nature is observable (LDT1003: every
                    # inbound frame type gets a behavior, not a
                    # fall-through).
                    self._count("fleet_deregister_errors")
            except (ConnectionError, OSError, P.ProtocolError):
                pass  # coordinator gone: expiry will reap the lease
        self.registered.clear()

    def abort(self) -> None:
        """Crash-shaped leave (chaos ``kill``): no deregister — the
        coordinator finds out the hard way, at heartbeat expiry."""
        self.stop(deregister=False)

    def pause_heartbeats(self) -> None:
        """Chaos ``partition``: the server keeps serving but goes silent on
        the control plane; the coordinator expires its lease at TTL."""
        self._paused.set()

    def resume_heartbeats(self) -> None:
        self._paused.clear()
