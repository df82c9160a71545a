"""Deterministic fault injection for fleet members — failover is *tested*.

A copy of ``lance_distributed_training_tpu/fleet/chaos.py`` for the port.

A failover path that only runs in production outages is an untested path.
This module gives tests (and the CI fleet smoke) scripted control over a
member server's failure modes, deterministically:

* **kill** — the crash shape: every socket (listener + live sessions) is
  closed mid-stream with no ``MSG_END``, heartbeats stop with no
  ``DEREGISTER``. Clients see a dropped connection; the coordinator finds
  out at heartbeat expiry. ``kill_after(n)`` arms the kill to fire
  synchronously in the server's sender thread after *exactly* ``n`` batch
  frames have been sent — the test knows precisely which step the failover
  resumes from, every run.
* **stall** — the slow-server shape: the sender thread blocks before the
  n-th send for a scripted duration. No connection drops, so a correct
  client waits (a stall must NOT trigger failover — that's the livelock
  the no-mid-stream-deadline policy exists to prevent).
* **partition** — the control-plane-only cut: heartbeats pause (the
  coordinator expires the lease at TTL) while the data plane keeps
  serving. ``heal()`` resumes heartbeats and the agent re-registers on the
  ``unknown fleet member`` answer.

The injection point is ``DataService.chaos`` — a callable the sender loop
invokes before each batch send (``chaos("send", peer, step)``). In-thread
execution is what makes the schedule deterministic: the k-th send is the
k-th hook call, regardless of thread scheduling or wall clocks.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = ["ChaosController"]


class ChaosController:
    """Scripted kill/stall/partition of ONE member server under test
    control. Construct with the member's :class:`DataService` (and its
    fleet agent, when registered); the controller installs itself as the
    service's chaos hook."""

    def __init__(self, service, agent=None):
        self.service = service
        self.agent = agent if agent is not None else getattr(
            service, "fleet_agent", None
        )
        self._lock = threading.Lock()
        self._sends = 0
        self._kill_at: Optional[int] = None
        self._stall_at: Optional[int] = None
        self._stall_s = 0.0
        self._stalled = threading.Event()  # test sync: stall reached
        self.killed = threading.Event()  # test sync: kill fired
        service.chaos = self._hook

    # -- scripting ----------------------------------------------------------

    def kill_after(self, batches: int) -> "ChaosController":
        """Arm an abrupt kill to fire after exactly ``batches`` batch
        frames have crossed the wire (fleet-wide, all sessions)."""
        with self._lock:
            self._kill_at = int(batches)
        return self

    def stall_after(self, batches: int, seconds: float) -> "ChaosController":
        """Arm a sender stall of ``seconds`` before send ``batches + 1``."""
        with self._lock:
            self._stall_at = int(batches)
            self._stall_s = float(seconds)
        return self

    @property
    def batches_sent(self) -> int:
        with self._lock:
            return self._sends

    # -- immediate actions --------------------------------------------------

    def kill_now(self) -> None:
        """SIGKILL shape, in-process: no END frames, no deregister, every
        socket closed. Idempotent."""
        if self.killed.is_set():
            return
        self.killed.set()
        if self.agent is not None:
            self.agent.abort()
        # DataService.stop() closes the listener and every session socket
        # without sending MSG_END — from a peer's point of view that IS the
        # crash: connection reset mid-stream.
        self.service.stop()

    def partition(self) -> None:
        """Cut the control plane only: heartbeats pause, data keeps
        flowing; the coordinator expires the lease at TTL."""
        if self.agent is not None:
            self.agent.pause_heartbeats()

    def heal(self) -> None:
        """End a partition: heartbeats resume; the agent re-registers when
        the coordinator answers ``unknown fleet member``."""
        if self.agent is not None:
            self.agent.resume_heartbeats()

    def wait_stalled(self, timeout: float = 10.0) -> bool:
        """Block a test until an armed stall has actually been reached."""
        return self._stalled.wait(timeout)

    # -- the injection point ------------------------------------------------

    def _hook(self, event: str, peer: str, step: int) -> None:
        """Called by the server's sender thread before each batch send.
        Runs armed actions synchronously — determinism comes from being IN
        the send path, not racing it."""
        if event != "send":
            return
        with self._lock:
            self._sends += 1
            sends = self._sends
            kill = self._kill_at is not None and sends > self._kill_at
            stall = self._stall_at is not None and sends > self._stall_at
            if stall:
                self._stall_at = None  # one-shot
                stall_s = self._stall_s
        if stall:
            self._stalled.set()
            # Interruptible sleep: a concurrent kill/stop ends the stall.
            self.service._stopped.wait(stall_s)
        if kill:
            self.kill_now()
            # Abort this very send: the step armed as the kill point must
            # never reach the wire (kill_after(n) == exactly n delivered).
            raise ConnectionError("chaos: member killed")
