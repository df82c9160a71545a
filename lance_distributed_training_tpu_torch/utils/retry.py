"""One retry policy for every reconnect loop — full jitter, deadline budget.

A copy of ``lance_distributed_training_tpu/utils/retry.py`` for the port:
the same delays from the same seed.

Before this module the exponential-backoff loop was written three times with
three slightly different shapes: ``service/client.py`` (``_connect`` — no
cap, no jitter), ``fleet/balancer.py`` (``_resolve_members`` and
``_dial_member`` — 2 s cap, no jitter, a stray sleep after the final
attempt). Divergent retry behavior is itself a reliability bug: the uncapped
client loop could sleep 100+ s deep into a schedule while the fleet gave up,
and none of the loops jittered — N trainers restarted by the same preemption
redial a recovering server in lockstep, the classic retry storm.

:func:`retrying` is the one loop. Policy knobs live in
:class:`RetryPolicy`; sleeps use *full jitter* (AWS architecture-blog
recipe: ``sleep = uniform(0, min(cap, base * 2**attempt))``) so synchronized
clients de-synchronize by construction, and an optional **deadline budget**
bounds the whole loop's wall time — an attempt that cannot start (or whose
backoff cannot complete) before the deadline is simply not made, so callers
with an SLO fail fast instead of draining the full attempt schedule.

Every retry (attempt > 0) increments ``retry_attempts_total`` on the
registry, so /metrics shows reconnect pressure across ALL subsystems on one
series (per-subsystem counters like ``svc_connect_retries`` stay where they
were — this is the aggregate).

Jitter draws from an OS-entropy ``np.random.default_rng()`` — retry timing
must NOT be deterministic across processes (that would re-create the
thundering herd the jitter exists to break); LDT001 sanctions ``default_rng``
because plan/shuffle randomness never flows through here.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..obs.registry import MetricsRegistry, default_registry

__all__ = ["RetryPolicy", "retrying"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Shape of one retry schedule.

    ``attempts`` counts TOTAL tries (first attempt included; clamped >= 1).
    ``base_s`` doubles per retry up to ``cap_s``; with ``jitter`` the actual
    sleep is uniform in ``[0, bound]`` (full jitter), else exactly ``bound``.
    ``deadline_s`` is the whole loop's wall budget measured from the first
    attempt: no retry starts (and no backoff sleep begins) past it.
    """

    attempts: int = 5
    base_s: float = 0.2
    cap_s: float = 10.0
    deadline_s: Optional[float] = None
    jitter: bool = True

    def backoff_bound_s(self, retry_index: int) -> float:
        """Upper bound of the sleep before retry ``retry_index`` (0-based:
        the sleep between attempt 0 and attempt 1 has index 0)."""
        return min(self.cap_s, self.base_s * (2.0 ** retry_index))


def retrying(
    policy: RetryPolicy,
    *,
    stop: Optional[threading.Event] = None,
    registry: Optional[MetricsRegistry] = None,
    interrupt_message: str = "interrupted during retry",
    _rng: Optional[np.random.Generator] = None,
) -> Iterator[int]:
    """Yield attempt indices ``0, 1, …`` with backoff sleeps in between.

    The caller's body runs between yields: try the operation, ``return`` /
    ``break`` on success, swallow the retryable exception and fall through
    to the next iteration otherwise. When the generator is exhausted every
    attempt failed — the caller raises its own "unreachable after N
    attempts" error (messages stay caller-owned and specific).

    ``stop`` makes the loop abort-able: a set event raises
    ``ConnectionError(interrupt_message)`` between attempts and interrupts
    backoff sleeps mid-wait — closing a loader during an outage returns
    promptly instead of draining the schedule. ``_rng`` overrides the
    OS-entropy jitter source (deterministic tests only).
    """
    registry = registry if registry is not None else default_registry()
    rng = _rng if _rng is not None else np.random.default_rng()
    waiter = stop if stop is not None else threading.Event()
    deadline = (
        time.monotonic() + policy.deadline_s
        if policy.deadline_s is not None
        else None
    )
    for attempt in range(max(1, policy.attempts)):
        if stop is not None and stop.is_set():
            raise ConnectionError(interrupt_message)
        if attempt:
            bound = policy.backoff_bound_s(attempt - 1)
            delay = float(rng.uniform(0.0, bound)) if policy.jitter else bound
            if deadline is not None and (
                time.monotonic() + delay > deadline
            ):
                # Budget exhausted: the retry could not complete its backoff
                # (or start) inside the deadline — stop trying, let the
                # caller raise with its last captured error.
                return
            registry.counter("retry_attempts_total").inc()
            if waiter.wait(delay):
                raise ConnectionError(interrupt_message)
        elif deadline is not None and time.monotonic() > deadline:
            return
        yield attempt
