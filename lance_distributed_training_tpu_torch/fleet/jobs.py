"""Job plane — multi-tenant registry, fairness, and admission control.

A copy of ``lance_distributed_training_tpu/fleet/jobs.py`` for the port.

One fleet, N logical consumers. Before r20 every HELLO was anonymous:
one cursor per connection, one metric scope per server, and a
Coordinator that balanced *bytes* with no notion of *whose* bytes. This
module is the tf.data-service half the ROADMAP calls out (PAPERS.md
2210.14826 — disaggregated input processing shared across jobs): a
**job** is a named tenant (``job_id`` in the v6 HELLO, see
``service/protocol.py``) with a priority class, its own resume cursors,
its own metric scope, and an admission verdict.

Three pieces, one per plane:

* :class:`FairScheduler` — stride scheduling over *produce* steps. Each
  job owns a virtual pass that advances by ``1/weight`` per granted
  step; when several jobs' producers contend, the lowest pass goes
  first, so long-run produce share converges to the weight ratio.
  Preempting classes (``inference``) sort ahead of every non-preempting
  waiter regardless of pass — a single-batch fetch never queues behind
  a bulk scan. The decision core (:meth:`FairScheduler.pick` /
  :meth:`FairScheduler.advance`) is pure state, unit-testable without
  threads; :meth:`FairScheduler.begin_step` is the blocking wrapper the
  server's producer calls, and its wait is hard-bounded — fairness is
  *pacing*, never a wedge (a dead peer cannot stall another tenant's
  stream, and batch CONTENT is untouched either way — LDT1301: this
  class only decides *when* a step is produced, never *what*).
* :class:`JobPlane` — the DataService-side tenant table. Resolves the
  HELLO's job fields (absent → the implicit default job, which is how
  every pre-v6 peer keeps its exact pre-r20 behavior), admits or
  refuses sessions (:class:`AdmissionRefused` messages start with the
  frozen ``ADMISSION_REFUSED_MARKER`` wire prose), and owns per-job
  ``ServiceCounters`` scopes (``svc_job_<slug>_*`` — the label-less
  registry's name-prefix discipline, LDT601) plus a per-job
  :class:`~..obs.slo.SLOTracker` publishing ``slo_job_<slug>_stall_pct``
  burn-down. Already-admitted jobs are NEVER refused: a failover
  reconnect must always succeed, so admission gates apply to *new*
  tenants only.
* :class:`JobRegistry` — the Coordinator-side fleet view. Aggregates
  the per-job stats that ride member heartbeats (the optional ``jobs``
  field — old coordinators ignore it, exactly like ``queue_wait_hist``)
  into fleet-wide rows (sessions summed, cursors maxed, cache hit
  rates, worst SLO burn) served to ``MSG_FLEET_RESOLVE`` clients,
  ``/healthz``, and the ``ldt jobs`` / ``ldt fleet recommend`` CLIs.
  Cursors survive member loss: the registry keeps the max step it ever
  saw per job, so "where was my job?" has an answer even while the
  fleet that served it is being replaced.

Per-job *plans* need no new machinery: ``plan_for`` keys plans by the
full sampler config and builds them through ``LanceSource.shard_plans``
(the PR-16 graph seam), so two jobs with identical configs share one
plan object and two jobs with different configs cannot drift — and the
PR-13 content-keyed batch cache makes the second same-config job stream
decode-free for free (cross-job cache hits are just cache hits).

Clock policy: admission and stall windows use ``time.monotonic()``
(durations); nothing here touches batch bytes, plan order, or cursor
*computation* — cursors are observed ACKs, recorded as telemetry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..obs.registry import MetricsRegistry, default_registry
from ..obs.slo import SLOTracker, scoped_slos
from ..service import protocol as P
from ..utils.metrics import ServiceCounters

__all__ = [
    "DEFAULT_JOB_ID",
    "DEFAULT_PRIORITY",
    "PriorityClass",
    "PRIORITY_CLASSES",
    "job_slug",
    "AdmissionRefused",
    "FairScheduler",
    "JobPlane",
    "JobRegistry",
]

# The implicit tenant: what a v5 peer, or a v6 peer that declared
# nothing, maps onto. Its existence is what makes the job plane
# downgrade-SAFE — pre-r20 exchanges become "the default job" with no
# behavior change, not an error.
DEFAULT_JOB_ID = "default"
DEFAULT_PRIORITY = "training"


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One admission/fairness class a job declares in its HELLO.

    ``weight`` is the stride-scheduling share (2:1 weights → 2:1
    long-run produce steps under contention). ``preempt`` classes sort
    ahead of every non-preempting waiter regardless of accumulated
    pass — the low-latency guarantee. ``read_only`` classes are serving
    probes (single-batch fetches, no training epoch) and are exempt
    from the ``admission_max_jobs`` cap: the cap protects bulk decode
    capacity, which a read-only fetch barely touches."""

    name: str
    weight: float
    preempt: bool = False
    read_only: bool = False


# The built-in vocabulary. Unknown classes are refused at admission
# (a typo'd class silently scheduled at some default weight would be
# the skew-class bug this repo refuses everywhere else).
PRIORITY_CLASSES: Dict[str, PriorityClass] = {
    "inference": PriorityClass(
        "inference", weight=4.0, preempt=True, read_only=True
    ),
    "training": PriorityClass("training", weight=2.0),
    "bulk": PriorityClass("bulk", weight=1.0),
}

_SLUG_RE = re.compile(r"[^a-z0-9_]+")


def job_slug(job_id: str) -> str:
    """``job_id`` → metric-safe scope fragment (``[a-z0-9_]+``).

    Registry names must match ``^[a-z][a-z0-9_]*$`` (LDT601); a job id
    is operator prose (``smoke-train``, ``Tenant.A``). Lowercase, map
    every illegal run to ``_``, and never return empty — the result is
    embedded as ``svc_job_<slug>_*`` / ``slo_job_<slug>_*``. Lossy by
    design: colliding tenants are disambiguated by :class:`JobPlane`
    with a content-hash suffix, not here."""
    slug = _SLUG_RE.sub("_", str(job_id).lower()).strip("_")
    return slug or "job"


class AdmissionRefused(Exception):
    """A session's job was refused admission. ``str(exc)`` is the full
    diagnosable message (starts with ``ADMISSION_REFUSED_MARKER``) and
    is what the server sends as the MSG_ERROR payload."""


def _refusal(reason: str) -> AdmissionRefused:
    return AdmissionRefused(f"{P.ADMISSION_REFUSED_MARKER}: {reason}")


class FairScheduler:
    """Weighted-fair stride scheduling of produce steps across jobs.

    State is three maps under one condition variable: per-job virtual
    pass, weight, and preempt flag, plus a count of producer threads
    currently *waiting* per job. Only waiting jobs contend — a job
    whose producer is blocked on its own full queue (a slow consumer)
    neither holds anyone back nor banks credit it would later burst.

    The decision core is pure: :meth:`pick` says which contender goes
    next (``(not preempt, pass, job_id)`` — preemptors first, then
    lowest pass, id as the deterministic tie-break) and :meth:`advance`
    charges one step at ``1/weight``. :meth:`begin_step` wraps them
    with a bounded wait: ``max_wait_s`` caps any single step's fairness
    delay so a wedged tenant degrades fairness, never liveness."""

    def __init__(
        self,
        classes: Optional[Dict[str, PriorityClass]] = None,
        max_wait_s: float = 1.0,
    ):
        self._classes = dict(classes or PRIORITY_CLASSES)
        self.max_wait_s = float(max_wait_s)
        self._cond = threading.Condition()
        self._vpass: Dict[str, float] = {}
        self._weight: Dict[str, float] = {}
        self._preempt: Dict[str, bool] = {}
        self._waiting: Dict[str, int] = {}

    def _ensure_locked(self, job_id: str, priority: str) -> None:
        if job_id in self._vpass:
            return
        cls = self._classes.get(priority) or self._classes.get(
            DEFAULT_PRIORITY, PriorityClass(DEFAULT_PRIORITY, 1.0)
        )
        # Join at the minimum live pass: no catch-up burst (joining at
        # 0 while incumbents sit at 50 would grant 50 back-to-back
        # steps) and no starvation (joining above everyone would).
        self._vpass[job_id] = min(self._vpass.values(), default=0.0)
        self._weight[job_id] = max(1e-6, float(cls.weight))
        self._preempt[job_id] = bool(cls.preempt)

    def ensure(self, job_id: str, priority: str = DEFAULT_PRIORITY) -> None:
        """Register a job's class before its first step (idempotent)."""
        with self._cond:
            self._ensure_locked(job_id, priority)

    def forget(self, job_id: str) -> None:
        with self._cond:
            self._vpass.pop(job_id, None)
            self._weight.pop(job_id, None)
            self._preempt.pop(job_id, None)
            self._cond.notify_all()

    def _pick_locked(self, waiting: Iterable[str]) -> Optional[str]:
        best: Optional[Tuple[Tuple[bool, float, str], str]] = None
        for job_id in waiting:
            self._ensure_locked(job_id, DEFAULT_PRIORITY)
            key = (not self._preempt[job_id], self._vpass[job_id], job_id)
            if best is None or key < best[0]:
                best = (key, job_id)
        return best[1] if best is not None else None

    def pick(self, waiting: Iterable[str]) -> Optional[str]:
        """Which of the contending jobs produces next (pure decision)."""
        with self._cond:
            return self._pick_locked(list(waiting))

    def _advance_locked(self, job_id: str) -> None:
        self._ensure_locked(job_id, DEFAULT_PRIORITY)
        self._vpass[job_id] += 1.0 / self._weight[job_id]
        self._cond.notify_all()

    def advance(self, job_id: str) -> None:
        """Charge ``job_id`` one produce step (pure state update)."""
        with self._cond:
            self._advance_locked(job_id)

    def begin_step(self, job_id: str) -> None:
        """Block (bounded) until it is ``job_id``'s turn, then charge it.

        Fast path — no other job has a waiting producer — takes the
        lock once and returns. Same-job producer threads never pace
        each other (fairness is across tenants, not within one)."""
        deadline = time.monotonic() + self.max_wait_s
        with self._cond:
            self._ensure_locked(job_id, DEFAULT_PRIORITY)
            self._waiting[job_id] = self._waiting.get(job_id, 0) + 1
            try:
                while True:
                    contenders = [j for j, c in self._waiting.items() if c > 0]
                    if len(contenders) <= 1:
                        break
                    if self._pick_locked(contenders) == job_id:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        break  # bounded: degrade fairness, never liveness
                    self._cond.wait(timeout=min(0.05, remaining))
            finally:
                count = self._waiting.get(job_id, 1) - 1
                if count > 0:
                    self._waiting[job_id] = count
                else:
                    self._waiting.pop(job_id, None)
            self._advance_locked(job_id)


class _JobState:
    """One admitted tenant on one DataService (plane-lock protected)."""

    __slots__ = (
        "job_id",
        "priority",
        "slug",
        "counters",
        "sessions",
        "cursors",
        "plan_keys",
        "slo",
    )

    def __init__(
        self,
        job_id: str,
        priority: PriorityClass,
        slug: str,
        counters: ServiceCounters,
        slo: Optional[SLOTracker],
    ):
        self.job_id = job_id
        self.priority = priority
        self.slug = slug
        self.counters = counters
        self.sessions: Set[str] = set()
        self.cursors: Dict[str, int] = {}  # client_id -> last acked step
        self.plan_keys: Set[str] = set()
        self.slo = slo

    def cursor(self) -> int:
        """Max acked step across this job's clients (-1 = none yet)."""
        return max(self.cursors.values(), default=-1)


class JobPlane:
    """The DataService-side tenant table: admission, scopes, cursors.

    ``max_jobs``/``max_stall_pct`` are the admission knobs (``0`` =
    disabled, the default — so a pre-r20 deployment admits everything,
    exactly as before). ``stall_fn`` is the service's windowed stall
    probe; a *new* job arriving while the fleet already burns its stall
    SLO is refused with a diagnosable marker message rather than
    admitted into a brown-out. ``counters`` is the service-wide
    ``svc_`` scope (refusal counter, ``svc_jobs_active`` gauge);
    per-job scopes are created here on first admit."""

    def __init__(
        self,
        *,
        counters: Optional[ServiceCounters] = None,
        registry: Optional[MetricsRegistry] = None,
        max_jobs: int = 0,
        max_stall_pct: float = 0.0,
        stall_fn: Optional[Callable[[], float]] = None,
        slo_interval_s: float = 5.0,
        classes: Optional[Dict[str, PriorityClass]] = None,
    ):
        self._registry = (
            registry if registry is not None else default_registry()
        )
        self._counters = (
            counters
            if counters is not None
            else ServiceCounters(registry=self._registry)
        )
        self._classes = dict(classes or PRIORITY_CLASSES)
        self.max_jobs = int(max_jobs)
        self.max_stall_pct = float(max_stall_pct)
        self._stall_fn = stall_fn
        self._slo_interval_s = float(slo_interval_s)
        self.scheduler = FairScheduler(self._classes)
        self._lock = threading.RLock()
        self._jobs: Dict[str, _JobState] = {}
        self._slugs: Dict[str, str] = {}  # slug -> owning job_id
        # Per-job stall windows: job_id -> (monotonic instant,
        # queue_empty_s total at that instant); consumed by the per-job
        # SLO probe, which runs on the tracker ticker.
        self._stall_prev: Dict[str, Tuple[float, float]] = {}

    # -- HELLO resolution --------------------------------------------------

    @staticmethod
    def resolve(job_id, priority) -> Tuple[str, str]:
        """Raw HELLO ``job_id``/``job_priority`` fields → ``(job_id,
        priority)`` with the implicit default for absent/null values (v5
        peers, undeclared v6). Takes the fields, not the payload, so the
        server's handshake reads them where LDT1401 can see the pairing."""
        return (
            str(job_id) if job_id else DEFAULT_JOB_ID,
            str(priority) if priority else DEFAULT_PRIORITY,
        )

    # -- admission ---------------------------------------------------------

    def _slug_locked(self, job_id: str) -> str:
        slug = job_slug(job_id)
        owner = self._slugs.get(slug)
        if owner is not None and owner != job_id:
            # Colliding tenants ("a-b" vs "a.b" both → "a_b"): the
            # second comer gets a content-hash suffix so its metric
            # scope stays distinct and deterministic for this pair.
            digest = hashlib.sha1(job_id.encode("utf-8")).hexdigest()[:6]
            slug = f"{slug}_{digest}"
        self._slugs[slug] = job_id
        return slug

    def admit(self, job_id: str, priority: str, session_key: str) -> None:
        """Admit one session of ``job_id`` or raise AdmissionRefused.

        Gates apply to NEW jobs only — an already-admitted job's
        reconnect (failover, resume, a second worker process) must
        always succeed, or a fleet blip would strand a tenant that was
        already serving. A re-declaration with a *different* priority
        class is refused as skew: two halves of one job scheduled at
        different weights would silently break the fair-share story."""
        with self._lock:
            cls = self._classes.get(priority)
            if cls is None:
                self._counters.add("admission_refusals")
                raise _refusal(
                    f"unknown priority class {priority!r} for job "
                    f"{job_id!r} (known: {sorted(self._classes)})"
                )
            state = self._jobs.get(job_id)
            if state is not None:
                if state.priority.name != priority:
                    self._counters.add("admission_refusals")
                    raise _refusal(
                        f"job {job_id!r} already admitted with priority "
                        f"class {state.priority.name!r}, HELLO declares "
                        f"{priority!r} — priority skew across one job's "
                        f"clients"
                    )
                state.sessions.add(session_key)
                self._publish_locked(state)
                return
            if self.max_jobs > 0 and not cls.read_only:
                active = sum(
                    1
                    for s in self._jobs.values()
                    if not s.priority.read_only
                )
                if active >= self.max_jobs:
                    self._counters.add("admission_refusals")
                    raise _refusal(
                        f"job capacity reached ({active}/{self.max_jobs} "
                        f"non-read-only jobs admitted); job {job_id!r} "
                        f"must wait for a slot (--admission_max_jobs)"
                    )
            if self.max_stall_pct > 0.0 and self._stall_fn is not None:
                try:
                    stall = float(self._stall_fn())
                except Exception:  # noqa: BLE001 — a broken probe must
                    stall = 0.0  # not close the admission gate
                if stall > self.max_stall_pct:
                    self._counters.add("admission_refusals")
                    raise _refusal(
                        f"fleet stall {stall:.1f}% exceeds the admission "
                        f"ceiling {self.max_stall_pct:.1f}% "
                        f"(--admission_max_stall_pct); admitting new job "
                        f"{job_id!r} would breach the stall SLO for "
                        f"every admitted tenant"
                    )
            slug = self._slug_locked(job_id)
            counters = ServiceCounters(
                prefix=f"svc_job_{slug}", registry=self._registry
            )
            slo = SLOTracker(
                probes={
                    f"job_{slug}_stall_pct": (
                        lambda j=job_id: self._job_stall(j)
                    )
                },
                slos=scoped_slos(f"job_{slug}"),
                registry=self._registry,
                interval_s=self._slo_interval_s,
            ).start()
            state = _JobState(job_id, cls, slug, counters, slo)
            state.sessions.add(session_key)
            self._jobs[job_id] = state
            self.scheduler.ensure(job_id, priority)
            self._publish_locked(state)

    def release(self, job_id: str, session_key: str) -> None:
        """One session ended. The job's state (cursor, scope, class)
        survives — reconnects resume the same tenant."""
        with self._lock:
            state = self._jobs.get(job_id)
            if state is None:
                return
            state.sessions.discard(session_key)
            self._publish_locked(state)

    def _publish_locked(self, state: _JobState) -> None:
        state.counters.gauge("sessions", float(len(state.sessions)))
        state.counters.gauge("cursor", float(state.cursor()))
        self._counters.gauge("jobs_active", float(len(self._jobs)))

    # -- per-job accounting (called from the session hot paths) ------------

    def counters_for(self, job_id: str) -> Optional[ServiceCounters]:
        with self._lock:
            state = self._jobs.get(job_id)
            return state.counters if state is not None else None

    def note_cursor(self, job_id: str, client_id: str, step: int) -> None:
        """Record an observed ACK — the per-job resume cursor view."""
        with self._lock:
            state = self._jobs.get(job_id)
            if state is None:
                return
            prev = state.cursors.get(client_id, -1)
            if step > prev:
                state.cursors[client_id] = int(step)
                state.counters.gauge("cursor", float(state.cursor()))

    def note_plan(self, job_id: str, plan_key) -> None:
        """Record which shared plan instance this job streams from."""
        with self._lock:
            state = self._jobs.get(job_id)
            if state is not None and len(state.plan_keys) < 32:
                state.plan_keys.add(str(plan_key))

    def note_cache(self, job_id: str, hit: bool) -> None:
        with self._lock:
            state = self._jobs.get(job_id)
        if state is not None:
            state.counters.add("cache_hit" if hit else "cache_miss")

    def begin_step(self, job_id: str) -> None:
        self.scheduler.begin_step(job_id)

    # -- per-job SLO probe -------------------------------------------------

    def _job_stall(self, job_id: str) -> float:
        """Windowed per-job stall % (share of the window this job's
        senders sat on an empty queue, per session), NaN until two
        samples exist. Mirrors ``DataService.pressure`` at job scope."""
        with self._lock:
            state = self._jobs.get(job_id)
            if state is None:
                return math.nan
            snap = state.counters.snapshot()
            empty = float(snap.get(f"svc_job_{state.slug}_queue_empty_s", 0.0))
            sessions = max(1, len(state.sessions))
            now = time.monotonic()
            prev = self._stall_prev.get(job_id)
            self._stall_prev[job_id] = (now, empty)
        if prev is None:
            return math.nan
        window = now - prev[0]
        if window <= 0.0:
            return math.nan
        return min(100.0, 100.0 * (empty - prev[1]) / (window * sessions))

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, dict]:
        """Per-job stats for heartbeats / ``/healthz`` — JSON-safe,
        objective names de-scoped back to their base (``stall_pct``)
        so consumers need not know the slug."""
        with self._lock:
            states = list(self._jobs.values())
        out: Dict[str, dict] = {}
        for state in states:
            snap = state.counters.snapshot()
            prefix = f"svc_job_{state.slug}_"
            slo_status = {}
            if state.slo is not None:
                scope = f"job_{state.slug}_"
                for name, entry in state.slo.status().items():
                    base = (
                        name[len(scope):] if name.startswith(scope) else name
                    )
                    slo_status[base] = entry
            out[state.job_id] = {
                "priority": state.priority.name,
                "sessions": len(state.sessions),
                "cursor": state.cursor(),
                "plans": sorted(state.plan_keys),
                "batches_sent": snap.get(prefix + "batches_sent", 0.0),
                "cache_hit": snap.get(prefix + "cache_hit", 0.0),
                "cache_miss": snap.get(prefix + "cache_miss", 0.0),
                "slo": slo_status,
            }
        return out

    def stop(self) -> None:
        with self._lock:
            states = list(self._jobs.values())
        for state in states:
            if state.slo is not None:
                state.slo.stop()


def _hit_rate(hit: float, miss: float) -> Optional[float]:
    total = hit + miss
    return round(hit / total, 4) if total > 0 else None


class JobRegistry:
    """The Coordinator-side fleet-wide job view.

    Fed from two directions: ``MSG_FLEET_RESOLVE`` payloads *declare* a
    job before any member has served it (so ``ldt jobs`` can see a
    tenant the moment its loader resolves), and member heartbeats carry
    each DataService's :meth:`JobPlane.stats` (the optional ``jobs``
    field — ignored by old coordinators, like every heartbeat extension
    since v5). Cursors are retained at registry scope beyond member
    loss: the max acked step per job survives the very failover that
    destroyed the member-side state."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._declared: Dict[str, str] = {}  # job_id -> priority class
        self._members: Dict[str, Dict[str, dict]] = {}
        self._cursors: Dict[str, int] = {}  # job_id -> max step ever seen

    def declare(self, job_id, priority=None) -> None:
        """A resolving client announced its job (additive, idempotent)."""
        if not job_id or not isinstance(job_id, str):
            return
        with self._lock:
            if isinstance(priority, str) and priority:
                self._declared[job_id] = priority
            else:
                self._declared.setdefault(job_id, DEFAULT_PRIORITY)

    def observe_member(self, server_id: str, jobs) -> None:
        """Absorb one heartbeat's per-job stats (malformed → ignored:
        telemetry must never kill the heartbeat handler)."""
        if not isinstance(jobs, dict):
            return
        clean: Dict[str, dict] = {}
        for job_id, entry in jobs.items():
            if not isinstance(job_id, str) or not isinstance(entry, dict):
                continue
            clean[job_id] = entry
        with self._lock:
            self._members[server_id] = clean
            for job_id, entry in clean.items():
                self._declared.setdefault(
                    job_id, str(entry.get("priority") or DEFAULT_PRIORITY)
                )
                cursor = entry.get("cursor")
                if P.is_json_int(cursor):
                    prev = self._cursors.get(job_id, -1)
                    if cursor > prev:
                        self._cursors[job_id] = cursor

    def drop_member(self, server_id: str) -> None:
        """Member expired or deregistered — its live stats leave the
        aggregate; registry-scope cursors stay."""
        with self._lock:
            self._members.pop(server_id, None)

    def payload(self) -> List[dict]:
        """Fleet-wide per-job rows (JSON-safe, sorted by job_id) for
        RESOLVE_OK / ``/healthz`` / ``ldt jobs``."""
        with self._lock:
            rows: Dict[str, dict] = {}
            for job_id, priority in self._declared.items():
                rows[job_id] = {
                    "job_id": job_id,
                    "priority": priority,
                    "sessions": 0,
                    "cursor": self._cursors.get(job_id, -1),
                    "batches_sent": 0.0,
                    "cache_hit": 0.0,
                    "cache_miss": 0.0,
                    "slo_burn": {},
                }
            for member_jobs in self._members.values():
                for job_id, entry in member_jobs.items():
                    row = rows.get(job_id)
                    if row is None:
                        continue
                    pr = entry.get("priority")
                    if isinstance(pr, str) and pr:
                        row["priority"] = pr
                    sessions = entry.get("sessions")
                    if P.is_json_int(sessions):
                        row["sessions"] += sessions
                    for key in ("batches_sent", "cache_hit", "cache_miss"):
                        value = entry.get(key)
                        if isinstance(value, (int, float)) and not isinstance(
                            value, bool
                        ):
                            row[key] += float(value)
                    slo = entry.get("slo")
                    if isinstance(slo, dict):
                        for objective, detail in slo.items():
                            burn = (
                                detail.get("burn")
                                if isinstance(detail, dict)
                                else None
                            )
                            if not isinstance(burn, dict):
                                continue
                            worst = row["slo_burn"].setdefault(objective, {})
                            for label, rate in burn.items():
                                if isinstance(
                                    rate, (int, float)
                                ) and not isinstance(rate, bool):
                                    worst[label] = max(
                                        worst.get(label, 0.0), float(rate)
                                    )
            out = []
            for job_id in sorted(rows):
                row = rows[job_id]
                row["cache_hit_rate"] = _hit_rate(
                    row["cache_hit"], row["cache_miss"]
                )
                out.append(row)
            return out
