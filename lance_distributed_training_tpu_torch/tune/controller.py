"""``AutoTuner`` — the closed loop between obs/ and the pipeline's knobs.

A copy of ``lance_distributed_training_tpu/tune/controller.py`` for the
port: the same windows, decisions and trace records, so a trace written by
either package verifies under the other.

A background daemon thread per training process: every ``interval_s`` it

1. pulls the windowed delta of the process registry
   (:class:`~..obs.registry.RegistryDelta` — the obs subsystem already
   measures everything the tf.data autotuner needs: decode_ms, queue_wait,
   batch_age, stall pct, bufpool hit rate, shm ring waits),
2. reduces it to a small signal ``window`` (:func:`derive_window`),
3. asks the :class:`~.policy.HillClimbPolicy` for decisions, and
4. actuates them through the registered :class:`~.tunable.Tunable` set —
   clamped to each knob's declared bounds, never reordering or dropping a
   batch (every actuator adjusts *capacity*, not content).

Observability: every tick lands in ``autotune_ticks_total``; every applied
actuation in ``autotune_decisions_total`` (+ ``autotune_reverts_total`` for
reverts), updates the ``autotune_knob_<name>`` gauge, sets
``autotune_bottleneck`` (see :data:`~.policy.BOTTLENECK_CODES`), and emits
an ``autotune.apply`` span — so ``/metrics`` and ``ldt trace export`` both
show what the controller did and why.

Determinism (``LDT_AUTOTUNE_TRACE=<path>``): each tick appends one JSONL
record ``{tick, window, knobs, bounds, decisions}``. The policy is a pure
function of its state and those inputs, so :func:`replay_trace` can re-run
a recorded sequence against a fresh policy and :func:`verify_trace` asserts
the identical decision sequence comes out — decisions are testable after
the fact, not just observable.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..obs.registry import MetricsRegistry, RegistryDelta, default_registry
from ..obs.spans import span
from .policy import BOTTLENECK_CODES, Decision, HillClimbPolicy, PolicyConfig
from .tunable import Tunable

__all__ = [
    "AutoTuner",
    "derive_window",
    "replay_trace",
    "verify_trace",
    "TRACE_ENV",
]

TRACE_ENV = "LDT_AUTOTUNE_TRACE"

# Decode-latency sources, first present wins: in-process pipelines stamp
# pipeline_decode_ms, remote loaders close lineage_decode_ms, the service
# host observes svc_decode_ms (a loopback process can have all three).
_DECODE_SOURCES = ("pipeline_decode_ms", "lineage_decode_ms", "svc_decode_ms")


def derive_window(delta: Dict[str, float]) -> Dict[str, float]:
    """Reduce one registry delta to the policy's signal dict. Keys are
    omitted (not zeroed) when their source series saw no traffic, so the
    policy can distinguish "no pool in this run" from "pool hit rate 0".

    * ``steps`` — train steps this window,
    * ``stall_pct`` — loader share of (loader + step) busy time,
    * ``h2d_pct`` — H2D dispatch share of the same denominator,
    * ``bufpool_hit_rate`` — window hit/(hit+miss),
    * ``decode_ms_p95`` / ``queue_wait_ms_p95`` / ``shm_wait_ms_p95`` —
      tail latencies per stage,
    * ``ring_occupancy`` — the placement ring's current depth gauge.
    """
    w: Dict[str, float] = {}
    steps = delta.get("trainer_step_ms_count", 0.0)
    w["steps"] = steps
    loader_ms = delta.get("trainer_loader_ms_sum", 0.0)
    step_ms = delta.get("trainer_step_ms_sum", 0.0)
    busy = loader_ms + step_ms
    w["stall_pct"] = 100.0 * loader_ms / busy if busy > 0 else 0.0
    h2d_ms = delta.get("trainer_h2d_ms_sum", 0.0)
    w["h2d_pct"] = 100.0 * h2d_ms / busy if busy > 0 else 0.0
    hits = delta.get("bufpool_hit_total", 0.0)
    misses = delta.get("bufpool_miss_total", 0.0)
    if hits + misses > 0:
        w["bufpool_hit_rate"] = hits / (hits + misses)
    for source in _DECODE_SOURCES:
        p95 = delta.get(f"{source}_p95")
        if p95 is not None:
            w["decode_ms_p95"] = p95
            # Straggler signal: tail-to-median skew of the SAME decode
            # series. Near 1 = uniform item costs (more capacity is the
            # only lever); large = a few items pin batch assembly — the
            # straggler_bound rung grows sched_lookahead instead.
            p50 = delta.get(f"{source}_p50")
            if p50 is not None and p50 > 0:
                w["decode_skew"] = p95 / p50
            break
    # Device-decode split attribution (the --device_decode arm): the host
    # entropy half's share of the per-batch decode cost. Near 1.0 = the
    # host Huffman pass dominates (more decode workers still pay off);
    # near 0.0 = the jitted device kernel dominates (growing the worker
    # pool buys nothing — the policy skips that rung). Present only when
    # both series saw traffic this window — which means IN-PROCESS decode:
    # registries are process-local, so with a WorkerPool (num_workers>0)
    # or a remote data service the entropy histogram lands in the decoding
    # process and the signal is absent here; the policy then falls back to
    # the plain capacity ladder (cross-process metric forwarding is the
    # open item, same locality as the server-side svc_* series).
    entropy_p50 = delta.get("decode_entropy_ms_p50")
    device_p50 = delta.get("decode_device_ms_p50")
    if entropy_p50 is not None and device_p50 is not None:
        total = entropy_p50 + device_p50
        if total > 0:
            w["decode_split"] = entropy_p50 / total
    # Ragged token plane (the --token_pack arm AND its padded control):
    # padding waste as a live signal. payload = real tokens, grid = the
    # token grid the device actually processes; their window ratio is what
    # the pack policy rung trades against recompile count. Same process-
    # locality caveat as decode_split: the counters live in the DECODING
    # process.
    payload = delta.get("pack_payload_tokens_total", 0.0)
    grid_tokens = delta.get("pack_grid_tokens_total", 0.0)
    if grid_tokens > 0:
        w["pad_waste_pct"] = 100.0 * (grid_tokens - payload) / grid_tokens
        w["pack_occupancy"] = payload / grid_tokens
    new_shapes = delta.get("pack_new_shapes_total")
    if new_shapes is not None:
        # Fresh jit traces the pack transform paid this window (each is a
        # compile): the cost side of a finer rows quantum. Lives in the
        # TRAINER process (the transform runs there), so it is present
        # even when decode is remote.
        w["pack_new_shapes"] = new_shapes
    # Straggler scheduler (data/schedule.py): dispatch reorders this
    # window. Present only when a scheduler ran — lets the policy (and
    # `ldt trace` readers) tell "scheduler off" from "scheduler idle".
    sched = delta.get("sched_dispatch_reorders_total")
    if sched is not None:
        w["sched_reorders"] = sched
    queue_wait = delta.get("svc_queue_wait_ms_p95")
    if queue_wait is not None:
        w["queue_wait_ms_p95"] = queue_wait
    shm_wait = delta.get("shm_slot_wait_ms_p95")
    if shm_wait is not None:
        w["shm_wait_ms_p95"] = shm_wait
    ring = delta.get("placement_buffer_depth")
    if ring is not None:
        w["ring_occupancy"] = ring
    jobs_active = delta.get("svc_jobs_active")
    if jobs_active is not None:
        # Job plane: how many tenants share this data plane right
        # now. Present only on a process that hosts a DataService (the
        # gauge is server-side) — lets the policy distinguish "my stall
        # is my own" from "capacity is deliberately shared N ways", where
        # shrinking a knob would hand the freed capacity to OTHER jobs
        # rather than prove it unneeded.
        w["jobs_active"] = jobs_active
    return w


class AutoTuner:
    """Own the control loop: a daemon thread ticking every ``interval_s``.

    ``tunables`` may be empty at construction and swapped per epoch with
    :meth:`set_tunables` (the trainer rebuilds loaders each epoch; the
    controller outlives them). :meth:`tick` is public and synchronous — the
    tests and the bench drive single deterministic control steps through it
    without any thread.
    """

    def __init__(
        self,
        tunables: Optional[List[Tunable]] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        interval_s: float = 1.0,
        policy: Optional[HillClimbPolicy] = None,
        policy_config: Optional[PolicyConfig] = None,
        trace_path: Optional[str] = None,
    ):
        self.registry = registry if registry is not None else default_registry()
        self.interval_s = max(0.05, float(interval_s))
        self.policy = (
            policy if policy is not None
            else HillClimbPolicy(policy_config)
        )
        self._delta = RegistryDelta(self.registry)
        self._lock = threading.Lock()  # guards _tunables + trace file + tick
        self._tunables: Dict[str, Tunable] = {}
        if tunables:
            self.set_tunables(tunables)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tick_n = 0
        self._ticks = self.registry.counter("autotune_ticks_total")
        self._decisions = self.registry.counter("autotune_decisions_total")
        self._reverts = self.registry.counter("autotune_reverts_total")
        self._errors = self.registry.counter("autotune_errors_total")
        self._bottleneck = self.registry.gauge("autotune_bottleneck")
        self._trace_file = None
        path = trace_path if trace_path is not None else os.environ.get(
            TRACE_ENV
        )
        if path:
            # Append (a resumed run extends the trace); line-buffered JSONL
            # so a crash mid-run still leaves complete records behind.
            self._trace_file = open(path, "a", buffering=1)

    # -- tunable set --------------------------------------------------------

    def set_tunables(self, tunables: List[Tunable]) -> None:
        """Swap the registered knob set (per-epoch loader rebuilds). First
        occurrence of a name wins, matching
        :func:`~.tunable.collect_tunables`."""
        table: Dict[str, Tunable] = {}
        for t in tunables:
            table.setdefault(t.name, t)
        with self._lock:
            self._tunables = table
        for name, t in table.items():
            self.registry.gauge(f"autotune_knob_{name}").set(t.get())

    # -- one control step ---------------------------------------------------

    def tick(self) -> List[Decision]:
        """One synchronous control step: window → decide → actuate.
        Returns the applied decisions (after bound clamping; a decision
        whose clamped target equals the current value is dropped as a
        no-op, not counted, not actuated)."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> List[Decision]:
        self._tick_n += 1
        self._ticks.inc()
        window = derive_window(self._delta.delta())
        tunables = self._tunables
        knobs = {name: t.get() for name, t in tunables.items()}
        bounds = {name: (t.lo, t.hi) for name, t in tunables.items()}
        decisions = self.policy.decide(window, knobs, bounds)
        applied: List[Decision] = []
        for d in decisions:
            t = tunables.get(d.knob)
            if t is None:
                continue
            target = min(t.hi, max(t.lo, int(d.target)))
            if target == knobs[d.knob]:
                continue  # clamped into a no-op: nothing to actuate
            with span("autotune.apply", knob=d.knob, target=target,
                      reason=d.reason):
                value = t.set(target)
            applied.append(Decision(d.knob, value, d.reason))
            self._decisions.inc()
            if d.reason == "revert":
                self._reverts.inc()
            self.registry.gauge(f"autotune_knob_{d.knob}").set(value)
        self._bottleneck.set(
            BOTTLENECK_CODES.get(self.policy.last_bottleneck, 0)
        )
        if self._trace_file is not None:
            record = {
                "tick": self._tick_n,
                "window": {k: round(float(v), 6)
                           for k, v in window.items()},
                "knobs": knobs,
                "bounds": {k: list(v) for k, v in bounds.items()},
                "decisions": [
                    [d.knob, d.target, d.reason] for d in decisions
                ],
                "applied": [
                    [d.knob, d.target, d.reason] for d in applied
                ],
            }
            self._trace_file.write(json.dumps(record) + "\n")
        return applied

    # -- lifecycle ----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — an actuator failure
                # (a resize hitting OSError under fd pressure, a knob whose
                # component died) must not silently kill the controller for
                # the rest of the run — a stuck-at-bad-knobs run is exactly
                # what this subsystem exists to prevent. Count it (the
                # autotune_errors_total series is the operator's signal),
                # log once per error, keep ticking.
                self._errors.inc()
                print(f"[autotune] tick failed: {exc!r}", flush=True)

    def start(self) -> "AutoTuner":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ldt-autotune"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._lock:
            if self._trace_file is not None:
                self._trace_file.close()
                self._trace_file = None

    def __enter__(self) -> "AutoTuner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- trace replay ------------------------------------------------------------


def read_trace(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def replay_trace(
    path: str, policy_config: Optional[PolicyConfig] = None
) -> List[List[Tuple[str, int, str]]]:
    """Re-run a fresh policy over a recorded trace's (window, knobs,
    bounds) sequence; returns the replayed decision lists in trace order.
    The policy is deterministic, so this must equal the recorded
    ``decisions`` — :func:`verify_trace` is that assertion."""
    policy = HillClimbPolicy(policy_config)
    out: List[List[Tuple[str, int, str]]] = []
    for record in read_trace(path):
        decisions = policy.decide(
            record["window"],
            {k: int(v) for k, v in record["knobs"].items()},
            {k: (int(v[0]), int(v[1]))
             for k, v in record["bounds"].items()},
        )
        out.append([(d.knob, d.target, d.reason) for d in decisions])
    return out


def verify_trace(
    path: str, policy_config: Optional[PolicyConfig] = None
) -> Tuple[bool, List[int]]:
    """``(ok, mismatched_tick_numbers)`` — replay vs record, tick by
    tick."""
    records = read_trace(path)
    replayed = replay_trace(path, policy_config)
    mismatches = []
    for record, decisions in zip(records, replayed):
        recorded = [tuple(d) for d in record["decisions"]]
        if recorded != decisions:
            mismatches.append(record["tick"])
    return not mismatches, mismatches
