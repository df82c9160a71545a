"""SLO plane — declared objectives with multi-window burn-rate gauges.

A copy of ``lance_distributed_training_tpu/obs/slo.py`` for the port.

An SLO here is a *declared* bound on a telemetry value this process can
probe ("stall_pct stays under 10", "queue_wait_p99_ms stays under 500")
plus an error budget: the share of time the bound is allowed to be
violated. The :class:`SLOTracker` samples each objective on a daemon
ticker and publishes, per objective:

* ``slo_<name>`` — the last probed value (a gauge an alert can read
  without re-deriving the probe);
* ``slo_<name>_burn_1m`` / ``_5m`` / ``_1h`` — multi-window burn rates:
  (observed violation share over the window) / (error budget share).
  1.0 = burning budget exactly as fast as allowed; 10× on the short
  window with ~1× on the long one is the classic page-now signature,
  while a slow leak shows the reverse. Multi-window burn is what makes
  the gauges actionable instead of flappy (the Google SRE workbook's
  alerting shape, scaled down to a process-local ticker).

Objectives default to :data:`DEFAULT_SLOS` and are overridable with the
``LDT_SLOS`` env var (``"stall_pct<=10@5,queue_wait_p99_ms<=500@5"`` —
``value<=threshold@budget_pct``); probes are plain callables the owning
process wires (the DataService probes its own pressure counters, the
trainer probes the lineage histograms), returning NaN when the value is
not yet defined — NaN samples are skipped, never counted as violations.

The fleet half lives on the Coordinator: heartbeats carry mergeable
queue-wait bucket counts (version-gated like pressure), aggregated into
``fleet_queue_wait_p50/p95/p99_ms`` — see ``fleet/coordinator.py``.

Clock policy: sampling instants are ``time.monotonic()`` (windowing is a
duration computation — LDT601).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

from .registry import MetricsRegistry, default_registry

__all__ = [
    "SLO",
    "DEFAULT_SLOS",
    "parse_slos",
    "scoped_slos",
    "SLOTracker",
]


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective: ``probe() <= threshold`` for all but
    ``budget_pct`` percent of any window."""

    name: str  # metric-safe ([a-z][a-z0-9_]*) — becomes slo_<name>*
    threshold: float
    budget_pct: float = 5.0  # allowed violation share of a window (%)


# The three objectives every data-plane deployment cares about first:
# decode starvation, end-to-end batch staleness, and queue dwell.
DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO("stall_pct", 10.0),
    SLO("batch_age_p99_ms", 2000.0),
    SLO("queue_wait_p99_ms", 500.0),
)

# Burn windows: label → seconds. Labels land in metric names, so they
# stay [a-z0-9_].
BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0),
    ("5m", 300.0),
    ("1h", 3600.0),
)


def parse_slos(spec: Optional[str]) -> Tuple[SLO, ...]:
    """``"name<=threshold[@budget_pct],…"`` → SLO tuple; ``None``/empty →
    :data:`DEFAULT_SLOS`. Malformed entries raise (a declared objective
    that silently vanished would be worse than a loud config error)."""
    if not spec or not spec.strip():
        return DEFAULT_SLOS
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "<=" not in part:
            raise ValueError(f"SLO {part!r}: expected name<=threshold")
        name, _, rest = part.partition("<=")
        budget = 5.0
        if "@" in rest:
            rest, _, budget_s = rest.partition("@")
            budget = float(budget_s)
        if not (0.0 < budget <= 100.0):
            raise ValueError(f"SLO {part!r}: budget_pct must be in (0, 100]")
        out.append(SLO(name.strip(), float(rest), budget))
    return tuple(out) if out else DEFAULT_SLOS


def scoped_slos(
    scope: str, slos: Optional[Sequence[SLO]] = None
) -> Tuple[SLO, ...]:
    """The given objectives re-named under a scope prefix —
    ``scoped_slos("job_tenant_a")`` turns ``stall_pct`` into
    ``job_tenant_a_stall_pct`` with the threshold and budget unchanged.

    This is how per-tenant burn-down rides the label-less registry
    (``obs/registry.py`` deliberately has no label dimension — LDT601
    name discipline instead): a scope IS a name prefix, so one
    :class:`SLOTracker` per job publishes ``slo_job_<slug>_stall_pct``
    and its burn windows next to the fleet-wide series. ``scope`` must
    itself be metric-safe (``[a-z][a-z0-9_]*`` — callers sanitize via
    ``fleet.jobs.job_slug``). ``slos=None`` scopes the ``LDT_SLOS``
    env-var objectives, like :class:`SLOTracker` itself."""
    if slos is None:
        slos = parse_slos(os.environ.get("LDT_SLOS"))
    return tuple(
        SLO(f"{scope}_{s.name}", s.threshold, s.budget_pct) for s in slos
    )


class SLOTracker:
    """Sample declared SLO probes and publish burn-rate gauges.

    ``probes`` maps objective name → zero-arg callable returning the
    current value (NaN = undefined, sample skipped). Objectives without
    a probe are ignored for this tracker — the trainer and the server
    declare the same SLO set but can each probe only their own half.
    A probe that raises is treated as NaN: telemetry must never kill
    the ticker (the heartbeat posture, ``fleet/agent.py``).
    """

    def __init__(
        self,
        probes: Dict[str, Callable[[], float]],
        slos: Optional[Sequence[SLO]] = None,
        registry: Optional[MetricsRegistry] = None,
        interval_s: float = 5.0,
    ):
        if slos is None:
            slos = parse_slos(os.environ.get("LDT_SLOS"))
        self.slos = tuple(s for s in slos if s.name in probes)
        self.probes = dict(probes)
        self.registry = (
            registry if registry is not None else default_registry()
        )
        self.interval_s = max(0.1, float(interval_s))
        # Per-objective (monotonic instant, violated) samples; bounded by
        # count (the longest window / interval, plus slack) AND trimmed by
        # age at read — memory stays fixed forever.
        horizon = max(seconds for _, seconds in BURN_WINDOWS)
        cap = int(horizon / self.interval_s) + 8
        self._samples: Dict[str, deque] = {
            s.name: deque(maxlen=cap) for s in self.slos
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        """One sampling pass (the ticker calls this; tests call it
        directly with a synthetic ``now``)."""
        now = time.monotonic() if now is None else now
        for slo in self.slos:
            try:
                value = float(self.probes[slo.name]())
            except Exception:  # noqa: BLE001 — telemetry must never
                value = math.nan  # kill the ticker
            if math.isnan(value):
                continue
            self.registry.gauge(f"slo_{slo.name}").set(round(value, 3))
            samples = self._samples[slo.name]
            samples.append((now, value > slo.threshold))
            for label, seconds in BURN_WINDOWS:
                lo = now - seconds
                total = bad = 0
                for t, violated in samples:
                    if t >= lo:
                        total += 1
                        bad += violated
                if total:
                    burn = (100.0 * bad / total) / slo.budget_pct
                    self.registry.gauge(
                        f"slo_{slo.name}_burn_{label}"
                    ).set(round(burn, 3))

    def status(self) -> Dict[str, dict]:
        """``{name: {value, threshold, budget_pct, burn: {label: x}}}`` —
        the ``/healthz``-friendly view of the published gauges."""
        out: Dict[str, dict] = {}
        for slo in self.slos:
            value_g = self.registry.get(f"slo_{slo.name}")
            if value_g is None:
                continue
            burn = {}
            for label, _ in BURN_WINDOWS:
                g = self.registry.get(f"slo_{slo.name}_burn_{label}")
                if g is not None:
                    burn[label] = g.value
            out[slo.name] = {
                "value": value_g.value,
                "threshold": slo.threshold,
                "budget_pct": slo.budget_pct,
                "burn": burn,
            }
        return out

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SLOTracker":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ldt-slo-tick"
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None
