"""Thread-safe metrics registry — counters, gauges, fixed-bucket histograms.

A copy of ``lance_distributed_training_tpu/obs/registry.py`` for the port:
the same series types, bucket edges and Prometheus text, so that the
autotuner reads the port's series by the JAX package's names.

The telemetry substrate every instrumented layer records into:
``ServiceCounters`` and ``StepTimer`` (``utils/metrics.py``) are thin facades
over it, the data pipeline and the disaggregated service observe per-batch
latency histograms through it, and ``obs/http.py`` renders it as Prometheus
text for scraping.

Design constraints, in order:

* **bounded memory** — histograms are fixed-bucket (no reservoirs, no raw
  sample retention): percentiles come from linear interpolation inside the
  bucket containing the target rank, the same estimate Prometheus'
  ``histogram_quantile`` computes server-side. A histogram is ~20 floats
  forever, no matter how many observations land in it.
* **thread-safe hot path** — every metric guards its state with its own
  small lock; ``observe``/``inc`` are a bisect + two adds, cheap enough to
  sit on per-batch paths.
* **one process-wide registry** — :func:`default_registry` is where all
  layers meet, so one ``/metrics`` endpoint sees the whole process (server
  counters AND client lineage histograms in a loopback test). Instances are
  still constructible for isolation (tests, multiple exporters).

Metric names must match ``[a-z][a-z0-9_]*`` (enforced here and by the
LDT601 lint) so every name is a valid Prometheus metric name as-is.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "METRIC_NAME_RE",
    "DEFAULT_MS_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RegistryDelta",
    "default_registry",
    "percentile_from_counts",
    "render_prometheus",
]

METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Default latency buckets (milliseconds): sub-ms decode through multi-second
# stalls. 16 finite bounds + the implicit +Inf overflow bucket.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


def _check_name(name: str) -> str:
    if not METRIC_NAME_RE.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: must match [a-z][a-z0-9_]* "
            "(a Prometheus-safe lower_snake_case name)"
        )
    return name


def percentile_from_counts(
    bounds: Sequence[float],
    counts: Sequence[int],
    total: int,
    q: float,
    observed_max: float = math.nan,
) -> float:
    """q-th percentile (0 < q <= 100) of a fixed-bucket count vector by
    linear interpolation — the shared math behind
    :meth:`Histogram.percentile` and the windowed-delta view
    (:class:`RegistryDelta`), where ``counts`` is a *difference* of two
    cumulative snapshots. A rank landing in the +Inf bucket clamps to
    ``observed_max`` when known (lifetime histograms track it) or the top
    finite bound (delta windows, which have no per-window max). NaN when
    ``total`` is 0."""
    if total <= 0:
        return math.nan
    # Fractional rank, no ceil — matches Prometheus histogram_quantile
    # (one observation in (1, 10] gives p50 = 5.5, not the bucket top).
    rank = total * min(max(q, 0.0), 100.0) / 100.0
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= len(bounds):  # overflow bucket
                if not math.isnan(observed_max):
                    return max(bounds[-1], observed_max)
                return bounds[-1]
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / c
            return lo + (hi - lo) * frac
        cum += c
    return bounds[-1]


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without the noise of
    a mantissa (``17`` not ``17.0``), everything else as repr."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically-increasing sum. ``inc(v)`` with v >= 0."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Instantaneous value. ``set(v)``."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = _check_name(name)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are the finite upper bounds (ascending); an implicit +Inf
    bucket catches overflow. Cumulative-bucket semantics match Prometheus:
    ``_bucket{le="b"}`` counts observations <= b.
    """

    kind = "histogram"

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        self.name = _check_name(name)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError(
                f"histogram {name} buckets must be non-empty and strictly "
                f"ascending, got {bounds}"
            )
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._max = math.nan  # largest observation: the +Inf-bucket clamp

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if not value <= self._max:  # first observe: nan comparison
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Tuple[list, float, int]:
        """``(per-bucket counts incl. +Inf, sum, count)`` — one consistent
        read for rendering and percentile math."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0 < q <= 100) by linear
        interpolation inside the bucket holding the target rank — bounded
        error (one bucket width), zero sample retention. A rank landing in
        the +Inf bucket clamps to the largest observation seen (not the top
        finite bound, which would understate a 60 s stall as 10 s — exactly
        the tail these histograms exist to surface). Returns NaN when
        empty."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            observed_max = self._max
        return percentile_from_counts(
            self.bounds, counts, total, q, observed_max
        )

    def percentiles(self, qs: Iterable[float] = (50, 95, 99)) -> Dict[str, float]:
        """``{"p50": …, "p95": …, "p99": …}`` for the given quantiles."""
        return {f"p{int(q)}": self.percentile(q) for q in qs}


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting an existing name returns the same object (so independent
    layers aggregate into one series, Prometheus-style); requesting it as a
    different kind is an error — silent type morphing would corrupt the
    scrape output.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, factory, kind: str):
        # Lock-free fast path for the hot lookup (per-batch/per-step call
        # sites hit this by name): metrics are never removed, and a plain
        # dict .get() of a fully-constructed value is safe under the GIL —
        # so callers don't need their own metric-object caches.
        existing = self._metrics.get(name)
        if existing is None:
            with self._lock:
                existing = self._metrics.get(name)
                if existing is None:
                    metric = factory()
                    self._metrics[name] = metric
                    return metric
        if existing.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{existing.kind}, not {kind}"
            )
        return existing

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name), "gauge")

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        hist = self._get_or_create(
            name, lambda: Histogram(name, buckets), "histogram"
        )
        # Hot-path callers (per-batch/per-step observe) pass the default:
        # skip rebuilding the float tuple for the common case — the
        # equality check still runs, so a custom-bucket re-registration
        # under the same name is caught either way.
        bounds = (DEFAULT_MS_BUCKETS if buckets is DEFAULT_MS_BUCKETS
                  else tuple(float(b) for b in buckets))
        if hist.bounds != bounds:
            # Same rationale as the kind check: silently returning the
            # first-registration buckets would leave a caller believing its
            # requested resolution took effect.
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{hist.bounds}, not {bounds}"
            )
        return hist

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> Dict[str, object]:
        """Name → metric, sorted — a stable snapshot for rendering."""
        with self._lock:
            return dict(sorted(self._metrics.items()))

    def snapshot(self) -> Dict[str, float]:
        """Flat scalar view: counters/gauges by name, histograms expanded to
        ``name_p50/p95/p99`` + ``name_count`` — the JSONL-friendly form."""
        out: Dict[str, float] = {}
        for name, metric in self.metrics().items():
            if isinstance(metric, Histogram):
                if metric.count:  # empty: percentiles are NaN, which
                    # json.dumps emits as a bare token strict parsers reject
                    for k, v in metric.percentiles().items():
                        out[f"{name}_{k}"] = v
                out[f"{name}_count"] = metric.count
            else:
                out[name] = metric.value  # type: ignore[union-attr]
        return out

    def render_prometheus(self) -> str:
        return render_prometheus(self)


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format (version 0.0.4) for every metric
    in the registry — the payload ``obs/http.py`` serves at ``/metrics``."""
    lines: list = []
    for name, metric in registry.metrics().items():
        lines.append(f"# TYPE {name} {metric.kind}")
        if isinstance(metric, Histogram):
            counts, total_sum, total = metric.snapshot()
            cum = 0
            for bound, c in zip(metric.bounds, counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {_fmt(total_sum)}")
            lines.append(f"{name}_count {total}")
        else:
            lines.append(f"{name} {_fmt(metric.value)}")  # type: ignore
    return "\n".join(lines) + ("\n" if lines else "")


class RegistryDelta:
    """Windowed view over a registry: each :meth:`delta` returns what
    happened **since the previous call** — the form a controller (or a bench
    script that used to scrape ``/metrics`` twice and subtract by hand) can
    actually act on. Cumulative series answer "how much ever"; a control
    loop needs "how much in the last window".

    Output is one flat ``{name: float}`` dict per window:

    * counters → the window's increment (``name``),
    * gauges → the current value verbatim (``name`` — gauges are already
      instantaneous),
    * histograms → ``name_count`` / ``name_sum`` window increments plus
      ``name_p50/p95/p99`` interpolated over the *window's* bucket deltas
      (only when the window saw observations; a +Inf-bucket rank clamps to
      the top finite bound — delta windows have no per-window max).

    Metrics created after the first call simply appear with their full value
    as the first delta (their previous snapshot is implicitly zero). One
    tracker per consumer: two consumers sharing an instance would steal each
    other's windows.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else _DEFAULT
        # name -> last-seen raw state: float for counters, (counts, sum,
        # count) for histograms. Single-consumer by contract (no lock).
        self._prev: Dict[str, object] = {}

    def delta(self, qs: Iterable[float] = (50, 95, 99)) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, metric in self.registry.metrics().items():
            if isinstance(metric, Histogram):
                counts, total_sum, total = metric.snapshot()
                prev = self._prev.get(name)
                if prev is None:
                    prev = ([0] * len(counts), 0.0, 0)
                dcounts = [a - b for a, b in zip(counts, prev[0])]
                dcount = total - prev[2]
                out[f"{name}_count"] = float(dcount)
                out[f"{name}_sum"] = total_sum - prev[1]
                if dcount > 0:
                    for q in qs:
                        out[f"{name}_p{int(q)}"] = percentile_from_counts(
                            metric.bounds, dcounts, dcount, q
                        )
                self._prev[name] = (counts, total_sum, total)
            elif isinstance(metric, Counter):
                value = metric.value
                out[name] = value - float(self._prev.get(name, 0.0))
                self._prev[name] = value
            else:  # Gauge: instantaneous, passes through
                out[name] = metric.value  # type: ignore[union-attr]
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry where every instrumented layer meets —
    serve it once (``--metrics_port``) and the scrape sees the whole
    process."""
    return _DEFAULT
