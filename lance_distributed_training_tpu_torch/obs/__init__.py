"""Observability of the port's host planes: the metrics registry the
autotuner reads (:mod:`.registry`), span tracing with the ``ldt trace``
subcommand (:mod:`.spans`), the per-item cost ledger with ``ldt costs``
(:mod:`.costs`), batch lineage (:mod:`.lineage`), the ``/metrics`` and
``/healthz`` exporter (:mod:`.http`), critical-path attribution
(:mod:`.critpath`), SLO burn rates (:mod:`.slo`) and the cross-process
trace context (:mod:`.tracectx`). Copies of the JAX package's ``obs/``
modules of the same names, with its exports."""

from .http import MetricsHTTPServer, build_info
from .lineage import make_lineage, observe_local_lineage, observe_wire_lineage
from .registry import (
    DEFAULT_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryDelta,
    default_registry,
    percentile_from_counts,
    render_prometheus,
)
from .costs import CostLedger, cost_context, default_ledger, note_cost
from .critpath import analyze as critpath_analyze
from .slo import SLO, DEFAULT_SLOS, SLOTracker, parse_slos
from .spans import Span, SpanTracer, chrome_trace, default_tracer, span
from .tracectx import (
    child,
    coerce_trace,
    make_trace,
    new_span_id,
    new_trace_id,
)

__all__ = ["CostLedger", "Counter", "DEFAULT_MS_BUCKETS", "DEFAULT_SLOS",
           "Gauge", "Histogram", "MetricsHTTPServer", "MetricsRegistry",
           "RegistryDelta", "SLO", "SLOTracker", "Span", "SpanTracer",
           "build_info", "child", "chrome_trace", "coerce_trace",
           "cost_context", "critpath_analyze", "default_ledger",
           "default_registry", "default_tracer", "make_lineage",
           "make_trace", "new_span_id", "new_trace_id", "note_cost",
           "observe_local_lineage", "observe_wire_lineage", "parse_slos",
           "percentile_from_counts", "render_prometheus", "span"]
