"""Observability of the port's host planes: the metrics registry the
autotuner reads (:mod:`.registry`), span tracing (:mod:`.spans`) and the
per-item cost ledger (:mod:`.costs`). Copies of the JAX package's ``obs/``
modules of the same names; its exporters, lineage, SLO tracker and the
``ldt trace``/``ldt costs`` subcommands wait for the port of the data
service."""

from .costs import CostLedger, cost_context, default_ledger, note_cost
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryDelta,
    default_registry,
    percentile_from_counts,
    render_prometheus,
)
from .spans import Span, SpanTracer, chrome_trace, default_tracer, span

__all__ = ["CostLedger", "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "RegistryDelta", "Span", "SpanTracer", "chrome_trace",
           "cost_context", "default_ledger", "default_registry",
           "default_tracer", "note_cost", "percentile_from_counts",
           "render_prometheus", "span"]
