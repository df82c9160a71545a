"""Observability-hygiene rule (LDT601).

Telemetry is only as trustworthy as its clocks and its names. Two failure
classes this rule gates, scoped to the *instrumented* modules (the
``obs-paths`` config — the obs/ package, StepTimer/ServiceCounters, the
data pipeline, and both halves of the service):

* **wall-clock durations** — ``time.time()`` is not monotonic (NTP slews,
  steps backwards on clock sync), so a duration measured with it can be
  negative or wildly wrong exactly when a fleet host's clock is being
  corrected — which is also exactly when you're staring at latency
  telemetry. Instrumented modules must use ``time.perf_counter`` /
  ``time.monotonic_ns`` for durations; epoch *stamps* that intentionally
  cross process boundaries use ``time.time_ns()`` (an integer timestamp,
  not a duration — see ``obs/lineage.py``'s clock policy).
* **invalid metric names** — every name handed to a registry factory
  (``.counter(…)`` / ``.gauge(…)`` / ``.histogram(…)``) must match
  ``[a-z][a-z0-9_]*`` so it is a valid Prometheus series name as-is; a bad
  name surfaces as a scrape-time parse error on a dashboard, far from the
  line that minted it.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register
# The lint enforces the registry's own runtime rule — one regex, one place
# (obs.registry is stdlib-only, so this import carries no jax baggage).
from ...obs.registry import METRIC_NAME_RE as _METRIC_NAME_RE
# Registry get-or-create factories whose first argument is the series name.
_METRIC_FACTORIES = {"counter", "gauge", "histogram"}


@register
class ObsHygiene(Rule):
    id = "LDT601"
    family = "obs"
    name = "obs-hygiene"
    description = (
        "instrumented modules: no time.time() (durations need "
        "perf_counter/monotonic_ns; stamps use time_ns), and metric names "
        "must match [a-z][a-z0-9_]*"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        obs_paths = getattr(config, "obs_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in obs_paths):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            if qn == "time.time":
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    "time.time() in an instrumented module — wall clocks "
                    "slew/step under NTP, corrupting measured durations; "
                    "use time.perf_counter()/time.monotonic_ns() for "
                    "durations (time.time_ns() only for cross-process "
                    "epoch stamps)",
                )
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_FACTORIES
            ):
                name_arg = None
                if node.args:
                    name_arg = node.args[0]
                else:
                    for kw in node.keywords:
                        if kw.arg == "name":
                            name_arg = kw.value
                            break
                if (
                    isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)
                    and not _METRIC_NAME_RE.match(name_arg.value)
                ):
                    yield Finding(
                        self.id, module.relpath,
                        node.lineno, node.col_offset,
                        f"metric name {name_arg.value!r} does not match "
                        "[a-z][a-z0-9_]* — it would not be a valid "
                        "Prometheus series name at scrape time",
                    )
