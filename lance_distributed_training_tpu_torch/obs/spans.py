"""Lightweight span tracing with a Chrome-trace / Perfetto export surface.

A copy of ``lance_distributed_training_tpu/obs/spans.py`` with its ``ldt
trace`` subcommand (:func:`trace_main`). The profiler passthrough is
``torch.profiler.record_function`` instead of
``jax.profiler.TraceAnnotation``: spans appear on the host timeline of a
``torch.profiler`` trace (``utils/profiling.py``).

A :class:`SpanTracer` records named regions (monotonic-clock start/stop,
parent ids from a per-thread stack) into a bounded ring buffer — the
always-on, ~zero-cost sibling of ``torch.profiler`` traces. Three export
surfaces:

* **Perfetto / chrome://tracing** — :func:`chrome_trace` converts completed
  spans to Chrome trace-event JSON (``ph: "X"`` complete events), written by
  :meth:`SpanTracer.write_chrome_trace` or the ``ldt trace export`` CLI
  (:func:`trace_main`), which reads either package's JSONL.
* **profiler passthrough** — in a process that has loaded torch, every
  span also enters a ``torch.profiler.record_function``, so the same
  regions appear on the host timeline of a ``torch.profiler`` trace
  (``utils/profiling.py``); a span never imports torch itself.
* **cross-process JSONL** — set ``LDT_TRACE_PATH`` (or pass ``jsonl_path``)
  and completed spans append to a JSONL file one event per line; ``ldt
  trace export --spans that-file`` stitches any number of processes'
  files into one Perfetto-loadable trace.

Clocks: span durations come from ``time.monotonic_ns`` (LDT601 forbids
``time.time()`` here); the JSONL/export timestamps are the same monotonic
microseconds. For CROSS-process merge each JSONL additionally carries one
``ldt.clock_sync`` anchor record (``wall_ns`` + ``mono_ns`` captured
together — an epoch *stamp* that intentionally crosses process
boundaries, the lineage clock policy) so ``ldt trace export`` can rebase
every process onto one wall timeline; within a process all math stays
monotonic.

Ring-buffer truncation is observable, not silent: every span dropped off
the full ring increments the ``spans_dropped_total`` counter, and JSONL
files carry cumulative ``ldt.spans_dropped`` markers so ``ldt trace
export`` can report how much the source processes truncated.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, List, Optional

__all__ = [
    "Span",
    "SpanTracer",
    "default_tracer",
    "span",
    "chrome_trace",
    "trace_main",
]


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed region. Times are ``time.monotonic_ns()`` instants."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int  # 0 = root
    thread_id: int
    pid: int
    attrs: Optional[dict] = None

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def to_event(self) -> dict:
        """Chrome trace-event dict (``ph: "X"`` complete event; ts/dur in
        microseconds — the Perfetto/chrome://tracing contract)."""
        args = {"span_id": self.span_id, "parent_id": self.parent_id}
        if self.attrs:
            args.update(self.attrs)
        return {
            "name": self.name,
            "ph": "X",
            "ts": self.start_ns / 1e3,
            "dur": (self.end_ns - self.start_ns) / 1e3,
            "pid": self.pid,
            "tid": self.thread_id,
            "args": args,
        }


def _annotation(name: str):
    """``torch.profiler.record_function`` once this process has loaded
    torch, else None. A span never imports torch: the host processes
    (``serve-data``, ``coordinator``) do not load it, and an import on a
    first span stalls every thread of the process for seconds (the JAX
    tracer imports jax when it can; a profiler trace exists only in a
    process that loaded torch, so nothing is lost here)."""
    global _ANNOTATION_CLS
    if _ANNOTATION_CLS is False:
        return None
    if _ANNOTATION_CLS is None:
        if "torch" not in sys.modules:
            return None  # unresolved: torch may load later
        try:
            from torch.profiler import record_function

            _ANNOTATION_CLS = record_function
        except Exception:  # torch broken: the tracer still works
            _ANNOTATION_CLS = False
            return None
    return _ANNOTATION_CLS(name)


_ANNOTATION_CLS = None  # unresolved | False (unavailable) | the class


class SpanTracer:
    """Thread-safe tracer: a ring buffer of completed spans.

    ``capacity`` bounds memory forever (old spans fall off the back — the
    recent-window view an engineer actually opens). ``jsonl_path`` (or the
    ``LDT_TRACE_PATH`` env var) additionally appends every completed span as
    one JSON line, the durable form ``ldt trace export`` consumes.
    """

    def __init__(self, capacity: int = 4096,
                 jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()  # ring buffer only — never held for IO
        self._io_lock = threading.Lock()  # JSONL handle; a slow flush must
        # not block threads opening spans or appending to the ring
        self._spans: deque = deque(maxlen=max(1, capacity))
        self._local = threading.local()
        self._ids = itertools.count(1)  # GIL-atomic: id allocation is lockless
        self._jsonl = None
        self._jsonl_path = jsonl_path or os.environ.get("LDT_TRACE_PATH")
        self._dropped = 0  # spans pushed off the full ring (see dropped)

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[dict]:
        """Record the enclosed block as one span; nests (parent = innermost
        open span on this thread) and mirrors into the torch profiler's host
        timeline when a profiler trace is active.

        Yields the span's attrs dict so attributes only known mid-block
        (``cache_hit``, result sizes) can be added before the span
        closes: ``with span("x") as a: a["hit"] = True``."""
        stack = self._stack()
        span_id = next(self._ids)
        parent_id = stack[-1] if stack else 0
        stack.append(span_id)
        annotation = _annotation(name)
        start = time.monotonic_ns()
        try:
            if annotation is not None:
                with annotation:
                    yield attrs
            else:
                yield attrs
        finally:
            end = time.monotonic_ns()
            stack.pop()
            self._record(Span(
                name=name, start_ns=start, end_ns=end, span_id=span_id,
                parent_id=parent_id, thread_id=threading.get_ident() % 2**31,
                pid=os.getpid(), attrs=attrs or None,
            ))

    def _record(self, span: Span) -> None:
        dropped = 0
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                # The ring evicts the oldest span to admit this one —
                # count it so a truncated in-process trace is diagnosable
                # (the old behavior dropped silently).
                self._dropped += 1
                dropped = self._dropped
            self._spans.append(span)
        if dropped:
            # Lazy import: registry never imports spans, so no cycle.
            from .registry import default_registry

            default_registry().counter("spans_dropped_total").inc()
        if self._jsonl_path is None:
            return
        # Serialize + flush outside the ring lock: a stalled disk slows the
        # writer, not every thread opening a span. Flush-per-span is the
        # durability contract (`ldt trace export` must see spans from
        # processes that died mid-run).
        line = json.dumps(span.to_event()) + "\n"
        if dropped and (dropped & (dropped - 1)) == 0:
            # Cumulative drop marker at power-of-two counts: the ring in
            # steady-state overflow drops one span per record, so a
            # per-drop marker would double the file; doubling cadence
            # keeps the count accurate within 2x at O(log n) lines.
            line += json.dumps({
                "name": "ldt.spans_dropped", "ph": "C",
                "pid": span.pid, "tid": 0,
                "ts": span.end_ns / 1e3,
                "args": {"dropped": dropped},
            }) + "\n"
        with self._io_lock:
            if self._jsonl_path is None:
                return
            if self._jsonl is None:
                try:
                    self._jsonl = open(self._jsonl_path, "a")
                except OSError:
                    self._jsonl_path = None  # never retry a bad path
                    return
                # One wall/monotonic anchor pair per (process, open):
                # what lets `ldt trace export` place this process's
                # monotonic timestamps on the shared wall timeline. An
                # epoch stamp crossing processes — the LDT601-sanctioned
                # use (see obs/lineage.py's clock policy).
                self._jsonl.write(json.dumps({
                    "name": "ldt.clock_sync", "ph": "M",
                    "pid": os.getpid(), "tid": 0, "ts": 0,
                    "args": {
                        "wall_ns": time.time_ns(),
                        "mono_ns": time.monotonic_ns(),
                    },
                }) + "\n")
            self._jsonl.write(line)
            self._jsonl.flush()

    # -- reading / export --------------------------------------------------

    def spans(self) -> List[Span]:
        """Completed spans, oldest first (bounded by ``capacity``)."""
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        """Spans pushed off the full ring since construction."""
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace(self) -> dict:
        out = chrome_trace([s.to_event() for s in self.spans()])
        dropped = self.dropped
        if dropped:
            out["otherData"]["spans_dropped"] = dropped
        return out

    def write_chrome_trace(self, path: str) -> str:
        """Dump the ring buffer as a Perfetto-loadable JSON file."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")
        return path

    def close(self) -> None:
        """Terminal: spans completing after close (e.g. on a daemon thread
        racing shutdown) still enter the ring buffer but no longer reopen
        the JSONL file."""
        with self._io_lock:
            self._jsonl_path = None
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def chrome_trace(events: List[dict]) -> dict:
    """Wrap trace events in the Chrome trace-event JSON envelope."""
    return {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "ldt trace export"},
    }


_DEFAULT: Optional[SpanTracer] = None
_DEFAULT_LOCK = threading.Lock()


def default_tracer() -> SpanTracer:
    """The process-wide tracer every instrumented layer records into.
    Created lazily so ``LDT_TRACE_PATH`` set by the entry point (CLI, test)
    is read at first use, not at import."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SpanTracer()
        return _DEFAULT


def span(name: str, **attrs):
    """Record a region on the process-wide tracer — the one-liner the
    instrumented modules use: ``with span("svc.decode", step=n): …``."""
    return default_tracer().span(name, **attrs)


# -- `ldt trace` CLI ---------------------------------------------------------


def _load_span_events(paths: List[str], out) -> List[dict]:
    """Merge span JSONL files into one event list (undecodable lines are
    reported and skipped; missing files are reported — a silently dropped
    host's spans read as "that host did nothing" in Perfetto)."""
    events: List[dict] = []
    missing = []
    for path in paths:
        if not os.path.exists(path):
            missing.append(path)
            continue
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    out.write(
                        f"ldt trace: skipping undecodable line "
                        f"{path}:{lineno}\n"
                    )
    if missing:
        out.write(
            f"ldt trace: missing span file(s): {', '.join(missing)}\n"
        )
    return events


def trace_main(argv=None, out=None) -> int:
    """``ldt trace export`` / ``ldt trace critical-path``.

    * ``export`` merges span JSONLs (written by any process running with
      ``LDT_TRACE_PATH``) into ONE Perfetto-loadable Chrome-trace JSON:
      per-process clocks rebased onto the wall timeline via the
      ``ldt.clock_sync`` anchors, cross-process batch chains stitched
      with flow arrows (``obs/critpath.py``), ring-buffer drop counts
      reported.
    * ``critical-path`` analyzes the same merged events into per-batch
      segment attribution + a straggler table.

    Returns the process exit status."""
    import argparse
    import sys

    out = out if out is not None else sys.stdout
    p = argparse.ArgumentParser(
        prog="ldt trace",
        description="Merge and analyze recorded span JSONLs",
    )
    sub = p.add_subparsers(dest="command")
    exp = sub.add_parser("export", help="convert span JSONL → Chrome trace")
    cp = sub.add_parser(
        "critical-path",
        help="per-batch segment attribution + straggler table",
    )
    for sp in (exp, cp):
        sp.add_argument(
            "--spans", action="append", default=None, metavar="JSONL",
            help="span JSONL file(s) written under LDT_TRACE_PATH "
                 "(repeatable; default: $LDT_TRACE_PATH or "
                 "ldt-spans.jsonl)",
        )
    exp.add_argument("--out", default="ldt-trace.json",
                     help="output Chrome-trace JSON path")
    cp.add_argument("--costs", default=None, metavar="JSONL",
                    help="cost-ledger JSONL (LDT_COST_PATH) to join the "
                         "straggler table against")
    cp.add_argument("--top", type=int, default=10,
                    help="slowest chains to show (default 10)")
    args = p.parse_args(list(argv) if argv is not None else None)
    if args.command not in ("export", "critical-path"):
        p.print_help(out)
        return 2
    from .critpath import (
        critical_path_main,
        dropped_spans,
        flow_events,
        rebase_events,
    )

    spans_paths = args.spans or [
        os.environ.get("LDT_TRACE_PATH", "ldt-spans.jsonl")
    ]
    events = _load_span_events(spans_paths, out)
    if not events:
        out.write(
            "ldt trace: no events collected — run with "
            "LDT_TRACE_PATH=<file> to record spans\n"
        )
        return 2
    if args.command == "critical-path":
        return critical_path_main(events, out, costs_path=args.costs,
                                  top=args.top)
    rebased, offsets = rebase_events(events)
    flows = flow_events(rebased)
    dropped = dropped_spans(events)
    with open(args.out, "w") as f:
        json.dump(chrome_trace(rebased + flows), f)
        f.write("\n")
    out.write(
        f"ldt trace: wrote {len(rebased)} events (+{len(flows)} flow "
        f"arrows, {len(offsets)} process clocks aligned) to {args.out} — "
        "open it at https://ui.perfetto.dev or chrome://tracing\n"
    )
    if dropped:
        out.write(
            f"ldt trace: source ring buffers dropped ~{dropped} spans — "
            "the merged trace is truncated (raise SpanTracer capacity "
            "or rely on the JSONL, which never drops)\n"
        )
    return 0
