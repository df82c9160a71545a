"""Per-item cost ledger — what each plan item actually cost to decode.

A copy of ``lance_distributed_training_tpu/obs/costs.py`` with its ``ldt
costs`` subcommand (:func:`costs_main`).

The straggler problem (MinatoLoader, PAPERS.md 2509.10712) is per-ITEM:
one oversized JPEG on the re-encode path, one long token tail, and batch
assembly stalls at the slowest row. Metrics histograms say decode got
slow; only a ledger keyed the way the planner keys work can say *which
items* are slow — the seam a straggler-aware scheduler consumes.

A :class:`CostLedger` holds bounded per-item records keyed by the SAME
content hash :class:`~..data.cache.BatchCache` keys plan items with
(``item_fingerprint``), so a ledger row, a cache entry, and a plan item
all name the same work. Fields are whatever the decode path observed::

    {"key": "sha256:…", "n": 3, "decode_ms": 41.2, "decode_ms_max": 55.0,
     "entropy_ms": 12.1, "device_ms": 8.9, "bytes": 602112,
     "token_len": 512, "reencode": 1, "cache_hit": 0, "step": 17}

Recording is two-layered so deep decode internals need no plumbing:

* the decode *caller* (``DataService._produce``, the in-process decode
  seam) opens :func:`cost_context` around one item's decode and the
  ledger gets one merged record on exit;
* decode *internals* (``data/device_decode.py`` entropy loop,
  ``data/token_pack.py``) call :func:`note_cost` — a thread-local merge
  into whichever context is open, a no-op when none is (so workers,
  tests, and bare calls cost two attribute loads).

Worker-pool decode runs in worker processes: their ``note_cost`` calls
land in the worker's own (context-less) process and are dropped; the
server still records arrival-gap ``decode_ms`` + bytes per item, which
is the wait the planner schedules against. Memory is bounded (oldest
records fall off), registry summaries ride ``/metrics`` as ``cost_*``,
and ``LDT_COST_PATH`` appends one JSON line per record — the durable
form ``ldt costs report`` consumes.

Clock policy: durations arrive already measured (monotonic, LDT601);
the JSONL stamp is ``time.time_ns()`` — an epoch stamp meant to cross
process boundaries, per the lineage clock policy.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .registry import MetricsRegistry, default_registry

__all__ = [
    "CostLedger",
    "default_ledger",
    "cost_context",
    "note_cost",
    "costs_main",
]

# Numeric fields where the historical MAX is the straggler signal (the
# slowest observation of an item, not its latest).
_TRACK_MAX = ("decode_ms",)
# Flag fields accumulated as counts (how often the slow path fired).
_FLAG_FIELDS = ("reencode", "cache_hit")
# Fields summarised into /metrics histograms on every record.
_HIST_FIELDS = ("decode_ms", "entropy_ms", "device_ms", "token_len")


class CostLedger:
    """Bounded, thread-safe per-item cost records (insertion-ordered
    ring: re-recording an item refreshes it to the young end)."""

    def __init__(self, capacity: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity)
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self._registry = registry
        self._io_lock = threading.Lock()
        self._jsonl = None
        self._jsonl_path = jsonl_path or os.environ.get("LDT_COST_PATH")

    @property
    def registry(self) -> MetricsRegistry:
        if self._registry is None:
            self._registry = default_registry()
        return self._registry

    # -- recording ---------------------------------------------------------

    def record(self, key: Optional[str], **fields) -> None:
        """Merge one observation of item ``key`` (None — an unaddressable
        item — is dropped: a ledger row nobody can schedule is noise)."""
        if key is None:
            return
        clean = {}
        for name, value in fields.items():
            if isinstance(value, bool):
                clean[name] = int(value)
            elif isinstance(value, (int, float)):
                clean[name] = round(float(value), 3)
        with self._lock:
            rec = self._records.pop(key, None)
            if rec is None:
                rec = {"key": key, "n": 0}
            rec["n"] += 1
            for name, value in clean.items():
                if name in _FLAG_FIELDS:
                    rec[name] = rec.get(name, 0) + value
                else:
                    rec[name] = value
            for name in _TRACK_MAX:
                if name in clean:
                    prev = rec.get(f"{name}_max", clean[name])
                    rec[f"{name}_max"] = max(prev, clean[name])
            self._records[key] = rec
            while len(self._records) > self._capacity:
                self._records.popitem(last=False)
        reg = self.registry
        reg.counter("cost_records_total").inc()
        if clean.get("bytes"):
            reg.counter("cost_bytes_total").inc(clean["bytes"])
        if clean.get("reencode"):
            reg.counter("cost_reencode_total").inc(clean["reencode"])
        for name in _HIST_FIELDS:
            if name in clean:
                reg.histogram(f"cost_{name}").observe(clean[name])
        self._append_jsonl(key, clean)

    def _append_jsonl(self, key: str, fields: dict) -> None:
        if self._jsonl_path is None:
            return
        line = json.dumps(
            dict(fields, key=key, ns=time.time_ns())  # epoch stamp:
        ) + "\n"  # crosses processes into `ldt costs report` (LDT601)
        with self._io_lock:
            if self._jsonl_path is None:
                return
            if self._jsonl is None:
                try:
                    self._jsonl = open(self._jsonl_path, "a")
                except OSError:
                    self._jsonl_path = None  # never retry a bad path
                    return
            self._jsonl.write(line)
            self._jsonl.flush()

    # -- reading -----------------------------------------------------------

    def records(self) -> List[dict]:
        """Current records, oldest first (bounded by capacity)."""
        with self._lock:
            return [dict(r) for r in self._records.values()]

    def top(self, n: int = 3, by: str = "decode_ms_max") -> List[dict]:
        """The ``n`` costliest items — the straggler table's rows."""
        recs = self.records()
        recs.sort(key=lambda r: r.get(by, r.get("decode_ms", 0.0)),
                  reverse=True)
        return recs[:n]

    def close(self) -> None:
        with self._io_lock:
            self._jsonl_path = None
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


_DEFAULT: Optional[CostLedger] = None
_DEFAULT_LOCK = threading.Lock()


def default_ledger() -> CostLedger:
    """The process-wide ledger (lazy, like the default tracer, so
    ``LDT_COST_PATH`` set by the entry point is honoured)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CostLedger()
        return _DEFAULT


# -- thread-local context: decode internals report without plumbing --------

_TLS = threading.local()


class cost_context:
    """Context manager the decode CALLER opens around one item: every
    :func:`note_cost` on this thread merges into one record, written to
    ``ledger`` on exit (exceptions included — a decode that died half
    way is exactly the record a straggler hunt wants)."""

    def __init__(self, key: Optional[str],
                 ledger: Optional[CostLedger] = None, **fields):
        self._key = key
        self._ledger = ledger
        self._fields = dict(fields)
        self._prev = None

    def __enter__(self) -> "cost_context":
        self._prev = getattr(_TLS, "fields", None)
        _TLS.fields = self._fields
        return self

    def __exit__(self, *exc) -> None:
        _TLS.fields = self._prev
        ledger = self._ledger if self._ledger is not None else default_ledger()
        ledger.record(self._key, **self._fields)

    def note(self, **fields) -> None:
        self._fields.update(fields)


def note_cost(**fields) -> None:
    """Merge fields into the innermost open :func:`cost_context` on this
    thread; a no-op (two attribute loads) when none is open — decode
    internals call this unconditionally."""
    current = getattr(_TLS, "fields", None)
    if current is not None:
        current.update(fields)


# -- `ldt costs` CLI ---------------------------------------------------------


def costs_main(argv=None, out=None) -> int:
    """``ldt costs report`` — aggregate cost-ledger JSONL (written under
    ``LDT_COST_PATH``) into a straggler table. Returns exit status."""
    import argparse
    import sys

    out = out if out is not None else sys.stdout
    p = argparse.ArgumentParser(
        prog="ldt costs",
        description="Report per-item decode costs from cost-ledger JSONL",
    )
    sub = p.add_subparsers(dest="command")
    rep = sub.add_parser("report", help="aggregate cost JSONL → table")
    rep.add_argument(
        "--costs", action="append", default=None, metavar="JSONL",
        help="cost JSONL file(s) written under LDT_COST_PATH (repeatable; "
             "default: $LDT_COST_PATH or ldt-costs.jsonl)",
    )
    rep.add_argument("--top", type=int, default=10,
                     help="straggler rows to show (default 10)")
    args = p.parse_args(list(argv) if argv is not None else None)
    if args.command != "report":
        p.print_help(out)
        return 2
    paths = args.costs or [os.environ.get("LDT_COST_PATH", "ldt-costs.jsonl")]
    ledger = CostLedger(capacity=1 << 20, jsonl_path=None,
                        registry=MetricsRegistry())
    lines = 0
    parsed = []  # (key, fields) in file order, for the prediction replay
    for path in paths:
        if not os.path.exists(path):
            out.write(f"ldt costs: missing cost file {path}\n")
            continue
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    out.write(
                        f"ldt costs: skipping undecodable line "
                        f"{path}:{lineno}\n"
                    )
                    continue
                if isinstance(rec, dict) and isinstance(rec.get("key"), str):
                    fields = {
                        k: v for k, v in rec.items() if k not in ("key", "ns")
                    }
                    ledger.record(rec["key"], **fields)
                    parsed.append((rec["key"], fields))
                    lines += 1
    # Predicted-vs-actual replay (data/schedule.py CostModel): walk the
    # ledger in recorded order, predicting each observation BEFORE folding
    # it in — exactly the error the straggler scheduler would have run
    # with. The per-key mean lands in the pred_err_ms column, so a
    # mispredicted straggler is diagnosable straight from this table.
    from ..data.schedule import CostModel

    model = CostModel()
    pred_err: dict = {}  # key -> [err_sum, n]
    for key, fields in parsed:
        ms = fields.get("decode_ms")
        if not isinstance(ms, (int, float)):
            continue
        err = abs(model.predict(key, fields) - float(ms))
        acc = pred_err.setdefault(key, [0.0, 0])
        acc[0] += err
        acc[1] += 1
        model.observe(key, float(ms), fields)
    recs = ledger.records()
    for rec in recs:
        acc = pred_err.get(rec["key"])
        if acc is not None:
            rec["pred_err_ms"] = round(acc[0] / acc[1], 3)
    if not recs:
        out.write(
            "ldt costs: no records — run with LDT_COST_PATH=<file> to "
            "record per-item costs\n"
        )
        return 2
    total_n = sum(r["n"] for r in recs)
    out.write(
        f"ldt costs: {len(recs)} items, {total_n} observations "
        f"({lines} lines)\n"
    )
    cols = ("n", "decode_ms_max", "decode_ms", "pred_err_ms", "entropy_ms",
            "device_ms", "bytes", "token_len", "reencode", "cache_hit")
    out.write("  " + " ".join(f"{c:>13}" for c in cols) + "  key\n")
    # Same straggler ordering as CostLedger.top(), over the annotated
    # records (top() re-copies and would drop the pred_err_ms join).
    recs.sort(key=lambda r: r.get("decode_ms_max", r.get("decode_ms", 0.0)),
              reverse=True)
    for rec in recs[:args.top]:
        row = " ".join(f"{rec.get(c, ''):>13}" for c in cols)
        out.write(f"  {row}  {rec['key'][:20]}\n")
    return 0
