"""Critical-path analysis over merged cross-process traces.

A copy of ``lance_distributed_training_tpu/obs/critpath.py`` for the
port; it reads span JSONL written by either package.

Input is the merged event list ``ldt trace export`` assembles from
per-process span JSONLs. Three layers of machinery live here:

* **clock rebasing** — span timestamps are per-process monotonic
  microseconds; each process's JSONL carries one ``ldt.clock_sync``
  anchor (wall_ns + mono_ns captured together, the LDT601-sanctioned
  epoch stamp) so all processes can be placed on one wall timeline.
  Loopback-accurate; across real hosts it inherits NTP skew exactly as
  lineage ``wire_ms`` does, and negative gaps clamp to zero.
* **flow stitching** — events sharing an ``args.trace_id`` (stamped by
  :mod:`.tracectx` at decode, propagated over protocol v5) become one
  Perfetto flow: arrows decode → send → merge across process tracks,
  with the true parent edge (``trace_parent`` = the remote segment's
  ``trace_span``) preserved in args.
* **attribution** — per batch (one trace id), tile the wall from decode
  start to step end into named segments::

      decode | cache   svc.decode duration (cache when the probe hit)
      queue_wait       svc.decode end → svc.send start (same clock)
      wire             svc.send start → receive start (rebased, clamped
                       — includes the send span itself: serialize +
                       socket write ride this segment, so the tiling
                       has no hole the size of every send)
      merge            receive-hop duration (client-side decode)
      h2d              receive end → train.step start (transform +
                       placement + prefetch dwell — the client's lap)
      step             train.step duration

  ``coverage_pct`` = attributed / wall. The tiling is exhaustive by
  construction, so coverage only drops when clock skew eats a gap —
  which is why the smoke asserts ≥90%, not ==100%. The straggler table
  joins the slowest chains with their cost-ledger records via the
  ``item`` attr (the BatchCache content hash) on the decode span.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CLOCK_SYNC_NAME",
    "DROP_MARK_NAME",
    "clock_offsets_us",
    "rebase_events",
    "flow_events",
    "dropped_spans",
    "analyze",
    "critical_path_main",
]

# Reserved JSONL record names written by obs/spans.py (ph "M"/"C"
# bookkeeping records, never rendered as duration tracks).
CLOCK_SYNC_NAME = "ldt.clock_sync"
DROP_MARK_NAME = "ldt.spans_dropped"

# Receive-hop span names (the process that pulls a batch off the wire).
_RECV_NAMES = ("client.decode", "fleet.recv")


def _args(event: dict) -> dict:
    args = event.get("args")
    return args if isinstance(args, dict) else {}


def clock_offsets_us(events: List[dict]) -> Dict[int, float]:
    """Per-pid wall-rebase offsets (µs to ADD to a monotonic ts) from
    ``ldt.clock_sync`` anchors. Multiple anchors per pid (a process that
    reopened its JSONL) keep the latest."""
    offsets: Dict[int, float] = {}
    for ev in events:
        if ev.get("name") != CLOCK_SYNC_NAME:
            continue
        args = _args(ev)
        wall, mono = args.get("wall_ns"), args.get("mono_ns")
        if isinstance(wall, (int, float)) and isinstance(mono, (int, float)):
            offsets[ev.get("pid")] = (float(wall) - float(mono)) / 1e3
    return offsets


def rebase_events(events: List[dict]) -> Tuple[List[dict], Dict[int, float]]:
    """Copy of ``events`` with every anchored pid's timestamps moved onto
    the wall timeline (µs since epoch). Unanchored pids pass through
    untouched — a single-process trace needs no alignment, and a legacy
    (pre-anchor) file stays renderable."""
    offsets = clock_offsets_us(events)
    out = []
    for ev in events:
        off = offsets.get(ev.get("pid"))
        if off is not None and isinstance(ev.get("ts"), (int, float)):
            ev = dict(ev, ts=ev["ts"] + off)
        out.append(ev)
    return out, offsets


def flow_events(events: List[dict]) -> List[dict]:
    """Perfetto flow events (ph s/t) binding each trace id's hops in
    (rebased) time order — the visible arrows decode → send → merge."""
    by_trace: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        trace_id = _args(ev).get("trace_id")
        if isinstance(trace_id, str):
            by_trace.setdefault(trace_id, []).append(ev)
    flows: List[dict] = []
    for trace_id, evs in by_trace.items():
        if len(evs) < 2:
            continue
        evs.sort(key=lambda e: e.get("ts", 0.0))
        for i, ev in enumerate(evs):
            flows.append({
                "name": "batch",
                "cat": "trace",
                "ph": "s" if i == 0 else "t",
                "id": trace_id[:16],
                "pid": ev.get("pid"),
                "tid": ev.get("tid"),
                "ts": ev.get("ts", 0.0) + (ev.get("dur", 0.0) if i == 0
                                           else 0.0),
            })
    return flows


def dropped_spans(events: List[dict]) -> int:
    """Total ring-buffer drops reported by the source processes (the max
    marker value per pid — markers are cumulative counts)."""
    per_pid: Dict[int, float] = {}
    for ev in events:
        if ev.get("name") != DROP_MARK_NAME:
            continue
        dropped = _args(ev).get("dropped")
        if isinstance(dropped, (int, float)):
            pid = ev.get("pid")
            per_pid[pid] = max(per_pid.get(pid, 0.0), float(dropped))
    return int(sum(per_pid.values()))


# -- attribution -------------------------------------------------------------


def _chains(events: List[dict]) -> Dict[str, dict]:
    """Classify each trace id's hops: root decode, send, receive."""
    chains: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = _args(ev)
        trace_id = args.get("trace_id")
        if not isinstance(trace_id, str):
            continue
        chain = chains.setdefault(trace_id, {"pids": set()})
        chain["pids"].add(ev.get("pid"))
        name = ev.get("name", "")
        if args.get("trace_parent") is not None or name in _RECV_NAMES:
            chain["recv"] = ev
        elif name.endswith(".send"):
            chain["send"] = ev
        elif args.get("trace_span") is not None:
            chain["root"] = ev
        if "step" in args and "step" not in chain:
            chain["step_no"] = args["step"]
    return chains


def _join_trainer(chains: Dict[str, dict], events: List[dict]) -> None:
    """Attach each chain's train.step span by step number: the trainer's
    spans predate trace propagation into the step function, so the join
    key is the step attr — picking the first step span at/after the
    chain's receive hop (multi-epoch runs reuse plan step numbers).

    Only chains WITH a receive hop join: a sent-but-never-merged chain
    (a stripe reconnect re-decodes its steps under fresh trace ids and
    abandons the in-flight frames) shares a step number with the chain
    that actually fed the trainer — joining it by number alone would
    attribute the step, and hours of unrelated wall, to a frame nobody
    consumed."""
    steps: Dict[object, List[dict]] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "train.step":
            step = _args(ev).get("step")
            if step is not None:
                steps.setdefault(step, []).append(ev)
    for evs in steps.values():
        evs.sort(key=lambda e: e.get("ts", 0.0))
    for chain in chains.values():
        step_no = chain.get("step_no")
        anchor = chain.get("recv")
        if step_no is None or anchor is None:
            continue
        t0 = anchor.get("ts", 0.0) + anchor.get("dur", 0.0)
        for ev in steps.get(step_no, ()):
            if ev.get("ts", 0.0) >= t0 - 1.0:  # 1 µs slack
                chain["train"] = ev
                chain["pids"].add(ev.get("pid"))
                break


def _end(ev: dict) -> float:
    return ev.get("ts", 0.0) + ev.get("dur", 0.0)


def attribute(chain: dict) -> Optional[dict]:
    """One chain → ``{segments, wall_ms, coverage_pct, dominant, …}`` or
    None for a chain with no root (nothing to anchor the wall on)."""
    root = chain.get("root")
    if root is None:
        return None
    send, recv, train = (
        chain.get("send"), chain.get("recv"), chain.get("train")
    )
    last = train or recv or send or root
    wall_us = max(_end(last) - root.get("ts", 0.0), 0.0)
    seg: Dict[str, float] = {}
    decode_name = ("cache" if _args(root).get("cache_hit") else "decode")
    seg[decode_name] = root.get("dur", 0.0)
    if send is not None:
        seg["queue_wait"] = max(send.get("ts", 0.0) - _end(root), 0.0)
        if recv is not None:
            # From send START: the send span's own duration (serialize +
            # socket write) belongs to the wire segment, not to a hole.
            seg["wire"] = max(
                recv.get("ts", 0.0) - send.get("ts", 0.0), 0.0
            )
        else:
            # Sent but never merged (the peer re-striped away): the send
            # span itself is all the wire time this chain witnessed.
            seg["wire"] = send.get("dur", 0.0)
    if recv is not None:
        seg["merge"] = recv.get("dur", 0.0)
        if train is not None:
            seg["h2d"] = max(train.get("ts", 0.0) - _end(recv), 0.0)
    if train is not None:
        seg["step"] = train.get("dur", 0.0)
    attributed = sum(seg.values())
    coverage = 100.0 * attributed / wall_us if wall_us > 0 else 100.0
    segments_ms = {k: round(v / 1e3, 3) for k, v in seg.items()}
    dominant = max(seg, key=seg.get) if seg else decode_name
    return {
        "segments_ms": segments_ms,
        "wall_ms": round(wall_us / 1e3, 3),
        "coverage_pct": round(min(coverage, 100.0), 2),
        "dominant": dominant,
        "pids": sorted(p for p in chain["pids"] if p is not None),
        "step": chain.get("step_no"),
        "item": _args(root).get("item"),
    }


def analyze(events: List[dict]) -> List[dict]:
    """Merged (already rebased) events → per-batch attributions, slowest
    first."""
    chains = _chains(events)
    _join_trainer(chains, events)
    out = []
    for trace_id, chain in chains.items():
        attr = attribute(chain)
        if attr is not None:
            attr["trace_id"] = trace_id
            out.append(attr)
    out.sort(key=lambda a: a["wall_ms"], reverse=True)
    return out


# -- `ldt trace critical-path` ----------------------------------------------


def _load_costs(path: Optional[str], out) -> Dict[str, dict]:
    if not path:
        return {}
    if not os.path.exists(path):
        out.write(f"ldt trace: missing cost file {path}\n")
        return {}
    records: Dict[str, dict] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and isinstance(rec.get("key"), str):
                merged = records.setdefault(rec["key"], {})
                merged.update(
                    {k: v for k, v in rec.items() if k != "ns"}
                )
    return records


def critical_path_main(events: List[dict], out,
                       costs_path: Optional[str] = None,
                       top: int = 10) -> int:
    """Analyze merged events and print the attribution + straggler
    report (the ``ldt trace critical-path`` body — ``obs/spans.py``
    parses the arguments and loads the JSONLs)."""
    rebased, _ = rebase_events(events)
    attrs = analyze(rebased)
    if not attrs:
        out.write(
            "ldt trace: no batch chains found — record with protocol v5 "
            "peers and LDT_TRACE_PATH set on every process\n"
        )
        return 2
    total = len(attrs)
    mean_cov = sum(a["coverage_pct"] for a in attrs) / total
    dominants: Dict[str, int] = {}
    for a in attrs:
        dominants[a["dominant"]] = dominants.get(a["dominant"], 0) + 1
    out.write(
        f"ldt trace: {total} batch chains, mean coverage "
        f"{mean_cov:.1f}% of wall\n"
    )
    out.write("dominant segments: " + ", ".join(
        f"{name}={n}" for name, n in
        sorted(dominants.items(), key=lambda kv: -kv[1])
    ) + "\n")
    costs = _load_costs(costs_path, out)
    out.write(
        f"{'step':>6} {'wall_ms':>9} {'cover%':>7} {'dominant':>10} "
        "segments\n"
    )
    for a in attrs[:top]:
        segs = " ".join(
            f"{k}={v}" for k, v in sorted(a["segments_ms"].items())
        )
        out.write(
            f"{str(a['step']):>6} {a['wall_ms']:>9} "
            f"{a['coverage_pct']:>7} {a['dominant']:>10} {segs}\n"
        )
        item = a.get("item")
        if item and item in costs:
            cost = ", ".join(
                f"{k}={v}" for k, v in sorted(costs[item].items())
                if k != "key"
            )
            out.write(f"{'':>6} cost[{str(item)[:16]}]: {cost}\n")
    return 0
