"""Cross-thread shared-state rule (LDT1002).

The reproducible-pipelines argument (PAPERS.md, arxiv 2604.21275): the
determinism contracts a distributed loader advertises die exactly at
unsynchronized cross-thread state — a cursor bumped by a receiver thread
and read by a checkpointing consumer, a lease dict swapped by a heartbeat
daemon under no lock. This rule consumes the shared
:class:`~..concmodel.ProgramInfo` and reports every ``self.<attr>`` that is
*written on one spawned-thread path and accessed on a different thread
path* with no common lock between the two sites.

What does NOT fire (the model's happens-before and handoff carve-outs):

* accesses in ``__init__`` — the object is not yet shared;
* writes that precede the first ``threading.Thread(...)`` statement of a
  spawning, main-rooted function (the ``start()`` publication pattern);
* attributes only ever assigned internally-synchronized values
  (``queue.Queue``, ``threading.Event``, ``collections.deque``, this
  repo's ``ServiceCounters``/``MetricsRegistry``, … — config
  ``threadsafe-types``) — using such an object IS the sanctioned handoff;
* any write/access pair the lock model proves share a lock (including
  locks held at every call site, the ``_locked`` convention).

A surviving finding is either a bug (add the lock, or route the value
through a queue/Event) or a *reviewed* benign race — suppress those with a
reasoned ignore; LDT10xx ignores without a ``-- reason`` stay live.
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, Rule, register


@register
class UnsynchronizedSharedState(Rule):
    id = "LDT1002"
    name = "unsynchronized-shared-state"
    description = (
        "attribute written on a spawned-thread path and accessed on "
        "another thread path with no common lock or sanctioned handoff"
    )
    family = "shared-state"

    def check_program(self, program, config) -> Iterable[Finding]:
        for ckey, attr, w, a in program.attr_conflicts():
            cls_name = ckey.rsplit(".", 1)[-1]
            w_threads = program.describe_roots(w.func)
            if a is w:
                detail = (
                    f"the single write site runs on multiple threads "
                    f"({w_threads})"
                )
            else:
                a_threads = program.describe_roots(a.func)
                a_kind = "written" if a.write else (
                    "called through" if a.call_through else "read"
                )
                detail = (
                    f"written on {w_threads} and {a_kind} on {a_threads} "
                    f"at {a.module}:{a.line}"
                )
            yield Finding(
                self.id, w.module, w.line, w.col,
                f"unsynchronized shared state: {cls_name}.{attr} {detail} "
                "with no common lock — guard both sides with one lock, or "
                "hand the value off via a queue/Event (reviewed benign "
                "races need a reasoned `# ldt: ignore[LDT1002] -- why`)",
            )
