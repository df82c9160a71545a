"""Cross-module lock-order rule (LDT1001).

A deadlock needs two facts that usually live in two files: thread 1 holds
lock A and wants B (say, the coordinator's lease-table lock and then the
metrics registry's), thread 2 holds B and wants A. Per-module AST rules are
structurally blind to it. This rule consumes the shared
:class:`~..concmodel.ProgramInfo` lock-order graph — an edge ``A → B`` for
every site where B is acquired while A is held (nested ``with``, a call
chain entered under A, or a function the fixpoint proves is only ever
called with A held) — and reports every elementary cycle, plus non-reentrant
re-acquisition (``with self._lock`` inside a frame already holding it: a
one-thread deadlock, no second thread required).

Static inference can report cycles whose edges never co-occur at runtime
(infeasible paths). The runtime witness closes that gap: run the test suite
with ``LDT_LOCK_SANITIZER=1`` (``utils/lockorder.py``) and hand the emitted
edge file to ``ldt check --lock-witness``. A cycle containing an edge that
the instrumented run *never observed* — while both locks demonstrably were
exercised — is marked ``witness_pruned`` (rendered, but neither failing the
gate nor baselined); a cycle whose every edge was observed gains the
runtime corroboration in its message, turning "potential" into
"reproduced".
"""

from __future__ import annotations

from typing import Iterable, List

from ..core import Finding, Rule, register


@register
class LockOrderCycles(Rule):
    id = "LDT1001"
    name = "lock-order-cycle"
    description = (
        "cross-module lock acquisition cycle (potential deadlock) or "
        "non-reentrant re-acquisition of a held lock"
    )
    family = "lock-order"

    def check_program(self, program, config) -> Iterable[Finding]:
        witness = getattr(config, "lock_witness", None)
        for cycle in program.lock_cycles():
            head = cycle[0]
            if len(cycle) == 1 and head.src == head.dst:
                yield Finding(
                    self.id, head.module, head.line, head.col,
                    f"non-reentrant lock {program.lock_display(head.src)} "
                    f"acquired while already held ({head.via}) — this "
                    "thread deadlocks against itself; use RLock or narrow "
                    "the outer critical section",
                )
                continue
            chain = " -> ".join(
                f"{program.lock_display(e.src)}"
                f" ({e.module}:{e.line}, {self._short_via(e.via)})"
                for e in cycle
            )
            closing = program.lock_display(cycle[0].src)
            message = (
                f"lock-order cycle ({len(cycle)} locks): {chain} -> "
                f"{closing} — two threads interleaving these acquisitions "
                "deadlock; pick one global order or drop a lock scope"
            )
            pruned = False
            if witness:
                verdict = self._witness_verdict(program, cycle, witness)
                if verdict == "pruned":
                    pruned = True
                    message += (
                        " [witness_pruned: an edge of this cycle was never "
                        "observed in the instrumented run although both "
                        "locks were exercised]"
                    )
                elif verdict == "confirmed":
                    message += (
                        " [witness: every edge of this cycle was observed "
                        "at runtime — this is a reproduced ordering, not "
                        "an inference]"
                    )
            yield Finding(
                self.id, head.module, head.line, head.col, message,
                witness_pruned=pruned,
            )

    @staticmethod
    def _short_via(via: str) -> str:
        return via if len(via) <= 64 else via[:61] + "..."

    @staticmethod
    def _witness_verdict(program, cycle, witness) -> str:
        """"pruned" | "confirmed" | "unknown" for a static cycle against
        the observed-edge set. Pruning is deliberately strict: it needs
        BOTH locks of the missing edge to have been exercised at runtime —
        absence of evidence about an untouched lock proves nothing."""
        observed_edges = witness.get("edges", set())
        acquired = witness.get("acquired", {})

        def sites(lock_key) -> List[str]:
            info = program.locks.get(lock_key)
            return list(info.sites) if info is not None else []

        def exercised(lock_key) -> bool:
            return any(s in acquired for s in sites(lock_key))

        def observed(edge) -> bool:
            return any(
                (s_src, s_dst) in observed_edges
                for s_src in sites(edge.src)
                for s_dst in sites(edge.dst)
            )

        all_observed = True
        for edge in cycle:
            if observed(edge):
                continue
            all_observed = False
            if exercised(edge.src) and exercised(edge.dst):
                return "pruned"
        return "confirmed" if all_observed else "unknown"
