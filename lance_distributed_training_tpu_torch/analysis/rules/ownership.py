"""Resource ownership/lifecycle rules (LDT1201-1203).

The zero-copy buffer plane and the service/fleet transports run on a
lease-release discipline: a BufferPool page, a shm slot token, a socket, a
joinable thread each have exactly one owner at a time, and every exit path
— including the exception edges and generator closes the loader-graph
refactor will reshuffle — must either release the handle or visibly hand
it to the next owner. LDT301 checks the *shape* of ownership one statement
at a time; these rules consume the interprocedural
:class:`~..ownermodel.OwnerModel` dataflow and check the *paths*:

* **LDT1201 leak-on-path** — some exit (an early return, a statement that
  can raise while the handle is held, a generator ``close()`` at a
  ``yield``) leaves the resource acquired and neither released nor
  transferred. Reported at the acquire site.
* **LDT1202 double-release** — a release reaches a handle that may already
  be released on some path (skipped for kinds whose release is documented
  idempotent: ``BufferPool.release`` ignores foreign pages, ``close()`` is
  re-callable; a shm token double-put hands one slot to two writers).
* **LDT1203 use-after-release** — any use of the handle on a path where it
  may already be released (``sock.shutdown`` after ``close``, touching a
  released pool page the sweep may already have recycled).

Like the other LDT1xxx whole-program families, a suppression needs a
``-- reason``; bare ignores stay live. The runtime witness
(``LDT_LEAK_SANITIZER=1`` + ``ldt check --leak-witness``) corroborates or
prunes LDT1201 exactly like the lock witness does LDT1001: a leak whose
acquire site demonstrably leaked in an instrumented run is *reproduced*;
one whose site was exercised and always balanced is ``witness_pruned``
(rendered, not failing, never baselined).
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, Rule, register
from ..ownermodel import build_owner_model

_CHANNEL_TEXT = {
    "exception": (
        "a statement that can raise while the handle is held exits the "
        "function without releasing it"
    ),
    "generator-close": (
        "an early generator close() (GeneratorExit at a yield) exits "
        "without releasing it"
    ),
    "return": (
        "a return/fall-off path exits without releasing or transferring it"
    ),
}


@register
class OwnershipLeak(Rule):
    id = "LDT1201"
    name = "resource-leak-on-path"
    description = (
        "acquired resource (pool lease, shm token, socket, thread, "
        "autotuner) held at a function exit path with no release/transfer"
    )
    family = "ownership"
    uses_owner_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_owner_model(program, config)
        witness = getattr(config, "leak_witness", None)
        for rec in model.records:
            if rec.leak is None:
                continue
            spec = model.spec(rec.kind)
            channel = _CHANNEL_TEXT.get(rec.leak, rec.leak)
            message = (
                f"{spec.describe or rec.kind} acquired into {rec.var!r} may "
                f"leak: {channel} — release in a finally, use a with block, "
                f"or transfer ownership (return / queue.put / publish on "
                f"self) before the exit"
            )
            pruned = False
            if witness:
                verdict = self._witness_verdict(rec, witness)
                if verdict == "reproduced":
                    message += (
                        " [witness: leases from this site were still held "
                        "at process exit in the instrumented run — a "
                        "reproduced leak, not an inference]"
                    )
                elif verdict == "pruned":
                    pruned = True
                    message += (
                        " [witness_pruned: this acquire site was exercised "
                        "in the instrumented run and every acquisition was "
                        "released]"
                    )
            yield Finding(
                self.id, rec.module, rec.line, rec.col, message,
                witness_pruned=pruned,
            )

    @staticmethod
    def _witness_verdict(rec, witness) -> str:
        """"reproduced" | "pruned" | "unknown" against the runtime leak
        witness. Pruning is strict, like the lock witness: it needs the
        site to have actually been exercised — absence of evidence about
        an untouched path proves nothing."""
        sites = witness.get("sites", {})
        entry = sites.get(rec.site())
        if not entry:
            return "unknown"
        if int(entry.get("leaked", 0)) > 0:
            return "reproduced"
        if int(entry.get("acquired", 0)) > 0:
            return "pruned"
        return "unknown"


@register
class DoubleRelease(Rule):
    id = "LDT1202"
    name = "double-release"
    description = (
        "resource released again on a path where it may already be "
        "released (non-idempotent kinds: e.g. a shm token double-put "
        "hands one slot to two writers)"
    )
    family = "ownership"
    uses_owner_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_owner_model(program, config)
        for issue in model.issues:
            if issue.issue != "double-release":
                continue
            spec = model.spec(issue.kind)
            yield Finding(
                self.id, issue.module, issue.line, issue.col,
                f"{spec.describe or issue.kind} {issue.var!r} (acquired at "
                f"line {issue.acquire_line}) may already be released on "
                "this path — releasing twice hands the resource to two "
                "owners; release exactly once per exit path",
            )


@register
class UseAfterRelease(Rule):
    id = "LDT1203"
    name = "use-after-release"
    description = (
        "resource used on a path where it may already be released "
        "(shutdown-after-close, touching a recycled pool page)"
    )
    family = "ownership"
    uses_owner_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_owner_model(program, config)
        for issue in model.issues:
            if issue.issue != "use-after-release":
                continue
            spec = model.spec(issue.kind)
            yield Finding(
                self.id, issue.module, issue.line, issue.col,
                f"{spec.describe or issue.kind} {issue.var!r} (acquired at "
                f"line {issue.acquire_line}) may already be released here — "
                "the handle is no longer owned (a released page can be "
                "recycled under you; a closed socket raises); reorder the "
                "use before the release",
            )
