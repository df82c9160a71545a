"""Content-purity taint rule (LDT1301).

The autotuner's contract — "actuation changes capacity, never content" —
and the bit-identical-stream guarantee every parity test pins are the same
invariant stated twice: the *content* of the stream (which rows land in
which batch, in what order, with what digests) must be a pure function of
(dataset, plan parameters, seed, epoch, cursor). Wall clocks, unseeded
RNG, thread identity, set-iteration order, multi-producer queue arrival
order, and live tunable values may shape *when* and *how fast* batches
move — never *what* is in them.

Before this rule that separation lived in prose and benches. Here it is
static: ``[tool.ldt-check.content-paths]`` declares the content
computations (plan generation, batch assembly, cursor arithmetic, lineage
digests) as ``path-glob[::function-glob]`` entries, and the
:class:`~..ownermodel.OwnerModel` purity pass flags every taint source
lexically inside a declared content function or any function it reaches
through resolved calls within content modules. A finding is either a real
reproducibility bug (seed the RNG, sort the iteration, derive the value
from the plan) or a reviewed-benign case — suppress those with a reasoned
``# ldt: ignore[LDT1301] -- why``; bare ignores stay live, the same
discipline as every other whole-program family.
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, Rule, register
from ..ownermodel import build_owner_model


@register
class ContentPurityTaint(Rule):
    id = "LDT1301"
    name = "content-purity-taint"
    description = (
        "nondeterminism source (wall clock, unseeded RNG, thread identity, "
        "set/queue order, actuator setter) reachable from a declared "
        "content path"
    )
    family = "purity"
    uses_owner_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_owner_model(program, config)
        for hit in model.taints:
            where = (
                "inside" if hit.func == hit.content_root
                else f"reachable from content path {hit.content_root}"
            )
            root = hit.content_root.rsplit(".", 2)
            root_short = ".".join(root[-2:])
            yield Finding(
                self.id, hit.module, hit.line, hit.col,
                f"nondeterminism source {hit.source} {where} "
                f"(content path {root_short}) — content must be a pure "
                "function of (dataset, plan, seed, epoch, cursor); "
                "capacity/telemetry may vary, content may not "
                "(reviewed-benign uses need a reasoned "
                "`# ldt: ignore[LDT1301] -- why`)",
            )
