"""Autotune-actuation rule (LDT1101).

An autotuner with an unbounded actuator is how a controller melts a host:
grow-on-stall against a saturated disk grows the worker pool forever, a
prefetch knob with no ceiling buffers the epoch in RAM. The runtime
``Tunable`` constructor requires ``lo``/``hi`` keywords, but that check
fires on the first *tick* of a running controller — this rule moves it to
commit time: every ``Tunable(...)`` construction site in the package must
declare both bounds, and literal bounds must form a non-degenerate range
(``lo < hi``; a degenerate range means the knob is not tunable and should
not be registered at all).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register


def _literal_int(node) -> object:
    if isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _literal_int(node.operand)
        return -inner if inner is not None else None
    return None


@register
class TunableBounds(Rule):
    id = "LDT1101"
    family = "tune"
    name = "tunable-bounds"
    description = (
        "a registered Tunable must declare lo=/hi= actuation bounds "
        "(unbounded actuation is how autotuners melt hosts)"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func) or ""
            if not (qn == "Tunable" or qn.endswith(".Tunable")):
                continue
            kwargs = {kw.arg: kw.value for kw in node.keywords
                      if kw.arg is not None}
            has_splat = any(kw.arg is None for kw in node.keywords)
            missing = sorted({"lo", "hi"} - set(kwargs))
            if missing:
                if has_splat:
                    # **kwargs may carry the bounds — benefit of the doubt
                    # (the runtime keyword-only check still backstops it).
                    continue
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"Tunable(...) without {'/'.join(missing)}= — every "
                    "registered knob needs explicit actuation bounds, or "
                    "the controller's grow-on-stall loop has no ceiling",
                )
                continue
            lo = _literal_int(kwargs["lo"])
            hi = _literal_int(kwargs["hi"])
            if lo is not None and hi is not None and lo >= hi:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"Tunable(...) bounds [{lo}, {hi}] are degenerate "
                    "(lo >= hi) — a knob with no range is not tunable; "
                    "don't register it",
                )
