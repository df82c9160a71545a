"""Dispatcher-exhaustiveness rule (LDT1003).

LDT501 pins the protocol *constants* (defined where referenced, values
consistent). It says nothing about *behavior*: add ``MSG_FLEET_DRAIN = 24``
to ``service/protocol.py``, teach the coordinator to send it, and every
LDT501 check stays green while the agent's dispatch loop silently falls
through to its error counter. This rule upgrades the contract to coverage:

* the config's ``dispatch`` table names each dispatcher module's inbound
  vocabulary (server: HELLO/ACK/ERROR; coordinator: the four fleet
  requests; …);
* every ``MSG_*`` constant the protocol module defines must appear in at
  least one dispatcher's vocabulary — a new frame type nobody is declared
  to handle is a finding at its definition line;
* every declared constant must be **behaviorally dispatched** in its
  module: compared against a received message type (``==``/``!=``/``in``)
  or keyed in a handler dict. Declaring is not handling — the reference
  must sit in dispatch position, so deleting the ``elif`` arm fails the
  gate even though the import still resolves. A comparison whose branch
  *rejects* the message counts: explicit rejection is a handled outcome.

The rule is inert when none of the configured dispatcher modules are in
the scanned set (fixture trees checking other rules), and a vocabulary
entry naming an undefined constant is itself a finding — the config must
never drift ahead of the protocol.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set

from ..core import Finding, ModuleInfo, Rule, register


def _constant_defs(proto: ModuleInfo) -> Dict[str, int]:
    """MSG_* name → definition line in the protocol module."""
    out: Dict[str, int] = {}
    for node in proto.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if isinstance(target, ast.Name) and target.id.startswith("MSG_"):
            out[target.id] = node.lineno
    return out


def _proto_const_ref(module: ModuleInfo, node: ast.AST,
                     proto_name: str) -> Optional[str]:
    """The MSG_* constant a Name/Attribute resolves to (through the import
    map), or None."""
    qn = module.qualname(node)
    if qn is None:
        return None
    if qn.startswith(proto_name + "."):
        leaf = qn[len(proto_name) + 1:]
        if "." not in leaf and leaf.startswith("MSG_"):
            return leaf
    return None


def _dispatched_constants(module: ModuleInfo, proto_name: str) -> Set[str]:
    """MSG_* constants this module dispatches on: referenced inside a
    comparison (against a received type) or as a handler-dict key."""
    out: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Compare):
            for sub in ast.walk(node):
                name = _proto_const_ref(module, sub, proto_name)
                if name:
                    out.add(name)
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if key is None:
                    continue
                name = _proto_const_ref(module, key, proto_name)
                if name:
                    out.add(name)
        elif isinstance(node, ast.Match):
            for case in node.cases:
                for sub in ast.walk(case.pattern):
                    name = _proto_const_ref(module, sub, proto_name)
                    if name:
                        out.add(name)
    return out


@register
class DispatcherExhaustiveness(Rule):
    id = "LDT1003"
    name = "dispatcher-exhaustiveness"
    description = (
        "protocol MSG_* constant with no dispatcher declared to handle "
        "it, or a dispatcher missing behavioral coverage (comparison / "
        "handler-dict key) for its declared vocabulary"
    )
    family = "dispatch"

    def check_project(self, modules, config) -> Iterable[Finding]:
        proto = next(
            (m for m in modules if m.relpath == config.protocol_module), None
        )
        if proto is None or proto.tree is None:
            return
        dispatch: Dict[str, list] = getattr(config, "dispatch", {}) or {}
        by_path = {m.relpath: m for m in modules}
        dispatchers = {
            path: by_path[path] for path in dispatch if path in by_path
        }
        if not dispatchers:
            return  # no configured dispatcher in this scan: nothing to gate
        defs = _constant_defs(proto)
        proto_name = proto.dotted_name
        declared: Set[str] = set()
        for path, vocabulary in sorted(dispatch.items()):
            declared.update(vocabulary)
            module = dispatchers.get(path)
            if module is None:
                continue
            covered = _dispatched_constants(module, proto_name)
            for const in sorted(set(vocabulary)):
                if const not in defs:
                    yield Finding(
                        self.id, path, 1, 0,
                        f"dispatch vocabulary names {const!r} which "
                        f"{config.protocol_module} does not define — "
                        "config drift ahead of the protocol",
                    )
                    continue
                if const not in covered:
                    yield Finding(
                        self.id, path, 1, 0,
                        f"dispatcher does not handle {const!r}: no "
                        "comparison or handler-dict entry dispatches it — "
                        "add the arm (or an explicit rejection) so the "
                        "frame type has a behavior, not a fall-through",
                    )
        for const, line in sorted(defs.items()):
            if const not in declared:
                yield Finding(
                    self.id, config.protocol_module, line, 0,
                    f"protocol constant {const!r} is in no dispatcher's "
                    "vocabulary ([tool.ldt-check.dispatch]) — a frame "
                    "type nobody is declared to handle; wire it into the "
                    "receiving dispatcher(s) and list it there",
                )
