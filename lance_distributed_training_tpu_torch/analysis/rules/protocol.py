"""Cross-module protocol-consistency rule (LDT501).

The wire protocol's frame-type and version constants live in ONE module
(``service/protocol.py``); the client and server reference them by
attribute. A constant referenced but not defined is a guaranteed
``AttributeError`` on a code path that may only fire mid-outage (error
frames, resume handshakes); a *redefined* constant with a different value is
worse — two peers silently speaking different dialects. This rule checks the
whole project at once:

* every uppercase attribute referenced on an alias of the protocol module
  must be defined there;
* any module-level constant elsewhere whose name collides with a protocol
  constant must carry the identical literal value.
"""

from __future__ import annotations

import ast
from typing import Iterable, Sequence

from ..core import Finding, ModuleInfo, Rule, register

_MISSING = object()


def _module_constants(module: ModuleInfo) -> dict:
    """Module-level UPPERCASE name → literal value (or _MISSING when the
    value is not a literal — presence still counts). Handles both plain
    assignments and annotated ones (``MSG_FOO: int = 7``)."""
    out = {}
    for node in module.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        if isinstance(target, ast.Name) and target.id.isupper():
            try:
                out[target.id] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                out[target.id] = _MISSING
    return out


@register
class ProtocolConsistency(Rule):
    id = "LDT501"
    family = "protocol"
    name = "protocol-consistency"
    description = (
        "frame-type/version constant referenced on the protocol module but "
        "not defined there, or redefined elsewhere with a different value"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo], config
    ) -> Iterable[Finding]:
        proto = next(
            (m for m in modules if m.relpath == config.protocol_module), None
        )
        if proto is None:
            return
        defined = _module_constants(proto)
        proto_name = proto.dotted_name
        for module in modules:
            if module is proto:
                continue
            aliases = {
                alias
                for alias, target in module.imports.items()
                if target == proto_name
            }
            # (a) referenced-but-undefined: P.MSG_FOO with no MSG_FOO.
            for node in ast.walk(module.tree):
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases
                    and node.attr.isupper()
                    and node.attr not in defined
                ):
                    yield Finding(
                        self.id, module.relpath,
                        node.lineno, node.col_offset,
                        f"protocol constant {node.attr!r} referenced via "
                        f"{node.value.id}.{node.attr} is not defined in "
                        f"{config.protocol_module} — AttributeError on "
                        "first use",
                    )
            # from-imports of specific constants.
            for alias, target in module.imports.items():
                if (
                    target.startswith(proto_name + ".")
                    and target.rsplit(".", 1)[1].isupper()
                    and target.rsplit(".", 1)[1] not in defined
                ):
                    yield Finding(
                        self.id, module.relpath, 1, 0,
                        f"from-import of protocol constant "
                        f"{target.rsplit('.', 1)[1]!r} which is not defined "
                        f"in {config.protocol_module}",
                    )
            # (b) redefinitions with mismatched values.
            local = _module_constants(module)
            for name, value in local.items():
                if name not in defined:
                    continue
                canonical = defined[name]
                if (
                    value is not _MISSING
                    and canonical is not _MISSING
                    and value != canonical
                ):
                    line = next(
                        (
                            n.lineno
                            for n in module.tree.body
                            if (
                                isinstance(n, ast.Assign)
                                and any(
                                    isinstance(t, ast.Name) and t.id == name
                                    for t in n.targets
                                )
                            )
                            or (
                                isinstance(n, ast.AnnAssign)
                                and isinstance(n.target, ast.Name)
                                and n.target.id == name
                            )
                        ),
                        1,
                    )
                    yield Finding(
                        self.id, module.relpath, line, 0,
                        f"protocol constant {name} redefined as {value!r} "
                        f"but {config.protocol_module} says {canonical!r} — "
                        "two peers would speak different dialects; import "
                        "it from the protocol module instead",
                    )
