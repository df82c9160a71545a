"""Copy-hygiene rule (LDT701).

The r6 zero-copy batch plane exists because redundant materialisation
between pipeline stages — not decode math — capped loader throughput
(`PERF_NOTES_r05.md` §1). The cheapest way to reintroduce that tax is one
innocent-looking call on a hot path:

* ``col.to_pylist()`` — materialises a Python ``bytes`` object per row of
  an Arrow binary column (the reference's per-batch pattern this repo was
  built to kill; the native decoder reads the column's buffers directly);
* ``col.to_pybytes()`` — same, one giant copy instead of many;
* ``bytes(buf[...])`` / ``bytes(f(...))`` — copies a memoryview/buffer
  slice into a fresh ``bytes`` just to hand it to something that accepts a
  buffer.

Scoped to the ``hot-paths`` modules from ``[tool.ldt-check]`` (decode, the
pipelines, the worker/buffer planes, both halves of the service wire):
everywhere else a pylist is a perfectly fine debugging tool. Grandfathered
sites (deliberate fallbacks, tiny control-frame copies) live in the
baseline — new ones fail the gate.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

_MATERIALIZERS = {"to_pylist", "to_pybytes"}


@register
class CopyHygiene(Rule):
    id = "LDT701"
    family = "copies"
    name = "copy-hygiene"
    description = (
        "hot-path modules: no .to_pylist()/.to_pybytes() on Arrow columns "
        "and no bytes(...) materialisation of buffer slices — the zero-copy "
        "plane exists to avoid exactly these"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        hot_paths = getattr(config, "hot_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in hot_paths):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _MATERIALIZERS
            ):
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f".{node.func.attr}() on a hot path materialises every "
                    "row as Python objects — feed the Arrow buffers to the "
                    "consumer directly (native decoder / numpy view), or "
                    "grandfather a deliberate fallback in the baseline",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id == "bytes"
                and len(node.args) == 1
                and not node.keywords
                and isinstance(node.args[0], (ast.Subscript, ast.Call))
            ):
                # bytes(view[a:b]) / bytes(f(...)): a full copy of a buffer
                # that was already addressable as a memoryview. bytes(name)
                # and bytes(<int>) stay legal — too many legitimate uses.
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    "bytes(...) over a subscript/call result copies a "
                    "buffer that is already addressable — pass the "
                    "memoryview through (or baseline a deliberate "
                    "small-control-frame copy)",
                )
