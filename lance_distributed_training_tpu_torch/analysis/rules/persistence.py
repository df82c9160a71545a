"""Crash-consistency rule (LDT901).

A state-persisting module (checkpoint cursors, lint baselines — anything a
*restart reads and trusts*) must never write its file in place: a SIGKILL
between ``open(path, "w")`` and the final flush leaves a torn document that
the next boot parses, half-applies, or dies on. The sanctioned pattern is
write-to-temp + ``os.replace`` (atomic on POSIX within a filesystem), as
``utils/checkpoint.py:atomic_write_json`` implements.

The rule flags truncating writes (``open(..., "w"/"wb"/"w+")`` and
``Path.write_text/write_bytes``) in modules matched by the ``state-paths``
config whose *enclosing function* never calls ``os.replace``/``os.rename``
— presence of the rename in the same function is taken as the tempfile
pattern (the temp file itself is then the thing being opened). Append-mode
opens are exempt: append-only JSONL logs lose at most the in-flight line,
which is a different durability contract than a document a restart trusts
wholesale.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

_RENAMES = {"os.replace", "os.rename"}
_PATH_WRITERS = {"write_text", "write_bytes"}


def _write_mode(node: ast.Call) -> str:
    """The mode string of an ``open()`` call, '' when absent/dynamic."""
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"  # open() default
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return ""  # dynamic mode: give the benefit of the doubt


@register
class NonAtomicStateWrite(Rule):
    id = "LDT901"
    family = "persistence"
    name = "non-atomic-state-write"
    description = (
        "truncating file write in a state-persisting module without "
        "tempfile + os.replace — a crash mid-write leaves a torn file the "
        "restart then trusts"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        state_paths = getattr(config, "state_paths", [])
        if not any(
            fnmatch.fnmatch(module.relpath, pat) for pat in state_paths
        ):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            what = None
            qn = module.qualname(node.func)
            if qn in ("open", "builtins.open") or (
                isinstance(node.func, ast.Name) and node.func.id == "open"
            ):
                mode = _write_mode(node)
                if mode.startswith(("w", "x")):
                    what = f"open(..., {mode!r})"
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _PATH_WRITERS
            ):
                what = f".{node.func.attr}(...)"
            if what is None:
                continue
            if self._atomic_in_scope(module, node):
                continue
            yield Finding(
                self.id, module.relpath, node.lineno, node.col_offset,
                f"{what} persists state in place — a crash mid-write "
                "leaves a torn file the restart trusts; write to a "
                "tempfile and os.replace() it into place "
                "(utils/checkpoint.py:atomic_write_json)",
            )

    @staticmethod
    def _atomic_in_scope(module: ModuleInfo, node: ast.AST) -> bool:
        """True when the enclosing function (or module, for top-level
        writes) also calls os.replace/os.rename — the write is then the
        tempfile half of the atomic pattern."""
        scope = module.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        )
        if scope is None:
            scope = module.tree
        for n in ast.walk(scope):
            if isinstance(n, ast.Call):
                qn = module.qualname(n.func)
                if qn in _RENAMES:
                    return True
        return False
