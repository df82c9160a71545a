"""Resource-leak rule (LDT301).

Leaked file handles and sockets are the slow killers of long training runs:
a service host accepting thousands of connections or a logger re-opened per
epoch eventually hits EMFILE mid-run. The rule demands that every acquired
handle has a *visible* ownership story, not a perfect escape analysis:

acquisitions (``open``, ``os.fdopen``, ``socket.socket``,
``socket.create_connection``, ``tarfile.open``, ``gzip.open``) are fine when

* used as a ``with`` context manager;
* returned (ownership transfers to the caller);
* passed whole into another call (ownership transfers to the callee, e.g. a
  session object or ``weakref.finalize``);
* a local that is ``.close()``/``.shutdown()``-ed somewhere in the same
  function;
* stored on ``self`` of a class that defines ``close``/``shutdown``/
  ``stop``/``__exit__``/``__del__`` — the instance owns it and has a
  teardown surface callers can reach.

Anything else — most importantly a bare-expression acquisition or a
``self.x = open(...)`` in a class with no teardown method — is flagged.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from ..core import Finding, ModuleInfo, Rule, register

_ACQUIRE = {
    "open", "io.open", "os.fdopen", "tarfile.open", "gzip.open",
    "socket.socket", "socket.create_connection",
}
_CLOSE_METHODS = {"close", "shutdown", "stop", "__exit__", "__del__"}


@register
class UnclosedResource(Rule):
    id = "LDT301"
    family = "resources"
    name = "unclosed-resource"
    description = (
        "open()/socket result without a visible ownership story (with / "
        "close in function / returned / stored on a class with teardown)"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if module.qualname(node.func) not in _ACQUIRE:
                continue
            problem = self._ownership_gap(module, node)
            if problem:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    problem,
                )

    def _ownership_gap(self, module: ModuleInfo, node: ast.Call):
        qn = module.qualname(node.func)
        # Inside a `with` item (directly or under an enclosing expression
        # like io.TextIOWrapper(open(...)))?
        cur: ast.AST = node
        parent = module.parents.get(cur)
        while parent is not None and not isinstance(parent, ast.stmt):
            if isinstance(parent, ast.withitem):
                return None
            if isinstance(parent, ast.Call) and parent is not node:
                return None  # wrapped/passed into another call: transferred
            cur = parent
            parent = module.parents.get(cur)
        # The climb above already handled `with` items (withitem parent) and
        # call-wrapping; `yield open(...)` falls through to the final
        # return None (an Expr statement whose value is the Yield, not the
        # acquisition itself).
        stmt = parent
        if isinstance(stmt, ast.Return):
            return None
        func = module.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef)
        )
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target = stmt.targets[0]
            if isinstance(target, ast.Name):
                return self._check_local(module, node, func, target.id, qn)
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                return self._check_self_attr(module, node, qn)
            return None  # tuple targets etc.: out of scope
        if isinstance(stmt, ast.Expr) and stmt.value is node:
            return (
                f"{qn}() result discarded — the handle leaks immediately; "
                "use a with block or keep and close it"
            )
        return None

    def _check_local(self, module, node, func, name, qn):
        scope = func if func is not None else module.tree
        transferred = False
        for n in ast.walk(scope):
            if isinstance(n, ast.Call):
                attr = (
                    n.func.attr if isinstance(n.func, ast.Attribute) else None
                )
                owner = (
                    n.func.value
                    if isinstance(n.func, ast.Attribute)
                    else None
                )
                if (
                    attr in ("close", "shutdown")
                    and isinstance(owner, ast.Name)
                    and owner.id == name
                ):
                    return None
                # Passed whole as an argument: ownership transferred.
                if any(
                    isinstance(a, ast.Name) and a.id == name for a in n.args
                ):
                    transferred = True
            if isinstance(n, ast.Return) and (
                isinstance(n.value, ast.Name) and n.value.id == name
                or isinstance(n.value, ast.Tuple)
                and any(
                    isinstance(e, ast.Name) and e.id == name
                    for e in n.value.elts
                )
            ):
                return None
            # Re-assigned onto self: the self-attr rules take over.
            if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and isinstance(n.value, ast.Name)
                and n.value.id == name
                for t in n.targets
            ):
                return self._check_self_attr(module, node, qn)
            if isinstance(n, ast.withitem) and (
                isinstance(n.context_expr, ast.Name)
                and n.context_expr.id == name
            ):
                return None
        if transferred:
            return None
        return (
            f"{qn}() assigned to {name!r} but never closed in this function "
            "(no close/shutdown, not returned, not handed off) — wrap in "
            "with, or close in a finally"
        )

    def _check_self_attr(self, module, node, qn):
        cls = module.enclosing(node, ast.ClassDef)
        if cls is None:
            return None  # self outside a class body: can't reason
        methods = {
            n.name
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if methods & _CLOSE_METHODS:
            return None
        return (
            f"{qn}() stored on self in class {cls.name!r}, which defines "
            f"none of {sorted(_CLOSE_METHODS)} — the handle outlives every "
            "scope with no teardown surface; add close() (and ideally "
            "__enter__/__exit__) and call it from shutdown"
        )
