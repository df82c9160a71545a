"""Concurrency-hygiene rules (LDT201-LDT203).

The loader/service stack is a web of producer threads and bounded queues
whose shutdown discipline (daemon flag + drain-then-join) and backpressure
contract (every queue bounded) were learned the hard way. These
rules keep the discipline structural:

* LDT201 — every ``threading.Thread(...)`` must state its lifecycle: either
  an explicit ``daemon=`` (this repo's policy is daemon=True + the
  drain-join pattern, see ``data/pipeline.py``) or a tracked ``.join()``.
* LDT202 — ``queue.Queue()`` with no ``maxsize`` in the streaming paths is
  an unbounded buffer: one slow consumer absorbs the whole epoch in RAM.
* LDT203 — a handshake ``recv`` with no prior ``settimeout`` pins a handler
  thread forever when a peer connects and goes silent.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable, Optional

from ..core import Finding, ModuleInfo, Rule, register

_QUEUE_CTORS = {
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "multiprocessing.Queue", "multiprocessing.JoinableQueue",
}
_RECV_NAMES = {"recv", "recv_into", "recvfrom", "recv_msg", "recv_frame"}
_HELLO_MARKERS = ("HELLO", "handshake")


@register
class ThreadLifecycle(Rule):
    id = "LDT201"
    family = "concurrency"
    name = "thread-lifecycle"
    description = (
        "threading.Thread without an explicit daemon= and without a "
        "tracked .join() — its shutdown story is undefined"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if module.qualname(node.func) != "threading.Thread":
                continue
            if any(kw.arg == "daemon" for kw in node.keywords):
                continue
            target = self._assign_target(module, node)
            if target is not None and self._joined(module, node, target):
                continue
            yield Finding(
                self.id, module.relpath, node.lineno, node.col_offset,
                "threading.Thread(...) without daemon= or a .join() path — "
                "state the lifecycle: daemon=True + drain-join on teardown "
                "(this repo's policy), or keep a handle and join it",
            )

    @staticmethod
    def _assign_target(module: ModuleInfo, node: ast.Call) -> Optional[str]:
        """Name (or self-attribute name) the Thread is bound to, if simple."""
        stmt = module.statement_of(node)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            t = stmt.targets[0]
            if isinstance(t, ast.Name):
                return t.id
            if isinstance(t, ast.Attribute):
                return t.attr
        return None

    @staticmethod
    def _joined(module: ModuleInfo, node: ast.Call, target: str) -> bool:
        scope = module.enclosing(
            node, (ast.ClassDef, ast.Module)
        ) or module.tree
        for n in ast.walk(scope):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
            ):
                owner = n.func.value
                name = owner.id if isinstance(owner, ast.Name) else (
                    owner.attr if isinstance(owner, ast.Attribute) else None
                )
                if name == target:
                    return True
        return False


@register
class UnboundedQueue(Rule):
    id = "LDT202"
    family = "concurrency"
    name = "unbounded-queue"
    description = (
        "queue.Queue() without maxsize on a streaming path — voids the "
        "backpressure contract (one slow consumer buffers the whole epoch)"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        patterns = getattr(config, "queue_paths", [])
        if patterns and not any(
            fnmatch.fnmatch(module.relpath, p) for p in patterns
        ):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if module.qualname(node.func) not in _QUEUE_CTORS:
                continue
            if self._bounded(node):
                continue
            yield Finding(
                self.id, module.relpath, node.lineno, node.col_offset,
                "unbounded queue on a streaming path (stdlib semantics: "
                "maxsize<=0 means infinite) — pass maxsize>=1 so "
                "backpressure reaches the producer instead of buffering "
                "the epoch in RAM",
            )

    @staticmethod
    def _bounded(node: ast.Call) -> bool:
        """A queue is bounded only when maxsize is present AND not a
        literal <= 0 — ``Queue(0)`` / ``Queue(maxsize=0)`` are the stdlib
        spelling of *infinite*, the exact thing this rule exists to catch.
        Non-literal maxsize expressions get the benefit of the doubt."""
        maxsize = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "maxsize"), None
        )
        if maxsize is None:
            return False
        if isinstance(maxsize, ast.Constant) and isinstance(
            maxsize.value, (int, float)
        ):
            return maxsize.value > 0
        if isinstance(maxsize, ast.UnaryOp) and isinstance(
            maxsize.op, ast.USub
        ):
            return False  # any negative literal is unbounded too
        return True


@register
class HandshakeRecvTimeout(Rule):
    id = "LDT203"
    family = "concurrency"
    name = "handshake-recv-timeout"
    description = (
        "blocking recv on a handshake path with no prior settimeout — a "
        "peer that connects and goes silent pins the handler forever"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not self._is_handshake(module, fn):
                continue
            first_recv: Optional[ast.Call] = None
            first_timeout_line: Optional[int] = None
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else (node.func.id if isinstance(node.func, ast.Name)
                          else None)
                )
                qn = module.qualname(node.func) or ""
                leaf = qn.rsplit(".", 1)[-1]
                if (attr in _RECV_NAMES or leaf in _RECV_NAMES) and (
                    first_recv is None or node.lineno < first_recv.lineno
                ):
                    first_recv = node
                if attr == "settimeout" and (
                    first_timeout_line is None
                    or node.lineno < first_timeout_line
                ):
                    first_timeout_line = node.lineno
            if first_recv is None:
                continue
            if self._deadline_bounded(first_recv):
                # recv_msg(sock, deadline=...) bounds the WHOLE frame read
                # (protocol._recv_exact) — strictly stronger than a socket
                # settimeout, which resets per received byte.
                continue
            if (
                first_timeout_line is None
                or first_timeout_line > first_recv.lineno
            ):
                yield Finding(
                    self.id, module.relpath,
                    first_recv.lineno, first_recv.col_offset,
                    f"handshake function {fn.name!r} blocks in recv with no "
                    "prior settimeout — a connected-but-silent peer pins "
                    "this thread forever; set a handshake deadline, then "
                    "clear it for the streaming phase",
                )

    @staticmethod
    def _deadline_bounded(recv: ast.Call) -> bool:
        for kw in recv.keywords:
            if kw.arg == "deadline" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value is None
            ):
                return True
        return False

    @staticmethod
    def _is_handshake(module: ModuleInfo, fn: ast.AST) -> bool:
        """A function is handshake-shaped when its name or body mentions the
        HELLO frame / 'handshake'. Narrow on purpose: steady-state stream
        receive loops have different deadline semantics (a slow decode is
        not a dead peer) and must not be forced onto a timeout."""
        if any(m.lower() in fn.name.lower() for m in _HELLO_MARKERS):
            return True
        for node in ast.walk(fn):
            name = None
            if isinstance(node, ast.Attribute):
                name = node.attr
            elif isinstance(node, ast.Name):
                name = node.id
            if name and any(m in name for m in _HELLO_MARKERS):
                return True
        return False
