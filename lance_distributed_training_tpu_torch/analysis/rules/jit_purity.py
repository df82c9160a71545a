"""Jit-purity rules (LDT101, LDT102).

A ``jax.jit``-compiled step function runs its Python body once per compile,
not once per step: ``print``/logging/wandb calls inside fire at trace time
(or worse, per-step via callbacks the author didn't intend), and host syncs
(``.item()``, ``jax.device_get``, ``np.asarray`` on traced values, casting a
traced argument with ``float()``/``int()``) either fail at trace time or —
when they survive — serialize the device stream against the host in the hot
loop, which is exactly the stall class the StepTimer exists to keep under 2%.
Telemetry belongs outside the jitted function, on fetched outputs.

In the PyTorch port these rules are copied unchanged and stay inert on the
port's own code: the port has no traced bodies (no ``jax.jit`` and no
``torch.compile``), so every Python line runs on every step and its host
syncs are LDT1714's domain. They are kept so that the port's checker gives
JAX's findings on JAX code.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..core import Finding, ModuleInfo, Rule, register

_JIT_NAMES = {"jax.jit", "jit", "jax.pmap", "pmap"}
_LOG_ROOTS = {"logging", "wandb"}
_LOGGERY = {"logger", "log", "_logger", "_log"}
# A logger-named variable only counts with a logging verb: `log.sum()` on a
# local named `log` (e.g. log = jnp.log(p)) is math, not telemetry.
_LOG_VERBS = {"debug", "info", "warning", "warn", "error", "exception",
              "critical", "log"}
_HOST_SYNC_CALLS = {
    "jax.device_get", "numpy.asarray", "numpy.array", "numpy.copy",
}
_CLOCKS = {"time.time", "time.perf_counter", "time.monotonic",
           "time.time_ns"}


def _is_jit_expr(module: ModuleInfo, node: ast.AST) -> bool:
    """Is ``node`` (a decorator or a call's func) a jit wrapper? Covers
    ``jax.jit``, ``@partial(jax.jit, ...)`` and ``jax.jit(...)`` calls."""
    qn = module.qualname(node)
    if qn in _JIT_NAMES:
        return True
    if isinstance(node, ast.Call):
        fq = module.qualname(node.func)
        if fq in _JIT_NAMES:
            return True
        if fq in ("functools.partial", "partial") and node.args:
            return module.qualname(node.args[0]) in _JIT_NAMES
    return False


def _jitted_functions(module: ModuleInfo) -> List[ast.AST]:
    """FunctionDefs/Lambdas that end up inside jax.jit:

    * decorated: ``@jax.jit`` / ``@partial(jax.jit, ...)``;
    * wrapped by name: ``jax.jit(step, ...)`` marks the ``def step`` in the
      same module (nearest definition by name);
    * wrapped inline: ``jax.jit(lambda ...: ...)``.
    """
    by_name = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    out: List[ast.AST] = []
    seen: Set[int] = set()

    def add(fn: ast.AST) -> None:
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append(fn)

    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_jit_expr(module, dec):
                    add(node)
        elif isinstance(node, ast.Call) and _is_jit_expr(module, node.func):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Lambda):
                    add(arg)
                elif isinstance(arg, ast.Name):
                    for fn in by_name.get(arg.id, []):
                        add(fn)
    return out


def _params_of(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return set(names)


@register
class JitSideEffect(Rule):
    id = "LDT101"
    family = "jit-purity"
    name = "jit-side-effect"
    description = (
        "print/logging/wandb/clock call inside a jax.jit-compiled function "
        "— side effects fire at trace time, not per step"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for fn in _jitted_functions(module):
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    qn = module.qualname(node.func) or ""
                    root = qn.split(".", 1)[0]
                    leaf = qn.rsplit(".", 1)[-1]
                    offender = None
                    if qn == "print":
                        offender = "print()"
                    elif "." in qn and (
                        root in _LOG_ROOTS
                        or (root in _LOGGERY and leaf in _LOG_VERBS)
                    ):
                        offender = f"{qn}()"
                    elif qn in _CLOCKS:
                        offender = f"{qn}()"
                    if offender:
                        yield Finding(
                            self.id, module.relpath,
                            node.lineno, node.col_offset,
                            f"{offender} inside a jit-compiled function "
                            "runs at trace time, not per step — move "
                            "telemetry outside the jitted step (or use "
                            "jax.debug.print deliberately)",
                        )


@register
class JitHostSync(Rule):
    id = "LDT102"
    family = "jit-purity"
    name = "jit-host-sync"
    description = (
        ".item()/jax.device_get/np.asarray/float() on traced values inside "
        "jax.jit — host syncs in the compiled hot path"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for fn in _jitted_functions(module):
            params = _params_of(fn)
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    offender = None
                    qn = module.qualname(node.func) or ""
                    if (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "item"
                        and not node.args
                    ):
                        offender = ".item()"
                    elif qn in _HOST_SYNC_CALLS:
                        offender = f"{qn}()"
                    elif (
                        qn in ("float", "int", "bool")
                        and len(node.args) == 1
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in params
                    ):
                        # Casting a traced ARGUMENT is a definite host sync;
                        # float(config.lr)-style casts of static values are
                        # fine, so only parameter names are flagged.
                        offender = f"{qn}({node.args[0].id})"
                    if offender:
                        yield Finding(
                            self.id, module.relpath,
                            node.lineno, node.col_offset,
                            f"{offender} inside a jit-compiled function "
                            "forces a device→host sync (or a trace error); "
                            "return the value and convert it outside the "
                            "step",
                        )
