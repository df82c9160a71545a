"""Determinism rules (LDT001-LDT003).

The epoch ``Plan`` must be a pure function of (dataset, sampler, batch,
shard, seed, epoch): every process builds all shards' plans and asserts
equal step counts, and the disaggregated service rebuilds the same plan from
the client's handshake. Any global-state randomness, wall-clock seeding, or
filesystem-order dependence in that path breaks bit-identical resume,
cross-process agreement, and A/B benchmarks — silently.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

# Global-state RNG entry points. Seeded `default_rng(seed)` / `Generator`
# methods are the sanctioned API and never match these.
_NP_GLOBAL = {
    "seed", "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "standard_normal", "bytes",
}
_STDLIB_RANDOM = {
    "seed", "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "getrandbits", "randbytes",
}

_CLOCKS = {
    "time.time", "time.time_ns", "datetime.datetime.now",
    "datetime.datetime.utcnow", "datetime.date.today",
}

_PLANNY = ("seed", "plan", "shuffle", "permut", "sampler")

_LISTING = {"os.listdir", "glob.glob", "glob.iglob", "os.scandir"}
_LISTING_METHODS = {"glob", "iglob", "iterdir", "rglob"}  # pathlib-style


@register
class UnseededGlobalRng(Rule):
    id = "LDT001"
    family = "determinism"
    name = "unseeded-global-rng"
    description = (
        "np.random.* / random.* global-state call — plan and shuffle "
        "randomness must come from a seeded np.random.default_rng(...)"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            if qn is None:
                continue
            bad = (
                (qn.startswith("numpy.random.")
                 and qn.rsplit(".", 1)[1] in _NP_GLOBAL)
                or (qn.startswith("random.")
                    and qn.count(".") == 1
                    and qn.rsplit(".", 1)[1] in _STDLIB_RANDOM)
            )
            if bad:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"global-state RNG call {qn}(); use a seeded "
                    "np.random.default_rng(seed) so plans/shuffles are "
                    "reproducible across processes and resumes",
                )


@register
class WallClockSeed(Rule):
    id = "LDT002"
    family = "determinism"
    name = "wall-clock-seed"
    description = (
        "time.time()/datetime.now() feeding seed/plan/shuffle construction "
        "— wall-clock seeds diverge across processes and resumes"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            if qn not in _CLOCKS:
                continue
            sink = self._plan_sink(module, node)
            if sink:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"{qn}() flows into {sink} — wall-clock values are "
                    "different on every process and every resume; derive "
                    "seeds from config.seed instead",
                )

    @staticmethod
    def _plan_sink(module: ModuleInfo, node: ast.AST):
        """Does this clock call feed plan/seed/shuffle construction?
        Detected via the enclosing statement: an assignment to a *seed*-named
        target, or an argument position of a *seed/plan/shuffle*-named call
        or keyword."""
        cur = node
        parent = module.parents.get(cur)
        while parent is not None and not isinstance(parent, ast.stmt):
            if isinstance(parent, ast.keyword) and parent.arg:
                if any(p in parent.arg.lower() for p in _PLANNY):
                    return f"keyword {parent.arg}="
            if isinstance(parent, ast.Call) and parent is not cur:
                qn = module.qualname(parent.func) or ""
                leaf = qn.rsplit(".", 1)[-1].lower()
                if any(p in leaf for p in _PLANNY):
                    return f"{qn}()"
            cur = parent
            parent = module.parents.get(cur)
        if isinstance(parent, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (
                parent.targets if isinstance(parent, ast.Assign)
                else [parent.target]
            )
            for t in targets:
                name = t.id if isinstance(t, ast.Name) else (
                    t.attr if isinstance(t, ast.Attribute) else ""
                )
                if any(p in name.lower() for p in _PLANNY):
                    return f"assignment to {name!r}"
        return None


@register
class UnsortedListing(Rule):
    id = "LDT003"
    family = "determinism"
    name = "unsorted-fs-listing"
    description = (
        "os.listdir/glob results used without sorted() — filesystem order "
        "is platform- and mount-dependent, so sample lists built from it "
        "differ across hosts"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            is_listing = qn in _LISTING or (
                qn is None
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _LISTING_METHODS
            )
            if not is_listing:
                continue
            if self._ordered_or_orderless(module, node):
                continue
            what = qn or f".{node.func.attr}"  # type: ignore[union-attr]
            yield Finding(
                self.id, module.relpath, node.lineno, node.col_offset,
                f"{what}() result used without sorted() — directory order "
                "is nondeterministic across hosts/filesystems; wrap in "
                "sorted(...) before building sample lists",
            )

    @staticmethod
    def _ordered_or_orderless(module: ModuleInfo, node: ast.Call) -> bool:
        """True when the listing is sorted in-expression, explicitly sorted
        later, or used where order cannot matter (membership test, len)."""
        cur: ast.AST = node
        parent = module.parents.get(cur)
        assigned_to = None
        while parent is not None and not isinstance(parent, ast.stmt):
            if isinstance(parent, ast.Call):
                pq = module.qualname(parent.func) or ""
                if pq.rsplit(".", 1)[-1] in ("sorted", "len", "set",
                                             "frozenset", "Counter"):
                    return True
            if isinstance(parent, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn)) for op in parent.ops
            ):
                return True
            cur = parent
            parent = module.parents.get(cur)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            t = parent.targets[0]
            if isinstance(t, ast.Name):
                assigned_to = t.id
        if assigned_to:
            func = module.enclosing(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)
            )
            scope = func if func is not None else module.tree
            for n in ast.walk(scope):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "sort"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == assigned_to
                ):
                    return True
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id == "sorted"
                    and n.args
                    and isinstance(n.args[0], ast.Name)
                    and n.args[0].id == assigned_to
                ):
                    return True
        return False
