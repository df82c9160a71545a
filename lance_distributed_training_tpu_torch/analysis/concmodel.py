"""Whole-program concurrency model (the LDT1001-1003 engine).

The per-module rules in :mod:`.rules` see one :class:`~.core.ModuleInfo` at
a time, which is exactly the wrong granularity for the bug classes a
distributed data plane actually deadlocks on: the lock acquired in
``fleet/coordinator.py`` and the lock acquired in ``obs/registry.py`` only
form a cycle *together*, and the attribute written by a thread spawned in
``service/server.py`` is read by a thread spawned in ``obs/http.py``. This
module parses nothing itself — it consumes the already-parsed module list
one ``ldt check`` run produced — and derives, in one pass:

* a **function table** (:class:`FunctionInfo` keyed by dotted qualname,
  nested ``def``\\ s included) with resolved call edges (``self.m()``,
  local/imported names, attribute calls through annotated or
  constructor-assigned attributes, class instantiation → ``__init__``);
* the **thread model**: every ``threading.Thread(target=...)`` spawn site,
  its resolved target, and the set of spawn roots each function is
  reachable from (``roots``; empty = only ever on the caller's thread);
* the **lock model**: every lock object (``self._lock =
  threading.Lock()`` attributes, module-level locks) with its creation
  site(s), every ``with <lock>`` acquisition, the lock-order edge set
  (lock A held while lock B is acquired — directly nested or through a
  resolved call chain), and the always-held-at-entry set per function
  (the ``_locked``-suffix convention, computed instead of trusted:
  the intersection of locks held at every resolved call site);
* the **shared-state model**: per ``(class, attribute)``, every
  ``self.attr`` read/write with the thread roots and held locks at that
  statement — ``__init__`` bodies and pre-spawn publication in a spawning
  function excluded (both are happens-before the thread exists).

Everything here is stdlib-only (``ast``) — like :mod:`.core`, the gate must
run even when the training package itself fails to import. The model is
deliberately conservative where resolution fails: an unresolvable call
contributes no edges (no false cycles from guesses), an unresolvable
``target=`` spawns no root. The runtime witness (``utils/lockorder.py`` +
``ldt check --lock-witness``) closes the other half: statically-inferred
edges that never happen get pruned by evidence, real ones get a trace.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import ModuleInfo

__all__ = [
    "ProgramInfo",
    "FunctionInfo",
    "ClassInfo",
    "LockInfo",
    "AttrAccess",
    "LockOrderEdge",
    "build_program",
]

# Constructors whose instances are internally synchronized (or immutable
# handles) — a shared attribute holding one of these is a sanctioned
# cross-thread handoff, not a data race. Matched as a suffix of the
# import-resolved constructor qualname; extended via config
# ``threadsafe-types``.
DEFAULT_THREADSAFE_TYPES = (
    "threading.Event",
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "threading.Barrier",
    "threading.Thread",
    "threading.local",
    "queue.Queue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
    "queue.SimpleQueue",
    "multiprocessing.Queue",
    "collections.deque",
    # This repo's internally-locked telemetry objects.
    "ServiceCounters",
    "MetricsRegistry",
    "StepTimer",
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}


@dataclasses.dataclass(frozen=True)
class LockInfo:
    """One lock identity: a ``self.<attr>`` lock of a class, or a
    module-level lock. ``key`` is the stable id the graphs use; ``sites``
    are the ``path:line`` creation points (the join key the runtime
    witness maps back onto)."""

    key: str  # "pkg.mod.Class._lock" or "pkg.mod._LOCK"
    reentrant: bool
    sites: Tuple[str, ...]  # ("pkg/mod.py:107", ...)


@dataclasses.dataclass
class AttrAccess:
    """One ``self.<attr>`` read or write."""

    attr: str
    write: bool
    module: str  # relpath
    line: int
    col: int
    func: str  # FunctionInfo key
    locks: Set[str] = dataclasses.field(default_factory=set)
    # True when the access is a bare load that is immediately called
    # (``self.q.put(...)``) — a delegation, not a value read. Only used to
    # refine messages; the race logic treats it as a read.
    call_through: bool = False


@dataclasses.dataclass(frozen=True)
class LockOrderEdge:
    """Lock ``src`` held while lock ``dst`` is acquired."""

    src: str
    dst: str
    module: str
    line: int
    col: int
    via: str  # "nested with" or "call chain f -> g"


@dataclasses.dataclass
class FunctionInfo:
    key: str  # dotted qualname, nested defs as parent.<name>
    module: str  # relpath
    node: ast.AST
    owner: Optional[str] = None  # owning class key, when it takes self
    calls: List[tuple] = dataclasses.field(default_factory=list)
    # [(callee_key, call_node, frozenset(held_lock_keys))]
    acquires: List[tuple] = dataclasses.field(default_factory=list)
    # [(lock_key, with_node)]
    spawns: List[tuple] = dataclasses.field(default_factory=list)
    # [(target_key_or_None, call_node)]
    accesses: List[AttrAccess] = dataclasses.field(default_factory=list)
    # Computed by the fixpoints:
    roots: Set[str] = dataclasses.field(default_factory=set)
    held_at_entry: Set[str] = dataclasses.field(default_factory=set)
    acquires_transitive: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class ClassInfo:
    key: str  # dotted qualname
    module: str
    node: ast.ClassDef
    lock_attrs: Dict[str, LockInfo] = dataclasses.field(default_factory=dict)
    # attr -> resolved constructor qualnames assigned to it (for the
    # threadsafe-type exemption) — only simple `self.x = Ctor(...)` forms.
    attr_ctors: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    # attr -> class keys (resolved), for attribute-call resolution.
    attr_types: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)


class ProgramInfo:
    """The cross-module model. Build with :func:`build_program` (cached per
    ``ldt check`` run by :func:`.core.analyze_project`)."""

    def __init__(self, modules: Sequence[ModuleInfo], config):
        self.modules = [m for m in modules if m.tree is not None]
        self.by_relpath = {m.relpath: m for m in self.modules}
        self.threadsafe_types = tuple(
            getattr(config, "threadsafe_types", None)
            or DEFAULT_THREADSAFE_TYPES
        )
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.locks: Dict[str, LockInfo] = {}
        self.lock_edges: List[LockOrderEdge] = []
        self.spawn_sites: List[tuple] = []  # (target_key, module, node)
        self._class_by_bare: Dict[str, List[str]] = {}
        self._collect()
        self._resolve_bodies()
        self._fixpoint_roots()
        self._fixpoint_held()
        self._fixpoint_acquires()
        self._collect_lock_edges()
        self._finalize_access_locks()

    # -- pass 1: declarations ------------------------------------------------

    def _collect(self) -> None:
        """Walk every module once: register classes, functions (nested defs
        included), lock attributes / module-level locks, and attribute
        constructor/annotation types."""
        for mod in self.modules:
            dotted = mod.dotted_name
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._collect_class(mod, dotted, node)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._collect_function(mod, f"{dotted}.{node.name}",
                                           node, owner=None)
                elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                    # Module-level lock: `_LOCK = threading.Lock()`.
                    t, v = node.targets[0], node.value
                    if isinstance(t, ast.Name) and isinstance(v, ast.Call):
                        qn = mod.qualname(v.func)
                        if qn in _LOCK_CTORS:
                            key = f"{dotted}.{t.id}"
                            self.locks[key] = LockInfo(
                                key=key,
                                reentrant=qn.endswith("RLock"),
                                sites=(f"{mod.relpath}:{node.lineno}",),
                            )

    def _collect_class(self, mod: ModuleInfo, dotted: str,
                       node: ast.ClassDef) -> None:
        ckey = f"{dotted}.{node.name}"
        cls = ClassInfo(key=ckey, module=mod.relpath, node=node)
        self.classes[ckey] = cls
        self._class_by_bare.setdefault(node.name, []).append(ckey)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._collect_function(
                    mod, f"{ckey}.{item.name}", item, owner=ckey
                )
        # Lock attributes + attribute types, from every method body (locks
        # are conventionally created in __init__, but start() patterns
        # exist too).
        for item in ast.walk(node):
            if not (isinstance(item, ast.Assign) and len(item.targets) == 1):
                continue
            t, v = item.targets[0], item.value
            if not (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                continue
            if isinstance(v, ast.IfExp):
                # `self.x = arg if arg is not None else default()` — the
                # guard-or-default idiom; either branch types the attr.
                for branch in (v.body, v.orelse):
                    if isinstance(branch, ast.Call):
                        qn = mod.qualname(branch.func)
                        if qn and qn not in _LOCK_CTORS:
                            cls.attr_ctors.setdefault(t.attr, set()).add(qn)
            if isinstance(v, ast.Call):
                qn = mod.qualname(v.func)
                if qn in _LOCK_CTORS:
                    site = f"{mod.relpath}:{item.lineno}"
                    key = f"{ckey}.{t.attr}"
                    prev = cls.lock_attrs.get(t.attr)
                    sites = (prev.sites if prev else ()) + (site,)
                    info = LockInfo(
                        key=key, reentrant=qn.endswith("RLock"), sites=sites
                    )
                    cls.lock_attrs[t.attr] = info
                    self.locks[key] = info
                elif qn:
                    cls.attr_ctors.setdefault(t.attr, set()).add(qn)
        # Constructor-parameter annotations: `def __init__(self, loader:
        # "FleetLoader")` + `self.loader = loader` gives the attr a type.
        init = next(
            (
                i for i in node.body
                if isinstance(i, ast.FunctionDef) and i.name == "__init__"
            ),
            None,
        )
        if init is not None:
            ann = {}
            for arg in list(init.args.args) + list(init.args.kwonlyargs):
                if arg.annotation is not None:
                    ann[arg.arg] = self._annotation_name(arg.annotation)
            for item in ast.walk(init):
                if not (
                    isinstance(item, ast.Assign)
                    and len(item.targets) == 1
                    and isinstance(item.targets[0], ast.Attribute)
                    and isinstance(item.targets[0].value, ast.Name)
                    and item.targets[0].value.id == "self"
                ):
                    continue
                value = item.value
                names = []
                if isinstance(value, ast.Name):
                    names.append(value.id)
                elif isinstance(value, ast.IfExp):
                    # `self.registry = registry if registry is not None
                    # else default_registry()` — the annotated param names
                    # the type either way.
                    for branch in (value.body, value.orelse):
                        if isinstance(branch, ast.Name):
                            names.append(branch.id)
                for name in names:
                    if name in ann and ann[name]:
                        cls.attr_ctors.setdefault(
                            item.targets[0].attr, set()
                        ).add(ann[name])

    @staticmethod
    def _annotation_name(node: ast.AST) -> Optional[str]:
        """Bare class name out of an annotation: ``Foo``, ``"Foo"``,
        ``Optional["Foo"]`` → ``Foo``."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value.strip().strip('"').split("[")[0].split(".")[-1]
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Subscript):  # Optional[X] / list[X]
            return ProgramInfo._annotation_name(node.slice)
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    def _collect_function(self, mod: ModuleInfo, key: str, node,
                          owner: Optional[str]) -> None:
        self.functions[key] = FunctionInfo(
            key=key, module=mod.relpath, node=node, owner=owner
        )
        # Nested defs: the placement plane's `produce`, pipeline closures.
        # They share the enclosing method's `self`, so they keep the owner.
        for item in node.body:
            for sub in ast.walk(item):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and self._is_direct_nested(node, sub):
                    self._collect_function(
                        mod, f"{key}.<locals>.{sub.name}", sub, owner=owner
                    )

    @staticmethod
    def _is_direct_nested(outer, candidate) -> bool:
        """True when ``candidate`` is nested in ``outer`` with no function
        boundary in between (deeper nesting registers from its own parent's
        _collect_function walk)."""
        for item in ast.walk(outer):
            if item is candidate:
                continue
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item is not outer:
                for sub in ast.walk(item):
                    if sub is candidate:
                        return False
        return True

    # -- pass 2: bodies ------------------------------------------------------

    def _resolve_bodies(self) -> None:
        for fn in list(self.functions.values()):
            self._resolve_body(fn)

    def _resolve_body(self, fn: FunctionInfo) -> None:
        mod = self.by_relpath[fn.module]
        cls = self.classes.get(fn.owner) if fn.owner else None
        # Local variable types from `name = ClassName(...)` in this body.
        local_types: Dict[str, str] = {}
        for node in self._walk_own(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
            ):
                ckey = self._resolve_class(mod, node.value.func)
                if ckey:
                    local_types[node.targets[0].id] = ckey
        held: List[str] = []
        self._visit_block(fn, mod, cls, local_types, fn.node.body, held)

    def _walk_own(self, node):
        """Walk a function body, NOT descending into nested defs (they are
        their own FunctionInfo)."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            cur = stack.pop()
            yield cur
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(cur))

    def _visit_block(self, fn, mod, cls, local_types, body, held) -> None:
        """Statement-ordered walk tracking the with-lock stack (``held``)."""
        for stmt in body:
            if isinstance(stmt, ast.With):
                # Items acquire LEFT TO RIGHT and each is held while the
                # next acquires — `with a, b:` is `with a: with b:` for
                # ordering purposes, so extend `held` per item, not after
                # the whole statement.
                acquired: List[str] = []
                for item in stmt.items:
                    self._visit_exprs_in(fn, mod, cls, local_types, [item],
                                         held)
                    lk = self._lock_ref(mod, cls, item.context_expr)
                    if lk is not None:
                        fn.acquires.append((lk, stmt))
                        acquired.append(lk)
                        held.append(lk)
                self._visit_block(fn, mod, cls, local_types, stmt.body, held)
                for _ in acquired:
                    held.pop()
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested def: analyzed as its own function
            elif isinstance(stmt, (ast.If, ast.While)):
                self._visit_exprs_in(fn, mod, cls, local_types, [stmt.test],
                                     held)
                self._visit_block(fn, mod, cls, local_types, stmt.body, held)
                self._visit_block(fn, mod, cls, local_types, stmt.orelse,
                                  held)
            elif isinstance(stmt, ast.For):
                self._visit_exprs_in(
                    fn, mod, cls, local_types, [stmt.target, stmt.iter], held
                )
                self._visit_block(fn, mod, cls, local_types, stmt.body, held)
                self._visit_block(fn, mod, cls, local_types, stmt.orelse,
                                  held)
            elif isinstance(stmt, ast.Try):
                self._visit_block(fn, mod, cls, local_types, stmt.body, held)
                for handler in stmt.handlers:
                    self._visit_block(fn, mod, cls, local_types,
                                      handler.body, held)
                self._visit_block(fn, mod, cls, local_types, stmt.orelse,
                                  held)
                self._visit_block(fn, mod, cls, local_types,
                                  stmt.finalbody, held)
            else:
                self._visit_exprs_in(fn, mod, cls, local_types, [stmt], held)

    def _visit_exprs_in(self, fn, mod, cls, local_types, nodes, held) -> None:
        snapshot = frozenset(held)
        for top in nodes:
            if top is None:
                continue
            stack = [top]
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Call):
                    self._record_call(fn, mod, cls, local_types, node,
                                      snapshot)
                elif isinstance(node, ast.Attribute):
                    self._record_attr(fn, mod, cls, node, snapshot)
                stack.extend(ast.iter_child_nodes(node))

    # -- reference resolution ------------------------------------------------

    def _resolve_class(self, mod: ModuleInfo, func_expr) -> Optional[str]:
        """Class key a call expression instantiates, or None."""
        qn = mod.qualname(func_expr)
        if qn is None:
            return None
        if qn in self.classes:
            return qn
        # `beta.Beta` resolved `beta` → pkg.beta, giving pkg.beta.Beta ✓;
        # `from .x import C` gives pkg.x.C directly ✓. Fall back to a
        # unique bare-name match (string annotations, re-exports).
        bare = qn.rsplit(".", 1)[-1]
        keys = self._class_by_bare.get(bare, [])
        if len(keys) == 1:
            return keys[0]
        return None

    def _class_by_name(self, name: Optional[str]) -> Optional[str]:
        if not name:
            return None
        keys = self._class_by_bare.get(name, [])
        return keys[0] if len(keys) == 1 else None

    def _lock_ref(self, mod, cls: Optional[ClassInfo], expr) -> Optional[str]:
        """Lock key a with-context expression names, or None."""
        # `with self._lock:`
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
            and expr.attr in cls.lock_attrs
        ):
            return cls.lock_attrs[expr.attr].key
        # `with _MODULE_LOCK:` (possibly imported).
        qn = mod.qualname(expr)
        if qn is not None:
            if qn in self.locks:
                return qn
            # Same-module bare name.
            candidate = f"{mod.dotted_name}.{qn}"
            if candidate in self.locks:
                return candidate
        # `with other.obj._lock:` — attribute chain whose base resolves to
        # a typed attr; only one level deep (`self.pool._lock`).
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Attribute)
            and isinstance(expr.value.value, ast.Name)
            and expr.value.value.id == "self"
            and cls is not None
        ):
            for tkey in self._attr_class_keys(cls, expr.value.attr):
                target = self.classes.get(tkey)
                if target and expr.attr in target.lock_attrs:
                    return target.lock_attrs[expr.attr].key
        return None

    def _attr_class_keys(self, cls: ClassInfo, attr: str) -> List[str]:
        """Program classes an attribute of ``cls`` may hold instances of."""
        out = []
        for qn in cls.attr_ctors.get(attr, ()):
            ckey = qn if qn in self.classes else self._class_by_name(
                qn.rsplit(".", 1)[-1]
            )
            if ckey:
                out.append(ckey)
        return out

    def _method_key(self, ckey: str, name: str) -> Optional[str]:
        key = f"{ckey}.{name}"
        return key if key in self.functions else None

    def _resolve_callee(self, fn, mod, cls, local_types,
                        func_expr) -> Optional[str]:
        """FunctionInfo key a call expression targets, or None."""
        # self.m(...)
        if (
            isinstance(func_expr, ast.Attribute)
            and isinstance(func_expr.value, ast.Name)
        ):
            base = func_expr.value.id
            if base == "self" and cls is not None:
                got = self._method_key(cls.key, func_expr.attr)
                if got:
                    return got
                # Through a typed attribute is handled below via qualname
                # failure; self.m unresolved ends here.
                return None
            # local var of known class: `session.run`
            if base in local_types:
                return self._method_key(local_types[base], func_expr.attr)
        # obj attr chain `self.loader._dial_member(...)`
        if (
            isinstance(func_expr, ast.Attribute)
            and isinstance(func_expr.value, ast.Attribute)
            and isinstance(func_expr.value.value, ast.Name)
            and func_expr.value.value.id == "self"
            and cls is not None
        ):
            for tkey in self._attr_class_keys(cls, func_expr.value.attr):
                got = self._method_key(tkey, func_expr.attr)
                if got:
                    return got
            return None
        qn = mod.qualname(func_expr)
        if qn is None:
            return None
        if qn in self.functions:
            return qn
        if qn in self.classes:  # instantiation
            return self._method_key(qn, "__init__") or None
        # Same-module bare name (module-level def or nested sibling).
        candidate = f"{mod.dotted_name}.{qn}"
        if candidate in self.functions:
            return candidate
        # Nested function referenced by bare name inside its parent.
        candidate = f"{fn.key}.<locals>.{qn}"
        if candidate in self.functions:
            return candidate
        ckey = self._resolve_class(mod, func_expr)
        if ckey:
            return self._method_key(ckey, "__init__")
        return None

    def _spawn_target(self, fn, mod, cls, local_types,
                      call: ast.Call) -> Optional[str]:
        for kw in call.keywords:
            if kw.arg == "target":
                return self._resolve_callee(fn, mod, cls, local_types,
                                            kw.value)
        return None

    # -- recorders -----------------------------------------------------------

    def _record_call(self, fn, mod, cls, local_types, node: ast.Call,
                     held: frozenset) -> None:
        qn = mod.qualname(node.func)
        if qn == "threading.Thread":
            target = self._spawn_target(fn, mod, cls, local_types, node)
            fn.spawns.append((target, node))
            self.spawn_sites.append((target, fn.module, node))
            return
        callee = self._resolve_callee(fn, mod, cls, local_types, node.func)
        if callee is not None:
            fn.calls.append((callee, node, held))

    def _record_attr(self, fn, mod, cls, node: ast.Attribute,
                     held: frozenset) -> None:
        if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            return
        if cls is None:
            return
        if node.attr in cls.lock_attrs:
            return  # lock handles are the synchronization, not the state
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        parent_is_call = False
        if not write:
            parent = mod.parents.get(node)
            parent_is_call = (
                isinstance(parent, ast.Call) and parent.func is node
            )
        fn.accesses.append(
            AttrAccess(
                attr=node.attr,
                write=write,
                module=fn.module,
                line=node.lineno,
                col=node.col_offset,
                func=fn.key,
                locks=set(held),
                call_through=parent_is_call,
            )
        )

    # -- fixpoints -----------------------------------------------------------

    def _callers(self) -> Dict[str, List[tuple]]:
        callers: Dict[str, List[tuple]] = {}
        for fn in self.functions.values():
            for callee, node, held in fn.calls:
                callers.setdefault(callee, []).append((fn.key, held))
        return callers

    def _fixpoint_roots(self) -> None:
        """roots(f) = spawn targets f is reachable from (BFS per target)."""
        for target, _module, _node in self.spawn_sites:
            if target is None or target not in self.functions:
                continue
            seen = {target}
            stack = [target]
            while stack:
                cur = stack.pop()
                self.functions[cur].roots.add(target)
                for callee, _n, _h in self.functions[cur].calls:
                    if callee not in seen and callee in self.functions:
                        seen.add(callee)
                        stack.append(callee)

    def _fixpoint_held(self) -> None:
        """held_at_entry(f) = ∩ over resolved call sites of (site-held ∪
        caller's own entry set). Functions with no resolved callers hold
        nothing at entry. Decreasing fixpoint from ⊤."""
        callers = self._callers()
        TOP = None  # lattice top: "unconstrained"
        state: Dict[str, Optional[frozenset]] = {
            k: (frozenset() if k not in callers else TOP)
            for k in self.functions
        }
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for key, fn in self.functions.items():
                sites = callers.get(key)
                if not sites:
                    continue
                acc: Optional[frozenset] = TOP
                for caller_key, held in sites:
                    caller_entry = state.get(caller_key)
                    site_set = frozenset(held) | (
                        caller_entry if caller_entry else frozenset()
                    )
                    acc = site_set if acc is TOP else (acc & site_set)
                if acc is TOP:
                    acc = frozenset()
                if state[key] != acc:
                    state[key] = acc
                    changed = True
        for key, fn in self.functions.items():
            entry = state.get(key)
            fn.held_at_entry = set(entry or ())

    def _fixpoint_acquires(self) -> None:
        """acquires_transitive(f) = direct with-locks ∪ callees'. Increasing
        fixpoint (cycles in the call graph converge)."""
        for fn in self.functions.values():
            fn.acquires_transitive = {lk for lk, _n in fn.acquires}
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for fn in self.functions.values():
                for callee, _n, _h in fn.calls:
                    sub = self.functions.get(callee)
                    if sub is None:
                        continue
                    before = len(fn.acquires_transitive)
                    fn.acquires_transitive |= sub.acquires_transitive
                    if len(fn.acquires_transitive) != before:
                        changed = True

    # -- lock-order edges ----------------------------------------------------

    def _collect_lock_edges(self) -> None:
        """Edge src→dst for every acquisition of dst while src is held:
        a directly nested ``with``, a resolved call (at any depth) that
        acquires dst, or an acquisition in a function entered with src
        already held (held_at_entry)."""
        seen: Set[tuple] = set()

        def add(src, dst, module, node, via):
            lk = self.locks.get(src)
            if src == dst and lk is not None and lk.reentrant:
                return  # RLock re-entry is legal
            key = (src, dst, module, node.lineno, via)
            if key in seen:
                return
            seen.add(key)
            self.lock_edges.append(
                LockOrderEdge(
                    src=src, dst=dst, module=module, line=node.lineno,
                    col=getattr(node, "col_offset", 0), via=via,
                )
            )

        for fn in self.functions.values():
            # Direct acquisitions with something already held at entry
            # (the computed `_locked`-convention coverage).
            for lk, node in fn.acquires:
                for held in fn.held_at_entry:
                    add(held, lk, fn.module, node,
                        f"acquired in {fn.key} (entered holding)")
            self._edges_in_function(fn, add)

    def _edges_in_function(self, fn: FunctionInfo, add) -> None:
        """Re-walk the function's statements with the with-stack to catch
        nested-with and call-under-lock edges (the body walk in pass 2
        kept call-site held-sets, which is what we need here)."""
        # Nested with: acquires list order does not carry nesting, so use
        # the recorded call held-sets plus a dedicated nested-with scan.
        mod = self.by_relpath[fn.module]
        cls = self.classes.get(fn.owner) if fn.owner else None

        def scan(body, held):
            for stmt in body:
                if isinstance(stmt, ast.With):
                    # `with a, b:` == `with a: with b:` — item N is held
                    # while item N+1 acquires, so the edge records per
                    # item, against everything held so far INCLUDING
                    # earlier items of this same statement.
                    acquired = []
                    for item in stmt.items:
                        lk = self._lock_ref(mod, cls, item.context_expr)
                        if lk is not None:
                            for h in held:
                                add(h, lk, fn.module, stmt, "nested with")
                            acquired.append(lk)
                            held.append(lk)
                    scan(stmt.body, held)
                    for _ in acquired:
                        held.pop()
                elif isinstance(stmt, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                elif isinstance(stmt, (ast.If, ast.While, ast.For)):
                    scan(stmt.body, held)
                    scan(stmt.orelse, held)
                elif isinstance(stmt, ast.Try):
                    scan(stmt.body, held)
                    for h_ in stmt.handlers:
                        scan(h_.body, held)
                    scan(stmt.orelse, held)
                    scan(stmt.finalbody, held)

        scan(fn.node.body, [])
        # Calls made while holding locks (at the site or since entry),
        # whose callees transitively acquire more.
        for callee, node, held in fn.calls:
            effective = set(held) | fn.held_at_entry
            if not effective:
                continue
            sub = self.functions.get(callee)
            if sub is None:
                continue
            for dst in sub.acquires_transitive:
                for src in effective:
                    add(src, dst, fn.module, node,
                        f"call chain {fn.key} -> {callee}")

    def _finalize_access_locks(self) -> None:
        """Fold each function's entry-held locks into its accesses (the
        ``_locked``-convention half of the lock coverage)."""
        for fn in self.functions.values():
            if not fn.held_at_entry:
                continue
            for acc in fn.accesses:
                acc.locks |= fn.held_at_entry

    # -- queries the rules use ----------------------------------------------

    def lock_cycles(self) -> List[List[LockOrderEdge]]:
        """Elementary cycles in the lock-order graph, as edge lists.
        Deduplicated by the cycle's lock set; self-loops (non-reentrant
        re-acquisition) come out as single-edge cycles."""
        adj: Dict[str, List[LockOrderEdge]] = {}
        for e in self.lock_edges:
            adj.setdefault(e.src, []).append(e)
        cycles: List[List[LockOrderEdge]] = []
        seen_sets: Set[frozenset] = set()

        for e in self.lock_edges:
            if e.src == e.dst:
                key = frozenset([e.src])
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append([e])

        def dfs(start: str, cur: str, path: List[LockOrderEdge],
                on_path: Set[str]) -> None:
            for edge in adj.get(cur, ()):
                if edge.dst == edge.src:
                    continue
                if edge.dst == start and path:
                    key = frozenset(x.src for x in path + [edge])
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append(path + [edge])
                    continue
                if edge.dst in on_path:
                    continue
                # Canonical start: only explore nodes >= start so each
                # cycle is found from its smallest lock key exactly once.
                if edge.dst < start:
                    continue
                on_path.add(edge.dst)
                dfs(start, edge.dst, path + [edge], on_path)
                on_path.discard(edge.dst)

        for node in sorted(adj):
            dfs(node, node, [], {node})
        return cycles

    def attr_conflicts(self) -> List[tuple]:
        """Cross-thread unsynchronized (class, attr) conflicts:
        ``(class_key, attr, write_access, other_access)`` — one per
        conflicting WRITE site (so a reviewed suppression on one write
        never hides a different racy write of the same attr), paired with
        the first access it can race against. Exemptions: accesses in
        ``__init__``; pre-spawn publication (writes before the first
        ``Thread(...)`` statement of a spawning, unrooted function); attrs
        only ever assigned threadsafe-constructor values outside
        ``__init__`` — and, of course, any pair sharing a lock."""
        by_attr: Dict[tuple, List[AttrAccess]] = {}
        for fn in self.functions.values():
            if fn.owner is None:
                continue
            init_key = f"{fn.owner}.__init__"
            in_init = fn.key == init_key or fn.key.startswith(
                init_key + ".<locals>."
            )
            if in_init:
                continue
            first_spawn = min(
                (n.lineno for _t, n in fn.spawns), default=None
            )
            for acc in fn.accesses:
                if (
                    not fn.roots
                    and first_spawn is not None
                    and acc.line <= first_spawn
                ):
                    # start()-pattern publication: the access precedes the
                    # spawn that makes the attr visible to another thread —
                    # ordinary happens-before, not a race (applies to the
                    # pre-spawn reads too: nothing else exists yet).
                    continue
                by_attr.setdefault((fn.owner, acc.attr), []).append(acc)

        conflicts = []
        for (ckey, attr), accesses in sorted(by_attr.items()):
            writes = [a for a in accesses if a.write]
            if not writes:
                continue
            if self._attr_is_threadsafe(ckey, attr, writes):
                continue
            for w, a in self._conflicting_pairs(writes, accesses):
                conflicts.append((ckey, attr, w, a))
        return conflicts

    def _attr_is_threadsafe(self, ckey: str, attr: str,
                            writes: List[AttrAccess]) -> bool:
        cls = self.classes.get(ckey)
        if cls is None:
            return False
        ctors = cls.attr_ctors.get(attr)
        if not ctors:
            return False
        return all(
            any(qn.endswith(suffix) for suffix in self.threadsafe_types)
            for qn in ctors
        )

    def _roots_of(self, acc: AttrAccess) -> frozenset:
        fn = self.functions.get(acc.func)
        roots = fn.roots if fn is not None else set()
        return frozenset(roots) if roots else frozenset(["<main>"])

    def _conflicting_pairs(self, writes, accesses) -> List[tuple]:
        """For each write site, the first access it can race against (or
        itself, when the one site is reachable from two thread roots)."""
        ordered = sorted(
            accesses, key=lambda a: (a.module, a.line, a.col, not a.write)
        )
        out = []
        for w in sorted(writes, key=lambda a: (a.module, a.line, a.col)):
            w_roots = self._roots_of(w)
            for a in ordered:
                if a is w:
                    # A single site reachable from two different thread
                    # roots races with itself.
                    if len(w_roots) < 2 or w.locks:
                        continue
                    out.append((w, w))
                    break
                a_roots = self._roots_of(a)
                combined = w_roots | a_roots
                if len(combined) < 2:
                    continue  # always the same single thread
                if w.locks & a.locks:
                    continue  # a common lock serializes them
                out.append((w, a))
                break
        return out

    # -- presentation helpers ------------------------------------------------

    def describe_roots(self, fn_key: str) -> str:
        fn = self.functions.get(fn_key)
        if fn is None or not fn.roots:
            return "<main>"
        return "+".join(sorted(r.rsplit(".", 2)[-2] + "." +
                               r.rsplit(".", 1)[-1] if "." in r else r
                               for r in fn.roots))

    def lock_display(self, key: str) -> str:
        parts = key.split(".")
        return ".".join(parts[-2:]) if len(parts) >= 2 else key


def build_program(modules: Sequence[ModuleInfo], config) -> ProgramInfo:
    """Build the model once per run (``analyze_project`` memoizes on the
    module list identity so the three LDT10xx rules share one pass)."""
    return ProgramInfo(modules, config)
