"""Ownership/lifecycle dataflow + content-purity taint (LDT12xx/LDT13xx).

The loader-graph refactor (ROADMAP keystone) reshuffles exactly the code
whose invariants per-module AST rules cannot see: who owns a BufferPool
page, a shm slot token, a socket, a thread — across ``try/finally``,
early returns, generator closes, and handoffs between functions — and
which values are allowed to influence the *content* of the stream versus
only its *capacity*. This module derives both models in one pass over the
already-built :class:`~.concmodel.ProgramInfo` (no second AST walk — the
satellite contract is ONE parse, ONE function table per ``ldt check`` run):

* the **ownership model**: every acquisition of a resource named in the
  ``[tool.ldt-check.resources]`` vocabulary (``BufferPool.lease`` →
  ``release``, shm slot token → ack-put, ``socket.socket`` → ``close``,
  non-daemon ``threading.Thread`` → ``join``, ``AutoTuner`` → ``stop``)
  is tracked through a per-function control-flow walk with exception
  edges (any statement that can raise while a resource is held is an exit
  path), ``finally`` joins, early ``return``\\ s, and generator-close
  edges (a ``yield`` is a potential exit: ``close()`` raises GeneratorExit
  there). Ownership *transfers* end tracking: returning the handle,
  putting it on a queue, storing it on ``self`` or into a container,
  passing it as a keyword argument (the ``out=`` convention), registering
  it with a callback, or handing it to a function the interprocedural
  fixpoint proved publishes or releases its parameter (the
  ``_publish_conn``/``_release_host`` idioms). What survives to an exit
  still *held* is a leak-on-path; a second release on a non-idempotent
  kind is a double-release; any use after a release is a use-after-release.

* the **purity model**: functions declared content paths
  (``[tool.ldt-check.content-paths]``: batch assembly, plan generation,
  cursor arithmetic, lineage digests) and everything they reach inside
  content modules must be free of nondeterminism taint sources — wall
  clocks, unseeded RNG, thread identity, set-iteration order, pops off
  queue-typed attributes (multi-producer arrival order), and autotune
  actuator setters. This pins statically the "actuation changes capacity,
  never content" separation the autotuner's bit-identical-stream benches
  only assert empirically.

The model is conservative exactly like the concurrency model: an
unresolved call contributes no ownership transfer edges and no reachable
taint — silence where the analyzer cannot see, findings only where it
can. The runtime witness (``utils/leaktrack.py`` + ``ldt check
--leak-witness``) closes the gap with evidence, mirroring the lock
witness: a static leak whose acquire site demonstrably leaked at runtime
is *reproduced*; one whose site was exercised and always balanced is
``witness_pruned`` (rendered, not failing).
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .concmodel import FunctionInfo, ProgramInfo

__all__ = [
    "OwnerModel",
    "ResourceSpec",
    "AcquireRecord",
    "LifecycleIssue",
    "TaintHit",
    "DEFAULT_TAINT_SOURCES",
    "build_owner_model",
]

# Ownership states (may-analysis: a var's state is a SET of these).
_HELD = "held"
_RELEASED = "released"
_XFER = "transferred"

# Call-attribute names that hand ownership to another holder: queues,
# containers, executors, callback registries. A tracked handle passed as a
# positional argument to one of these is transferred, not leaked.
_SINK_ATTRS = {
    "put", "put_nowait", "append", "appendleft", "add", "send", "submit",
    "extend", "insert", "register", "add_done_callback",
}
_SINK_QUALNAMES = {"weakref.finalize", "atexit.register"}

# Methods ON a tracked handle that do not constitute an exception edge:
# activation/config calls that only fail on programmer error (`t.start()`
# on a started thread, `sock.settimeout` on a closed fd). bind / listen /
# connect / send / recv stay raise points — those failing mid-setup is
# exactly the fd-leak class LDT1201 exists for.
_NONRAISY_METHODS = {
    "start", "settimeout", "setsockopt", "set", "clear", "is_alive",
    "is_set", "getsockname", "fileno", "locked",
}


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """One vocabulary entry: how a resource kind is acquired and released.
    ``idempotent`` kinds (``BufferPool.release`` ignores foreign/returned
    pages; ``socket.close`` is re-callable) skip the double-release rule —
    use-after-release still applies."""

    kind: str
    acquire: Tuple[str, ...]
    release: Tuple[str, ...]
    describe: str = ""
    idempotent: bool = False


# The repo vocabulary (overridable via [tool.ldt-check.resources]). Acquire
# patterns match the resolved callee's dotted tail, or — normalization
# fallback for untyped attributes — the raw attribute chain with case and
# underscores folded (`self.buffer_pool.lease` matches `BufferPool.lease`).
DEFAULT_RESOURCES: Dict[str, dict] = {
    "pool-page": {
        "acquire": ["BufferPool.lease"],
        "release": ["release", "release_batch"],
        "describe": "BufferPool page lease",
        "idempotent": True,
    },
    "shm-token": {
        "acquire": ["ShmSlotWriter._acquire"],
        "release": ["put", "put_nowait", "release_token"],
        "describe": "shm ring slot token",
        # A double-put hands one slot to two writers: memory corruption.
        "idempotent": False,
    },
    "socket": {
        "acquire": ["socket.socket", "socket.create_connection"],
        "release": ["close"],
        "describe": "socket",
        "idempotent": True,
    },
    "thread": {
        # Non-daemon threads only (the factory skips daemon=True spawns:
        # LDT201 owns the daemon-or-join policy; ownership tracks joins).
        "acquire": ["threading.Thread"],
        "release": ["join"],
        "describe": "non-daemon thread",
        "idempotent": True,
    },
    "autotuner": {
        "acquire": ["AutoTuner"],
        "release": ["stop"],
        "describe": "autotune controller",
        "idempotent": True,
    },
}

# Nondeterminism taint sources (call qualnames; bare names match the call's
# attribute/function name — the actuator-setter entries). Extended, not
# replaced, by [tool.ldt-check] taint-sources.
DEFAULT_TAINT_SOURCES: Tuple[str, ...] = (
    # wall clocks & monotonic clocks — time must never shape content
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    # unseeded/global RNG (seeded np.random.default_rng(...) is fine: its
    # method calls hang off a Call, which has no resolvable qualname here)
    "random.random", "random.randint", "random.randrange", "random.choice",
    "random.shuffle", "random.sample", "random.getrandbits", "random.uniform",
    "numpy.random.permutation", "numpy.random.shuffle",
    "numpy.random.randint", "numpy.random.random", "numpy.random.rand",
    "numpy.random.choice",
    # identity — varies per run/thread/process
    "threading.get_ident", "threading.current_thread",
    "uuid.uuid4", "uuid.uuid1", "os.urandom", "os.getpid",
    "secrets.token_hex", "secrets.token_bytes",
    # autotune actuator setters: capacity knobs must never steer content
    "set_prefetch", "set_budget", "set_workers",
)


@dataclasses.dataclass
class AcquireRecord:
    """One tracked acquisition. ``leak`` is set by the flow when some path
    exits the function with the resource still held."""

    kind: str
    module: str  # relpath
    line: int
    col: int
    func: str  # FunctionInfo key
    var: str
    leak: Optional[str] = None  # "exception" | "return" | "generator-close"

    def site(self) -> str:
        return f"{self.module}:{self.line}"


@dataclasses.dataclass(frozen=True)
class LifecycleIssue:
    """A double-release or use-after-release at a specific site."""

    issue: str  # "double-release" | "use-after-release"
    kind: str
    module: str
    line: int
    col: int
    func: str
    var: str
    acquire_line: int


@dataclasses.dataclass(frozen=True)
class TaintHit:
    """A nondeterminism source reachable from a declared content path."""

    source: str
    module: str
    line: int
    col: int
    func: str  # function containing the source
    content_root: str  # the declared content function it is reachable from


def _norm(part: str) -> str:
    return part.replace("_", "").lower()


class OwnerModel:
    """The ownership + purity model over a shared :class:`ProgramInfo`."""

    def __init__(self, program: ProgramInfo, config):
        self.program = program
        self.specs = self._parse_specs(config)
        # Interprocedural roles (fixpoint over the resolved call graph):
        self.acquirers: Dict[str, str] = {}  # fn key -> kind it returns fresh
        self.releasers: Dict[str, str] = {}  # fn key -> kind of released param
        self.transferers: Set[str] = set()   # fn key publishes/stores a param
        self.records: List[AcquireRecord] = []
        self.issues: List[LifecycleIssue] = []
        self.taints: List[TaintHit] = []
        # (mod, cls, local_types) per function key — the fixpoint and the
        # flow both resolve through these; building them once per function
        # keeps the whole model build linear in program size.
        self._ctx_cache: Dict[str, tuple] = {}
        self._interproc_fixpoint()
        for fn in self.program.functions.values():
            _Flow(self, fn).run()
        self._record_inline_acquires()
        self.records.sort(key=lambda r: (r.module, r.line, r.col))
        self.issues.sort(key=lambda i: (i.module, i.line, i.col))
        self._build_purity(config)

    # -- vocabulary ---------------------------------------------------------

    @staticmethod
    def _parse_specs(config) -> List[ResourceSpec]:
        raw = getattr(config, "resources", None) or DEFAULT_RESOURCES
        specs = []
        for kind, entry in raw.items():
            specs.append(ResourceSpec(
                kind=kind,
                acquire=tuple(entry.get("acquire", ())),
                release=tuple(entry.get("release", ())),
                describe=entry.get("describe", kind),
                idempotent=bool(entry.get("idempotent", False)),
            ))
        return specs

    def spec(self, kind: str) -> ResourceSpec:
        for s in self.specs:
            if s.kind == kind:
                return s
        raise KeyError(kind)

    @staticmethod
    def _match_tail(pattern: str, candidate: Optional[str]) -> bool:
        """Dotted-tail match with case/underscore folding, so the pattern
        ``BufferPool.lease`` matches both the resolved callee key
        ``…buffers.BufferPool.lease`` and the raw untyped attribute chain
        ``self.buffer_pool.lease``."""
        if not candidate:
            return False
        pparts = pattern.split(".")
        cparts = candidate.split(".")
        if len(cparts) < len(pparts):
            return False
        return all(
            _norm(p) == _norm(c)
            for p, c in zip(pparts, cparts[-len(pparts):])
        )

    def acquire_kind(self, fn, mod, cls, local_types,
                     call: ast.Call) -> Optional[str]:
        """Resource kind a call acquires, or None. Resolution order:
        a function the fixpoint proved returns a fresh resource, then the
        configured acquire patterns against the resolved callee and the
        raw qualname."""
        callee = self.program._resolve_callee(fn, mod, cls, local_types,
                                              call.func)
        if callee in self.acquirers:
            return self.acquirers[callee]
        qn = mod.qualname(call.func)
        for spec in self.specs:
            for pat in spec.acquire:
                if self._match_tail(pat, callee) or self._match_tail(pat, qn):
                    if pat.endswith("threading.Thread") or pat == "Thread":
                        # Daemon spawns are LDT201's jurisdiction (daemon OR
                        # join); ownership tracks joinable threads only.
                        for kw in call.keywords:
                            if kw.arg == "daemon" and isinstance(
                                kw.value, ast.Constant
                            ) and kw.value.value is True:
                                return None
                    return spec.kind
        return None

    def _record_inline_acquires(self) -> None:
        """Register ``return pool.lease(...)`` wrapper sites as (immediately
        transferred) acquire records: no finding is possible there, but the
        site is a real runtime acquisition point the leak witness keys by,
        and the ownership graph should show the wrapper as an acquirer."""
        seen = {(r.module, r.line) for r in self.records}
        for fn in self.program.functions.values():
            mod, cls, local_types = self._fn_ctx(fn)
            for node in self.program._walk_own(fn.node):
                if not (isinstance(node, ast.Return)
                        and isinstance(node.value, ast.Call)):
                    continue
                kind = self.acquire_kind(fn, mod, cls, local_types,
                                         node.value)
                if kind and (fn.module, node.value.lineno) not in seen:
                    seen.add((fn.module, node.value.lineno))
                    self.records.append(AcquireRecord(
                        kind=kind, module=fn.module,
                        line=node.value.lineno,
                        col=node.value.col_offset, func=fn.key,
                        var="<returned>",
                    ))

    def acquire_sites(self) -> Set[str]:
        """Every static acquire site (``relpath:line``) — the join keys the
        runtime leak witness maps onto."""
        return {r.site() for r in self.records}

    # -- interprocedural roles ----------------------------------------------

    def _interproc_fixpoint(self) -> None:
        """Grow the acquirer/releaser/transferer sets until stable: a
        function returning a fresh resource makes its callers' call sites
        acquire sites; a function releasing a bare parameter makes calls
        passing a handle releases; a function storing a parameter on
        ``self`` (the ``_publish`` handle-swap) or into a sink makes such
        calls transfers."""
        changed = True
        iters = 0
        while changed and iters < 20:
            changed = False
            iters += 1
            for fn in self.program.functions.values():
                kind = self._returns_fresh(fn)
                if kind and self.acquirers.get(fn.key) != kind:
                    self.acquirers[fn.key] = kind
                    changed = True
                kind = self._releases_param(fn)
                if kind and self.releasers.get(fn.key) != kind:
                    self.releasers[fn.key] = kind
                    changed = True
                if fn.key not in self.transferers and \
                        self._publishes_param(fn):
                    self.transferers.add(fn.key)
                    changed = True

    def _fn_ctx(self, fn: FunctionInfo):
        """(mod, cls, local_types) for resolving calls inside ``fn`` —
        local types come from ``name = ClassName(...)`` assignments plus
        annotated parameters (``buffer_pool: Optional[BufferPool]``).
        Cached per function key (the fixpoint revisits every function)."""
        cached = self._ctx_cache.get(fn.key)
        if cached is not None:
            return cached
        program = self.program
        mod = program.by_relpath[fn.module]
        cls = program.classes.get(fn.owner) if fn.owner else None
        local_types: Dict[str, str] = {}
        args = getattr(fn.node, "args", None)
        if args is not None:
            for arg in list(args.args) + list(args.kwonlyargs):
                if arg.annotation is None:
                    continue
                name = ProgramInfo._annotation_name(arg.annotation)
                ckey = program._class_by_name(name)
                if ckey:
                    local_types[arg.arg] = ckey
        for node in program._walk_own(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
            ):
                ckey = program._resolve_class(mod, node.value.func)
                if ckey:
                    local_types[node.targets[0].id] = ckey
        self._ctx_cache[fn.key] = (mod, cls, local_types)
        return mod, cls, local_types

    def _param_names(self, fn: FunctionInfo) -> List[str]:
        args = getattr(fn.node, "args", None)
        if args is None:
            return []
        names = [a.arg for a in list(args.args) + list(args.kwonlyargs)]
        return [n for n in names if n != "self"]

    def _returns_fresh(self, fn: FunctionInfo) -> Optional[str]:
        """Kind this function returns a freshly-acquired resource of:
        ``return pool.lease(...)`` directly, or acquire-to-local + a
        ``return local`` somewhere."""
        mod, cls, local_types = self._fn_ctx(fn)
        acquired: Dict[str, str] = {}
        for node in self.program._walk_own(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
            ):
                kind = self.acquire_kind(fn, mod, cls, local_types,
                                         node.value)
                if kind:
                    acquired[node.targets[0].id] = kind
            elif isinstance(node, ast.Return) and node.value is not None:
                if isinstance(node.value, ast.Call):
                    kind = self.acquire_kind(fn, mod, cls, local_types,
                                             node.value)
                    if kind:
                        return kind
                if isinstance(node.value, ast.Name) and \
                        node.value.id in acquired:
                    return acquired[node.value.id]
        return None

    def release_names(self, kind: Optional[str] = None) -> Set[str]:
        """Normalized release-method names, for one kind or all."""
        out: Set[str] = set()
        for spec in self.specs:
            if kind is None or spec.kind == kind:
                out |= {_norm(r) for r in spec.release}
        return out

    def _release_targets(self, fn, mod, cls, local_types, call: ast.Call,
                         names: Set[str], release_names: Set[str],
                         kind: Optional[str]) -> Set[str]:
        """Subset of ``names`` this call releases: ``var.close()``,
        ``pool.release(var)``, or a resolved releaser callee taking var."""
        out: Set[str] = set()
        func = call.func
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id in names \
                    and _norm(func.attr) in release_names:
                out.add(func.value.id)
            if _norm(func.attr) in release_names:
                for a in call.args:
                    if isinstance(a, ast.Name) and a.id in names:
                        out.add(a.id)
        callee = self.program._resolve_callee(fn, mod, cls, local_types,
                                              func)
        if callee in self.releasers and (
            kind is None or self.releasers[callee] == kind
        ):
            for a in call.args:
                if isinstance(a, ast.Name) and a.id in names:
                    out.add(a.id)
        return out

    def _releases_param(self, fn: FunctionInfo) -> Optional[str]:
        params = set(self._param_names(fn))
        if not params:
            return None
        mod, cls, local_types = self._fn_ctx(fn)
        all_release = self.release_names()
        for node in self.program._walk_own(fn.node):
            if not isinstance(node, ast.Call):
                continue
            hit = self._release_targets(fn, mod, cls, local_types, node,
                                        params, all_release, None)
            if hit:
                # Kind attribution: the release-method name decides (the
                # first spec claiming it). Ambiguous names (close/put) pick
                # the first matching spec — acceptable: releasers are an
                # is-a-release fact, kinds only gate double-release.
                func = node.func
                attr = _norm(func.attr) if isinstance(func, ast.Attribute) \
                    else ""
                for spec in self.specs:
                    if attr in {_norm(r) for r in spec.release}:
                        return spec.kind
                callee = self.program._resolve_callee(
                    fn, mod, cls, local_types, func
                )
                if callee in self.releasers:
                    return self.releasers[callee]
        return None

    def _publishes_param(self, fn: FunctionInfo) -> bool:
        """True when a bare parameter is stored on ``self``/a container or
        handed to a sink — callers passing a handle have transferred it."""
        params = set(self._param_names(fn))
        if not params:
            return False
        for node in self.program._walk_own(fn.node):
            if isinstance(node, ast.Assign):
                if not any(
                    isinstance(v, ast.Name) and v.id in params
                    for v in ast.walk(node.value)
                ):
                    continue
                for t in node.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        return True
            elif isinstance(node, ast.Call):
                if _is_sink_call(node, self.program.by_relpath[fn.module]):
                    for a in node.args:
                        if isinstance(a, ast.Name) and a.id in params:
                            return True
        return False

    # -- purity --------------------------------------------------------------

    def _build_purity(self, config) -> None:
        entries = list(getattr(config, "content_paths", None) or ())
        if not entries:
            return
        parsed = []  # (path_glob, fn_glob)
        for entry in entries:
            path_glob, _, fn_glob = entry.partition("::")
            parsed.append((path_glob, fn_glob or "*"))
        module_globs = [p for p, _f in parsed]

        def in_content_modules(fn: FunctionInfo) -> bool:
            return any(
                fnmatch.fnmatch(fn.module, g) for g in module_globs
            )

        roots = [
            fn for fn in self.program.functions.values()
            if any(
                fnmatch.fnmatch(fn.module, pg)
                and fnmatch.fnmatch(fn.key, fg)
                for pg, fg in parsed
            )
        ]
        sources = tuple(DEFAULT_TAINT_SOURCES) + tuple(
            getattr(config, "taint_sources", None) or ()
        )
        # Reachability: BFS from each declared content function through
        # resolved calls, bounded to content modules — a content function
        # timing itself via the obs layer does not drag telemetry code
        # into content scope.
        reach_root: Dict[str, str] = {}
        for root in roots:
            stack = [root.key]
            while stack:
                cur = stack.pop()
                if cur in reach_root:
                    continue
                reach_root[cur] = root.key
                cur_fn = self.program.functions.get(cur)
                if cur_fn is None:
                    continue
                for callee, _n, _h in cur_fn.calls:
                    sub = self.program.functions.get(callee)
                    if sub is not None and callee not in reach_root and \
                            in_content_modules(sub):
                        stack.append(callee)
        seen: Set[tuple] = set()
        for key, root_key in reach_root.items():
            fn = self.program.functions.get(key)
            if fn is None:
                continue
            for hit in self._scan_taint(fn, sources):
                src, node = hit
                dedup = (fn.module, node.lineno, node.col_offset, src)
                if dedup in seen:
                    continue
                seen.add(dedup)
                self.taints.append(TaintHit(
                    source=src, module=fn.module, line=node.lineno,
                    col=node.col_offset, func=key, content_root=root_key,
                ))
        self.taints.sort(key=lambda t: (t.module, t.line, t.col))

    def _scan_taint(self, fn: FunctionInfo, sources):
        mod = self.program.by_relpath[fn.module]
        cls = self.program.classes.get(fn.owner) if fn.owner else None
        for node in self.program._walk_own(fn.node):
            if isinstance(node, ast.Call):
                qn = mod.qualname(node.func)
                attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                    else None
                for src in sources:
                    if "." in src:
                        if qn == src:
                            yield src, node
                            break
                    elif qn == src or attr == src:
                        yield src, node
                        break
                else:
                    # Multi-producer queue pop: .get/.get_nowait on a
                    # self-attribute the class model typed as a queue —
                    # arrival order is scheduler order, never content
                    # order.
                    if attr in ("get", "get_nowait") and cls is not None \
                            and isinstance(node.func, ast.Attribute):
                        base = node.func.value
                        if (
                            isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                        ):
                            ctors = cls.attr_ctors.get(base.attr, ())
                            if any("queue" in c.lower() or
                                   c.endswith("Queue") for c in ctors):
                                yield "queue-pop-order", node
            elif isinstance(node, ast.For):
                # Iterating a set iterates hash order — per-process salt.
                it = node.iter
                if isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call)
                    and mod.qualname(it.func) in ("set", "frozenset")
                ):
                    yield "set-iteration-order", node


def _is_sink_call(call: ast.Call, mod) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in _SINK_ATTRS:
        return True
    # Bare-name callback registration (`register(sock)`, a `finalize`
    # parameter): the callee's NAME declares the handoff even when the
    # callee itself cannot be resolved.
    if isinstance(func, ast.Name) and func.id in _SINK_ATTRS:
        return True
    qn = mod.qualname(func)
    return qn in _SINK_QUALNAMES


# -- per-function flow -------------------------------------------------------


class _BlockOut:
    """Exit channels of one statement block."""

    __slots__ = ("normal", "raised", "returned", "broke", "continued")

    def __init__(self):
        self.normal: Optional[dict] = None
        self.raised: List[dict] = []
        self.returned: List[dict] = []
        self.broke: List[dict] = []
        self.continued: List[dict] = []


def _merge(*envs) -> Optional[dict]:
    """May-join: union of states per record (absent = not acquired on that
    path, contributes nothing)."""
    live = [e for e in envs if e is not None]
    if not live:
        return None
    out: dict = {}
    for env in live:
        for rid, states in env.items():
            out[rid] = out.get(rid, frozenset()) | states
    return out


class _Flow:
    """Path-sensitive ownership walk of one function body."""

    def __init__(self, model: OwnerModel, fn: FunctionInfo):
        self.model = model
        self.fn = fn
        self.mod, self.cls, self.local_types = model._fn_ctx(fn)
        self.binding: Dict[str, AcquireRecord] = {}
        self.records: List[AcquireRecord] = []
        self.is_generator = any(
            isinstance(n, (ast.Yield, ast.YieldFrom))
            for n in model.program._walk_own(fn.node)
        )

    def run(self) -> None:
        # Fast path: functions with no acquire events need no flow.
        if not self._has_acquires():
            return
        out = self._flow_block(self.fn.node.body, {})
        exits = [
            ("return", _merge(out.normal, *out.returned)),
            ("exception", _merge(*out.raised)),
        ]
        for channel, env in exits:
            if env is None:
                continue
            for rec in self.records:
                if _HELD in env.get(id(rec), frozenset()) and rec.leak is None:
                    rec.leak = (
                        "generator-close" if channel == "exception"
                        and self.is_generator else channel
                    )
        self.model.records.extend(self.records)

    def _has_acquires(self) -> bool:
        for node in self.model.program._walk_own(self.fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and self.model.acquire_kind(
                    self.fn, self.mod, self.cls, self.local_types, node.value
                )
            ):
                return True
        return False

    # -- block/statement walk ------------------------------------------------

    def _flow_block(self, body: Sequence[ast.stmt], env: dict) -> _BlockOut:
        out = _BlockOut()
        cur: Optional[dict] = dict(env)
        for stmt in body:
            if cur is None:
                break  # unreachable tail after return/raise/break
            cur = self._flow_stmt(stmt, cur, out)
        out.normal = cur
        return out

    def _flow_stmt(self, stmt: ast.stmt, env: dict,
                   out: _BlockOut) -> Optional[dict]:
        if isinstance(stmt, ast.If):
            then_env, else_env = self._refine_guard(stmt.test, env)
            self._expr_events(stmt.test, then_env, out)
            t = self._flow_block(stmt.body, then_env)
            e = self._flow_block(stmt.orelse, else_env)
            self._fold(out, t, e)
            return _merge(t.normal, e.normal)
        if isinstance(stmt, (ast.While, ast.For)):
            if isinstance(stmt, ast.For):
                env = self._expr_events(stmt.iter, env, out)
            else:
                env = self._expr_events(stmt.test, env, out)
            b = self._flow_block(stmt.body, env)
            out.raised.extend(b.raised)
            out.returned.extend(b.returned)
            merged = _merge(env, b.normal, *b.broke, *b.continued)
            o = self._flow_block(stmt.orelse, merged or env)
            self._fold(out, o)
            return _merge(merged, o.normal)
        if isinstance(stmt, ast.Try):
            return self._flow_try(stmt, env, out)
        if isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            for item in stmt.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Name) and ctx.id in self.binding:
                    # `with sock:` — the context manager owns teardown.
                    env = self._transition(env, ctx.id, _XFER)
                else:
                    env = self._expr_events(ctx, env, out)
            b = self._flow_block(stmt.body, env)
            self._fold(out, b)
            return b.normal
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                env = self._transfer_names_in(stmt.value, env)
            out.returned.append(env)
            return None
        if isinstance(stmt, ast.Raise):
            out.raised.append(env)
            return None
        if isinstance(stmt, ast.Break):
            out.broke.append(env)
            return None
        if isinstance(stmt, ast.Continue):
            out.continued.append(env)
            return None
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A closure capturing a tracked handle escapes it (the
            # placement plane's `produce` pattern).
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and node.id in self.binding:
                    env = self._transition(env, node.id, _XFER)
            return env
        return self._apply_stmt(stmt, env, out)

    def _fold(self, out: _BlockOut, *blocks: _BlockOut) -> None:
        for b in blocks:
            out.raised.extend(b.raised)
            out.returned.extend(b.returned)
            out.broke.extend(b.broke)
            out.continued.extend(b.continued)

    def _flow_try(self, stmt: ast.Try, env: dict,
                  out: _BlockOut) -> Optional[dict]:
        body = self._flow_block(stmt.body, env)
        handler_in = _merge(*body.raised) or dict(env)
        handler_normals: List[Optional[dict]] = []
        pre_raised: List[dict] = []
        pre_returned: List[dict] = list(body.returned)
        catches_all = False
        for handler in stmt.handlers:
            if handler.type is None or self._is_broad(handler.type):
                catches_all = True
            h = self._flow_block(handler.body, handler_in)
            handler_normals.append(h.normal)
            pre_raised.extend(h.raised)
            pre_returned.extend(h.returned)
            out.broke.extend(h.broke)
            out.continued.extend(h.continued)
        if not stmt.handlers or not catches_all:
            # Typed handlers leave other exception classes escaping with
            # the body's mid-flight state — the balancer fd-leak class.
            pre_raised.extend(body.raised)
        orelse = self._flow_block(stmt.orelse, body.normal or {})
        self._fold(out, orelse)
        pre_raised.extend(orelse.raised)
        pre_returned.extend(orelse.returned)
        out.broke.extend(body.broke)
        out.continued.extend(body.continued)
        pre_normal = _merge(
            orelse.normal if stmt.orelse else body.normal, *handler_normals
        )
        if stmt.finalbody:
            # The finally runs on every channel; flow it once over the
            # join and re-split (standard conservative approximation — a
            # `finally: release(x)` marks x released on all of them).
            joined = _merge(pre_normal, *pre_raised, *pre_returned)
            f = self._flow_block(stmt.finalbody, joined or {})
            self._fold(out, f)
            if f.normal is None:
                return None  # finally itself always exits
            if pre_raised:
                out.raised.append(f.normal)
            if pre_returned:
                out.returned.append(f.normal)
            return f.normal if pre_normal is not None else None
        out.raised.extend(pre_raised)
        out.returned.extend(pre_returned)
        return pre_normal

    @staticmethod
    def _is_broad(type_node: ast.AST) -> bool:
        names = []
        if isinstance(type_node, ast.Name):
            names = [type_node.id]
        elif isinstance(type_node, ast.Tuple):
            names = [e.id for e in type_node.elts if isinstance(e, ast.Name)]
        return any(n in ("Exception", "BaseException") for n in names)

    def _refine_guard(self, test: ast.AST, env: dict) -> Tuple[dict, dict]:
        """None-guard path refinement: under ``if sock is not None:`` the
        else branch cannot hold the resource (the acquire never happened on
        that path) — without this, the standard ``except: if sock: close``
        cleanup reads as a leak."""
        then_env, else_env = dict(env), dict(env)

        def drop(e: dict, name: str) -> dict:
            rec = self.binding.get(name)
            if rec is not None and id(rec) in e:
                e = dict(e)
                e[id(rec)] = frozenset([_XFER])
            return e

        name = None
        positive = True
        if isinstance(test, ast.Name):
            name = test.id
        elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Name):
            name, positive = test.operand.id, False
        elif isinstance(test, ast.Compare) and len(test.ops) == 1 and \
                isinstance(test.left, ast.Name) and \
                isinstance(test.comparators[0], ast.Constant) and \
                test.comparators[0].value is None:
            name = test.left.id
            positive = isinstance(test.ops[0], ast.IsNot)
        if name is not None and name in self.binding:
            if positive:
                else_env = drop(else_env, name)
            else:
                then_env = drop(then_env, name)
        return then_env, else_env

    # -- statement effects ---------------------------------------------------

    def _transition(self, env: dict, name: str, state: str) -> dict:
        rec = self.binding.get(name)
        if rec is None:
            return env
        env = dict(env)
        env[id(rec)] = frozenset([state])
        return env

    def _states(self, env: dict, name: str) -> frozenset:
        rec = self.binding.get(name)
        if rec is None:
            return frozenset()
        return env.get(id(rec), frozenset())

    def _transfer_names_in(self, expr: ast.AST, env: dict) -> dict:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in self.binding:
                env = self._transition(env, node.id, _XFER)
        return env

    def _expr_events(self, expr: Optional[ast.AST], env: dict,
                     out: _BlockOut) -> dict:
        if expr is None:
            return env
        holder = ast.Expr(value=expr)
        ast.copy_location(holder, expr)
        return self._apply_stmt(holder, env, out) or env

    def _apply_stmt(self, stmt: ast.stmt, env: dict,
                    out: _BlockOut) -> Optional[dict]:
        entry_env = env
        model = self.model
        tracked = set(self.binding)
        consumed: Set[int] = set()  # id(ast node) already explained
        releases: List[Tuple[str, ast.Call]] = []
        transfers: Set[str] = set()
        uses: List[Tuple[str, ast.AST]] = []
        acquire_target: Optional[Tuple[str, str, ast.Call]] = None
        raisy = False

        value = getattr(stmt, "value", None)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(value, ast.Call):
            kind = model.acquire_kind(self.fn, self.mod, self.cls,
                                      self.local_types, value)
            if kind:
                acquire_target = (stmt.targets[0].id, kind, value)
                consumed.add(id(value.func))

        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                if acquire_target is not None and node is acquire_target[2]:
                    continue
                handled = False
                if tracked:
                    kinds = {self.binding[n].kind for n in tracked}
                    rel_names: Set[str] = set()
                    for k in kinds:
                        rel_names |= model.release_names(k)
                    hit = model._release_targets(
                        self.fn, self.mod, self.cls, self.local_types,
                        node, tracked, rel_names, None,
                    )
                    for name in hit:
                        # The name must be released under ITS kind's verbs
                        # (a socket is not released by `put`).
                        if _norm_call_matches(
                            model, node, self.binding[name].kind,
                            self, name,
                        ):
                            releases.append((name, node))
                            handled = True
                            self._consume_name(node, name, consumed)
                    if not handled and _is_sink_call(node, self.mod):
                        for a in node.args:
                            if isinstance(a, ast.Name) and a.id in tracked:
                                transfers.add(a.id)
                                consumed.add(id(a))
                                handled = True
                    callee = model.program._resolve_callee(
                        self.fn, self.mod, self.cls, self.local_types,
                        node.func,
                    )
                    if callee in model.transferers:
                        for a in node.args:
                            if isinstance(a, ast.Name) and a.id in tracked:
                                transfers.add(a.id)
                                consumed.add(id(a))
                                handled = True
                    for kw in node.keywords:
                        if isinstance(kw.value, ast.Name) and \
                                kw.value.id in tracked:
                            # Keyword passing (the numpy `out=` convention)
                            # is a deliberate handoff.
                            transfers.add(kw.value.id)
                            consumed.add(id(kw.value))
                    if not handled and isinstance(node.func, ast.Attribute) \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id in tracked \
                            and node.func.attr in _NONRAISY_METHODS:
                        handled = True  # a use, but not an exception edge
                if not handled:
                    raisy = True
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load):
                raisy = True
            elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                pass  # handled after the walk

        # Assignments whose RHS mentions a tracked handle alias/store it.
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)) and \
                value is not None:
            for node in ast.walk(value):
                if isinstance(node, ast.Name) and node.id in tracked and \
                        id(node) not in consumed:
                    transfers.add(node.id)
                    consumed.add(id(node))

        # Remaining loads are plain uses.
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in tracked and id(node) not in consumed:
                uses.append((node.id, node))

        # Apply: releases (double-release check), transfers, uses
        # (use-after-release check), in that order.
        for name, call in releases:
            rec = self.binding[name]
            states = self._states(env, name)
            if _RELEASED in states and \
                    not model.spec(rec.kind).idempotent:
                model.issues.append(LifecycleIssue(
                    issue="double-release", kind=rec.kind,
                    module=self.fn.module, line=call.lineno,
                    col=call.col_offset, func=self.fn.key, var=name,
                    acquire_line=rec.line,
                ))
            env = self._transition(env, name, _RELEASED)
        for name in transfers:
            env = self._transition(env, name, _XFER)
        reported: Set[tuple] = set()
        for name, node in uses:
            rec = self.binding[name]
            states = self._states(env, name)
            key = (name, node.lineno)
            if _RELEASED in states and key not in reported:
                reported.add(key)
                model.issues.append(LifecycleIssue(
                    issue="use-after-release", kind=rec.kind,
                    module=self.fn.module, line=node.lineno,
                    col=node.col_offset, func=self.fn.key, var=name,
                    acquire_line=rec.line,
                ))

        # Exception edge: the statement can raise with the PRE-statement
        # states (the release/transfer may not have happened yet).
        if raisy and any(
            _HELD in entry_env.get(id(rec), frozenset())
            for rec in self.binding.values()
        ):
            out.raised.append(entry_env)

        # Generator-close edge: a yield is a potential exit (close() raises
        # GeneratorExit there). The yielded value was already delivered, so
        # transfer it first, then snapshot.
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Yield, ast.YieldFrom)):
                if node.value is not None:
                    env = self._transfer_names_in(node.value, env)
                if any(
                    _HELD in env.get(id(rec), frozenset())
                    for rec in self.binding.values()
                ):
                    out.raised.append(env)

        # New acquisition / rebinds LAST (they shadow the old handle).
        if acquire_target is not None:
            name, kind, call = acquire_target
            rec = AcquireRecord(
                kind=kind, module=self.fn.module, line=call.lineno,
                col=call.col_offset, func=self.fn.key, var=name,
            )
            self.binding[name] = rec
            self.records.append(rec)
            env = dict(env)
            env[id(rec)] = frozenset([_HELD])
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id in self.binding:
            # Rebound to something untracked. Stop tracking only when the
            # handle was already released on this path (the close-then-
            # redial pattern: the name now holds a fresh foreign value).
            # A rebind while still held is the branch-alternative pattern
            # (`dst = pool.lease(...) if pool else np.empty(...)` split
            # across if/else) — the original acquisition stays live on its
            # own path and must keep flowing to its transfer/release.
            name = stmt.targets[0].id
            if not (isinstance(value, ast.Name) and value.id == name) and \
                    _RELEASED in self._states(env, name):
                self.binding.pop(name, None)
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self.binding.pop(t.id, None)
        return env

    def _consume_name(self, call: ast.Call, name: str,
                      consumed: Set[int]) -> None:
        func = call.func
        if isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name) and func.value.id == name:
            consumed.add(id(func.value))
        for a in call.args:
            if isinstance(a, ast.Name) and a.id == name:
                consumed.add(id(a))


def _norm_call_matches(model: OwnerModel, call: ast.Call, kind: str,
                       flow: _Flow, name: str) -> bool:
    """Does this call release ``name`` under ``kind``'s own verbs?"""
    hit = model._release_targets(
        flow.fn, flow.mod, flow.cls, flow.local_types, call, {name},
        model.release_names(kind), kind,
    )
    return name in hit


def build_owner_model(program: ProgramInfo, config) -> OwnerModel:
    """Build (or reuse) the ownership/purity model for this run's
    ProgramInfo — memoized on the program instance so the LDT12xx and
    LDT13xx rule families, the ``--leak-witness`` summary, and ``ldt graph
    --ownership`` all share ONE dataflow pass (the satellite contract:
    one parse, one function table, one ownership walk per run)."""
    cached = getattr(program, "_owner_model", None)
    if cached is not None:
        return cached
    model = OwnerModel(program, config)
    program._owner_model = model
    return model
