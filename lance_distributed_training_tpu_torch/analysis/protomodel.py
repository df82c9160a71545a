"""Whole-program wire-protocol evolution model (the LDT14xx engine).

Every HELLO field added since v1 (``stripe_index``/``stripe_count``,
``device_decode``, ``dataset_fingerprint``) had to be individually
remembered in ``decode_config_skew``, version-gated, and
downgrade-tolerated — and until this model, nothing but a careful
reader caught the change that forgot one. Like the concurrency
(:mod:`.concmodel`) and ownership (:mod:`.ownermodel`) models, this one
derives the whole contract from the already-parsed
:class:`~.concmodel.ProgramInfo` — one parse, one function table, one
model build per ``ldt check`` run — and makes it machine-checked:

* the **message vocabulary**: every ``MSG_*`` constant the protocol
  module defines (value + definition line) plus the version-gate
  constants (``PROTOCOL_VERSION``/``MIN_PROTOCOL_VERSION``/
  ``*_MIN_VERSION``);
* the **payload schema**: for each message, the fields *written* — dict
  literals handed to ``send_msg``-shaped calls, ``return MSG_X, {...}``
  handler tuples, constructor functions that return a dict literal
  (``protocol.hello``), send-forwarders (``agent._call``), and
  ``payload["k"] = v`` augmentation — and the fields *read* —
  ``req.get("k")`` / ``req["k"]`` / ``"k" in req`` on a payload variable
  whose message identity is proven by the dominating ``msg_type ==
  MSG_X`` / ``msg_type != MSG_X: raise`` guards, resolved
  **interprocedurally**: through parameters (``decode_config_skew(req)``),
  thread-spawn ``args=`` tuples (``Thread(target=self._produce,
  args=(plan, steps, req))``), handler dicts (``{MSG_X: self._handle_x}``),
  recv-forwarders (``agent._call`` returning ``recv_msg(...)``'s tuple),
  and payload-returning functions (``resolve_fleet`` → ``fleet_main``);
* the **version gates**: per function, which gate constants it compares
  against — the evidence LDT1402 demands before a version-gated field may
  be read or served outside the protocol module.

Reads *inside* the protocol module never satisfy the contract: the schema
owner validating its own fields proves nothing about the peer consuming
them — which is exactly what makes "delete one skew check in
``decode_config_skew``" an LDT1401 failure at the orphaned field.

Conservative like its siblings: an unresolvable send payload contributes
no writes but also no findings against its fields' readers only when the
witness says so — the runtime half (``utils/wiretrack.py`` +
``ldt check --wire-witness``) records which (msg, field, version) tuples
actually crossed the loopback wire and corroborates or prunes LDT1403
exactly like the lock and leak witnesses do their families.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .concmodel import FunctionInfo, ProgramInfo

__all__ = [
    "ProtoModel",
    "MessageInfo",
    "FieldSite",
    "build_proto_model",
]

# Gate-constant shape: PROTOCOL_VERSION, MIN_PROTOCOL_VERSION,
# STRIPE_MIN_VERSION, LINEAGE_MIN_VERSION, FEATURE_MIN_VERSION, ...
_GATE_RE = re.compile(r"^[A-Z][A-Z0-9_]*VERSION$")

# Resolved-callee / qualname tails that mean "this call sends a control
# frame" (arg layout: sock, msg_type, payload) or "this call receives one"
# (returns (msg_type, payload)).
_SEND_TAILS = ("send_msg",)
_RECV_TAILS = ("recv_msg",)

_TERMINAL = (ast.Raise, ast.Return, ast.Continue, ast.Break)


@dataclasses.dataclass(frozen=True)
class FieldSite:
    """One write or read of a payload field."""

    msg: str  # MSG_* name
    field: str
    module: str  # relpath
    line: int
    col: int
    func: str  # FunctionInfo key ("<module>" for module level)


@dataclasses.dataclass
class MessageInfo:
    """One MSG_* constant and its schema as the program uses it."""

    name: str
    value: Optional[int]
    line: int  # definition line in the protocol module
    writes: Dict[str, List[FieldSite]] = dataclasses.field(
        default_factory=dict
    )
    reads: Dict[str, List[FieldSite]] = dataclasses.field(
        default_factory=dict
    )
    # reads inside the protocol module — tracked separately: the schema
    # owner's own tolerant decode never satisfies the peer-read contract.
    self_reads: Dict[str, List[FieldSite]] = dataclasses.field(
        default_factory=dict
    )


def _const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _block_terminates(body: Sequence[ast.stmt]) -> bool:
    """Does this branch always leave the current statement sequence?"""
    return bool(body) and isinstance(body[-1], _TERMINAL)


def _bind_args(target: FunctionInfo, func_expr,
               args: Sequence[ast.AST],
               keywords) -> Dict[str, ast.AST]:
    """Bind call-site argument expressions onto ``target``'s parameter
    names — the ONE implementation of the positional/keyword/self-offset
    mapping shared by send-forwarder resolution, parameter-role
    propagation, and thread-spawn ``args=`` tuples. ``func_expr`` is the
    expression the call went through: a bound-method shape (an Attribute
    on an instance — ``obj.m(...)``, ``target=self._produce``) skips the
    implicit ``self``."""
    names = [a.arg for a in target.node.args.args]
    offset = 1 if (
        target.owner is not None and isinstance(func_expr, ast.Attribute)
    ) else 0
    bound: Dict[str, ast.AST] = {}
    for i, arg in enumerate(args):
        idx = i + offset
        if idx < len(names):
            bound[names[idx]] = arg
    for kw in keywords:
        if kw.arg:
            bound[kw.arg] = kw.value
    return bound


class ProtoModel:
    """The wire-protocol schema model over a shared :class:`ProgramInfo`."""

    def __init__(self, program: ProgramInfo, config):
        self.program = program
        self.proto_path: str = getattr(
            config, "protocol_module",
            "lance_distributed_training_tpu/service/protocol.py",
        )
        binary = getattr(config, "protocol_binary", None)
        self.binary_messages: Set[str] = set(
            binary if binary is not None else ["MSG_BATCH"]
        )
        # field -> gate constant name (LDT1402 vocabulary).
        self.gated_fields: Dict[str, str] = dict(
            getattr(config, "protocol_versions", None) or {}
        )
        self.messages: Dict[str, MessageInfo] = {}
        self.msg_values: Dict[int, str] = {}
        self.gate_constants: Dict[str, int] = {}
        # fn key -> gate constant names compared anywhere in the function.
        self.fn_guards: Dict[str, Set[str]] = {}
        # fn key -> schema of the dict literal it returns
        #   {field: (module, line, col)}; the interprocedural constructor
        # map (protocol.hello, coordinator._members_payload_locked, ...).
        self.returns_schema: Dict[str, Dict[str, tuple]] = {}
        # fn key -> (msg_param_name, payload_param_name) for functions that
        # forward their parameters into a send (agent._call's send half).
        self.send_forwarders: Dict[str, Tuple[str, str]] = {}
        # fn keys whose return value is a (msg_type, payload) recv tuple
        # (agent._call's receive half).
        self.recv_forwarders: Set[str] = set()
        # fn key -> msg names its return value may be a payload of.
        self.returns_roles: Dict[str, Set[str]] = {}
        # (fn key, param name) -> msg roles, grown by the fixpoint.
        self.param_roles: Dict[Tuple[str, str], Set[str]] = {}
        # LDT1402 serve/read sites of gated fields lacking a guard:
        # (field, gate_const, module, line, col, fn key).
        self.ungated_sites: List[tuple] = []
        # send sites per msg: [(module, line)] — the topology ldt graph
        # --protocol renders (schema-resolved or not).
        self.send_sites: Dict[str, List[tuple]] = {}
        # Per-Call-node callee memo: the walk fixpoint re-visits every
        # call each round; resolution is pure in the AST, so cache by
        # node identity (ASTs outlive the model via the module cache).
        self._callee_cache: Dict[int, Optional[str]] = {}

        self._collect_protocol_constants()
        if self.messages:
            self._prepass()
            self._scan_handler_dicts()
            self._walk_fixpoint()
            self._finalize_gates()

    # -- protocol module ----------------------------------------------------

    def _collect_protocol_constants(self) -> None:
        proto = self.program.by_relpath.get(self.proto_path)
        if proto is None or proto.tree is None:
            return
        self._proto_dotted = proto.dotted_name
        for node in proto.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            elif isinstance(node, ast.AnnAssign):
                target = node.target
            else:
                continue
            if not isinstance(target, ast.Name):
                continue
            value = _const_int(getattr(node, "value", None))
            if target.id.startswith("MSG_"):
                self.messages[target.id] = MessageInfo(
                    name=target.id, value=value, line=node.lineno
                )
                if value is not None:
                    self.msg_values[value] = target.id
            elif _GATE_RE.match(target.id) and value is not None:
                self.gate_constants[target.id] = value

    def _msg_const(self, mod, node: ast.AST) -> Optional[str]:
        """MSG_* name a Name/Attribute resolves to, or None."""
        qn = mod.qualname(node)
        if qn is None:
            return None
        leaf = qn.rsplit(".", 1)[-1]
        if leaf in self.messages:
            # Accept both `P.MSG_X` (resolved into the protocol module) and
            # a same-module bare `MSG_X` (the protocol module itself, or a
            # star-ish re-export) — the constant name is globally unique.
            return leaf
        return None

    def _gate_const(self, mod, node: ast.AST) -> Optional[str]:
        qn = mod.qualname(node)
        if qn is None:
            return None
        leaf = qn.rsplit(".", 1)[-1]
        if leaf in self.gate_constants:
            return leaf
        return None

    def _scan_handler_dicts(self) -> None:
        """``{MSG_X: self._handle_x, ...}`` handler tables: each mapped
        method's first non-self parameter receives the corresponding
        message role (the coordinator's ``_handle_conn`` dispatch shape).
        Seeds ``param_roles`` before the walk fixpoint runs."""
        for fn in self.program.functions.values():
            mod = self.program.by_relpath[fn.module]
            cls = self.program.classes.get(fn.owner) if fn.owner else None
            for node in self.program._walk_own(fn.node):
                if not isinstance(node, ast.Dict):
                    continue
                for key, value in zip(node.keys, node.values):
                    if key is None:
                        continue
                    msg = self._msg_const(mod, key)
                    if not msg:
                        continue
                    callee = self.program._resolve_callee(
                        fn, mod, cls, {}, value
                    )
                    target = self.program.functions.get(callee) \
                        if callee else None
                    if target is None:
                        continue
                    names = [a.arg for a in target.node.args.args]
                    idx = 1 if target.owner is not None else 0
                    if idx < len(names):
                        self.param_roles.setdefault(
                            (callee, names[idx]), set()
                        ).add(msg)

    # -- pre-pass: role-independent facts ------------------------------------

    def _prepass(self) -> None:
        """Compute returns_schema (dict-literal constructors, with a small
        fixpoint through call/variable hops), send/recv forwarders, and
        per-function gate-guard sets."""
        for fn in self.program.functions.values():
            mod = self.program.by_relpath[fn.module]
            guards: Set[str] = set()
            for node in self.program._walk_own(fn.node):
                if isinstance(node, ast.Compare):
                    for sub in [node.left] + list(node.comparators):
                        gate = self._gate_const(mod, sub)
                        if gate:
                            guards.add(gate)
            if guards:
                self.fn_guards[fn.key] = guards
            self._detect_forwarders(fn, mod)
        # returns_schema fixpoint: direct dict-literal returns first, then
        # returns through locals and resolved calls (hello -> _hello,
        # _members_payload_locked -> _handle_resolve's local).
        changed = True
        iters = 0
        while changed and iters < 8:
            changed = False
            iters += 1
            for fn in self.program.functions.values():
                schema = self._returns_schema_of(fn)
                if schema and self.returns_schema.get(fn.key) != schema:
                    self.returns_schema[fn.key] = schema
                    changed = True

    def _detect_forwarders(self, fn: FunctionInfo, mod) -> None:
        params = {
            a.arg for a in list(fn.node.args.args)
            + list(fn.node.args.kwonlyargs)
        }
        for node in self.program._walk_own(fn.node):
            if not isinstance(node, ast.Call):
                continue
            if self._is_send_call(fn, mod, node) and len(node.args) >= 3:
                m, p = node.args[1], node.args[2]
                if (
                    isinstance(m, ast.Name) and m.id in params
                    and isinstance(p, ast.Name) and p.id in params
                ):
                    self.send_forwarders[fn.key] = (m.id, p.id)
        for node in self.program._walk_own(fn.node):
            if isinstance(node, ast.Return) and isinstance(
                node.value, ast.Call
            ):
                if self._is_recv_call(fn, mod, node.value):
                    self.recv_forwarders.add(fn.key)

    def _callee_tail(self, fn: FunctionInfo, mod, call: ast.Call) -> str:
        """Best-effort dotted tail of what a call targets: the resolved
        callee key when the program knows it, else the raw qualname."""
        callee = self._resolve_callee(fn, mod, call.func)
        if callee:
            return callee
        qn = mod.qualname(call.func)
        if qn:
            return qn
        if isinstance(call.func, ast.Attribute):
            return call.func.attr
        return ""

    def _is_send_call(self, fn, mod, call: ast.Call) -> bool:
        tail = self._callee_tail(fn, mod, call)
        return any(
            tail == t or tail.endswith("." + t) for t in _SEND_TAILS
        )

    def _is_recv_call(self, fn, mod, call: ast.Call) -> bool:
        tail = self._callee_tail(fn, mod, call)
        if any(tail == t or tail.endswith("." + t) for t in _RECV_TAILS):
            return True
        return tail in self.recv_forwarders

    def _resolve_callee(self, fn: FunctionInfo, mod, func_expr
                        ) -> Optional[str]:
        """ProgramInfo's resolver plus `local = self.attr` typing (the
        `svc = self.service` idiom the server's handshake path uses)."""
        key = id(func_expr)
        if key in self._callee_cache:
            return self._callee_cache[key]
        cls = self.program.classes.get(fn.owner) if fn.owner else None
        local_types = self._local_types(fn, mod, cls)
        got = self.program._resolve_callee(
            fn, mod, cls, local_types, func_expr
        )
        self._callee_cache[key] = got
        return got

    def _local_types(self, fn: FunctionInfo, mod, cls) -> Dict[str, str]:
        cached = getattr(fn, "_proto_local_types", None)
        if cached is not None:
            return cached
        local: Dict[str, str] = {}
        for node in self.program._walk_own(fn.node):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                continue
            name, value = node.targets[0].id, node.value
            if isinstance(value, ast.Call):
                ckey = self.program._resolve_class(mod, value.func)
                if ckey:
                    local[name] = ckey
            elif (
                isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id == "self"
                and cls is not None
            ):
                # `svc = self.service` — type from the annotated attr.
                keys = self.program._attr_class_keys(cls, value.attr)
                if len(keys) == 1:
                    local[name] = keys[0]
        fn._proto_local_types = local
        return local

    def _returns_schema_of(self, fn: FunctionInfo
                           ) -> Optional[Dict[str, tuple]]:
        """Schema of the dict this function returns, when that is a single
        dict literal (directly, via a local, or via a schema-returning
        call). Functions with multiple differently-shaped returns get the
        union — good enough for constructors, which have one."""
        mod = self.program.by_relpath[fn.module]
        local_schemas = self._literal_schemas(fn, mod)
        out: Dict[str, tuple] = {}
        for node in self.program._walk_own(fn.node):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            schema = self._expr_schema(fn, mod, node.value, local_schemas)
            if schema:
                out.update(schema)
        return out or None

    def _literal_schemas(self, fn: FunctionInfo, mod
                         ) -> Dict[str, Dict[str, tuple]]:
        """name -> dict-literal schema for locals assigned a dict literal
        (or a schema-returning call), augmented by `name["k"] = v`. Two
        ordered passes: literal/call assigns first, then augmentations —
        `_walk_own` has no statement order, and the agent's
        ``payload["pressure"] = ...`` sits inside an if/try after the
        literal."""
        out: Dict[str, Dict[str, tuple]] = {}
        for node in self.program._walk_own(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                schema = self._expr_schema(fn, mod, node.value, out)
                if schema is not None:
                    out[node.targets[0].id] = dict(schema)
        for node in self.program._walk_own(fn.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
            ):
                target = node.targets[0]
                key = _const_str(target.slice)
                name = target.value.id
                if key is not None and name in out:
                    out[name][key] = (
                        fn.module, target.lineno, target.col_offset
                    )
        return out

    def _expr_schema(self, fn, mod, expr, local_schemas
                     ) -> Optional[Dict[str, tuple]]:
        if isinstance(expr, ast.Dict):
            schema: Dict[str, tuple] = {}
            for k in expr.keys:
                key = _const_str(k) if k is not None else None
                if key is not None:
                    schema[key] = (fn.module, k.lineno, k.col_offset)
            return schema
        if isinstance(expr, ast.Name) and expr.id in local_schemas:
            return dict(local_schemas[expr.id])
        if isinstance(expr, ast.Call):
            callee = self._resolve_callee(fn, mod, expr.func)
            if callee and callee in self.returns_schema:
                return dict(self.returns_schema[callee])
        return None

    # -- main walk (role fixpoint) -------------------------------------------

    def _walk_fixpoint(self) -> None:
        """Walk every function collecting writes/reads; parameter, spawn,
        and return role propagation converges in a few passes (roles only
        grow)."""
        for _round in range(6):
            before = (
                {k: set(v) for k, v in self.param_roles.items()},
                {k: set(v) for k, v in self.returns_roles.items()},
            )
            for m in self.messages.values():
                m.writes.clear()
                m.reads.clear()
                m.self_reads.clear()
            self.ungated_sites = []
            self.send_sites = {}
            for fn in self.program.functions.values():
                _FnWalk(self, fn).run()
            after = (
                {k: set(v) for k, v in self.param_roles.items()},
                {k: set(v) for k, v in self.returns_roles.items()},
            )
            if after == before:
                break

    # -- recording (called by _FnWalk) ---------------------------------------

    def record_send(self, fn: FunctionInfo, mod, msg: str, payload_expr,
                    local_schemas, line: int) -> None:
        if msg in self.binary_messages:
            return
        info = self.messages.get(msg)
        if info is None:
            return
        self.send_sites.setdefault(msg, []).append((fn.module, line))
        schema = None
        if payload_expr is not None:
            schema = self._expr_schema(fn, mod, payload_expr, local_schemas)
        if not schema:
            return
        for field, (module, fline, fcol) in schema.items():
            info.writes.setdefault(field, []).append(FieldSite(
                msg=msg, field=field, module=module, line=fline, col=fcol,
                func=fn.key,
            ))

    def record_read(self, fn: FunctionInfo, msgs: Set[str], field: str,
                    line: int, col: int) -> None:
        for msg in msgs:
            if msg in self.binary_messages:
                continue
            info = self.messages.get(msg)
            if info is None:
                continue
            site = FieldSite(
                msg=msg, field=field, module=fn.module, line=line, col=col,
                func=fn.key,
            )
            if fn.module == self.proto_path:
                info.self_reads.setdefault(field, []).append(site)
            else:
                info.reads.setdefault(field, []).append(site)
                # Qualified ("MSG_HELLO.stripe_index") entries scope the
                # gate to one message; a bare field name gates it
                # everywhere (RESOLVE_OK's membership stripe_count is NOT
                # the version-gated HELLO field of the same name).
                gate = self.gated_fields.get(f"{msg}.{field}") \
                    or self.gated_fields.get(field)
                if gate:
                    self._note_gated(fn, field, gate, line, col)

    def record_gated_kwarg(self, fn: FunctionInfo, field: str, line: int,
                           col: int) -> None:
        """A gated field passed by keyword into a schema constructor — a
        serve site that needs the same guard a read does. Matched by field
        name across qualified entries (a constructor serves whatever
        message its schema is sent as)."""
        if fn.module == self.proto_path:
            return
        gate = self.gated_fields.get(field)
        if gate is None:
            for key, value in self.gated_fields.items():
                if key.endswith("." + field):
                    gate = value
                    break
        if gate:
            self._note_gated(fn, field, gate, line, col)

    def _note_gated(self, fn: FunctionInfo, field: str, gate: str,
                    line: int, col: int) -> None:
        if not self._guard_verdicts(gate).get(fn.key, False):
            self.ungated_sites.append(
                (field, gate, fn.module, line, col, fn.key)
            )

    def _callers_map(self) -> Dict[str, List[str]]:
        cached = getattr(self, "_callers_cache", None)
        if cached is None:
            cached = {}
            for caller in self.program.functions.values():
                for callee, _n, _h in caller.calls:
                    cached.setdefault(callee, []).append(caller.key)
            self._callers_cache = cached
        return cached

    def _guard_verdicts(self, gate: str) -> Dict[str, bool]:
        """fn key -> "every call chain into this function passes a
        comparison against ``gate``". The semantics per function: it holds
        the guard itself, or it has callers and EVERY caller is guarded
        (the `_hello` helper whose one caller `_dial_member` holds the
        guard). Computed whole-graph per gate — Tarjan SCCs of the caller
        graph in dependency order, then a greatest-fixpoint inside each
        SCC — so diamond caller graphs and recursive helper chains get
        their correct verdict instead of a path-order-dependent one
        (naive memoized DFS poisons shared intermediates with
        cycle-contaminated False). A caller cycle with no external entry
        and no internal guard is unguarded, like any other uncalled
        function."""
        cached = getattr(self, "_gate_verdict_cache", None)
        if cached is None:
            cached = self._gate_verdict_cache = {}
        if gate in cached:
            return cached[gate]
        callers = self._callers_map()
        has_guard = {
            fn for fn, gates in self.fn_guards.items() if gate in gates
        }
        verdict: Dict[str, bool] = {}

        def settle(members: List[str]) -> None:
            """Verdict for one SCC; every caller OUTSIDE it is already
            settled (Tarjan pops successor components first)."""
            inside = set(members)
            if len(members) == 1 and members[0] not in callers.get(
                members[0], ()
            ):
                fn = members[0]
                cs = callers.get(fn, ())
                verdict[fn] = fn in has_guard or (
                    bool(cs) and all(verdict.get(c, False) for c in cs)
                )
                return
            external = any(
                c not in inside
                for m in members
                for c in callers.get(m, ())
            )
            if not external and not (inside & has_guard):
                for m in members:
                    verdict[m] = False
                return
            # Greatest fixpoint: start optimistic, refute until stable —
            # a recursion back-edge is not an unguarded entry; only real
            # external paths (and missing internal guards) refute.
            for m in members:
                verdict[m] = True
            changed = True
            while changed:
                changed = False
                for m in members:
                    cs = callers.get(m, ())
                    value = m in has_guard or (
                        bool(cs)
                        and all(verdict.get(c, False) for c in cs)
                    )
                    if value != verdict[m]:
                        verdict[m] = value
                        changed = True

        # Iterative Tarjan over the caller graph (successors = callers):
        # components pop callers-first, exactly the settle() order.
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        counter = [0]
        for root in self.program.functions:
            if root in index:
                continue
            work = [(root, iter(callers.get(root, ())))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                node, succs = work[-1]
                advanced = False
                for succ in succs:
                    if succ not in self.program.functions:
                        continue
                    if succ not in index:
                        index[succ] = low[succ] = counter[0]
                        counter[0] += 1
                        stack.append(succ)
                        on_stack.add(succ)
                        work.append(
                            (succ, iter(callers.get(succ, ())))
                        )
                        advanced = True
                        break
                    if succ in on_stack:
                        low[node] = min(low[node], index[succ])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    members = []
                    while True:
                        top = stack.pop()
                        on_stack.discard(top)
                        members.append(top)
                        if top == node:
                            break
                    settle(members)
        cached[gate] = verdict
        return verdict

    def _finalize_gates(self) -> None:
        self.ungated_sites.sort(key=lambda s: (s[2], s[3], s[4]))

    # -- rule queries --------------------------------------------------------

    def orphan_writes(self) -> List[FieldSite]:
        """LDT1401: fields some sender writes that no peer module reads.
        One finding per (msg, field), at the first write site."""
        out = []
        for name in sorted(self.messages):
            info = self.messages[name]
            for field in sorted(info.writes):
                if field in info.reads:
                    continue
                sites = sorted(
                    info.writes[field], key=lambda s: (s.module, s.line)
                )
                out.append(sites[0])
        return out

    def orphan_reads(self) -> List[FieldSite]:
        """LDT1403: fields some peer reads that no sender writes — dead
        drift (a removed field still consumed, or a typo'd key). One
        finding per read site."""
        out = []
        for name in sorted(self.messages):
            info = self.messages[name]
            for field in sorted(info.reads):
                if field in info.writes:
                    continue
                out.extend(sorted(
                    info.reads[field], key=lambda s: (s.module, s.line)
                ))
        return out

    def _field_in_traffic(self, key: str) -> bool:
        """Does a protocol-versions entry's field appear anywhere in the
        modeled schema (written, read, or validated)?"""
        if "." in key:
            msg, field = key.split(".", 1)
            info = self.messages.get(msg)
            infos = [info] if info is not None else []
        else:
            field = key
            infos = list(self.messages.values())
        return any(
            field in i.writes or field in i.reads or field in i.self_reads
            for i in infos
        )

    def config_drift(self) -> List[str]:
        """Gate constants named in [tool.ldt-check.protocol-versions] that
        the protocol module does not define — reported only for entries
        whose field actually appears in the modeled traffic. An entry
        naming a message or field outside the scanned protocol is scoped
        config (inert here), like a dispatch-table row for an unscanned
        module; one guarding LIVE traffic with a nonexistent constant is
        a broken gate nobody can ever satisfy."""
        missing = set()
        for key, gate in self.gated_fields.items():
            if gate in self.gate_constants:
                continue
            if not self._field_in_traffic(key):
                continue
            missing.add(gate)
        return sorted(missing)

    def witness_receipt(self, witness: dict) -> dict:
        """Corroboration summary for the --json report / CI receipt: how
        much of the runtime (msg, field) evidence maps onto the static
        schema."""
        fields = witness.get("fields", {})
        observed = 0
        matched = 0
        for value, field_counts in fields.items():
            name = self.msg_values.get(int(value))
            info = self.messages.get(name) if name else None
            for field in field_counts:
                observed += 1
                if info is not None and (
                    field in info.writes
                    or field in info.reads
                    or field in info.self_reads
                ):
                    matched += 1
        return {
            "observed_fields": observed,
            "matched_fields": matched,
            "frames": sum(
                int(n) for n in witness.get("frames", {}).values()
            ),
            # Negotiated versions the run actually exercised — the
            # receipt's proof that the interop matrix covered more than
            # one protocol generation.
            "versions_seen": sorted({
                int(v)
                for versions in witness.get("versions", {}).values()
                for v in versions
            }),
        }

    def witness_verdict(self, witness: dict, site: FieldSite) -> str:
        """"pruned" | "reproduced" | "unknown" for an LDT1403 orphan-read
        against the wire witness. Pruned when the (msg, field) tuple was
        observed crossing the wire (a writer exists outside the static
        view); reproduced when the message was exercised and the field
        never appeared."""
        info = self.messages.get(site.msg)
        if info is None or info.value is None:
            return "unknown"
        value = str(info.value)
        fields = witness.get("fields", {}).get(value, {})
        if int(fields.get(site.field, 0)) > 0:
            return "pruned"
        if int(witness.get("frames", {}).get(value, 0)) > 0:
            return "reproduced"
        return "unknown"


class _FnWalk:
    """One function's statement-ordered walk: payload-role tracking under
    msg-type guards, schema sends, field reads."""

    def __init__(self, model: ProtoModel, fn: FunctionInfo):
        self.model = model
        self.fn = fn
        self.mod = model.program.by_relpath[fn.module]
        self.cls = (
            model.program.classes.get(fn.owner) if fn.owner else None
        )
        # Safe to cache across walk rounds: literal schemas depend only on
        # returns_schema, which the prepass fixpoint froze before the
        # first round.
        cached = getattr(fn, "_proto_schemas", None)
        if cached is None:
            cached = model._literal_schemas(fn, self.mod)
            fn._proto_schemas = cached
        self.local_schemas = cached
        # payload var -> roles (None = known payload, message unproven).
        self.roles: Dict[str, Optional[Set[str]]] = {}
        # msg-type var -> payload var it was received with.
        self.partner: Dict[str, str] = {}
        # Parameters with roles from the interprocedural fixpoint.
        for arg in list(fn.node.args.args) + list(fn.node.args.kwonlyargs):
            got = model.param_roles.get((fn.key, arg.arg))
            if got:
                self.roles[arg.arg] = set(got)

    def run(self) -> None:
        self._block(self.fn.node.body)

    # -- statements ----------------------------------------------------------

    def _block(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        model, fn, mod = self.model, self.fn, self.mod
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs walk as their own FunctionInfo
        if isinstance(stmt, ast.If):
            self._if(stmt)
            return
        if isinstance(stmt, (ast.While, ast.For)):
            if isinstance(stmt, ast.For):
                self._exprs([stmt.iter])
            else:
                self._exprs([stmt.test])
            self._block(stmt.body)
            self._block(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._exprs([item.context_expr])
            self._block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._block(stmt.body)
            for handler in stmt.handlers:
                self._block(handler.body)
            self._block(stmt.orelse)
            self._block(stmt.finalbody)
            return
        if isinstance(stmt, ast.Return):
            self._return(stmt)
            self._exprs([stmt.value] if stmt.value is not None else [])
            return
        if isinstance(stmt, ast.Assign):
            self._assign(stmt)
            return
        self._exprs([stmt])

    def _assign(self, stmt: ast.Assign) -> None:
        model, fn, mod = self.model, self.fn, self.mod
        value = stmt.value
        if len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Tuple):
            elts = stmt.targets[0].elts
            # `msg_type, payload = recv_msg(...)` (or a recv-forwarder).
            if (
                len(elts) == 2
                and all(isinstance(e, ast.Name) for e in elts)
                and isinstance(value, ast.Call)
                and model._is_recv_call(fn, mod, value)
            ):
                self.partner[elts[0].id] = elts[1].id
                self.roles[elts[1].id] = None
                self._exprs([value])
                return
            # `reply_type, reply = MSG_X, {...}` — a handler's deferred
            # send pairing (the coordinator's error arms).
            if (
                len(elts) == 2
                and isinstance(value, ast.Tuple)
                and len(value.elts) == 2
            ):
                msg = model._msg_const(mod, value.elts[0])
                if msg:
                    model.record_send(
                        fn, mod, msg, value.elts[1], self.local_schemas,
                        stmt.lineno,
                    )
        if (
            len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            name = stmt.targets[0].id
            # `payload = resolve_fleet(...)` — a payload-returning callee.
            if isinstance(value, ast.Call):
                callee = model._resolve_callee(fn, mod, value.func)
                got = model.returns_roles.get(callee) if callee else None
                if got:
                    self.roles[name] = set(got)
        self._exprs([value])

    def _return(self, stmt: ast.Return) -> None:
        model, fn, mod = self.model, self.fn, self.mod
        value = stmt.value
        if value is None:
            return
        # `return MSG_X, payload` — the coordinator handler contract.
        if isinstance(value, ast.Tuple) and len(value.elts) == 2:
            msg = model._msg_const(mod, value.elts[0])
            if msg:
                model.record_send(
                    fn, mod, msg, value.elts[1], self.local_schemas,
                    stmt.lineno,
                )
                return
        # `return reply` where reply carries proven roles.
        if isinstance(value, ast.Name):
            roles = self.roles.get(value.id)
            if roles:
                model.returns_roles.setdefault(fn.key, set()).update(roles)

    # -- guards --------------------------------------------------------------

    def _guard_of(self, test: ast.AST):
        """(msgvar, msg, is_eq, rest_exprs) for a msg-type comparison test,
        else None. BoolOp(And, [guard, rest...]) applies the guard to the
        rest of its own test too (`msg_type == MSG_ERROR and MARKER in
        reply.get("message")`)."""
        model, mod = self.model, self.mod
        rest: List[ast.AST] = []
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And) \
                and test.values:
            rest = list(test.values[1:])
            test = test.values[0]
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Eq, ast.NotEq))
        ):
            return None
        left, right = test.left, test.comparators[0]
        for var_node, const_node in ((left, right), (right, left)):
            if isinstance(var_node, ast.Name) and var_node.id in self.partner:
                msg = model._msg_const(mod, const_node)
                if msg:
                    return (
                        var_node.id, msg,
                        isinstance(test.ops[0], ast.Eq), rest,
                    )
        return None

    def _if(self, stmt: ast.If) -> None:
        guard = self._guard_of(stmt.test)
        if guard is None:
            self._exprs([stmt.test])
            self._block(stmt.body)
            self._block(stmt.orelse)
            return
        msgvar, msg, is_eq, rest = guard
        payload = self.partner[msgvar]
        outer = self.roles.get(payload)
        if is_eq:
            # Reads in the rest of the same And-test see the narrowed role.
            self.roles[payload] = {msg}
            self._exprs(rest)
            self._block(stmt.body)
            self.roles[payload] = outer
            self._block(stmt.orelse)
        else:
            self._exprs(rest)
            self._block(stmt.body)
            if _block_terminates(stmt.body):
                # `if msg_type != MSG_X: raise` — everything after is X.
                self._block(stmt.orelse)
                self.roles[payload] = {msg}
            else:
                self.roles[payload] = {msg}
                self._block(stmt.orelse)
                self.roles[payload] = outer

    # -- expressions ---------------------------------------------------------

    def _exprs(self, nodes) -> None:
        for top in nodes:
            if top is None:
                continue
            stack = [top]
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(node, ast.Call):
                    self._call(node)
                elif isinstance(node, ast.Subscript):
                    self._subscript(node)
                elif isinstance(node, ast.Compare):
                    self._compare_in(node)
                stack.extend(ast.iter_child_nodes(node))

    def _roles_of(self, node: ast.AST) -> Optional[Set[str]]:
        if isinstance(node, ast.Name):
            return self.roles.get(node.id)
        return None

    def _call(self, call: ast.Call) -> None:
        model, fn, mod = self.model, self.fn, self.mod
        # payload.get("field" [, default])
        func = call.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "get"
            and isinstance(func.value, ast.Name)
        ):
            roles = self.roles.get(func.value.id)
            if roles and call.args:
                field = _const_str(call.args[0])
                if field is not None:
                    model.record_read(
                        fn, roles, field, call.lineno, call.col_offset
                    )
        # send_msg(sock, MSG_X, payload) — direct or through a forwarder.
        if model._is_send_call(fn, mod, call) and len(call.args) >= 3:
            msg = model._msg_const(mod, call.args[1])
            if msg:
                model.record_send(
                    fn, mod, msg, call.args[2], self.local_schemas,
                    call.lineno,
                )
        callee = model._resolve_callee(fn, mod, func)
        if callee in model.send_forwarders:
            # fn(msg, payload) forwarding both into a send: map the call
            # site's constant + payload expr through the parameter names.
            msg_param, payload_param = model.send_forwarders[callee]
            target = model.program.functions.get(callee)
            if target is not None:
                bound = _bind_args(
                    target, func, call.args, call.keywords
                )
                msg = model._msg_const(mod, bound.get(msg_param)) \
                    if bound.get(msg_param) is not None else None
                if msg and bound.get(payload_param) is not None:
                    model.record_send(
                        fn, mod, msg, bound[payload_param],
                        self.local_schemas, call.lineno,
                    )
        # Parameter-role propagation into the resolved callee, positional
        # and keyword; `threading.Thread(target=..., args=(...))` spawns
        # map their args tuple onto the target's parameters.
        qn = mod.qualname(func)
        if qn == "threading.Thread":
            self._spawn_roles(call)
        elif callee:
            self._param_roles(call, callee, func)
        # Gated fields served by keyword into a schema constructor —
        # record_gated_kwarg owns the gate lookup (bare AND qualified
        # "MSG_X.field" entries); no pre-filter here, a bare-name check
        # against qualified keys would silently disable the serve half.
        if callee and callee in model.returns_schema:
            for kw in call.keywords:
                if kw.arg:
                    model.record_gated_kwarg(
                        fn, kw.arg, call.lineno, call.col_offset
                    )

    def _param_roles(self, call: ast.Call, callee: str, func) -> None:
        model = self.model
        target = model.program.functions.get(callee)
        if target is None:
            return
        for name, arg in _bind_args(
            target, func, call.args, call.keywords
        ).items():
            roles = self._roles_of(arg)
            if roles:
                model.param_roles.setdefault(
                    (callee, name), set()
                ).update(roles)

    def _spawn_roles(self, call: ast.Call) -> None:
        model, fn, mod = self.model, self.fn, self.mod
        cls = model.program.classes.get(fn.owner) if fn.owner else None
        target_key = model.program._spawn_target(
            fn, mod, cls, model._local_types(fn, mod, cls), call
        )
        target = model.program.functions.get(target_key) \
            if target_key else None
        if target is None:
            return
        spawn_target = next(
            (kw.value for kw in call.keywords if kw.arg == "target"), None
        )
        args_kw = next(
            (kw.value for kw in call.keywords if kw.arg == "args"), None
        )
        if not isinstance(args_kw, ast.Tuple):
            return
        for name, arg in _bind_args(
            target, spawn_target, args_kw.elts, ()
        ).items():
            roles = self._roles_of(arg)
            if roles:
                model.param_roles.setdefault(
                    (target_key, name), set()
                ).update(roles)

    def _subscript(self, node: ast.Subscript) -> None:
        if not isinstance(node.value, ast.Name):
            return
        roles = self.roles.get(node.value.id)
        if not roles:
            return
        field = _const_str(node.slice)
        if field is None:
            return
        if isinstance(node.ctx, ast.Store):
            return  # augmentation handled by the schema pass
        self.model.record_read(
            self.fn, roles, field, node.lineno, node.col_offset
        )

    def _compare_in(self, node: ast.Compare) -> None:
        # `"field" in payload`
        if len(node.ops) != 1 or not isinstance(node.ops[0], ast.In):
            return
        comp = node.comparators[0]
        if not isinstance(comp, ast.Name):
            return
        roles = self.roles.get(comp.id)
        if not roles:
            return
        field = _const_str(node.left)
        if field is not None:
            self.model.record_read(
                self.fn, roles, field, node.lineno, node.col_offset
            )

def build_proto_model(program: ProgramInfo, config) -> ProtoModel:
    """Build (or reuse) the wire-protocol model for this run's ProgramInfo
    — memoized on the program instance so the LDT14xx rules, the
    ``--wire-witness`` receipt, and ``ldt graph --protocol`` share ONE
    schema pass (the same single-build contract as the ownership model)."""
    cached = getattr(program, "_proto_model", None)
    if cached is not None:
        return cached
    model = ProtoModel(program, config)
    program._proto_model = model
    return model
