"""Whole-program device-semantics model (the LDT1701-1704 engine).

The compute plane's XLA-facing assumptions — mesh-axis names, partition
specs, buffer donation, jit static arguments, host-sync points — are
exactly the contracts a compiler does NOT check: a typo'd axis in a
``PartitionSpec`` compiles fine and silently replicates instead of
sharding, a donated buffer read after the call returns whatever the
compiler scribbled into it, a batch-shape-derived Python value reaching a
``static_argnames`` position recompiles the kernel per batch, and a stray
``float()`` on a device value serialises the async dispatch stream the
trainer exists to keep full. This module derives, from the one
:class:`~.concmodel.ProgramInfo` an ``ldt check`` run builds:

* every **jit site** (``jax.jit`` / ``pjit`` / ``pmap`` / ``shard_map`` —
  decorator, ``partial(jax.jit, ...)`` decorator, or wrapping call) with
  its resolved target function, ``static_argnames`` / ``static_argnums``,
  ``donate_argnums`` (the may-donate branch of a conditional counts), and
  the candidate def-site lines the runtime compile witness joins on;
* every **axis reference**: literal axis names inside
  ``PartitionSpec``/``P(...)`` calls (``with_sharding_constraint`` and
  ``shard_map`` specs included — the spec call is scanned wherever it
  appears) and literal ``axis_name`` arguments of collectives
  (``psum``/``pmean``/``pcast``/``axis_size``/...);
* **donation dataflow** (LDT1702): jit-wrapped callables tracked through
  local bindings, factory returns (``make_train_step`` returns the jit
  object), and one call level into parameters, then a branch-aware
  read-after-donate scan at every call that donates a named argument;
* **recompile dataflow** (LDT1703): ``.shape``/``len()``-derived values
  reaching static positions of jitted callables (a derivation routed
  through a declared quantized funnel — ``static-funnels`` — is
  sanctioned), plus Python ``if``/``while`` branches on parameter shapes
  inside jitted content-path functions, where shapes vary per batch;
* **host syncs** (LDT1704): ``.item()`` / ``float()``/``int()``/``bool()``
  / ``np.asarray`` coercions of device-derived values in the declared
  ``device-hot-paths`` modules, outside jitted bodies (those are LDT102's
  domain) and outside the declared ``sync-funnels``.

Everything is stdlib ``ast`` over the already-parsed module list — one
parse, one model per run, timed as ``model_build_ms["mesh"]`` in the
``--json`` report. Like the ownership model, inference is conservative:
an unresolvable callee contributes nothing, a non-literal axis name is
skipped (no false positives from guesses). The runtime half
(``utils/compiletrack.py`` + ``ldt check --compile-witness``) closes the
loop on LDT1703 with per-callsite compile counts: a hazard whose jit site
demonstrably recompiled after warmup is *reproduced*; one whose site was
exercised with a single steady-state compile is witness-pruned.

The PyTorch port's copy adds the torch forms (LDT1711, LDT1713, LDT1714),
scanned only in modules that import ``torch`` and none of ``jax``/``flax``
(so they stay inert on JAX code, and JAX's forms keep their findings):

* **launch sites**: the kernel launchers and cuDNN-autotuned forwards named
  by ``launch-sites`` (``path-glob::function-glob``), with their def lines
  as the torch compile witness's join keys;
* **torch axis references**: literal keys of a topology's
  ``group``/``index``/``size``/``ranks``/``strides`` maps and literal
  ``axis=``/``*_axis=`` keywords (port ``parallel/comm.py``'s ``AXES``);
* **torch recompile hazards**: a ``.shape``/``len()``-derived value,
  outside ``static-funnels``, reaching a launch site as an argument or as
  the size of a tensor handed to it (a new cuDNN autotune, a new launch
  configuration);
* **torch host syncs**: ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
  ``float()``/``int()``/``bool()`` or ``np.asarray`` on a torch value, or
  ``torch.cuda.synchronize``, in ``device-hot-paths`` outside
  ``sync-funnels``.
"""

from __future__ import annotations

import ast
import dataclasses
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

from .concmodel import ProgramInfo

__all__ = [
    "MeshModel",
    "JitSite",
    "AxisRef",
    "DonateHazard",
    "RecompileHazard",
    "SyncHazard",
    "build_mesh_model",
]

# Resolved qualnames that wrap a function for device compilation. shard_map
# and pcast/axis_size route through parallel/_compat in this repo, so dotted
# tails are matched for those.
_JIT_QNAMES = {"jax.jit", "jit", "jax.pmap", "pmap", "pjit",
               "jax.experimental.pjit.pjit"}
_JIT_TAILS = (".pjit", ".shard_map")

# Collective -> positional index of its axis_name argument.
_COLLECTIVES = {
    "psum": 1, "pmean": 1, "pmax": 1, "pmin": 1, "psum_scatter": 1,
    "all_gather": 1, "ppermute": 1, "pcast": 1,
    "axis_size": 0, "axis_index": 0,
}

_SYNC_COERCIONS = ("float", "int", "bool")
_SYNC_QNAMES = {"numpy.asarray", "numpy.array", "jax.device_get"}

# jax host-metadata APIs: their results live on the host (device handles,
# process topology, abstract shapes) — calls to these never taint a value
# as device-resident.
_HOST_METADATA_QNAMES = {
    "jax.devices", "jax.local_devices", "jax.device_count",
    "jax.local_device_count", "jax.process_count", "jax.process_index",
    "jax.default_backend", "jax.eval_shape", "jax.tree_util.tree_structure",
}


@dataclasses.dataclass
class JitSite:
    """One jit/pjit/pmap/shard_map wrap site."""

    kind: str          # "jit" | "pjit" | "pmap" | "shard_map"
    name: str          # display name of the wrapped callable
    module: str        # relpath of the wrap site
    line: int
    col: int
    func_key: Optional[str]        # ProgramInfo function key, when resolved
    def_module: Optional[str]      # relpath of the wrapped def
    def_lines: Tuple[int, ...]     # witness join candidates (def +
    #                                decorators + wrap line)
    node: Optional[ast.AST]        # the wrapped FunctionDef/Lambda
    params: Tuple[str, ...]
    static_argnames: Tuple[str, ...]
    static_argnums: Tuple[int, ...]
    donate_argnums: Tuple[int, ...]
    donate_conditional: bool       # donate came from one branch of an IfExp

    def witness_sites(self) -> Tuple[str, ...]:
        """``path:line`` candidates the runtime compile witness may report
        this site under — ``co_firstlineno`` points at the def or the first
        decorator depending on the interpreter, so every candidate counts."""
        if not self.def_module:
            return ()
        return tuple(f"{self.def_module}:{ln}" for ln in self.def_lines)


@dataclasses.dataclass(frozen=True)
class AxisRef:
    """One literal mesh-axis name reference."""

    axis: str
    module: str
    line: int
    col: int
    context: str  # "PartitionSpec" or "collective <name>"


@dataclasses.dataclass(frozen=True)
class DonateHazard:
    """A value passed in a donated position is read again after the call."""

    module: str
    line: int      # the donating call
    col: int
    var: str
    read_line: int
    func: str      # enclosing function key
    callee: str    # display name of the donating callable


@dataclasses.dataclass(frozen=True)
class RecompileHazard:
    """A batch-content-derived Python value steers compilation."""

    module: str
    line: int
    col: int
    detail: str
    func: str
    site: JitSite  # the jit site whose cache the value keys


@dataclasses.dataclass(frozen=True)
class SyncHazard:
    """A host-sync coercion of a device-derived value on a hot path."""

    module: str
    line: int
    col: int
    expr: str
    func: str


def _str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Literal ``"a"`` / ``("a", "b")`` / ``["a"]`` → tuple of names; None
    for anything non-literal (conservative: unresolved statics are skipped,
    never guessed)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            out.append(e.value)
        return tuple(out)
    return None


def _int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            got = _int_tuple(e)
            if got is None or len(got) != 1:
                return None
            out.append(got[0])
        return tuple(out)
    return None


def _params_of(fn: ast.AST) -> Tuple[str, ...]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return tuple(names)


def _pos_params(fn_node: ast.AST) -> List[str]:
    args = fn_node.args
    return [a.arg for a in args.posonlyargs + args.args]


def _base_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name through Attribute/Subscript chains: ``x.val[0]`` → x."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _match_paths(relpath: str, globs) -> bool:
    return any(fnmatch(relpath, g) for g in globs)


def _match_func_globs(fn_key: str, bare: str, globs) -> bool:
    """Function-name globs match the bare name or the dotted key tail."""
    for g in globs:
        if fnmatch(bare, g) or fnmatch(fn_key, g) \
                or fnmatch(fn_key, f"*{g}"):
            return True
    return False


class MeshModel:
    """Build with :func:`build_mesh_model` (memoized per ProgramInfo)."""

    def __init__(self, program: ProgramInfo, config):
        self.program = program
        self.mesh_axes = tuple(
            getattr(config, "mesh_axes", None)
            or ("data", "model", "seq", "pipe")
        )
        self.static_funnels = tuple(
            getattr(config, "static_funnels", None) or ()
        )
        self.sync_funnels = tuple(getattr(config, "sync_funnels", None) or ())
        self.device_hot_paths = tuple(
            getattr(config, "device_hot_paths", None) or ()
        )
        self.content_paths = tuple(getattr(config, "content_paths", None)
                                   or ())
        self.jit_sites: List[JitSite] = []
        self.axis_refs: List[AxisRef] = []
        self.donate_hazards: List[DonateHazard] = []
        self.recompile_hazards: List[RecompileHazard] = []
        self.host_syncs: List[SyncHazard] = []
        # (function key, local name) -> JitSite, plus module-level bindings
        # keyed (relpath, name). Built by the jit scan, extended by the
        # factory-return and parameter propagation passes.
        self._bound: Dict[Tuple[str, str], JitSite] = {}
        self._module_bound: Dict[Tuple[str, str], JitSite] = {}
        self._factories: Dict[str, JitSite] = {}
        self._fn_by_node = {
            id(fn.node): fn for fn in program.functions.values()
        }
        self._collect_jit_sites()
        self._collect_axis_refs()
        self._propagate_bindings()
        self._scan_donation()
        self._scan_recompile()
        self._scan_host_sync()
        # The torch forms (module docstring).
        self.launch_sites: List[JitSite] = []
        self.torch_axis_refs: List[AxisRef] = []
        self.torch_recompile_hazards: List[RecompileHazard] = []
        self.torch_host_syncs: List[SyncHazard] = []
        self.launch_globs = tuple(getattr(config, "launch_sites", None)
                                  or ())
        self._scan_torch()

    # -- jit sites -----------------------------------------------------------

    def _jit_kind(self, mod, node: ast.AST) -> Optional[str]:
        """``node`` (a decorator or call func) names a jit wrapper? Returns
        the kind, unwrapping ``partial(jax.jit, ...)``."""
        qn = mod.qualname(node)
        if qn in _JIT_QNAMES or (qn or "").endswith(_JIT_TAILS) \
                or qn == "shard_map":
            tail = (qn or "").rsplit(".", 1)[-1]
            return {"jit": "jit", "pjit": "pjit", "pmap": "pmap",
                    "shard_map": "shard_map"}.get(tail, "jit")
        if isinstance(node, ast.Call):
            # Only the partial form unwraps: `jax.jit(f, ...)(x)` must NOT
            # register x — the inner call registers f on its own walk.
            fq = mod.qualname(node.func)
            if fq in ("functools.partial", "partial") and node.args:
                return self._jit_kind(mod, node.args[0])
            if not node.args:
                # `@jax.jit(static_argnames=...)` — a configured-decorator
                # call (keyword-only, so plain `jax.jit(f, ...)` wrap calls
                # never re-register through their own func).
                return self._jit_kind(mod, node.func)
        return None

    @staticmethod
    def _jit_kwargs(node: ast.AST) -> dict:
        """static/donate kwargs off the decorator or wrapping call (the
        ``partial`` call carries them in the decorator form)."""
        out = {"static_argnames": (), "static_argnums": (),
               "donate_argnums": (), "donate_conditional": False}
        if not isinstance(node, ast.Call):
            return out
        for kw in node.keywords:
            if kw.arg == "static_argnames":
                out["static_argnames"] = _str_tuple(kw.value) or ()
            elif kw.arg == "static_argnums":
                out["static_argnums"] = _int_tuple(kw.value) or ()
            elif kw.arg == "donate_argnums":
                value = kw.value
                if isinstance(value, ast.IfExp):
                    # `(0,) if donate else ()` — take the may-donate branch.
                    for branch in (value.body, value.orelse):
                        got = _int_tuple(branch)
                        if got:
                            out["donate_argnums"] = got
                            out["donate_conditional"] = True
                            break
                else:
                    out["donate_argnums"] = _int_tuple(value) or ()
        return out

    def _register_site(self, mod, kind: str, wrap_node: ast.AST,
                       target: Optional[ast.AST], name: str,
                       kwargs: dict) -> JitSite:
        fn = self._fn_by_node.get(id(target)) if target is not None else None
        def_lines: Tuple[int, ...] = ()
        def_module = None
        params: Tuple[str, ...] = ()
        if target is not None:
            def_module = mod.relpath
            lines = {target.lineno, wrap_node.lineno}
            for dec in getattr(target, "decorator_list", []):
                lines.add(dec.lineno)
            def_lines = tuple(sorted(lines))
            params = _params_of(target)
        site = JitSite(
            kind=kind, name=name, module=mod.relpath,
            line=wrap_node.lineno, col=wrap_node.col_offset,
            func_key=fn.key if fn else None,
            def_module=def_module, def_lines=def_lines,
            node=target, params=params,
            static_argnames=kwargs["static_argnames"],
            static_argnums=kwargs["static_argnums"],
            donate_argnums=kwargs["donate_argnums"],
            donate_conditional=kwargs["donate_conditional"],
        )
        self.jit_sites.append(site)
        return site

    @staticmethod
    def _nearest_def(mod, call: ast.Call, cands: List[ast.AST]):
        """Python scoping for the jitted callable's name when the module
        holds several same-named defs (two nested ``step`` functions):
        prefer a def in the call's own enclosing function, then the
        closest preceding def, then the last one."""
        if not cands:
            return None
        fn_kinds = (ast.FunctionDef, ast.AsyncFunctionDef)
        encl = mod.enclosing(call, fn_kinds)
        if encl is not None:
            local = [c for c in cands
                     if mod.enclosing(c, fn_kinds) is encl]
            if local:
                return local[-1]
        preceding = [c for c in cands if c.lineno < call.lineno]
        return (preceding or cands)[-1]

    def _collect_jit_sites(self) -> None:
        for mod in self.program.modules:
            defs_by_name: Dict[str, List[ast.AST]] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs_by_name.setdefault(node.name, []).append(node)
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        kind = self._jit_kind(mod, dec)
                        if kind:
                            self._register_site(
                                mod, kind, dec, node, node.name,
                                self._jit_kwargs(dec),
                            )
                elif isinstance(node, ast.Call):
                    kind = self._jit_kind(mod, node.func)
                    if not kind or not node.args:
                        continue
                    first = node.args[0]
                    if isinstance(first, ast.Lambda):
                        target, name = first, "<lambda>"
                    elif isinstance(first, ast.Name):
                        cands = defs_by_name.get(first.id, [])
                        target, name = self._nearest_def(mod, node, cands), \
                            first.id
                    else:
                        continue
                    site = self._register_site(
                        mod, kind, node, target, name,
                        self._jit_kwargs(node),
                    )
                    self._bind_result(mod, node, site)

    def _bind_result(self, mod, call: ast.Call, site: JitSite) -> None:
        """Track what the jit object is bound to: a local/module name
        (``step = jax.jit(f, ...)``) or a factory's return value."""
        parent = mod.parents.get(call)
        encl = mod.enclosing(call, (ast.FunctionDef, ast.AsyncFunctionDef))
        fn = self._fn_by_node.get(id(encl)) if encl is not None else None
        if isinstance(parent, ast.Assign) and parent.value is call \
                and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            name = parent.targets[0].id
            if fn is not None:
                self._bound[(fn.key, name)] = site
            else:
                self._module_bound[(mod.relpath, name)] = site
        elif isinstance(parent, ast.Return) and fn is not None:
            self._factories[fn.key] = site

    # -- axis references -----------------------------------------------------

    def _collect_axis_refs(self) -> None:
        for mod in self.program.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                qn = mod.qualname(node.func) or ""
                tail = qn.rsplit(".", 1)[-1]
                if tail == "PartitionSpec":
                    for arg in node.args:
                        elts = arg.elts if isinstance(
                            arg, (ast.Tuple, ast.List)) else [arg]
                        for e in elts:
                            if isinstance(e, ast.Constant) \
                                    and isinstance(e.value, str):
                                self.axis_refs.append(AxisRef(
                                    e.value, mod.relpath, e.lineno,
                                    e.col_offset, "PartitionSpec",
                                ))
                elif tail in _COLLECTIVES and (
                    qn.startswith("jax.") or "_compat" in qn or qn == tail
                ):
                    cands: List[ast.AST] = []
                    pos = _COLLECTIVES[tail]
                    if len(node.args) > pos:
                        cands.append(node.args[pos])
                    for kw in node.keywords:
                        if kw.arg == "axis_name":
                            cands.append(kw.value)
                    for cand in cands:
                        for axis in _str_tuple(cand) or ():
                            self.axis_refs.append(AxisRef(
                                axis, mod.relpath, cand.lineno,
                                cand.col_offset, f"collective {tail}",
                            ))

    # -- binding propagation -------------------------------------------------

    def _propagate_bindings(self) -> None:
        """Factory returns into assignment targets, then bound callables one
        call level into parameters — enough to follow
        ``train_step = make_train_step(...)`` into ``_train_loop``."""
        # A function that returns a NAME bound to a jit object is a factory
        # too (``jitted = jax.jit(step, ...); return jitted`` — the shape the
        # compile-sanitizer wrap guard produces).
        for fn in self.program.functions.values():
            if fn.key in self._factories:
                continue
            for node in self._walk_own(fn.node):
                if isinstance(node, ast.Return) \
                        and isinstance(node.value, ast.Name):
                    site = self._bound.get((fn.key, node.value.id))
                    if site is not None:
                        self._factories[fn.key] = site
                        break
        for fn in self.program.functions.values():
            mod = self.program.by_relpath.get(fn.module)
            if mod is None:
                continue
            for callee_key, call_node, _held in fn.calls:
                site = self._factories.get(callee_key)
                if site is None:
                    continue
                stmt = mod.statement_of(call_node)
                if isinstance(stmt, ast.Assign) and stmt.value is call_node \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    self._bound[(fn.key, stmt.targets[0].id)] = site
        # One level into parameters.
        param_bound: Dict[Tuple[str, str], JitSite] = {}
        for fn in self.program.functions.values():
            for callee_key, call_node, _held in fn.calls:
                callee = self.program.functions.get(callee_key)
                if callee is None:
                    continue
                pos = _pos_params(callee.node)
                for i, a in enumerate(call_node.args):
                    site = self._site_for_name(fn, a)
                    if site is not None and i < len(pos):
                        param_bound[(callee_key, pos[i])] = site
                for kw in call_node.keywords:
                    site = self._site_for_name(fn, kw.value)
                    if site is not None and kw.arg:
                        param_bound[(callee_key, kw.arg)] = site
        self._bound.update(param_bound)

    def _site_for_name(self, fn, node: ast.AST) -> Optional[JitSite]:
        if not isinstance(node, ast.Name):
            return None
        return self._bound.get((fn.key, node.id)) \
            or self._module_bound.get((fn.module, node.id))

    def _jit_calls_in(self, fn):
        """Yield ``(call_node, site)`` for every call in ``fn`` that invokes
        a known jit-wrapped callable: a bound local/param/module name, or a
        resolved edge to a decorated jitted function."""
        by_key = {
            s.func_key: s for s in self.jit_sites if s.func_key is not None
        }
        mod = self.program.by_relpath.get(fn.module)
        if mod is None:
            return
        seen = set()
        for callee_key, call_node, _held in fn.calls:
            site = by_key.get(callee_key)
            if site is not None:
                seen.add(id(call_node))
                yield call_node, site
        for node in self._walk_own(fn.node):
            if isinstance(node, ast.Call) and id(node) not in seen:
                site = self._site_for_name(fn, node.func)
                if site is not None:
                    yield node, site

    @staticmethod
    def _walk_own(node):
        """Walk a function body without descending into nested defs (they
        are their own FunctionInfo — same discipline as the concurrency
        model's body walk)."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            cur = stack.pop()
            yield cur
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(cur))

    # -- LDT1702: use-after-donate -------------------------------------------

    def _scan_donation(self) -> None:
        for fn in self.program.functions.values():
            mod = self.program.by_relpath.get(fn.module)
            if mod is None:
                continue
            for call, site in self._jit_calls_in(fn):
                if not site.donate_argnums:
                    continue
                for i in site.donate_argnums:
                    if i < len(call.args) \
                            and isinstance(call.args[i], ast.Name):
                        name = call.args[i].id
                        read = self._read_after(mod, fn, call, name)
                        if read is not None:
                            self.donate_hazards.append(DonateHazard(
                                module=fn.module, line=call.lineno,
                                col=call.col_offset, var=name,
                                read_line=read, func=fn.key,
                                callee=site.name,
                            ))

    @staticmethod
    def _binds(stmt: ast.AST, name: str) -> bool:
        """Does this statement rebind ``name`` at its top level?"""
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            targets = [stmt.target]
        flat: List[ast.AST] = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                flat.extend(t.elts)
            else:
                flat.append(t)
        for t in flat:
            if isinstance(t, ast.Starred):
                t = t.value
            if isinstance(t, ast.Name) and t.id == name:
                return True
        return False

    @staticmethod
    def _first_read(stmt: ast.AST, name: str) -> Optional[int]:
        """Line of the first read of ``name`` anywhere in ``stmt`` (any
        branch counts — a read on SOME path after a donate is the bug)."""
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id == name \
                    and isinstance(node.ctx, ast.Load):
                return node.lineno
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id == name:
                return node.lineno
        return None

    def _read_after(self, mod, fn, call: ast.Call,
                    name: str) -> Optional[int]:
        """First read of ``name`` on any path after the donating ``call``
        (the same statement-ordered CFG walk discipline as the LDT1201 leak
        scan): siblings after the call's statement, then each enclosing
        block's later siblings; climbing through a loop whose body never
        rebinds the name flags the call's own next-iteration read."""
        stmt = mod.statement_of(call)
        if self._binds(stmt, name):
            return None  # the result rebinds the donated name — refreshed
        cur: ast.AST = stmt
        while cur is not fn.node:
            parent = mod.parents.get(cur)
            if parent is None:
                return None
            for field in ("body", "orelse", "finalbody"):
                block = getattr(parent, field, None)
                if isinstance(block, list) and cur in block:
                    for later in block[block.index(cur) + 1:]:
                        read = self._first_read(later, name)
                        if read is not None:
                            return read
                        if self._binds(later, name):
                            return None
                    break
            if isinstance(parent, (ast.For, ast.AsyncFor, ast.While)):
                rebound = any(
                    self._binds(s, name) for s in ast.walk(parent)
                    if isinstance(s, ast.stmt)
                )
                if not rebound:
                    # Next iteration re-reads the donated name at the call.
                    return call.lineno
                return None  # rebound somewhere in the loop: assume fresh
            cur = parent
        return None

    # -- LDT1703: recompile hazards ------------------------------------------

    def _funneled(self, mod, expr: ast.AST) -> bool:
        """Does the derivation route through a declared quantized funnel
        (``static-funnels`` name tails — coeff_chunk, pack_rows_quantum,
        ...)? A funnel clamps the value to a short ladder, so the jit cache
        sees O(1) keys instead of one per batch."""
        if not self.static_funnels:
            return False
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                qn = mod.qualname(node.func) or ""
                tail = qn.rsplit(".", 1)[-1] if qn else (
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else ""
                )
                if any(fnmatch(tail, f) for f in self.static_funnels):
                    return True
        return False

    @staticmethod
    def _shape_or_len(expr: ast.AST, params=None) -> bool:
        """Does the expression read ``.shape`` or ``len()`` (of a parameter,
        when ``params`` is given)?"""
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and node.attr == "shape":
                if params is None or _base_name(node.value) in params:
                    return True
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "len" and node.args:
                if params is None or _base_name(node.args[0]) in params:
                    return True
        return False

    def _shape_derived_locals(self, mod, fn) -> Dict[str, int]:
        """name → assign line for locals derived from ``.shape``/``len()``
        without a funnel in the derivation."""
        out: Dict[str, int] = {}
        for node in self._walk_own(fn.node):
            if not (isinstance(node, ast.Assign) and node.value is not None):
                continue
            if self._funneled(mod, node.value) \
                    or not self._shape_or_len(node.value):
                continue
            for t in node.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for e in elts:
                    if isinstance(e, ast.Name):
                        out[e.id] = node.lineno
        return out

    def _in_content_paths(self, site: JitSite) -> bool:
        if site.def_module is None:
            return False
        bare = site.name
        key = site.func_key or bare
        for entry in self.content_paths:
            path_pat, _, fn_pat = entry.partition("::")
            if not fnmatch(site.def_module, path_pat):
                continue
            if not fn_pat or fnmatch(bare, fn_pat) or fnmatch(key, fn_pat) \
                    or fnmatch(key, f"*{fn_pat}"):
                return True
        return False

    def _scan_recompile(self) -> None:
        # Call-site form: shape/len-derived values into static positions.
        for fn in self.program.functions.values():
            mod = self.program.by_relpath.get(fn.module)
            if mod is None:
                continue
            derived = self._shape_derived_locals(mod, fn)

            def hazardous(expr: ast.AST) -> bool:
                if isinstance(expr, ast.Name):
                    if expr.id in derived:
                        return True
                if self._funneled(mod, expr):
                    return False
                return self._shape_or_len(expr)

            for call, site in self._jit_calls_in(fn):
                if not (site.static_argnames or site.static_argnums):
                    continue
                static_args: List[Tuple[str, ast.AST]] = []
                for kw in call.keywords:
                    if kw.arg and kw.arg in site.static_argnames:
                        static_args.append((kw.arg, kw.value))
                for i in site.static_argnums:
                    if i < len(call.args):
                        static_args.append((f"#{i}", call.args[i]))
                for label, expr in static_args:
                    if hazardous(expr):
                        self.recompile_hazards.append(RecompileHazard(
                            module=fn.module, line=call.lineno,
                            col=call.col_offset,
                            detail=(
                                f"batch-shape-derived value reaches static "
                                f"argument {label!r} of jitted "
                                f"{site.name!r}"
                            ),
                            func=fn.key, site=site,
                        ))
        # In-jit form: Python branches on parameter shapes inside jitted
        # content-path functions (shapes there vary per batch).
        for site in self.jit_sites:
            if site.node is None or not self._in_content_paths(site):
                continue
            mod = self.program.by_relpath.get(site.def_module)
            if mod is None:
                continue
            fn_key = site.func_key or site.name
            for node in self._walk_own(site.node):
                if isinstance(node, (ast.If, ast.While)) \
                        and self._shape_or_len(node.test, set(site.params)) \
                        and not self._funneled(mod, node.test):
                    self.recompile_hazards.append(RecompileHazard(
                        module=site.def_module, line=node.lineno,
                        col=node.col_offset,
                        detail=(
                            f"Python branch on a parameter shape inside "
                            f"jitted content-path function {site.name!r}"
                        ),
                        func=fn_key, site=site,
                    ))

    # -- LDT1704: hot-path host syncs ----------------------------------------

    def _device_names(self, mod, fn) -> set:
        """Fixpoint over assignments: names holding device values — results
        of jit-wrapped callables (bound names, resolved jitted defs, or a
        bare callable parameter invoked in a device-hot-path function:
        trainer-style step callbacks), jax.* calls, or values derived from
        either."""
        jit_keys = {s.func_key for s in self.jit_sites if s.func_key}
        edge_by_call = {id(c): k for k, c, _h in fn.calls}
        params = set(_params_of(fn.node))

        def device_call(node: ast.Call) -> bool:
            if edge_by_call.get(id(node)) in jit_keys:
                return True
            if self._site_for_name(fn, node.func) is not None:
                return True
            if isinstance(node.func, ast.Name) and node.func.id in params:
                return True  # step-callback parameter invoked directly
            qn = mod.qualname(node.func) or ""
            if qn in _HOST_METADATA_QNAMES:
                return False
            return qn.startswith(("jax.", "jax_"))

        assigns: List[Tuple[List[str], ast.AST]] = []
        for node in self._walk_own(fn.node):
            if isinstance(node, ast.Assign):
                names = []
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    names.extend(
                        e.id for e in elts if isinstance(e, ast.Name)
                    )
                assigns.append((names, node.value))
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name):
                assigns.append(([node.target.id], node.value))

        device: set = set()
        changed = True
        while changed:
            changed = False
            for names, value in assigns:
                if not names or set(names) <= device:
                    continue
                tainted = False
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Call) and device_call(sub):
                        tainted = True
                        break
                    if isinstance(sub, ast.Name) and sub.id in device \
                            and isinstance(sub.ctx, ast.Load):
                        tainted = True
                        break
                if tainted:
                    before = len(device)
                    device.update(names)
                    changed = changed or len(device) > before
        return device

    def _scan_host_sync(self) -> None:
        if not self.device_hot_paths:
            return
        jitted_nodes = {
            id(s.node) for s in self.jit_sites if s.node is not None
        }
        for fn in self.program.functions.values():
            if not _match_paths(fn.module, self.device_hot_paths):
                continue
            if id(fn.node) in jitted_nodes:
                continue  # inside-jit syncs are LDT102's domain
            bare = fn.key.rsplit(".", 1)[-1]
            if self.sync_funnels \
                    and _match_func_globs(fn.key, bare, self.sync_funnels):
                continue
            mod = self.program.by_relpath.get(fn.module)
            if mod is None:
                continue
            device = self._device_names(mod, fn)
            if not device:
                continue
            for node in self._walk_own(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                qn = mod.qualname(node.func) or ""
                expr = None
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "item" and not node.args \
                        and _base_name(node.func.value) in device:
                    expr = f"{_base_name(node.func.value)}.item()"
                elif qn in _SYNC_COERCIONS and len(node.args) == 1 \
                        and _base_name(node.args[0]) in device:
                    expr = f"{qn}({_base_name(node.args[0])})"
                elif qn in _SYNC_QNAMES and node.args \
                        and _base_name(node.args[0]) in device:
                    expr = f"{qn}({_base_name(node.args[0])})"
                if expr is not None:
                    self.host_syncs.append(SyncHazard(
                        module=fn.module, line=node.lineno,
                        col=node.col_offset, expr=expr, func=fn.key,
                    ))

    # -- torch forms ---------------------------------------------------------

    def _scan_torch(self) -> None:
        torch_mods = [m for m in self.program.modules if _torch_module(m)]
        if not torch_mods:
            return
        torch_paths = {m.relpath for m in torch_mods}
        for fn in self.program.functions.values():
            if fn.module in torch_paths and self._is_launch_site(fn):
                mod = self.program.by_relpath[fn.module]
                node = fn.node
                lines = {node.lineno}
                for dec in getattr(node, "decorator_list", []):
                    lines.add(dec.lineno)
                self.launch_sites.append(JitSite(
                    kind="launch", name=fn.key.rsplit(".", 1)[-1],
                    module=mod.relpath, line=node.lineno,
                    col=node.col_offset, func_key=fn.key,
                    def_module=mod.relpath, def_lines=tuple(sorted(lines)),
                    node=node, params=_params_of(node), static_argnames=(),
                    static_argnums=(), donate_argnums=(),
                    donate_conditional=False,
                ))
        for mod in torch_mods:
            self._collect_torch_axis_refs(mod)
        by_key = {s.func_key: s for s in self.launch_sites}
        for fn in self.program.functions.values():
            if fn.module not in torch_paths:
                continue
            mod = self.program.by_relpath[fn.module]
            self._scan_torch_recompile(mod, fn, by_key)
            if _match_paths(fn.module, self.device_hot_paths):
                bare = fn.key.rsplit(".", 1)[-1]
                if not (self.sync_funnels and _match_func_globs(
                        fn.key, bare, self.sync_funnels)):
                    self._scan_torch_sync(mod, fn)

    def _is_launch_site(self, fn) -> bool:
        bare = fn.key.rsplit(".", 1)[-1]
        for entry in self.launch_globs:
            path_pat, _, fn_pat = entry.partition("::")
            if fnmatch(fn.module, path_pat) and (
                not fn_pat or _match_func_globs(fn.key, bare, (fn_pat,))
            ):
                return True
        return False

    def _collect_torch_axis_refs(self, mod) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in _TOPOLOGY_MAPS:
                key = node.slice
                if isinstance(key, ast.Constant) \
                        and isinstance(key.value, str):
                    self.torch_axis_refs.append(AxisRef(
                        key.value, mod.relpath, key.lineno, key.col_offset,
                        f"topology {node.value.attr}[...]",
                    ))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg and (kw.arg == "axis"
                                   or kw.arg.endswith("_axis")) \
                            and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str):
                        self.torch_axis_refs.append(AxisRef(
                            kw.value.value, mod.relpath, kw.value.lineno,
                            kw.value.col_offset, f"keyword {kw.arg}=",
                        ))

    def _scan_torch_recompile(self, mod, fn, by_key) -> None:
        calls = [(by_key[k], c) for k, c, _h in fn.calls if k in by_key]
        if not calls:
            return
        # Python scalars derived from .shape/len() that make a new shape:
        # not a tensor, and not a dimension copied unchanged.
        params = set(_params_of(fn.node))
        derived = set()
        for node in self._walk_own(fn.node):
            if isinstance(node, ast.Assign) \
                    and self._shape_or_len(node.value) \
                    and not self._funneled(mod, node.value) \
                    and not _passthrough(node.value) \
                    and not _torch_valued(mod, node.value, set(), params):
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    derived.update(e.id for e in elts
                                   if isinstance(e, ast.Name))

        def shaped(expr: ast.AST) -> bool:
            if self._funneled(mod, expr) or _passthrough(expr):
                return False
            if any(isinstance(n, ast.Name) and n.id in derived
                   for n in ast.walk(expr)):
                return True
            return self._shape_or_len(expr) \
                and not _torch_valued(mod, expr, set(), params)

        # Locals holding a tensor whose size came from a shape-derived
        # value: a constructor, reshape or slice with such a size.
        sized: Dict[str, int] = {}
        for node in self._walk_own(fn.node):
            if isinstance(node, ast.Assign) and _sizes_tensor(
                    mod, node.value, shaped):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        sized[t.id] = node.lineno
        for site, call in calls:
            args = list(call.args) + [kw.value for kw in call.keywords]
            for arg in args:
                label = None
                if isinstance(arg, ast.Name) and arg.id in sized:
                    label = f"tensor {arg.id!r} sized from a batch shape"
                elif _sizes_tensor(mod, arg, shaped):
                    label = "a tensor sized from a batch shape"
                elif shaped(arg):
                    label = "a batch-shape-derived value"
                if label is None:
                    continue
                self.torch_recompile_hazards.append(RecompileHazard(
                    module=fn.module, line=call.lineno, col=call.col_offset,
                    detail=(f"{label} reaches launch site {site.name!r} "
                            f"({site.module}:{site.line})"),
                    func=fn.key, site=site,
                ))
                break

    def _torch_device_names(self, mod, fn) -> set:
        """Names holding torch values: results of ``torch.*`` calls (not
        host metadata), ``.to()``/``.cuda()``, a called callable parameter,
        parameters annotated as tensors, and values derived from them
        (never through ``.shape``/``.size()``/... metadata)."""
        params = set(_params_of(fn.node))
        device: set = set()
        args = fn.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = a.annotation
            if ann is not None and "Tensor" in ast.unparse(ann):
                device.add(a.arg)
        assigns: List[Tuple[List[str], ast.AST]] = []
        for node in self._walk_own(fn.node):
            if isinstance(node, ast.Assign):
                names = []
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    names.extend(
                        e.id for e in elts if isinstance(e, ast.Name))
                assigns.append((names, node.value))
        changed = True
        while changed:
            changed = False
            for names, value in assigns:
                if names and not set(names) <= device and _torch_valued(
                        mod, value, device, params):
                    device.update(names)
                    changed = True
        return device

    def _scan_torch_sync(self, mod, fn) -> None:
        device = self._torch_device_names(mod, fn)
        params = set(_params_of(fn.node))
        for node in self._walk_own(fn.node):
            if not isinstance(node, ast.Call):
                continue
            qn = mod.qualname(node.func) or ""
            expr = None
            if qn == "torch.cuda.synchronize":
                expr = "torch.cuda.synchronize()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TORCH_SYNC_METHODS \
                    and not node.args and _torch_valued(
                        mod, node.func.value, device, params):
                expr = f"{_short_src(node.func.value)}.{node.func.attr}()"
            elif (qn in _SYNC_COERCIONS or qn in _SYNC_QNAMES) \
                    and len(node.args) >= 1 and _torch_valued(
                        mod, node.args[0], device, params):
                expr = f"{qn}({_short_src(node.args[0])})"
            if expr is not None:
                self.torch_host_syncs.append(SyncHazard(
                    module=fn.module, line=node.lineno, col=node.col_offset,
                    expr=expr, func=fn.key,
                ))

    def enclosing_function(self, relpath: str, line: int):
        """The innermost function of ``relpath`` whose body spans
        ``line``, or None: the join of a witness transfer site onto the
        declared sync funnels."""
        best = None
        for fn in self.program.functions.values():
            if fn.module != relpath:
                continue
            node = fn.node
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end and (
                    best is None or node.lineno >= best.node.lineno):
                best = fn
        return best

    def at_sync_funnel(self, site: str) -> bool:
        """Is the witness site ``path:line`` inside a declared sync
        funnel?"""
        relpath, _, line = site.rpartition(":")
        try:
            fn = self.enclosing_function(relpath, int(line))
        except ValueError:
            return False
        if fn is None:
            return False
        return _match_func_globs(fn.key, fn.key.rsplit(".", 1)[-1],
                                 self.sync_funnels)

    # -- runtime witness -----------------------------------------------------

    def witness_receipt(self, witness: dict) -> dict:
        """The corroboration summary the CI compile-witness stage asserts
        on: how much of the runtime compile evidence maps onto static jit
        sites, and the transfer-event totals."""
        compiles = witness.get("compiles", {})
        static_sites = set()
        for site in self.jit_sites + self.launch_sites:
            static_sites.update(site.witness_sites())
        matched = [s for s in compiles if s in static_sites]
        transfers = witness.get("transfers", {})

        def _total(direction: str) -> int:
            return sum(
                int(entry.get("count", 0))
                for entry in transfers.get(direction, {}).values()
            )

        receipt = {
            "runtime_sites": len(compiles),
            "matched_sites": len(matched),
            "recompiled_sites": sum(
                1 for s in matched
                if int(compiles[s].get("post_warmup", 0)) > 0
            ),
            "h2d_events": _total("h2d"),
            "d2h_events": _total("d2h"),
        }
        if self.launch_sites:
            # The torch witness: D2H events inside a declared sync funnel
            # (the trainer's drain points), against all D2H events.
            receipt["d2h_at_funnels"] = sum(
                int(entry.get("count", 0))
                for site, entry in transfers.get("d2h", {}).items()
                if self.at_sync_funnel(site)
            )
        return receipt

    def witness_verdict(self, site: JitSite, witness: dict) -> str:
        """"reproduced" | "pruned" | "unknown" for an LDT1703 hazard whose
        jit site the compile witness may have exercised. Strict-evidence
        discipline: an untouched site proves nothing."""
        compiles = witness.get("compiles", {})
        entries = [
            compiles[s] for s in site.witness_sites() if s in compiles
        ]
        if not entries:
            return "unknown"
        if any(int(e.get("post_warmup", 0)) > 0 for e in entries):
            return "reproduced"
        if any(int(e.get("calls", 0)) > 1 for e in entries):
            # More than the warmup call, zero new signatures after it: the
            # predicted steady-state recompile demonstrably did not happen.
            return "pruned"
        return "unknown"


_TOPOLOGY_MAPS = ("group", "index", "size", "ranks", "strides")
_TORCH_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# Tensor metadata: reading it never waits for the device.
_TORCH_META_ATTRS = {"shape", "dtype", "device", "is_cuda", "ndim",
                     "requires_grad", "layout"}
_TORCH_META_METHODS = {"size", "dim", "numel", "nelement", "stride",
                       "element_size", "is_contiguous", "data_ptr",
                       "get_device", "ndimension"}
# torch calls whose results live on the host.
_TORCH_HOST_QNAMES = {"torch.device", "torch.Generator", "torch.is_tensor",
                      "torch.get_default_dtype", "torch.Size", "torch.finfo",
                      "torch.iinfo", "torch.no_grad", "torch.manual_seed"}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                        "torch.utils.", "torch.nn.", "torch.autograd.",
                        "torch.profiler.")
# Calls that make a tensor whose size is an argument, and reshapes.
_TORCH_SIZED_CTORS = {"empty", "zeros", "ones", "full", "arange", "randn",
                      "rand", "randint", "new_empty", "new_zeros",
                      "new_ones", "new_full", "view", "reshape", "expand",
                      "narrow", "repeat"}


def _torch_module(mod) -> bool:
    """A module of torch code: it imports torch and nothing of JAX."""
    names = set(mod.imports.values())
    tops = {n.split(".")[0] for n in names}
    return "torch" in tops and not tops & {"jax", "flax", "jaxlib"}


def _short_src(node: ast.AST) -> str:
    text = ast.unparse(node)
    return text if len(text) <= 40 else text[:37] + "..."


# torch calls that make a tensor: on the card only when told (``device=``)
# or when made from a value already there.
_TORCH_CTORS = {"tensor", "as_tensor", "asarray", "from_numpy", "empty",
                "zeros", "ones", "full", "arange", "rand", "randn",
                "randint", "randperm", "linspace", "eye"}


def _cuda_device(mod, node: ast.AST) -> bool:
    """A CUDA device argument: a ``"cuda..."`` literal, ``torch.device(
    "cuda"...)``, or a name or attribute that names a device."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        if mod.qualname(node.func) == "torch.device" and node.args:
            return _cuda_device(mod, node.args[0])
        return False
    name = node.id if isinstance(node, ast.Name) else (
        node.attr if isinstance(node, ast.Attribute) else None)
    if name is None:
        return False
    name = name.lower()
    return name in ("device", "dev") or name.endswith("_device") \
        or name.startswith("cuda")


def _torch_valued(mod, expr: ast.AST, device: set, params: set) -> bool:
    """Does ``expr`` hold a value that may live on the card? Tensor
    metadata (``.shape``, ``.size()``, ``len()``...) prunes the walk; a
    constructor counts only with a ``device=`` or a card operand, ``.to``
    only with a CUDA device or a card receiver."""
    def walk(node) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _TORCH_META_ATTRS:
            return False
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        if isinstance(node, ast.Name):
            return node.id in device and isinstance(node.ctx, ast.Load)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _TORCH_META_METHODS:
                return False
            if isinstance(func, ast.Name) and func.id == "len":
                return False
            if isinstance(func, ast.Name) and func.id in params:
                return True  # a step callback parameter invoked directly
            if isinstance(func, ast.Attribute) and func.attr == "cuda":
                return True
            if isinstance(func, ast.Attribute) and func.attr == "to":
                targets = list(node.args[:1]) + [
                    kw.value for kw in node.keywords if kw.arg == "device"]
                if any(_cuda_device(mod, t) for t in targets):
                    return True
                return walk(func.value)
            qn = mod.qualname(func) or ""
            if qn.startswith("torch."):
                tail = qn.rsplit(".", 1)[-1]
                if qn in _TORCH_HOST_QNAMES \
                        or qn.startswith(_TORCH_HOST_PREFIXES):
                    return False
                if tail in _TORCH_CTORS and qn == f"torch.{tail}":
                    return any(kw.arg == "device" for kw in node.keywords) \
                        or any(walk(a) for a in node.args)
                return True
        return any(walk(child) for child in ast.iter_child_nodes(node))

    return walk(expr)


def _passthrough(expr: ast.AST) -> bool:
    """A size copied from another tensor unchanged (``x.shape``,
    ``x.shape[i]``, ``x.shape[a:b]``, ``x.size(i)``): no new shape."""
    if isinstance(expr, ast.Attribute) and expr.attr == "shape":
        return True
    if isinstance(expr, ast.Subscript):
        return _passthrough(expr.value)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "size":
        return True
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_passthrough(e) or isinstance(e, ast.Constant)
                   for e in expr.elts)
    return False


def _sizes_tensor(mod, expr: ast.AST, shaped) -> bool:
    """Is ``expr`` a tensor made or reshaped with a shape-derived size
    (``torch.zeros(n, ...)``, ``x.view(n, -1)``, ``x[:n]``)?"""
    if isinstance(expr, ast.Call):
        func = expr.func
        tail = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if tail in _TORCH_SIZED_CTORS:
            qn = mod.qualname(func) or ""
            if isinstance(func, ast.Attribute) or qn.startswith("torch."):
                sizes = list(expr.args) + [
                    kw.value for kw in expr.keywords if kw.arg == "size"]
                return any(shaped(a) for a in sizes)
        return False
    if isinstance(expr, ast.Subscript):
        sl = expr.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for part in parts:
            if isinstance(part, ast.Slice):
                bounds = [b for b in (part.lower, part.upper, part.step) if b]
                if any(shaped(b) for b in bounds):
                    return True
    return False


def build_mesh_model(program: ProgramInfo, config) -> MeshModel:
    """Build (or reuse) the device-semantics model for this run's
    ProgramInfo — memoized on the program instance so the LDT17xx rules,
    the ``--compile-witness`` receipt, and ``ldt graph --mesh`` share ONE
    pass (the same single-build contract as the ownership model)."""
    cached = getattr(program, "_mesh_model", None)
    if cached is not None:
        return cached
    model = MeshModel(program, config)
    program._mesh_model = model
    return model
