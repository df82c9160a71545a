"""Analyzer core: module model, rule registry, suppressions, baseline.

The distributed-training bug classes this subsystem gates — nondeterministic
plan construction, host syncs inside jitted step functions, leaked workers,
unbounded queues — all share a property: they pass every fast test and then
silently corrupt a scaling run days later. A lint pass makes them visible at
commit time instead. The design mirrors the pluggable-rule linters (flake8,
ruff) at a fraction of the machinery:

* :class:`ModuleInfo` — one parsed source file: AST with parent links, an
  import-alias map (``np`` → ``numpy``), raw lines, and per-line suppression
  state (``# ldt: ignore[LDT001]``).
* :class:`Rule` — subclasses register with :func:`register`; a rule checks
  either one module at a time (``check_module``) or the whole project at once
  (``check_project`` — cross-module invariants like protocol-constant
  consistency).
* :class:`Finding` — one violation, with a line-content fingerprint so the
  baseline survives line drift.
* Baseline — grandfathered findings stored in a JSON file; ``ldt check``
  fails only on findings NOT in the baseline, so the gate can be adopted on
  an imperfect codebase and ratcheted down.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Finding",
    "ModuleInfo",
    "Rule",
    "register",
    "all_rules",
    "analyze",
    "analyze_project",
    "parse_modules",
    "load_baseline",
    "write_baseline",
    "fingerprint",
    "split_new_findings",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a specific source location.

    ``witness_pruned`` is set (never by hand — by the LDT1001 witness
    cross-check) when runtime lock-order evidence contradicts the static
    inference: the finding still renders (flagged) but does not fail the
    gate and never enters a baseline.
    """

    rule: str  # "LDT001"
    path: str  # root-relative posix path
    line: int  # 1-based
    col: int  # 0-based
    message: str
    witness_pruned: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"


_SUPPRESS_RE = re.compile(
    r"#\s*ldt:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?"
    r"(?:\s*(?:--|—)\s*(?P<reason>\S.*))?"
)

# The cross-module rules: their findings assert whole-program properties
# (a deadlock cycle, a cross-thread race, a leak-on-path, taint into a
# content computation, a payload field one peer forgot), so an unexplained
# per-line ignore is exactly the "trust me" no reader can check.
# Suppressions for the concurrency (LDT10xx), ownership (LDT12xx), purity
# (LDT13xx), wire-protocol (LDT14xx), and device-semantics (LDT17xx)
# families require a reason string:
#     # ldt: ignore[LDT1002] -- GIL-atomic monotonic cursor, torn reads ok
_REASON_REQUIRED_RE = re.compile(r"LDT1[02347]\d\d$")


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, tuple]:
    """Per-line suppressions: line number → ``(rules, reason)`` where
    ``rules`` is a set of rule ids or ``None`` meaning "every rule" (bare
    ``# ldt: ignore``), and ``reason`` is the free text after ``--`` (or
    ``None`` when absent — LDT10xx rules refuse reasonless ignores)."""
    out: Dict[int, tuple] = {}
    for i, text in enumerate(lines, start=1):
        if "ldt:" not in text:  # cheap pre-filter
            continue
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        reason = m.group("reason")
        if rules is not None:
            rules = {r.strip().upper() for r in rules.split(",") if r.strip()}
        out[i] = (rules, reason.strip() if reason else None)
    return out


class ModuleInfo:
    """A parsed source file plus the derived maps every rule needs."""

    def __init__(self, root: str, relpath: str, source: str):
        self.root = root
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.Module] = None
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source, filename=relpath)
        except SyntaxError as exc:
            self.syntax_error = exc
        self.suppressions = _parse_suppressions(self.lines)
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.imports: Dict[str, str] = {}
        if self.tree is not None:
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self.parents[child] = parent
            self._collect_imports()

    # -- identity ----------------------------------------------------------

    @property
    def dotted_name(self) -> str:
        """``pkg/sub/mod.py`` → ``pkg.sub.mod`` (``__init__`` → ``pkg.sub``)."""
        mod = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        parts = mod.split("/")
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    @property
    def package(self) -> str:
        """The package a level-1 relative import resolves against: for an
        ``__init__.py`` that is the package itself (its dotted name), for a
        regular module it is the parent."""
        if self.relpath.endswith("__init__.py"):
            return self.dotted_name
        return (
            self.dotted_name.rsplit(".", 1)[0]
            if "." in self.dotted_name else ""
        )

    def _collect_imports(self) -> None:
        """Alias → absolute dotted module/symbol map. Relative imports are
        resolved against this module's package so cross-module rules can
        match ``from . import protocol as P`` to the real protocol file."""
        assert self.tree is not None
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:  # `import numpy.random as npr`
                        self.imports[alias.asname] = alias.name
                    else:  # `import numpy.random` binds the top name only
                        top = alias.name.split(".")[0]
                        self.imports[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: climb from this module's package
                    pkg_parts = self.package.split(".") if self.package else []
                    climb = node.level - 1
                    if climb:
                        pkg_parts = pkg_parts[: -climb or None]
                    base = ".".join(pkg_parts + ([base] if base else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.imports[alias.asname or alias.name] = (
                        f"{base}.{alias.name}" if base else alias.name
                    )

    # -- helpers for rules -------------------------------------------------

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with the leading alias
        resolved through the import map: ``np.random.shuffle`` →
        ``numpy.random.shuffle``. ``None`` for non-name expressions."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        parts[0] = self.imports.get(parts[0], parts[0])
        return ".".join(parts)

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        """Nearest ancestor of one of ``kinds`` (a class or tuple of AST
        node classes), or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def statement_of(self, node: ast.AST) -> ast.AST:
        """The innermost statement containing ``node``."""
        cur = node
        while not isinstance(cur, ast.stmt):
            parent = self.parents.get(cur)
            if parent is None:
                return cur
            cur = parent
        return cur

    def suppressed(self, finding: Finding) -> bool:
        entry = self.suppressions.get(finding.line)
        if entry is None:
            return False
        rules, reason = entry
        if rules is not None and finding.rule not in rules:
            return False
        if _REASON_REQUIRED_RE.match(finding.rule) and not reason:
            # A bare ignore on an LDT10xx finding is ineffective by design:
            # the finding stays live, so the lint fails until the ignore
            # carries a `-- reason`.
            return False
        return True

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Rule:
    """Base class. Subclass, set ``id``/``name``/``description`` (and
    ``family`` — the ``rule_family`` the JSON reporter emits), implement
    ``check_module``, ``check_project``, and/or ``check_program``, decorate
    with ``@register``."""

    id: str = ""
    name: str = ""
    description: str = ""
    family: str = "general"

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        return ()

    def check_project(
        self, modules: Sequence[ModuleInfo], config
    ) -> Iterable[Finding]:
        return ()

    def check_program(self, program, config) -> Iterable[Finding]:
        """Cross-module rules over the shared concurrency model
        (:class:`~.concmodel.ProgramInfo`) — built ONCE per run and handed
        to every rule that overrides this, instead of each rule re-walking
        every AST."""
        return ()


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global rule registry."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    # Importing the rules package populates the registry exactly once.
    from . import rules  # noqa: F401

    return dict(_REGISTRY)


# -- analysis driver -------------------------------------------------------


def _iter_py_files(root: str, paths: Sequence[str], exclude: Sequence[str]):
    """Yield root-relative posix paths of .py files under ``paths``."""
    seen = set()
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full) and full.endswith(".py"):
            candidates = [p]
        elif os.path.isdir(full):
            candidates = []
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        rel = os.path.relpath(
                            os.path.join(dirpath, fn), root
                        )
                        candidates.append(rel.replace(os.sep, "/"))
        else:
            continue
        for rel in candidates:
            rel = rel.replace(os.sep, "/")
            if rel in seen:
                continue
            if any(fnmatch.fnmatch(rel, pat) for pat in exclude):
                continue
            seen.add(rel)
            yield rel


def analyze(root: str, config) -> List[Finding]:
    """Parse every configured file and run every enabled rule.

    Returns findings sorted by (path, line, rule), with per-line
    ``# ldt: ignore`` suppressions already applied. Files that fail to parse
    produce an LDT000 finding (an unparseable file cannot be checked, which
    is itself a gate failure) and are skipped by the rules.
    """
    return analyze_project(root, config)[0]


# Parse cache: (root, relpath, mtime_ns, size) → ModuleInfo. One `ldt
# check` run parses each file exactly once already; this carries the
# parses ACROSS runs in the same process (the test suite runs the
# full-repo analysis half a dozen times; the CLI pays one stat per file on
# a warm cache). ModuleInfo is never mutated after construction, so
# sharing is safe. Root and relpath are part of the key deliberately: a
# ModuleInfo's identity (its reported path, its dotted name, every
# relpath-keyed config match) depends on the root it was loaded under —
# the same file analyzed from a different root must be a different entry.
_MODULE_CACHE: Dict[tuple, ModuleInfo] = {}
_MODULE_CACHE_MAX = 1024


def _load_module(root: str, rel: str) -> ModuleInfo:
    full = os.path.join(root, rel)
    try:
        st = os.stat(full)
        key = (os.path.abspath(root), rel, st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        cached = _MODULE_CACHE.get(key)
        if cached is not None:
            return cached
    with open(full, encoding="utf-8") as f:
        source = f.read()
    mod = ModuleInfo(root, rel, source)
    if key is not None:
        if len(_MODULE_CACHE) >= _MODULE_CACHE_MAX:
            _MODULE_CACHE.clear()
        _MODULE_CACHE[key] = mod
    return mod


def parse_modules(root: str, config):
    """Parse (or cache-hit) every configured file WITHOUT running rules —
    ``(modules, findings, files_checked)`` where findings are the LDT000
    parse failures. ``ldt graph`` uses this directly: it needs the module
    set for the concurrency model, not a lint pass."""
    modules: List[ModuleInfo] = []
    findings: List[Finding] = []
    files_checked = 0
    for rel in _iter_py_files(root, config.paths, config.exclude):
        files_checked += 1
        try:
            mod = _load_module(root, rel)
        except OSError as exc:
            findings.append(Finding("LDT000", rel, 1, 0, f"unreadable: {exc}"))
            continue
        if mod.syntax_error is not None:
            findings.append(
                Finding(
                    "LDT000", rel, mod.syntax_error.lineno or 1, 0,
                    f"syntax error: {mod.syntax_error.msg}",
                )
            )
            continue
        modules.append(mod)
    return modules, findings, files_checked


def analyze_project(root: str, config, timing: Optional[dict] = None):
    """:func:`analyze` plus the parsed modules and total file count —
    ``(findings, modules, files_checked)``. The CLI uses the extras for
    reporting (line text, counts) without re-reading anything. ``timing``
    (a dict, filled in place) receives ``wall_ms`` / ``parse_ms`` for the
    ``--json`` report."""
    import time as _time

    t_start = _time.perf_counter()
    modules, findings, files_checked = parse_modules(root, config)
    t_parsed = _time.perf_counter()

    rules = {
        rid: rule for rid, rule in all_rules().items()
        if rid not in config.disable
    }
    by_path = {m.relpath: m for m in modules}
    # The cross-module models are built at most ONCE per run and shared by
    # every program-level rule: ProgramInfo (LDT1001-1003) and, layered on
    # top of it without re-walking any AST, the ownership/purity model
    # (LDT1201-1203, LDT1301). Per-family build time is recorded so the
    # --json report can prove the single-pass contract holds.
    program = None
    if any(
        type(rule).check_program is not Rule.check_program
        for rule in rules.values()
    ):
        from .concmodel import build_program

        t0 = _time.perf_counter()
        program = build_program(modules, config)
        t1 = _time.perf_counter()
        model_ms = {"concurrency": round((t1 - t0) * 1e3, 3)}
        if any(
            getattr(rule, "uses_proto_model", False)
            for rule in rules.values()
        ):
            from .protomodel import build_proto_model

            tp = _time.perf_counter()
            proto = build_proto_model(program, config)
            model_ms["protocol"] = round(
                (_time.perf_counter() - tp) * 1e3, 3
            )
            wire = getattr(config, "wire_witness", None)
            if wire is not None and timing is not None:
                # The corroboration receipt the CI wire-witness stage
                # asserts on: how much of the runtime (msg, field)
                # evidence maps onto the static schema.
                timing["wire_witness"] = proto.witness_receipt(wire)
        if any(
            getattr(rule, "uses_owner_model", False)
            for rule in rules.values()
        ):
            from .ownermodel import build_owner_model

            t_own = _time.perf_counter()
            owner = build_owner_model(program, config)
            model_ms["ownership"] = round(
                (_time.perf_counter() - t_own) * 1e3, 3
            )
            witness = getattr(config, "leak_witness", None)
            if witness is not None and timing is not None:
                # The corroboration receipt the CI leak-witness stage
                # asserts on: how much of the runtime evidence maps onto
                # static acquire sites the model knows.
                static_sites = owner.acquire_sites()
                wsites = witness.get("sites", {})
                timing["leak_witness"] = {
                    "runtime_sites": len(wsites),
                    "matched_sites": sum(
                        1 for s in wsites if s in static_sites
                    ),
                    "leaked_sites": sum(
                        1 for v in wsites.values()
                        if int(v.get("leaked", 0)) > 0
                    ),
                }
        if any(
            getattr(rule, "uses_mesh_model", False)
            for rule in rules.values()
        ):
            from .meshmodel import build_mesh_model

            t_mesh = _time.perf_counter()
            mesh = build_mesh_model(program, config)
            model_ms["mesh"] = round(
                (_time.perf_counter() - t_mesh) * 1e3, 3
            )
            compile_w = getattr(config, "compile_witness", None)
            if compile_w is not None and timing is not None:
                # The corroboration receipt the CI compile-witness stage
                # asserts on: how much of the runtime compile/transfer
                # evidence maps onto static jit sites.
                timing["compile_witness"] = mesh.witness_receipt(compile_w)
        if timing is not None:
            timing["model_build_ms"] = model_ms
    for rule in rules.values():
        for mod in modules:
            findings.extend(rule.check_module(mod, config))
        findings.extend(rule.check_project(modules, config))
        if program is not None and (
            type(rule).check_program is not Rule.check_program
        ):
            findings.extend(rule.check_program(program, config))

    kept = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    if timing is not None:
        t_end = _time.perf_counter()
        timing["parse_ms"] = round((t_parsed - t_start) * 1e3, 3)
        timing["wall_ms"] = round((t_end - t_start) * 1e3, 3)
    return kept, modules, files_checked


# -- baseline --------------------------------------------------------------


def fingerprint(finding: Finding, line_text: str) -> str:
    """Stable id for a baseline entry: rule + path + normalized line content
    (NOT the line number, so pure line drift never un-grandfathers a
    finding). Two identical violations on identical lines in one file
    collapse to one fingerprint — acceptable: fixing one of them still
    leaves the fingerprint live, and fixing both retires it."""
    h = hashlib.sha256(
        f"{finding.rule}|{finding.path}|{' '.join(line_text.split())}".encode()
    )
    return h.hexdigest()[:16]


def _fingerprints(findings: Sequence[Finding], by_path) -> List[str]:
    out = []
    for f in findings:
        mod = by_path.get(f.path)
        text = mod.line_text(f.line) if mod is not None else ""
        out.append(fingerprint(f, text))
    return out


def load_baseline(path: str) -> set:
    """Fingerprint set from a baseline file; empty when absent."""
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {entry["fingerprint"] for entry in data.get("findings", [])}


def write_baseline(
    path: str,
    findings: Sequence[Finding],
    root: str,
    modules: Optional[Sequence[ModuleInfo]] = None,
) -> None:
    """Grandfather the current findings: future runs fail only on new ones.
    ``modules`` (from :func:`analyze_project`) supplies line text without
    re-reading files; disk is the fallback for paths not in it."""
    by_path = {m.relpath: m for m in (modules or ())}
    entries = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None:
            text = mod.line_text(f.line)
        else:
            try:
                with open(os.path.join(root, f.path),
                          encoding="utf-8") as fh:
                    lines = fh.read().splitlines()
                text = lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
            except OSError:
                text = ""
        entries.append(
            {
                "fingerprint": fingerprint(f, text),
                "rule": f.rule,
                "path": f.path,
                "message": f.message,
            }
        )
    # Atomic replace (the LDT901 discipline): the baseline is state every
    # later `ldt check` trusts — a crash mid-write must leave the previous
    # baseline, not a torn JSON that fails the gate everywhere. Deliberate
    # duplication of utils/checkpoint.py:atomic_write_json: this module
    # must stay stdlib-only (the gate runs standalone even when the
    # training package — and its jax import — fails to load).
    import tempfile

    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)), prefix=".tmp-baseline-"
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "findings": entries}, f, indent=2)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def split_new_findings(
    findings: Sequence[Finding],
    baseline: set,
    root: str,
    modules: Optional[Sequence[ModuleInfo]] = None,
) -> tuple:
    """(new, grandfathered) relative to a baseline fingerprint set.
    ``modules`` (from :func:`analyze_project`) supplies line text without
    re-reading files; disk is the fallback for paths not in it (LDT000)."""
    new, old = [], []
    cache: Dict[str, List[str]] = {
        m.relpath: m.lines for m in (modules or ())
    }
    for f in findings:
        if f.path not in cache:
            try:
                with open(os.path.join(root, f.path), encoding="utf-8") as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = []
        lines = cache[f.path]
        text = lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        (old if fingerprint(f, text) in baseline else new).append(f)
    return new, old
