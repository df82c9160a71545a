"""``ldt check`` / ``ldt graph`` — the distributed-training lint CLI.

``check``: exit status is the gate contract — 0 when no NEW findings
(relative to the baseline, when one exists), 1 when new findings are
reported, 2 on usage errors. ``--update-baseline`` grandfathers the current
findings so the gate can be adopted incrementally and ratcheted down.
``--lock-witness`` feeds a runtime lock-order witness (emitted by the test
suite under ``LDT_LOCK_SANITIZER=1``) into the LDT1001 cross-check:
observed orderings corroborate static cycles, contradicted ones prune.
``--leak-witness`` is the same loop for the LDT1201 ownership family: a
runtime lease witness (``LDT_LEAK_SANITIZER=1``, ``utils/leaktrack.py``)
corroborates leaks that reproduced and prunes exercised-and-balanced
sites, and the report carries the match summary so CI can assert the
static and runtime halves still overlap.

``graph``: render the cross-module concurrency model (spawned-thread
roots, the locks each thread path acquires, the lock-order edges) as
Graphviz DOT (``--dot``) or a text summary — the machine-checked topology
the README renders. ``--ownership`` adds the resource-ownership model:
resource kinds as diamond nodes, acquire→release edges, red edges for
leak-on-path findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from .config import resolve_config
from .core import (
    all_rules,
    analyze_project,
    load_baseline,
    parse_modules,
    split_new_findings,
    write_baseline,
)
from .reporters import render_json, render_text

__all__ = ["check_main", "build_check_parser", "graph_main"]


def build_check_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldt check",
        description="AST-based distributed-training lint "
                    "(rules LDT001-LDT1301; config in [tool.ldt-check])",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to check (default: configured paths)")
    p.add_argument("--root", default=None,
                   help="repo root: reported paths and the baseline are "
                        "relative to it; its pyproject.toml's "
                        "[tool.ldt-check] table is read when it has one, "
                        "else the port's analysis/ldt-check.toml (default: "
                        "the directory holding the port's package)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    p.add_argument("--update-baseline", action="store_true",
                   help="write current findings to the baseline file and "
                        "exit 0 — future runs fail only on NEW findings")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding as new")
    p.add_argument("--lock-witness", default=None, metavar="PATH",
                   help="runtime lock-order witness JSON (emitted by a "
                        "test run under LDT_LOCK_SANITIZER=1): observed "
                        "orderings corroborate LDT1001 cycles, "
                        "contradicted ones are marked witness_pruned and "
                        "do not fail the gate")
    p.add_argument("--leak-witness", default=None, metavar="PATH",
                   help="runtime resource-lease witness JSON (emitted by "
                        "a test run under LDT_LEAK_SANITIZER=1, "
                        "utils/leaktrack.py): sites that demonstrably "
                        "leaked corroborate LDT1201 findings, exercised-"
                        "and-balanced sites mark them witness_pruned")
    p.add_argument("--wire-witness", default=None, metavar="PATH",
                   help="runtime wire-traffic witness JSON (emitted by a "
                        "test run under LDT_WIRE_SANITIZER=1, "
                        "utils/wiretrack.py): a (msg, field) tuple "
                        "observed crossing the wire prunes the LDT1403 "
                        "orphan-read at that field (a writer exists "
                        "outside the static view); a message exercised "
                        "without the field corroborates it")
    p.add_argument("--compile-witness", default=None, metavar="PATH",
                   help="runtime compile/transfer witness JSON (emitted by "
                        "a test run under LDT_COMPILE_SANITIZER=1, "
                        "utils/compiletrack.py): a jit site that "
                        "demonstrably recompiled after warmup corroborates "
                        "the LDT1703 hazard there; one exercised with a "
                        "single steady-state signature marks it "
                        "witness_pruned")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    return p


def _rel_site(site: str, root: str) -> str:
    """Relativize a witness ``abspath:line`` site to ``root`` — the one
    join-key discipline BOTH witness families share (the static models
    report root-relative posix ``path:line`` sites)."""
    file_part, _, line = site.rpartition(":")
    try:
        rel = os.path.relpath(file_part, root)
    except ValueError:  # different drive (windows): keep absolute
        rel = file_part
    return f"{rel.replace(os.sep, '/')}:{line}"


def load_lock_witness(path: str, root: str) -> dict:
    """Parse a ``utils/lockorder.py`` witness file into the structure the
    LDT1001 rule consumes: ``{"edges": {(src, dst), ...}, "acquired":
    {site: count}}`` with sites relativized to ``root`` (``path:line``)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    edges = {
        (_rel_site(e["src"], root), _rel_site(e["dst"], root))
        for e in data.get("edges", [])
    }
    acquired = {
        _rel_site(site, root): count
        for site, count in data.get("acquired", {}).items()
    }
    return {"edges": edges, "acquired": acquired}


def load_wire_witness(path: str) -> dict:
    """Parse a ``utils/wiretrack.py`` witness file into the structure the
    LDT1403 rule consumes: ``{"frames": {msg_value: count}, "fields":
    {msg_value: {field: count}}, "versions": {msg_value: [v, ...]}}``.
    Message types are numeric on the wire — the protocol model maps them
    back to ``MSG_*`` names, so every key must parse as an int HERE
    (``str(int(k))`` normalizes and raises into the caller's
    unreadable-witness exit-2 path, never a mid-analysis traceback)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {
        "frames": {
            str(int(k)): int(v)
            for k, v in data.get("frames", {}).items()
        },
        "fields": {
            str(int(k)): {str(field): int(n) for field, n in fields.items()}
            for k, fields in data.get("fields", {}).items()
        },
        "versions": {
            str(int(k)): sorted(int(v) for v in versions)
            for k, versions in data.get("versions", {}).items()
        },
    }


def load_leak_witness(path: str, root: str) -> dict:
    """Parse a ``utils/leaktrack.py`` witness file into the structure the
    LDT1201 rule consumes: ``{"sites": {"path:line": {"acquired": n,
    "released": n, "leaked": n}}}`` with sites relativized to ``root`` —
    the same join-key discipline as the lock witness."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    sites = {
        _rel_site(site, root): dict(entry)
        for site, entry in data.get("sites", {}).items()
    }
    return {"sites": sites}


def load_compile_witness(path: str, root: str) -> dict:
    """Parse a ``utils/compiletrack.py`` witness file into the structure the
    LDT1703 rule and the mesh model's receipt consume: ``{"compiles":
    {"path:line": {"calls": n, "compiles": n, "post_warmup": n}},
    "transfers": {"h2d"|"d2h": {"path:line": {"count": n, "bytes": n}}}}``
    with sites relativized to ``root`` — the same join-key discipline as
    the lock/leak witnesses. Every count must parse as an int HERE so a
    malformed file raises into the caller's unreadable-witness exit-2
    path, never a mid-analysis traceback."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    compiles = {
        _rel_site(site, root): {
            "calls": int(entry["calls"]),
            "compiles": int(entry["compiles"]),
            "post_warmup": int(entry["post_warmup"]),
        }
        for site, entry in data.get("compiles", {}).items()
    }
    transfers = {
        str(direction): {
            _rel_site(site, root): {
                "count": int(entry["count"]),
                "bytes": int(entry["bytes"]),
            }
            for site, entry in table.items()
        }
        for direction, table in data.get("transfers", {}).items()
    }
    return {"compiles": compiles, "transfers": transfers}


def check_main(argv: Optional[Sequence[str]] = None,
               out=None) -> int:
    """The ``ldt check`` entry point. Returns the process exit status."""
    args = build_check_parser().parse_args(
        list(argv) if argv is not None else None
    )
    out = out if out is not None else sys.stdout

    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            out.write(f"{rid}  {rule.name}: {rule.description}\n")
        return 0

    root, config = resolve_config(args.root)
    if args.paths:
        if args.update_baseline:
            # A partial scan must never rewrite the whole baseline: findings
            # in unscanned files would be silently un-grandfathered and the
            # next full run would fail on them.
            out.write(
                "ldt check: --update-baseline requires a full scan — drop "
                "the explicit paths\n"
            )
            return 2
        config.paths = list(args.paths)
    if args.lock_witness:
        try:
            config.lock_witness = load_lock_witness(args.lock_witness, root)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            out.write(
                f"ldt check: unreadable lock witness "
                f"{args.lock_witness}: {exc}\n"
            )
            return 2
    if args.leak_witness:
        try:
            config.leak_witness = load_leak_witness(args.leak_witness, root)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            out.write(
                f"ldt check: unreadable leak witness "
                f"{args.leak_witness}: {exc}\n"
            )
            return 2
    if args.wire_witness:
        try:
            config.wire_witness = load_wire_witness(args.wire_witness)
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            out.write(
                f"ldt check: unreadable wire witness "
                f"{args.wire_witness}: {exc}\n"
            )
            return 2
    if args.compile_witness:
        try:
            config.compile_witness = load_compile_witness(
                args.compile_witness, root
            )
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            out.write(
                f"ldt check: unreadable compile witness "
                f"{args.compile_witness}: {exc}\n"
            )
            return 2

    timing: dict = {}
    findings, modules, files_checked = analyze_project(
        root, config, timing=timing
    )
    by_path = {m.relpath: m for m in modules}
    if files_checked == 0:
        # Scanning nothing is a misconfiguration (wrong cwd, bad --root,
        # bad paths), not a clean result — a 0-file "pass" would silently
        # void the gate.
        out.write(
            f"ldt check: no files matched {config.paths} under {root} — "
            "run from the repo root or pass --root\n"
        )
        return 2

    baseline_path = os.path.join(root, config.baseline)
    if args.update_baseline:
        # Witness-pruned findings never enter the baseline: they are
        # evidence-contradicted, not grandfathered debt.
        solid = [f for f in findings if not f.witness_pruned]
        write_baseline(baseline_path, solid, root, modules)
        out.write(
            f"ldt check: baseline written to {config.baseline} "
            f"({len(solid)} finding{'s' if len(solid) != 1 else ''})\n"
        )
        return 0

    if args.no_baseline:
        new, old = list(findings), []
    else:
        baseline = load_baseline(baseline_path)
        new, old = split_new_findings(findings, baseline, root, modules)

    rules = all_rules()

    def family_of(rule_id: str) -> str:
        rule = rules.get(rule_id)
        return getattr(rule, "family", "general") if rule else "general"

    if args.as_json:
        def line_text_of(f):
            mod = by_path.get(f.path)
            return mod.line_text(f.line) if mod is not None else ""

        render_json(
            new, out, root=root, grandfathered=len(old),
            files_checked=files_checked, line_text_of=line_text_of,
            family_of=family_of, timing=timing,
        )
    else:
        render_text(
            new, out, grandfathered=len(old), files_checked=files_checked
        )
        summary = timing.get("leak_witness")
        if summary is not None:
            # The corroboration receipt the CI stage greps: runtime lease
            # evidence mapped onto the static ownership model's acquire
            # sites.
            out.write(
                f"ldt check: leak witness: {summary['matched_sites']}/"
                f"{summary['runtime_sites']} runtime sites match static "
                f"acquire sites, {summary['leaked_sites']} leaked\n"
            )
        wire_summary = timing.get("wire_witness")
        if wire_summary is not None:
            # Same receipt discipline for the wire witness: observed
            # (msg, field) traffic mapped onto the static payload schema.
            versions = wire_summary.get("versions_seen") or []
            suffix = (
                " (versions seen: "
                + ", ".join(str(v) for v in versions) + ")"
                if versions else ""
            )
            out.write(
                f"ldt check: wire witness: "
                f"{wire_summary['matched_fields']}/"
                f"{wire_summary['observed_fields']} observed (msg, field) "
                f"tuples match the static schema over "
                f"{wire_summary['frames']} frames{suffix}\n"
            )
        compile_summary = timing.get("compile_witness")
        if compile_summary is not None:
            # Same receipt discipline for the compile witness: runtime jit
            # sites mapped onto the static mesh model's def-site candidates,
            # plus the transfer-event totals the CI stage eyeballs.
            out.write(
                f"ldt check: compile witness: "
                f"{compile_summary['matched_sites']}/"
                f"{compile_summary['runtime_sites']} runtime jit sites "
                f"match static jit sites, "
                f"{compile_summary['recompiled_sites']} recompiled "
                f"post-warmup, {compile_summary['h2d_events']} H2D / "
                f"{compile_summary['d2h_events']} D2H transfer events"
                + (f", {compile_summary['d2h_at_funnels']} D2H at declared "
                   "sync funnels" if "d2h_at_funnels" in compile_summary
                   else "")
                + "\n"
            )
    return 1 if any(not f.witness_pruned for f in new) else 0


# -- ldt graph ---------------------------------------------------------------


def build_graph_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ldt graph",
        description="render the cross-module concurrency model (thread "
                    "roots, lock acquisitions, lock-order edges)",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to model (default: configured paths)")
    p.add_argument("--root", default=None,
                   help="repo root (config + relative paths); as for "
                        "check, its pyproject.toml's table or the port's "
                        "analysis/ldt-check.toml")
    p.add_argument("--dot", action="store_true",
                   help="Graphviz DOT on stdout (pipe through `dot -Tsvg`)"
                        " instead of the text summary")
    p.add_argument("--ownership", action="store_true",
                   help="also render the resource-ownership model: "
                        "resource kinds as diamond nodes beside the "
                        "thread boxes and lock ellipses, acquire->release "
                        "edges, RED acquire edges for leak-on-path "
                        "findings")
    p.add_argument("--protocol", action="store_true",
                   help="also render the wire-protocol model: MSG_* "
                        "hexagons with writer->msg->reader edges, "
                        "per-message field schemas, and the version-gate "
                        "annotations LDT1402 enforces")
    p.add_argument("--loader", action="store_true",
                   help="also render the unified loader graph "
                        "(data/graph.py): the five canonical LoaderGraph "
                        "shapes as node chains, with cursor owners and "
                        "tunable-bearing nodes marked")
    p.add_argument("--mesh", action="store_true",
                   help="also render the device-semantics model "
                        "(analysis/meshmodel.py): jitted kernels with "
                        "their static/donated argument sets, and every "
                        "literal mesh-axis reference grouped per axis")
    return p


def _short(key: str) -> str:
    parts = key.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else key


def graph_main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    """The ``ldt graph`` entry point. Returns the process exit status."""
    args = build_graph_parser().parse_args(
        list(argv) if argv is not None else None
    )
    out = out if out is not None else sys.stdout
    root, config = resolve_config(args.root)
    if args.paths:
        config.paths = list(args.paths)
    # Parse only — the graph needs the module set for the concurrency
    # model, not a full lint pass over every rule.
    modules, _parse_findings, files_checked = parse_modules(root, config)
    if files_checked == 0:
        out.write(
            f"ldt graph: no files matched {config.paths} under {root}\n"
        )
        return 2
    from .concmodel import build_program

    program = build_program(modules, config)
    owner = None
    if args.ownership:
        from .ownermodel import build_owner_model

        owner = build_owner_model(program, config)
    proto = None
    if args.protocol:
        from .protomodel import build_proto_model

        proto = build_proto_model(program, config)
    mesh = None
    if args.mesh:
        from .meshmodel import build_mesh_model

        mesh = build_mesh_model(program, config)
    loaders = None
    if args.loader:
        # Spec-only canonical graphs: describe() never compiles, so this
        # touches no dataset, socket, or decoder.
        from ..data.graph import canonical_graphs

        loaders = {
            name: g.describe() for name, g in canonical_graphs().items()
        }

    # thread root -> set of lock keys any function on that root acquires
    root_locks: dict = {}
    spawn_targets = sorted(
        {t for t, _m, _n in program.spawn_sites if t is not None}
    )
    for target in spawn_targets:
        locks = set()
        for fn in program.functions.values():
            if target in fn.roots:
                locks |= {lk for lk, _n in fn.acquires}
        root_locks[target] = locks

    if args.dot:
        out.write("digraph ldt_concurrency {\n")
        out.write("  rankdir=LR;\n")
        out.write('  node [fontname="monospace", fontsize=10];\n')
        for target in spawn_targets:
            out.write(
                f'  "thread:{target}" [label="{_short(target)}", '
                'shape=box, style=filled, fillcolor="#dbeafe"];\n'
            )
        for key in sorted(program.locks):
            out.write(
                f'  "lock:{key}" [label="{_short(key)}", shape=ellipse, '
                'style=filled, fillcolor="#fef3c7"];\n'
            )
        for target in spawn_targets:
            for lk in sorted(root_locks[target]):
                out.write(
                    f'  "thread:{target}" -> "lock:{lk}" '
                    '[color="#64748b"];\n'
                )
        seen = set()
        for e in program.lock_edges:
            if (e.src, e.dst) in seen:
                continue
            seen.add((e.src, e.dst))
            out.write(
                f'  "lock:{e.src}" -> "lock:{e.dst}" '
                f'[color="#dc2626", penwidth=2, '
                f'label="{e.module}:{e.line}"];\n'
            )
        if owner is not None:
            # Resource diamonds beside the thread boxes and lock ellipses:
            # function --acquire--> resource (RED when that acquire site
            # has a leak-on-path finding), resource --release--> kind's
            # release verbs.
            kinds = sorted({r.kind for r in owner.records})
            for kind in kinds:
                spec = owner.spec(kind)
                out.write(
                    f'  "res:{kind}" [label="{spec.describe or kind}", '
                    'shape=diamond, style=filled, fillcolor="#dcfce7"];\n'
                )
                out.write(
                    f'  "rel:{kind}" [label="release: '
                    f'{", ".join(spec.release)}", shape=plaintext];\n'
                )
                out.write(f'  "res:{kind}" -> "rel:{kind}" '
                          '[style=dashed, color="#16a34a"];\n')
            seen_acq = set()
            for rec in owner.records:
                key = (rec.func, rec.kind, rec.leak is not None)
                if key in seen_acq:
                    continue
                seen_acq.add(key)
                out.write(
                    f'  "fn:{rec.func}" [label="{_short(rec.func)}", '
                    'shape=box];\n'
                )
                if rec.leak is not None:
                    out.write(
                        f'  "fn:{rec.func}" -> "res:{rec.kind}" '
                        f'[color="#dc2626", penwidth=2, '
                        f'label="LEAK {rec.module}:{rec.line}"];\n'
                    )
                else:
                    out.write(
                        f'  "fn:{rec.func}" -> "res:{rec.kind}" '
                        f'[color="#16a34a", '
                        f'label="{rec.module}:{rec.line}"];\n'
                    )
        if proto is not None:
            # Message hexagons between their writers and readers: the
            # per-field schema rides the node label, gated fields marked.
            for name in sorted(proto.messages):
                info = proto.messages[name]
                if name in proto.binary_messages:
                    label = f"{name}\\n(binary)"
                else:
                    fields = sorted(set(info.writes) | set(info.reads))
                    marked = [
                        f + "*" if (
                            f"{name}.{f}" in proto.gated_fields
                            or f in proto.gated_fields
                        ) else f
                        for f in fields
                    ]
                    label = name + (
                        "\\n" + ", ".join(marked) if marked else ""
                    )
                out.write(
                    f'  "msg:{name}" [label="{label}", shape=hexagon, '
                    'style=filled, fillcolor="#ede9fe"];\n'
                )
                writers = sorted({
                    s.func for sites in info.writes.values()
                    for s in sites
                })
                readers = sorted({
                    s.func for sites in info.reads.values() for s in sites
                })
                for w in writers:
                    out.write(
                        f'  "fn:{w}" [label="{_short(w)}", shape=box];\n'
                        f'  "fn:{w}" -> "msg:{name}" '
                        '[color="#7c3aed"];\n'
                    )
                for r in readers:
                    out.write(
                        f'  "fn:{r}" [label="{_short(r)}", shape=box];\n'
                        f'  "msg:{name}" -> "fn:{r}" '
                        '[color="#2563eb"];\n'
                    )
        if mesh is not None:
            # Jitted kernels as double-octagon nodes (static/donated args in
            # the label), mesh axes as filled circles, axis-reference edges
            # labelled with their context; undeclared axes render RED.
            declared = set(mesh.mesh_axes)
            for axis in sorted(
                declared | {r.axis for r in mesh.axis_refs}
            ):
                color = "#fee2e2" if axis not in declared else "#cffafe"
                out.write(
                    f'  "axis:{axis}" [label="{axis}", shape=circle, '
                    f'style=filled, fillcolor="{color}"];\n'
                )
            for i, site in enumerate(mesh.jit_sites):
                label = f"{site.kind} {site.name}"
                if site.static_argnames or site.static_argnums:
                    statics = list(site.static_argnames) + [
                        f"#{n}" for n in site.static_argnums
                    ]
                    label += "\\nstatic: " + ", ".join(statics)
                if site.donate_argnums:
                    label += "\\ndonate: " + ", ".join(
                        f"#{n}" for n in site.donate_argnums
                    )
                    if site.donate_conditional:
                        label += " (conditional)"
                out.write(
                    f'  "jit:{i}" [label="{label}\\n'
                    f'{site.module}:{site.line}", shape=doubleoctagon, '
                    'style=filled, fillcolor="#fde68a"];\n'
                )
            by_axis: dict = {}
            for ref in mesh.axis_refs:
                by_axis.setdefault(ref.axis, []).append(ref)
            for axis, refs in sorted(by_axis.items()):
                contexts = sorted({r.context for r in refs})
                out.write(
                    f'  "axisrefs:{axis}" [label="{len(refs)} refs\\n'
                    f'{", ".join(contexts)}", shape=plaintext];\n'
                    f'  "axisrefs:{axis}" -> "axis:{axis}" '
                    '[style=dashed, color="#0891b2"];\n'
                )
            # The torch forms (port code only): launch sites as 3-D boxes,
            # topology axis keys grouped per axis like the specs above.
            for i, site in enumerate(mesh.launch_sites):
                out.write(
                    f'  "launch:{i}" [label="launch {site.name}\\n'
                    f'{site.module}:{site.line}", shape=box3d, '
                    'style=filled, fillcolor="#fde68a"];\n'
                )
            torch_axis: dict = {}
            for ref in mesh.torch_axis_refs:
                torch_axis.setdefault(ref.axis, []).append(ref)
            for axis, refs in sorted(torch_axis.items()):
                color = "#cffafe" if axis in declared else "#fee2e2"
                contexts = sorted({r.context for r in refs})
                out.write(
                    f'  "axis:{axis}" [label="{axis}", shape=circle, '
                    f'style=filled, fillcolor="{color}"];\n'
                    f'  "torchaxisrefs:{axis}" [label="{len(refs)} refs\\n'
                    f'{", ".join(contexts)}", shape=plaintext];\n'
                    f'  "torchaxisrefs:{axis}" -> "axis:{axis}" '
                    '[style=dashed, color="#0891b2"];\n'
                )
        if loaders is not None:
            # One cluster per canonical shape: the node chain left to
            # right, cursor owner double-bordered, tunable bearers dashed.
            for shape, desc in loaders.items():
                cid = shape.replace("-", "_")
                out.write(f'  subgraph "cluster_loader_{cid}" {{\n')
                out.write(f'    label="loader: {shape}";\n')
                prev = None
                for i, node in enumerate(desc["nodes"]):
                    nid = f"ldr:{shape}:{i}"
                    label = node["node"]
                    if node["detail"]:
                        label += "\\n" + node["detail"]
                    if node["tunables"]:
                        label += "\\ntunables: " + ", ".join(
                            node["tunables"]
                        )
                    style = "filled"
                    if node["cursor"]:
                        label += "\\n[cursor owner]"
                    if node["tunables"]:
                        style += ",dashed"
                    peripheries = 2 if node["cursor"] else 1
                    out.write(
                        f'    "{nid}" [label="{label}", shape=box, '
                        f'style="{style}", fillcolor="#f1f5f9", '
                        f'peripheries={peripheries}];\n'
                    )
                    if prev is not None:
                        out.write(f'    "{prev}" -> "{nid}";\n')
                    prev = nid
                out.write("  }\n")
        out.write("}\n")
    else:
        out.write(f"concurrency model over {files_checked} files: "
                  f"{len(program.functions)} functions, "
                  f"{len(spawn_targets)} thread roots, "
                  f"{len(program.locks)} locks, "
                  f"{len(program.lock_edges)} lock-order edges\n")
        for target in spawn_targets:
            on_root = sum(
                1 for fn in program.functions.values()
                if target in fn.roots
            )
            locks = ", ".join(sorted(_short(k) for k in root_locks[target]))
            out.write(f"  thread {_short(target)}: {on_root} functions"
                      f"{' — locks: ' + locks if locks else ''}\n")
        seen = set()
        for e in program.lock_edges:
            if (e.src, e.dst) in seen:
                continue
            seen.add((e.src, e.dst))
            out.write(f"  order {_short(e.src)} -> {_short(e.dst)} "
                      f"({e.module}:{e.line}, {e.via})\n")
        cycles = program.lock_cycles()
        out.write(f"  lock-order cycles: {len(cycles)}\n")
        if owner is not None:
            leaks = [r for r in owner.records if r.leak is not None]
            out.write(
                f"  ownership model: {len(owner.records)} acquire sites "
                f"across {len({r.kind for r in owner.records})} resource "
                f"kinds, {len(leaks)} leak-on-path\n"
            )
            for rec in owner.records:
                tag = f"  LEAK({rec.leak})" if rec.leak is not None else ""
                out.write(
                    f"  resource {rec.kind} acquired in "
                    f"{_short(rec.func)} ({rec.module}:{rec.line}){tag}\n"
                )
        if proto is not None:
            n_fields = sum(
                len(set(i.writes) | set(i.reads))
                for i in proto.messages.values()
            )
            out.write(
                f"  protocol model: {len(proto.messages)} messages, "
                f"{n_fields} payload fields, "
                f"{len(proto.gate_constants)} version gates\n"
            )
            for name in sorted(proto.messages):
                info = proto.messages[name]
                if name in proto.binary_messages:
                    out.write(f"  msg {name}: binary payload\n")
                    continue
                fields = sorted(set(info.writes) | set(info.reads))
                if not fields:
                    continue
                parts = []
                for f in fields:
                    mark = ""
                    if f not in info.reads:
                        mark = "!w-only"  # written, no peer read (LDT1401)
                    elif f not in info.writes:
                        mark = "!r-only"  # read, no writer (LDT1403)
                    gate = proto.gated_fields.get(f"{name}.{f}") \
                        or proto.gated_fields.get(f)
                    if gate:
                        mark += f" >={gate}"
                    parts.append(f + (f" [{mark.strip()}]" if mark else ""))
                out.write(f"  msg {name}: {', '.join(parts)}\n")
        if mesh is not None:
            out.write(
                f"  mesh model: {len(mesh.jit_sites)} jit sites, "
                f"{len(mesh.axis_refs)} axis references over axes "
                f"({', '.join(mesh.mesh_axes)})\n"
            )
            for site in mesh.jit_sites:
                marks = []
                if site.static_argnames or site.static_argnums:
                    marks.append("static: " + ", ".join(
                        list(site.static_argnames)
                        + [f"#{n}" for n in site.static_argnums]
                    ))
                if site.donate_argnums:
                    don = "donate: " + ", ".join(
                        f"#{n}" for n in site.donate_argnums
                    )
                    if site.donate_conditional:
                        don += " (conditional)"
                    marks.append(don)
                tail = f" [{'; '.join(marks)}]" if marks else ""
                out.write(
                    f"  {site.kind} {site.name} "
                    f"({site.module}:{site.line}){tail}\n"
                )
            by_axis: dict = {}
            for ref in mesh.axis_refs:
                by_axis.setdefault(ref.axis, []).append(ref)
            declared = set(mesh.mesh_axes)
            for axis, refs in sorted(by_axis.items()):
                flag = "" if axis in declared else " [UNDECLARED]"
                out.write(
                    f"  axis {axis}{flag}: {len(refs)} references "
                    f"({', '.join(sorted({r.context for r in refs}))})\n"
                )
            if mesh.launch_sites or mesh.torch_axis_refs:
                out.write(
                    f"  torch forms: {len(mesh.launch_sites)} launch sites, "
                    f"{len(mesh.torch_axis_refs)} topology axis "
                    "references\n"
                )
                for site in mesh.launch_sites:
                    out.write(f"  launch {site.name} "
                              f"({site.module}:{site.line})\n")
                torch_axis: dict = {}
                for ref in mesh.torch_axis_refs:
                    torch_axis.setdefault(ref.axis, []).append(ref)
                for axis, refs in sorted(torch_axis.items()):
                    flag = "" if axis in declared else " [UNDECLARED]"
                    out.write(
                        f"  torch axis {axis}{flag}: {len(refs)} references "
                        f"({', '.join(sorted({r.context for r in refs}))})\n"
                    )
        if loaders is not None:
            out.write(
                f"  loader graph model (data/graph.py): {len(loaders)} "
                "canonical shapes; * = cursor owner, ~ = tunable-bearing\n"
            )
            for shape, desc in loaders.items():
                chain = " -> ".join(
                    n["node"]
                    + ("*" if n["cursor"] else "")
                    + ("~" if n["tunables"] else "")
                    for n in desc["nodes"]
                )
                out.write(f"  loader {shape}: {chain}\n")
                for n in desc["nodes"]:
                    marks = []
                    if n["cursor"]:
                        marks.append("cursor owner")
                    if n["tunables"]:
                        marks.append("tunables: " + ", ".join(n["tunables"]))
                    tail = f" [{'; '.join(marks)}]" if marks else ""
                    out.write(
                        f"    {n['kind']:<10} {n['node']}"
                        f"{' — ' + n['detail'] if n['detail'] else ''}"
                        f"{tail}\n"
                    )
    return 0


if __name__ == "__main__":
    raise SystemExit(check_main())
