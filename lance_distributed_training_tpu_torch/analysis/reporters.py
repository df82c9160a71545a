"""Finding reporters: human text and machine ``--json``."""

from __future__ import annotations

import json
from typing import Optional, Sequence, TextIO

from .core import Finding, fingerprint

__all__ = ["render_text", "render_json"]


def render_text(
    findings: Sequence[Finding],
    out: TextIO,
    *,
    grandfathered: int = 0,
    files_checked: int = 0,
) -> None:
    """flake8-style one-line-per-finding in stable (path, line, rule) order,
    followed by a summary line the gate scripts can grep. Witness-pruned
    findings (runtime evidence contradicts the static inference) render
    flagged and do not count toward the failing total."""
    failing = 0
    pruned = 0
    for f in findings:
        tag = ""
        if f.witness_pruned:
            pruned += 1
            tag = " [witness-pruned]"
        else:
            failing += 1
        out.write(f"{f.location()}: {f.rule} {f.message}{tag}\n")
    if failing:
        out.write(
            f"\nldt check: {failing} new finding"
            f"{'s' if failing != 1 else ''}"
        )
    else:
        out.write("ldt check: clean")
    if pruned:
        out.write(f" ({pruned} witness-pruned)")
    if grandfathered:
        out.write(f" ({grandfathered} baselined)")
    out.write(f" [{files_checked} files]\n")


def render_json(
    findings: Sequence[Finding],
    out: TextIO,
    *,
    root: str,
    grandfathered: int = 0,
    files_checked: int = 0,
    line_text_of=None,
    family_of=None,
    timing: Optional[dict] = None,
) -> None:
    """Machine output. Schema (stable — tests pin it)::

        {
          "version": 2,
          "clean": bool,             # no UNPRUNED new findings
          "files_checked": int,
          "grandfathered": int,
          "wall_time_ms": float,     # whole analysis pass (parse + rules)
          "parse_ms": float,
          "findings": [
            {"rule", "rule_family", "path", "line", "col", "message",
             "fingerprint", "witness_pruned"}, ...
          ]
        }

    v1 → v2: per-finding ``rule_family`` (the rule's family slug, e.g.
    ``lock-order``) and ``witness_pruned`` (true when the runtime lock
    witness contradicted the static inference — rendered, not failing),
    plus the top-level timing fields. Exit-code and baseline semantics are
    unchanged, so existing gate machinery keeps working unmodified.

    Additive v2 fields: ``model_build_ms`` — per-family build time
    of the shared cross-module models ({"concurrency": ms, "ownership":
    ms, "protocol": ms}), the receipt that one ProgramInfo/parse pass
    serves every whole-program family — and ``leak_witness`` (only when
    ``ldt check --leak-witness`` ran): {"runtime_sites", "matched_sites",
    "leaked_sites"}, the static↔runtime corroboration summary.

    Additive v2 field: ``wire_witness`` (only when ``ldt check
    --wire-witness`` ran): {"observed_fields", "matched_fields",
    "frames"} — how much of the runtime (msg, field) wire traffic maps
    onto the static payload schema.

    Additive v2 fields: ``model_build_ms`` gains ``"mesh"`` (the
    device-semantics model), and ``compile_witness`` (only when ``ldt
    check --compile-witness`` ran): {"runtime_sites", "matched_sites",
    "recompiled_sites", "h2d_events", "d2h_events"} — how much of the
    runtime compile/transfer evidence maps onto the static jit sites.
    """
    records = []
    for f in findings:
        text = line_text_of(f) if line_text_of is not None else ""
        records.append(
            {
                "rule": f.rule,
                "rule_family": family_of(f.rule) if family_of else "general",
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
                "fingerprint": fingerprint(f, text),
                "witness_pruned": bool(f.witness_pruned),
            }
        )
    payload = {
        "version": 2,
        "clean": not any(not f.witness_pruned for f in findings),
        "files_checked": files_checked,
        "grandfathered": grandfathered,
        "wall_time_ms": (timing or {}).get("wall_ms", 0.0),
        "parse_ms": (timing or {}).get("parse_ms", 0.0),
        "model_build_ms": (timing or {}).get("model_build_ms", {}),
        "findings": records,
    }
    if (timing or {}).get("leak_witness") is not None:
        payload["leak_witness"] = timing["leak_witness"]
    if (timing or {}).get("wire_witness") is not None:
        payload["wire_witness"] = timing["wire_witness"]
    if (timing or {}).get("compile_witness") is not None:
        payload["compile_witness"] = timing["compile_witness"]
    json.dump(payload, out, indent=2)
    out.write("\n")
