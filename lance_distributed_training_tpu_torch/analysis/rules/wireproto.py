"""Wire-protocol evolution rules (LDT1401-1404).

LDT501 pins the protocol *constants* and LDT1003 pins message-level
dispatch coverage; neither sees the payload *fields* — the level at which
mixed-version fleets actually rot. These rules consume the shared
:class:`~..protomodel.ProtoModel` (built once per ``ldt check`` run on top
of the same :class:`~..concmodel.ProgramInfo` every whole-program family
shares):

* **LDT1401 unchecked-payload-field** — a field some sender writes that no
  peer module ever reads or skew-checks (the forgotten-
  ``decode_config_skew`` class: add ``device_decode`` to the HELLO, forget
  the server-side check, and the knob silently stops mattering). Reported
  at the field's write site; reads inside the protocol module itself do
  not count — the schema owner validating its own dict proves nothing
  about the peer.
* **LDT1402 ungated-versioned-field** — a field the config declares
  version-gated (``[tool.ldt-check.protocol-versions]``: ``stripe_index =
  "STRIPE_MIN_VERSION"``) read or served in a function with no comparison
  against its gate constant anywhere on the caller chain — a v3-only
  feature consumed where a v1 peer can reach it.
* **LDT1403 orphan-decoded-field** — a field some receiver reads that no
  sender writes: dead drift (a removed field still consumed, a typo'd
  key, a reader merged before its writer). The runtime wire witness
  (``LDT_WIRE_SANITIZER=1`` + ``ldt check --wire-witness``) corroborates
  or prunes these exactly like the lock/leak witnesses: a (msg, field)
  tuple observed crossing the wire proves a writer the static model
  cannot see (``witness_pruned``); a message exercised without the field
  ever appearing upgrades the finding to *reproduced*.
* **LDT1404 out-of-module-framing** — raw ``struct.pack``/``unpack``/
  ``Struct`` byte-framing outside the protocol module (the LDT401/LDT801
  vocabulary shape): framing drift in two places is how two builds stop
  agreeing on a length prefix.

LDT14xx suppressions require a ``-- reason`` like the other whole-program
families (core's reason-required set covers LDT1[0-4]xx).
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register
from ..protomodel import build_proto_model

_STRUCT_CALLS = (
    "struct.pack", "struct.unpack", "struct.pack_into",
    "struct.unpack_from", "struct.Struct", "struct.iter_unpack",
)


@register
class UncheckedPayloadField(Rule):
    id = "LDT1401"
    name = "unchecked-payload-field"
    description = (
        "wire-payload field written by one peer but never read or "
        "skew-checked by the other (reads inside the protocol module "
        "do not count)"
    )
    family = "wire-protocol"
    uses_proto_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_proto_model(program, config)
        for site in model.orphan_writes():
            yield Finding(
                self.id, site.module, site.line, site.col,
                f"{site.msg} field {site.field!r} is written on the wire "
                "but no peer module reads or skew-checks it — either the "
                "receiving side forgot its check (the decode_config_skew "
                "class) or the field is dead; wire the read/skew check in "
                "or remove the field",
            )


@register
class UngatedVersionedField(Rule):
    id = "LDT1402"
    name = "ungated-versioned-field"
    description = (
        "version-gated payload field ([tool.ldt-check.protocol-versions]) "
        "read or served with no comparison against its gate constant on "
        "the path — a vN-only feature where an older peer can reach"
    )
    family = "wire-protocol"
    uses_proto_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_proto_model(program, config)
        if not model.messages:
            return  # protocol module not in this scan: family inert
        for gate in model.config_drift():
            yield Finding(
                self.id, model.proto_path, 1, 0,
                f"[tool.ldt-check.protocol-versions] names gate constant "
                f"{gate!r} which the protocol module does not define — "
                "config drift ahead of the protocol",
            )
        for field, gate, module, line, col, fn_key in model.ungated_sites:
            yield Finding(
                self.id, module, line, col,
                f"version-gated field {field!r} is used here, but neither "
                f"this function nor its callers compare the peer version "
                f"against {gate} — an old peer reaching this path gets a "
                "feature it does not speak (the silent-duplication / "
                "silent-ignore class); guard the path or refuse the peer",
            )


@register
class OrphanDecodedField(Rule):
    id = "LDT1403"
    name = "orphan-decoded-field"
    description = (
        "wire-payload field read by a receiver that no sender writes — "
        "dead-field drift (field-level extension of LDT1003's "
        "message-level dispatch coverage)"
    )
    family = "wire-protocol"
    uses_proto_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_proto_model(program, config)
        witness = getattr(config, "wire_witness", None)
        for site in model.orphan_reads():
            message = (
                f"{site.msg} field {site.field!r} is read here but no "
                "sender in the program writes it — dead drift (removed "
                "field still consumed, or a typo'd key); remove the read "
                "or restore the writer"
            )
            pruned = False
            if witness:
                verdict = model.witness_verdict(witness, site)
                if verdict == "pruned":
                    pruned = True
                    message += (
                        " [witness_pruned: this (msg, field) tuple was "
                        "observed crossing the wire in the instrumented "
                        "run — a writer exists outside the static model's "
                        "view]"
                    )
                elif verdict == "reproduced":
                    message += (
                        " [witness: the message was exercised on the wire "
                        "and this field never appeared — a reproduced "
                        "dead read, not an inference]"
                    )
            yield Finding(
                self.id, site.module, site.line, site.col, message,
                witness_pruned=pruned,
            )


@register
class OutOfModuleFraming(Rule):
    id = "LDT1404"
    name = "out-of-module-framing"
    description = (
        "raw struct.pack/unpack byte-framing outside the protocol module "
        "— wire framing must have exactly one owner"
    )
    family = "wire-protocol"

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        import ast

        if module.tree is None:
            return
        proto = getattr(config, "protocol_module", "")
        if module.relpath == proto:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            if qn in _STRUCT_CALLS:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"raw byte-framing ({qn}) outside the protocol module "
                    f"({proto or 'unset'}) — a second framing site is how "
                    "two builds stop agreeing on the wire; move the "
                    "pack/unpack behind the protocol module's encoders",
                )
