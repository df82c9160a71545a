"""Device-semantics rules (LDT1701-1704).

The compute plane's XLA-facing contract is exactly what the compiler does
not check — these rules consume the whole-program
:class:`~..meshmodel.MeshModel` and machine-check it the way LDT14xx
checks the wire contract:

* **LDT1701 undeclared-axis** — a ``PartitionSpec`` or collective names an
  axis outside the declared mesh vocabulary (``[tool.ldt-check]
  mesh-axes``, seeded from ``parallel/mesh.py``). A typo'd ``"dtaa"``
  compiles fine and silently replicates instead of sharding.
* **LDT1702 use-after-donate** — a value passed in a donated position
  (``donate_argnums``) is read again on any path after the call,
  interprocedurally: the donated buffer now holds whatever XLA scribbled
  into it.
* **LDT1703 recompile hazard** — a batch-content-derived Python value
  (``.shape``, ``len()``) reaches a ``static_argnames``/``static_argnums``
  position, or a Python branch on a parameter shape sits inside a jitted
  content-path function; either keys the jit cache per batch. Derivations
  routed through a declared quantized funnel (``static-funnels``) are
  sanctioned — they clamp the key ladder to O(1).
* **LDT1704 hot-path host sync** — ``.item()`` / ``float()`` / ``int()``
  / ``bool()`` / ``np.asarray`` on a device-derived value in a declared
  ``device-hot-paths`` module outside jitted bodies and ``sync-funnels``
  — each one serialises the async dispatch stream.

Like the other whole-program families, a suppression needs a
``-- reason``; bare ignores stay live. The runtime witness
(``LDT_COMPILE_SANITIZER=1`` + ``ldt check --compile-witness``)
corroborates or prunes LDT1703 exactly like the leak witness does
LDT1201: a hazard whose jit site demonstrably recompiled after warmup in
an instrumented run is *reproduced*; one whose site was exercised with a
single steady-state compile is ``witness_pruned`` (rendered, not failing,
never baselined).

Where each form applies. LDT1701-1704 are JAX's rules, kept unchanged so
that the port's checker gives JAX's findings on JAX code; on the port they
are inert (it has no ``PartitionSpec``, no ``jax.jit`` and no donation,
so LDT1702 has nothing to check there at all). The torch forms apply to
modules that import torch and not JAX, and so are inert on JAX code:

* **LDT1711** — a literal axis key of a topology's ``group``/``index``/
  ``size``/``ranks``/``strides`` map (port ``parallel/comm.Topology``) or
  a literal ``axis=``/``*_axis=`` keyword outside ``mesh-axes`` (the
  port's ``AXES``).
* **LDT1713** — a ``.shape``/``len()``-derived value, outside
  ``static-funnels``, reaching a ``launch-sites`` callable (a kernel
  launcher's launch configuration, or a cuDNN-benchmarked forward, which
  autotunes every new input shape) as an argument or as the size of a
  tensor handed to it. The witness is the port's
  ``utils/compiletrack.py``, joined on the launch site's def line.
* **LDT1714** — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
  ``float()``/``int()``/``bool()`` or ``np.asarray`` on a torch value, or
  ``torch.cuda.synchronize``, in ``device-hot-paths`` outside
  ``sync-funnels``.
"""

from __future__ import annotations

from typing import Iterable

from ..core import Finding, Rule, register
from ..meshmodel import build_mesh_model


@register
class UndeclaredAxis(Rule):
    id = "LDT1701"
    name = "undeclared-mesh-axis"
    description = (
        "PartitionSpec/collective names a mesh axis outside the declared "
        "[tool.ldt-check] mesh-axes vocabulary — a typo'd axis silently "
        "replicates instead of sharding"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        declared = set(model.mesh_axes)
        for ref in model.axis_refs:
            if ref.axis in declared:
                continue
            yield Finding(
                self.id, ref.module, ref.line, ref.col,
                f"axis {ref.axis!r} in {ref.context} is not in the declared "
                f"mesh vocabulary {sorted(declared)} — a misspelt axis "
                f"compiles fine and silently replicates; fix the name or "
                f"declare it in [tool.ldt-check] mesh-axes",
            )


@register
class UseAfterDonate(Rule):
    id = "LDT1702"
    name = "use-after-donate"
    description = (
        "value passed in a donate_argnums position is read again after "
        "the call — the donated buffer now holds whatever XLA wrote into it"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        for h in model.donate_hazards:
            tail = (
                "re-read on the next loop iteration"
                if h.read_line == h.line
                else f"read again at line {h.read_line}"
            )
            yield Finding(
                self.id, h.module, h.line, h.col,
                f"{h.var!r} is donated to {h.callee!r} (donate_argnums) but "
                f"{tail} — the buffer is consumed by XLA at the call; "
                f"rebind the name from the call's result or drop the "
                f"donation",
            )


@register
class RecompileHazardRule(Rule):
    id = "LDT1703"
    name = "recompile-hazard"
    description = (
        "batch-content-derived Python value (.shape/len, outside the "
        "declared quantized funnels) reaches a jit static position or a "
        "Python branch inside a jitted content-path function — the jit "
        "cache keys per batch"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        witness = getattr(config, "compile_witness", None)
        for h in model.recompile_hazards:
            message = (
                f"{h.detail} — every distinct value compiles a new "
                f"executable; route it through a declared quantized funnel "
                f"(static-funnels) or hoist the branch out of the batch "
                f"path"
            )
            pruned = False
            if witness:
                verdict = model.witness_verdict(h.site, witness)
                if verdict == "reproduced":
                    message += (
                        " [witness: this jit site recompiled after warmup "
                        "in the instrumented run — a reproduced recompile, "
                        "not an inference]"
                    )
                elif verdict == "pruned":
                    pruned = True
                    message += (
                        " [witness_pruned: this jit site was exercised in "
                        "the instrumented run with no post-warmup "
                        "recompiles]"
                    )
            yield Finding(
                self.id, h.module, h.line, h.col, message,
                witness_pruned=pruned,
            )


@register
class HotPathHostSync(Rule):
    id = "LDT1704"
    name = "hot-path-host-sync"
    description = (
        ".item()/float()/int()/bool()/np.asarray on a device-derived value "
        "in a device-hot-paths module — serialises the async dispatch "
        "stream outside the declared sync funnels"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        for h in model.host_syncs:
            yield Finding(
                self.id, h.module, h.line, h.col,
                f"{h.expr} forces a device→host sync on the hot path "
                f"({h.func}) — it blocks until every queued computation "
                f"lands; keep values on device, batch the fetch, or declare "
                f"a sync funnel (sync-funnels) for a deliberate D2H site",
            )


@register
class TorchUndeclaredAxis(Rule):
    id = "LDT1711"
    name = "torch-undeclared-mesh-axis"
    description = (
        "torch form of LDT1701: a literal topology key (group/index/size/"
        "ranks/strides[...]) or axis= keyword outside the declared "
        "mesh-axes vocabulary"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        declared = set(model.mesh_axes)
        for ref in model.torch_axis_refs:
            if ref.axis in declared:
                continue
            yield Finding(
                self.id, ref.module, ref.line, ref.col,
                f"axis {ref.axis!r} in {ref.context} is not in the declared "
                f"mesh vocabulary {sorted(declared)} — the topology has no "
                f"such axis; fix the name or declare it in [tool.ldt-check] "
                f"mesh-axes",
            )


@register
class TorchRecompileHazard(Rule):
    id = "LDT1713"
    name = "torch-recompile-hazard"
    description = (
        "torch form of LDT1703: a .shape/len-derived value (outside the "
        "static funnels) reaches a kernel launcher or a cuDNN-benchmarked "
        "forward (launch-sites) — a new autotune or launch configuration "
        "per batch shape"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        witness = getattr(config, "compile_witness", None)
        for h in model.torch_recompile_hazards:
            message = (
                f"{h.detail} — every distinct shape is a new cuDNN autotune "
                f"or launch configuration; route it through a declared "
                f"quantized funnel (static-funnels) or pad to a fixed shape"
            )
            pruned = False
            if witness:
                verdict = model.witness_verdict(h.site, witness)
                if verdict == "reproduced":
                    message += (
                        " [witness: this launch site saw a new signature "
                        "after warmup in the instrumented run]"
                    )
                elif verdict == "pruned":
                    pruned = True
                    message += (
                        " [witness_pruned: this launch site was exercised "
                        "in the instrumented run with no post-warmup "
                        "signature]"
                    )
            yield Finding(
                self.id, h.module, h.line, h.col, message,
                witness_pruned=pruned,
            )


@register
class TorchHotPathHostSync(Rule):
    id = "LDT1714"
    name = "torch-hot-path-host-sync"
    description = (
        "torch form of LDT1704: .item()/.tolist()/.cpu()/.numpy(), "
        "float()/int()/bool()/np.asarray on a torch value, or "
        "torch.cuda.synchronize in a device-hot-paths module outside the "
        "declared sync funnels"
    )
    family = "mesh"
    uses_mesh_model = True

    def check_program(self, program, config) -> Iterable[Finding]:
        model = build_mesh_model(program, config)
        for h in model.torch_host_syncs:
            yield Finding(
                self.id, h.module, h.line, h.col,
                f"{h.expr} waits for the card on the hot path ({h.func}) — "
                f"it blocks until every queued kernel lands; keep values on "
                f"the card, batch the fetch into a drain point, or declare "
                f"a sync funnel (sync-funnels) for a deliberate D2H site",
            )
