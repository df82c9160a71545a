"""Placement-hygiene rule (LDT801).

The r7 placement plane (``data/placement.py``) exists because every loader
used to end in a private ``jax.device_put`` on the consumer thread — the
step then waited on the H2D transfer instead of overlapping it (~97%
loader stall in BENCH_AB_r05). The cheapest way to reintroduce that stall
is one innocent ``jax.device_put(batch)`` in a hot-path module: it works,
it is synchronous, and nothing measures it separately.

This rule rejects direct calls to the H2D primitives — ``jax.device_put``
and ``make_array_from_single_device_arrays`` (however imported from jax) —
in the ``hot-paths`` modules from ``[tool.ldt-check]``, outside the two
modules allowed to own them: ``data/placement.py`` (the plane) and
``parallel/_compat.py`` (the version shim both primitives are re-exported
from). Calls routed through the shim (``from ..parallel._compat import
device_put``) resolve to the compat module's dotted name and are legal;
the import map distinguishes them from jax's, so no suppression comments
are needed for the sanctioned paths. Same baseline machinery as LDT701:
grandfather a deliberate site with ``ldt check --update-baseline`` or a
``# ldt: ignore[LDT801]``.

In the PyTorch port LDT801 is kept unchanged (parity with JAX's checker on
JAX code; the port has no ``jax.device_put``, so it is inert there). Its
torch form, **LDT802**, applies to hot-path modules that import torch and
not JAX: ``.cuda()``, ``.to(<cuda device>)`` and ``torch.as_tensor`` /
``torch.tensor`` / ``torch.from_numpy(...).to`` with a CUDA ``device=``
outside ``data/placement.py``, the port's placement plane (pinned pages,
a copy stream and a ring of ``--placement_depth`` batches). A device
argument counts as CUDA when it is a ``"cuda..."`` literal, a
``torch.device("cuda"...)`` call, or a name or attribute that names a
device (``device``, ``dev``, ``*_device``, ``cuda*``).
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

# jax-qualified names of the H2D primitives the placement plane owns.
# make_array_from_process_local_data is the synchronous multi-process
# assembly — the exact consumer-thread transfer the plane replaces — so
# it is fenced too (the plane's own fallback uses the _compat re-export).
_H2D_QUALNAMES = {
    "jax.device_put",
    "jax.make_array_from_single_device_arrays",
    "jax.experimental.array.make_array_from_single_device_arrays",
    "jax.make_array_from_process_local_data",
}

# Modules allowed to touch them directly (besides the compat shim, which
# comes from config so a repo relayout keeps working).
_PLACEMENT_MODULE_SUFFIX = "data/placement.py"


@register
class PlacementHygiene(Rule):
    id = "LDT801"
    family = "placement"
    name = "placement-hygiene"
    description = (
        "hot-path modules: no direct jax.device_put / "
        "make_array_from_single_device_arrays — H2D belongs to the "
        "placement plane (data/placement.py) or the _compat shim, so "
        "transfers stay async, measured (trainer_h2d_ms), and off the "
        "consumer thread"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        import fnmatch

        hot_paths = getattr(config, "hot_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in hot_paths):
            return
        if module.relpath.endswith(_PLACEMENT_MODULE_SUFFIX):
            return
        if module.relpath == getattr(config, "compat_module", ""):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = module.qualname(node.func)
            if qn in _H2D_QUALNAMES:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"direct {qn}(...) on a hot path runs the H2D transfer "
                    "synchronously on the calling thread, invisible to the "
                    "trainer_h2d_ms accounting — route it through the "
                    "placement plane (data/placement.py) or the _compat "
                    "re-export, or baseline a deliberate site",
                )


_TORCH_TENSOR_CTORS = {"torch.as_tensor", "torch.tensor", "torch.asarray"}


@register
class TorchPlacementHygiene(Rule):
    id = "LDT802"
    family = "placement"
    name = "torch-placement-hygiene"
    description = (
        "torch form of LDT801: hot-path modules make no H2D copy "
        "(.cuda(), .to(cuda), torch.as_tensor/tensor(device=cuda)) outside "
        "the placement plane (data/placement.py)"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        import fnmatch

        from ..meshmodel import _cuda_device as _cuda_device_arg, _torch_module

        hot_paths = getattr(config, "hot_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in hot_paths):
            return
        if module.relpath.endswith(_PLACEMENT_MODULE_SUFFIX) \
                or not _torch_module(module):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            what = None
            device_kw = [kw.value for kw in node.keywords
                         if kw.arg == "device"]
            if isinstance(func, ast.Attribute) and func.attr == "cuda":
                what = ".cuda()"
            elif isinstance(func, ast.Attribute) and func.attr == "to" and (
                    any(_cuda_device_arg(module, a) for a in node.args[:1])
                    or any(_cuda_device_arg(module, a) for a in device_kw)):
                what = ".to(<cuda>)"
            elif module.qualname(func) in _TORCH_TENSOR_CTORS and any(
                    _cuda_device_arg(module, a) for a in device_kw):
                what = f"{module.qualname(func)}(..., device=<cuda>)"
            if what is not None:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"{what} on a hot path copies host to card on the "
                    "calling thread, outside the placement plane's pinned "
                    "pages and copy stream — route the batch through "
                    "data/placement.py, or suppress a deliberate site with "
                    "a reason",
                )
