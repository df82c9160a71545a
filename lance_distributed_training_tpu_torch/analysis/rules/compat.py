"""Compat-enforcement rule (LDT401).

The seed's single worst failure was 14 test modules dying at collection
because ``jax.experimental.shard_map`` moved between jax releases.
``parallel/_compat.py`` now owns every version-moved symbol (``shard_map``,
``pcast``, ``axis_size``) behind feature-detection; this rule makes the fix
permanent by rejecting any direct import or attribute use of those symbols
from jax anywhere else in the package.

In the PyTorch port LDT401 is kept unchanged, so that the port's checker
gives JAX's findings on JAX code; the port has no version shim and no jax
import, so it is inert there. Its torch form, **LDT402**, guards the port's
import boundary in the ``boundary-paths`` modules (empty by default, so
inert on JAX code): no import of ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax`` or of the JAX package ``lance_distributed_training_tpu``, and,
at module level (what runs at import), no ``triton`` import and no kernel
build (``load_library``, ``build_library``, ``_library``,
``cpp_extension.load``/``load_inline``): kernels build at their first
launch, so a machine without a compiler can import every module.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register


@register
class DirectCompatImport(Rule):
    id = "LDT401"
    family = "compat"
    name = "direct-compat-import"
    description = (
        "version-moved jax symbol (shard_map/pcast/axis_size) imported or "
        "used directly outside parallel/_compat.py"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        if module.relpath == config.compat_module:
            return
        symbols = set(config.compat_symbols)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:  # relative import — can only be the shim
                    continue
                if mod == "jax" or mod.startswith("jax."):
                    for alias in node.names:
                        if alias.name in symbols or mod.rsplit(
                            ".", 1
                        )[-1] in symbols:
                            yield Finding(
                                self.id, module.relpath,
                                node.lineno, node.col_offset,
                                f"direct import of {alias.name!r} from "
                                f"{mod!r} — this symbol moved between jax "
                                "releases and broke package-wide import "
                                "once already; import it from "
                                f"{config.compat_module} instead",
                            )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith("jax") and alias.name.rsplit(
                        ".", 1
                    )[-1] in symbols:
                        yield Finding(
                            self.id, module.relpath,
                            node.lineno, node.col_offset,
                            f"direct import of {alias.name!r} — import the "
                            f"symbol from {config.compat_module} instead",
                        )
            elif isinstance(node, ast.Attribute):
                if node.attr not in symbols:
                    continue
                qn = module.qualname(node)
                if qn and (
                    qn.startswith("jax.") or qn.startswith("jax.lax.")
                ):
                    # hasattr(lax, "...") probes are string-based and never
                    # reach here; a real attribute use does.
                    yield Finding(
                        self.id, module.relpath,
                        node.lineno, node.col_offset,
                        f"direct use of {qn} — version-moved jax API; use "
                        f"the shim in {config.compat_module}",
                    )


# Top-level packages the port may not import, and the JAX package itself.
_FOREIGN_TOPS = ("jax", "jaxlib", "flax", "optax", "orbax")
_JAX_PACKAGE = "lance_distributed_training_tpu"
# Calls that build or load a kernel library.
_BUILD_TAILS = ("load_library", "build_library", "_library", "load_inline")


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in _FOREIGN_TOPS or top == _JAX_PACKAGE


def _at_import(module: ModuleInfo, node: ast.AST) -> bool:
    """Does ``node`` run when the module is imported (not inside a def)?"""
    return module.enclosing(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) is None


@register
class PortImportBoundary(Rule):
    id = "LDT402"
    family = "compat"
    name = "port-import-boundary"
    description = (
        "torch form of LDT401: a boundary-paths module imports jax/flax/"
        "optax/orbax or the JAX package, or imports triton or builds a "
        "kernel at module level"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        paths = getattr(config, "boundary_paths", None) or ()
        if not any(fnmatch.fnmatch(module.relpath, p) for p in paths):
            return
        for node in ast.walk(module.tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            for name in names:
                if _foreign(name):
                    yield Finding(
                        self.id, module.relpath, node.lineno, node.col_offset,
                        f"import of {name!r} crosses the port's boundary — "
                        "the port imports torch and nothing of JAX or of "
                        "the JAX package; keep a copy of what it needs",
                    )
                elif name.split(".")[0] == "triton" \
                        and _at_import(module, node):
                    yield Finding(
                        self.id, module.relpath, node.lineno, node.col_offset,
                        "module-level triton import — import triton inside "
                        "the function that launches the kernel, so that a "
                        "machine without triton imports every module",
                    )
            if isinstance(node, ast.Call) and _at_import(module, node):
                qn = module.qualname(node.func) or ""
                tail = qn.rsplit(".", 1)[-1]
                if tail in _BUILD_TAILS or qn.endswith("cpp_extension.load"):
                    yield Finding(
                        self.id, module.relpath, node.lineno, node.col_offset,
                        f"{qn}(...) at import builds or loads a kernel — "
                        "build at the kernel's first launch instead",
                    )
