"""Padding-hygiene rule (LDT1501).

The ragged token plane (``data/token_pack.py``) exists because padding
token batches to a dataset-wide max length burned FLOPs and bandwidth
proportional to sequence-length variance. The cheapest way to reintroduce
that tax is one innocent-looking call on a hot path:

* ``np.pad(...)`` — materialises a padded copy of something that was
  already addressable ragged;
* a full-``max_len`` token allocation — ``np.zeros((B, seq_len))`` /
  ``np.full((n, max_len), pad_id)`` / ``np.empty((..., pad_to))`` built
  from a *max-length-shaped* name, i.e. a dense token grid sized to the
  worst case instead of the batch's actual content.

Scoped to the ``hot-paths`` modules from ``[tool.ldt-check]``, with ONE
exemption: ``data/token_pack.py`` itself — the padded control arm must
live somewhere, and keeping every full-length allocation in the module
that also measures its waste (``pack_grid_tokens_total``) is the point of
the rule. Everywhere else, ragged values+offsets (or the planner) is the
answer; a deliberate exception can still be grandfathered in the baseline
or carry a reasoned ``# ldt: ignore[LDT1501]``.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

# Shape-name fragments that mean "sized to the maximum, not the content".
_MAX_SHAPE_NAMES = ("max_len", "seq_len", "pad_to", "max_length")

_ALLOCATORS = {"zeros", "full", "empty", "ones"}

# The padded control arm's home: exempt (see module docstring).
_EXEMPT = ("*token_pack.py",)


def _mentions_max_name(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None:
            folded = name.lower()
            if any(frag in folded for frag in _MAX_SHAPE_NAMES):
                return True
    return False


@register
class PaddingHygiene(Rule):
    id = "LDT1501"
    family = "padding"
    name = "padding-hygiene"
    description = (
        "hot-path modules: no np.pad and no full-max_len token-grid "
        "allocations (np.zeros/full/empty/ones shaped by a "
        "max_len/seq_len/pad_to name) outside data/token_pack.py — the "
        "ragged plane exists so padding waste is measured there, not "
        "silently reintroduced elsewhere"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        hot_paths = getattr(config, "hot_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in hot_paths):
            return
        if any(fnmatch.fnmatch(module.relpath, p) for p in _EXEMPT):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr == "pad":
                # np.pad / jnp.pad on a hot path: a padded copy of data
                # that was already addressable. (Method .pad on arbitrary
                # objects is rare enough on these modules that the
                # attribute name is the signal; baseline a deliberate one.)
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    ".pad() on a hot path materialises a padded copy — "
                    "carry the ragged values+offsets convention "
                    "(data/token_pack.py) instead, or move the padding "
                    "into token_pack.py where its waste is measured",
                )
                continue
            if func.attr in _ALLOCATORS and node.args:
                shape = node.args[0]
                if _mentions_max_name(shape):
                    yield Finding(
                        self.id, module.relpath, node.lineno,
                        node.col_offset,
                        f".{func.attr}(...) allocates a full-max-length "
                        "token grid (shape references a "
                        "max_len/seq_len/pad_to name) — dataset-max "
                        "padding belongs in token_pack.py's padded "
                        "control arm, where pack_grid_tokens_total "
                        "measures it",
                    )
