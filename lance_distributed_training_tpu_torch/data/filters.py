"""Row-filter predicates for the columnar store.

Counterpart of ``lance_distributed_training_tpu/data/filters.py``: the same
grammar, the same pools and the same error messages. A predicate is
resolved once, up front, to a global row-index pool
(:meth:`~.format.Dataset.filter_indices`); the map-style sampler then
shards and permutes inside that pool, so every process sees the same pool
and the equal-step-count invariant of the distributed samplers holds.

Accepted predicate forms:

* a **string** in the mini-grammar ``column OP literal [& column OP
  literal ...]`` with OP in ``== != <= >= < >``, e.g. ``"label < 50"`` or
  ``"label >= 10 & label != 13"`` (conjunction only; the CLI's
  ``--filter``);
* a **pyarrow.compute.Expression**, e.g. ``pc.field("label") < 50``;
* a **callable** ``table -> bool mask`` for any Python predicate.
"""

from __future__ import annotations

import re
from typing import Callable, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

__all__ = ["parse_predicate", "predicate_mask", "Predicate"]

Predicate = Union[str, "pc.Expression", Callable[[pa.Table], np.ndarray]]

_COMPARISON = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*(==|!=|<=|>=|<|>)\s*(.+?)\s*$"
)

_OPS = {
    "==": lambda f, v: f == v,
    "!=": lambda f, v: f != v,
    "<": lambda f, v: f < v,
    "<=": lambda f, v: f <= v,
    ">": lambda f, v: f > v,
    ">=": lambda f, v: f >= v,
}


def _literal(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        raise ValueError(
            f"unparseable literal {text!r} (int, float, or quoted string)"
        ) from None


def parse_predicate(text: str) -> "pc.Expression":
    """``"label < 50 & label != 13"`` → a pyarrow compute Expression."""
    terms = [t for t in text.split("&") if t.strip()]
    if not terms:
        raise ValueError(f"empty predicate {text!r}")
    expr = None
    for term in terms:
        m = _COMPARISON.match(term)
        if m is None:
            raise ValueError(
                f"bad predicate term {term!r} (expected 'column OP literal' "
                "with OP in == != <= >= < >)"
            )
        column, op, lit = m.groups()
        piece = _OPS[op](pc.field(column), _literal(lit))
        expr = piece if expr is None else (expr & piece)
    return expr


def predicate_mask(table: pa.Table, predicate: Predicate) -> np.ndarray:
    """Evaluate any accepted predicate form → boolean numpy mask over rows."""
    if isinstance(predicate, str):
        predicate = parse_predicate(predicate)
    if callable(predicate) and not isinstance(predicate, pc.Expression):
        mask = np.asarray(predicate(table), dtype=bool)
        if mask.shape != (table.num_rows,):
            raise ValueError(
                f"callable predicate returned shape {mask.shape}, expected "
                f"({table.num_rows},)"
            )
        return mask
    # Expression: scan with the predicate as the filter but project only a
    # row-id column, so a kept row copies 8 bytes and never its payload (a
    # JPEG column). append_column is metadata only.
    import pyarrow.dataset as pads

    ids = pa.array(np.arange(table.num_rows, dtype=np.int64))
    kept = (
        pads.dataset(table.append_column("__row__", ids))
        .scanner(columns=["__row__"], filter=predicate)
        .to_table()
    )
    mask = np.zeros(table.num_rows, dtype=bool)
    mask[kept.column("__row__").to_numpy()] = True
    return mask
