"""Sampler plans — pure functions from fragment row counts to read plans.

Counterpart of ``lance_distributed_training_tpu/data/samplers.py``; the
plans are identical for identical arguments. A plan is per process: step
``s`` of process ``p`` is ``plan[s]``, a list of :class:`ReadRange`. Every
process emits the same number of steps of the same row count, which
:func:`assert_equal_step_counts` checks before training (unequal step
counts hang a collective).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

__all__ = [
    "ReadRange",
    "full_scan_plan",
    "sharded_batch_plan",
    "sharded_fragment_plan",
    "assert_equal_step_counts",
    "make_plan",
    "distributed_indices",
    "distributed_index_batches",
    "padded_eval_index_batches",
    "slice_plan",
]


class ReadRange(NamedTuple):
    """Rows ``[start, stop)`` of one fragment."""

    fragment: int
    start: int
    stop: int

    @property
    def num_rows(self) -> int:
        return self.stop - self.start


Plan = list[list[ReadRange]]


def _global_to_ranges(fragment_rows: Sequence[int], start: int,
                      stop: int) -> list[ReadRange]:
    """Global row span [start, stop) → per-fragment ranges (may straddle)."""
    offsets = np.concatenate([[0], np.cumsum(fragment_rows)])
    ranges = []
    for fid in range(len(fragment_rows)):
        lo = max(start, int(offsets[fid]))
        hi = min(stop, int(offsets[fid + 1]))
        if lo < hi:
            ranges.append(
                ReadRange(fid, lo - int(offsets[fid]), hi - int(offsets[fid]))
            )
    return ranges


def full_scan_plan(fragment_rows: Sequence[int], batch_size: int) -> Plan:
    """Every process scans the full dataset sequentially (not DP-aware);
    the last batch may be short."""
    total = int(sum(fragment_rows))
    return [
        _global_to_ranges(fragment_rows, start, min(start + batch_size, total))
        for start in range(0, total, batch_size)
    ]


def sharded_batch_plan(fragment_rows: Sequence[int], batch_size: int,
                       process_index: int, process_count: int, *,
                       shuffle: bool = False, seed: int = 0,
                       epoch: int = 0) -> Plan:
    """Global batches dealt round-robin (rank 0 → batches 0, n, 2n, …).

    The ragged tail and the batches that cannot be dealt evenly are
    dropped. ``shuffle`` permutes the batch order with a ``seed + epoch``
    numpy generator, the same on every process."""
    _check_topology(process_index, process_count)
    total = int(sum(fragment_rows))
    num_batches = total // batch_size
    usable = (num_batches // process_count) * process_count
    order = np.arange(usable)
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(usable)
    return [
        _global_to_ranges(fragment_rows, int(b) * batch_size,
                          (int(b) + 1) * batch_size)
        for b in order[process_index::process_count]
    ]


def sharded_fragment_plan(fragment_rows: Sequence[int], batch_size: int,
                          process_index: int, process_count: int, *,
                          pad: bool = True) -> Plan:
    """Process ``k`` reads fragments ``k, k + n, …`` sequentially.

    ``pad=True`` equalises step counts by wrapping around the process's
    own rows (``max_p ceil(rows_p / batch)`` steps); ``pad=False`` truncates
    every process to ``min_p floor(rows_p / batch)`` steps."""
    _check_topology(process_index, process_count)
    num_fragments = len(fragment_rows)
    per_proc_rows = [
        sum(fragment_rows[f] for f in range(p, num_fragments, process_count))
        for p in range(process_count)
    ]
    my_fragments = list(range(process_index, num_fragments, process_count))
    my_rows = per_proc_rows[process_index]
    if pad:
        steps = max(-(-rows // batch_size) for rows in per_proc_rows)
    else:
        steps = min(rows // batch_size for rows in per_proc_rows)
    if steps == 0:
        return []
    if my_rows == 0:
        # A process without fragments must still emit `steps` batches:
        # wrap reads around the whole dataset's non-empty fragments.
        my_fragments = [f for f in range(num_fragments) if fragment_rows[f] > 0]
        my_rows = sum(fragment_rows[f] for f in my_fragments)
        if my_rows == 0:
            raise ValueError("dataset has no rows")
    local_offsets = np.concatenate(
        [[0], np.cumsum([fragment_rows[f] for f in my_fragments])]
    )

    def local_range(start: int, stop: int) -> list[ReadRange]:
        out = []
        for i, fid in enumerate(my_fragments):
            lo = max(start, int(local_offsets[i]))
            hi = min(stop, int(local_offsets[i + 1]))
            if lo < hi:
                out.append(ReadRange(fid, lo - int(local_offsets[i]),
                                     hi - int(local_offsets[i])))
        return out

    plan: Plan = []
    for s in range(steps):
        ranges: list[ReadRange] = []
        need = batch_size
        cursor = (s * batch_size) % my_rows
        while need > 0:
            span = min(need, my_rows - cursor)
            ranges.extend(local_range(cursor, cursor + span))
            need -= span
            cursor = (cursor + span) % my_rows
        plan.append(ranges)
    return plan


def distributed_indices(num_rows: int, process_index: int,
                        process_count: int, *, shuffle: bool = True,
                        seed: int = 0, epoch: int = 0,
                        drop_last: bool = False) -> np.ndarray:
    """Map-style index sharding with torch ``DistributedSampler``'s
    semantics, ``set_epoch`` included: the permutation is seeded by
    ``seed + epoch``; rows are padded by wrap-around (or dropped with
    ``drop_last``) to a multiple of ``process_count`` and dealt
    ``indices[rank::world_size]``."""
    _check_topology(process_index, process_count)
    if shuffle:
        indices = np.random.default_rng(seed + epoch).permutation(num_rows)
    else:
        indices = np.arange(num_rows)
    if drop_last:
        indices = indices[:(num_rows // process_count) * process_count]
    else:
        target = -(-num_rows // process_count) * process_count
        if target > num_rows:
            indices = np.concatenate([indices, indices[:target - num_rows]])
    return indices[process_index::process_count]


def distributed_index_batches(num_rows: int, batch_size: int,
                              process_index: int, process_count: int, *,
                              shuffle: bool = True, seed: int = 0,
                              epoch: int = 0,
                              drop_last: bool = True) -> list[np.ndarray]:
    """:func:`distributed_indices` sliced into per-step batches: the
    map-style batches of the columnar and the folder loaders."""
    indices = distributed_indices(num_rows, process_index, process_count,
                                  shuffle=shuffle, seed=seed, epoch=epoch,
                                  drop_last=drop_last)
    n = len(indices)
    steps = n // batch_size if drop_last else -(-n // batch_size)
    return [indices[s * batch_size:(s + 1) * batch_size]
            for s in range(steps)]


def padded_eval_index_batches(num_rows: int, global_batch: int,
                              process_index: int, process_count: int, *,
                              index_pool: Optional[np.ndarray] = None
                              ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Full-coverage eval plan: every row exactly once at one batch shape.

    The tail batch is padded back to ``global_batch`` by wrap-around rows
    carried with weight 0.0, so a weighted metric counts each row once.
    Returns this process's ``(indices, weights)`` per step: its
    ``global_batch // process_count`` slice of each global batch. With
    ``index_pool`` (a filter pool, a val split) the positions index into
    the pool."""
    _check_topology(process_index, process_count)
    per_process, rem = divmod(global_batch, process_count)
    if rem:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes"
        )
    if num_rows <= 0:
        return []
    n_batches = -(-num_rows // global_batch)
    padded = n_batches * global_batch
    pos = np.arange(padded) % num_rows
    idx = index_pool[pos] if index_pool is not None else pos
    weights = (np.arange(padded) < num_rows).astype(np.float32)
    out = []
    for b in range(n_batches):
        lo = b * global_batch + process_index * per_process
        out.append((idx[lo:lo + per_process], weights[lo:lo + per_process]))
    return out


def make_plan(sampler_type: str, fragment_rows: Sequence[int],
              batch_size: int, process_index: int, process_count: int, *,
              pad: bool = True, shuffle: bool = False, seed: int = 0,
              epoch: int = 0) -> Plan:
    """Dispatch by sampler name; ``shuffle`` applies to the batch sampler
    only and raises with another."""
    if shuffle and sampler_type not in ("batch", "sharded_batch"):
        raise ValueError(
            f"shuffle=True supports sampler_type='batch' only — got "
            f"{sampler_type!r}"
        )
    if sampler_type in ("batch", "sharded_batch"):
        return sharded_batch_plan(
            fragment_rows, batch_size, process_index, process_count,
            shuffle=shuffle, seed=seed, epoch=epoch,
        )
    if sampler_type in ("fragment", "sharded_fragment"):
        return sharded_fragment_plan(
            fragment_rows, batch_size, process_index, process_count, pad=pad
        )
    if sampler_type in ("full", "full_scan"):
        return full_scan_plan(fragment_rows, batch_size)
    raise ValueError(f"Invalid sampler type: {sampler_type}")


def assert_equal_step_counts(plans: Sequence[Plan],
                             batch_size: Optional[int] = None) -> None:
    """All per-process plans must agree on step count and per-step rows."""
    counts = [len(p) for p in plans]
    if len(set(counts)) > 1:
        raise RuntimeError(
            f"deadlock hazard: per-process step counts differ: {counts}"
        )
    for step in range(counts[0] if counts else 0):
        rows = [sum(r.num_rows for r in plan[step]) for plan in plans]
        if len(set(rows)) > 1:
            raise RuntimeError(
                f"deadlock hazard: step {step} row counts differ across "
                f"processes: {rows}"
            )
        if batch_size is not None and rows and rows[0] != batch_size:
            raise RuntimeError(
                f"step {step} rows {rows[0]} != batch_size {batch_size}"
            )


def slice_plan(plan: Sequence, start_step: int) -> list:
    """The tail of a per-process plan from the resume cursor
    ``start_step``. A plan is a pure function of its arguments, so a
    restarted process rebuilds the same plan and the tail holds exactly the
    batches not yet consumed. ``start_step == len(plan)`` is valid (a
    checkpoint taken on the last batch resumes into an empty tail); beyond
    it the cursor is corrupt and raises."""
    if not 0 <= start_step <= len(plan):
        raise ValueError(
            f"resume cursor {start_step} outside plan of {len(plan)} steps"
        )
    return list(plan[start_step:])


def _check_topology(process_index: int, process_count: int) -> None:
    if process_count < 1 or not (0 <= process_index < process_count):
        raise ValueError(
            f"invalid topology: process {process_index} of {process_count}"
        )
