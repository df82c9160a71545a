"""Ragged token plane: variable-length sequences, FFD pack plans and the
text decode hook.

Counterpart of ``lance_distributed_training_tpu/data/token_pack.py``. A
variable-length column ``c`` rides the pipeline as two host tensors,
``c__values`` (flat int32 tokens, zero-padded to a power-of-two capacity
bucket) and ``c__offsets`` (int32 ``[n+1]`` row boundaries), plus a
batch-level pack plan (``_pack_slot``/``_pack_start`` per sequence and the
``_host_pack_meta`` header). K3 (:mod:`..ops.token_device`) scatters the
runs into packed ``[rows, pack_len]`` grids with segment and position ids
on the device.

* :class:`TokenPackPlanner` — deterministic length-bucketed
  first-fit-decreasing packing, a pure function of ``(lengths, pack_len,
  rows_multiple)``: the same lengths give the same plan.
* :class:`TokenDecoder` — the text tasks' decode hook in three modes:
  ``"pad"`` (pad every row to ``seq_len``), ``"pack"`` (FFD multi-sequence
  slots) and ``"bucket"`` (one sequence per slot, slot length bucketed to
  the batch max).

Every mode counts padding waste on the decoder itself:
``pack_payload_tokens_total`` (real tokens) against
``pack_grid_tokens_total`` (the grid the device processes), plus
``pack_sequences_total``, ``pack_truncated_tokens_total`` and
``pack_batches_total``. With a ``buffer_pool`` (:class:`~.buffers.BufferPool`)
the padded pages, the synthesised mask and the ragged page pairs are
leased from it. The JAX package's metrics registry, cost ledger and
autotuner hooks are not ported.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

__all__ = [
    "VALUES_SUFFIX",
    "OFFSETS_SUFFIX",
    "PACK_SLOT_KEY",
    "PACK_START_KEY",
    "PACK_META_KEY",
    "HOST_META_PREFIX",
    "PACK_MODE_FFD",
    "PACK_MODE_BUCKET",
    "COUNTER_NAMES",
    "is_ragged_key",
    "is_host_meta_key",
    "is_ragged_batch",
    "pack_meta",
    "ragged_bases",
    "ragged_capacity",
    "length_bucket",
    "PackPlan",
    "TokenPackConfig",
    "TokenPackPlanner",
    "TokenDecoder",
    "primitive_view",
    "list_column_parts",
    "fill_padded",
]

VALUES_SUFFIX = "__values"
OFFSETS_SUFFIX = "__offsets"
PACK_SLOT_KEY = "_pack_slot"
PACK_START_KEY = "_pack_start"
# Keys with this prefix stay host numpy through the pinned H2D stage, so
# the pack transform reads (rows, pack_len) without a device sync.
HOST_META_PREFIX = "_host_"
PACK_META_KEY = "_host_pack_meta"  # int32 [4]: rows, pack_len, payload, mode

PACK_MODE_FFD = 0  # multi-sequence slots + segment/position ids
PACK_MODE_BUCKET = 1  # one sequence per slot (row-preserving)

COUNTER_NAMES = (
    "pack_payload_tokens_total",
    "pack_grid_tokens_total",
    "pack_sequences_total",
    "pack_truncated_tokens_total",
    "pack_batches_total",
)


def is_ragged_key(name: str) -> bool:
    """Is this batch key part of the ragged convention (values/offsets/plan)?"""
    return (
        name.endswith(VALUES_SUFFIX)
        or name.endswith(OFFSETS_SUFFIX)
        or name in (PACK_SLOT_KEY, PACK_START_KEY)
    )


def is_host_meta_key(name: str) -> bool:
    """Host-passthrough keys: stay numpy through the H2D stage."""
    return name.startswith(HOST_META_PREFIX)


def is_ragged_batch(batch: dict) -> bool:
    return isinstance(batch, dict) and PACK_META_KEY in batch


def pack_meta(batch: dict) -> Tuple[int, int, int, int]:
    """``(rows, pack_len, payload, mode)`` from a ragged batch's host
    ``_host_pack_meta`` header (:meth:`PackPlan.meta` writes it)."""
    rows, pack_len, payload, mode = (
        int(x) for x in np.asarray(batch[PACK_META_KEY])[:4])
    return rows, pack_len, payload, mode


def ragged_bases(batch: dict) -> List[str]:
    """Base column names carried ragged in ``batch``, sorted."""
    return sorted(
        k[: -len(VALUES_SUFFIX)]
        for k in batch
        if k.endswith(VALUES_SUFFIX)
    )


def ragged_capacity(n: int, floor: int = 256) -> int:
    """Values-page capacity bucket for ``n`` flat tokens: the next power of
    two ≥ max(n, floor), so that variable batches reuse a few page sizes."""
    cap = max(int(n), floor, 1)
    return 1 << (cap - 1).bit_length()


def length_bucket(n: int, lo: int = 32, hi: int = 1 << 20) -> int:
    """Slot-length bucket: the next power of two ≥ n, clamped to [lo, hi]."""
    n = max(int(n), 1)
    edge = max(lo, 1 << (n - 1).bit_length())
    return min(edge, hi)


# -- Arrow views -------------------------------------------------------------


def primitive_view(arr: pa.Array) -> Tuple[np.ndarray, bool]:
    """A primitive Arrow array → ``(numpy view, copied)``: a null-free
    integer or float buffer is viewed in place; anything else is copied."""
    t = arr.type
    if arr.null_count == 0 and (
        pa.types.is_integer(t) or pa.types.is_floating(t)
    ):
        buf = arr.buffers()[1]
        if buf is not None:
            dtype = np.dtype(t.to_pandas_dtype())
            view = np.frombuffer(buf, dtype=dtype, count=arr.offset + len(arr))
            return view[arr.offset:], False
    return arr.to_numpy(zero_copy_only=False), True


def fill_padded(page: np.ndarray, values: np.ndarray, offsets: np.ndarray,
                lengths: np.ndarray) -> None:
    """Fill a pre-allocated ``[n, width]`` page with each row's (possibly
    truncated) token run."""
    for i in range(len(lengths)):
        n = int(lengths[i])
        page[i, :n] = values[int(offsets[i]):int(offsets[i]) + n]


def list_column_parts(col) -> Tuple[np.ndarray, np.ndarray, bool]:
    """A (large_)list column → ``(flat values view, offsets [B+1] int64,
    copied)``, offsets rebased to start at 0."""
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    raw_offsets, off_copied = primitive_view(col.offsets)
    offsets = raw_offsets.astype(np.int64)
    values, val_copied = primitive_view(col.values)
    lo, hi = int(offsets[0]), int(offsets[-1])
    return values[lo:hi], offsets - lo, (off_copied or val_copied)


def _single(col):
    return col.chunk(0) if isinstance(col, pa.ChunkedArray) else col


# -- the planner -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """One batch's packing decision. ``slot[i]``/``start[i]`` place
    sequence ``i``'s (possibly truncated) run at ``grid[slot[i],
    start[i]:start[i] + len_i]``; ``rows × pack_len`` is the grid shape."""

    slot: np.ndarray  # int32 [n]
    start: np.ndarray  # int32 [n]
    rows: int
    pack_len: int
    payload_tokens: int  # real tokens placed (after truncation)
    truncated_tokens: int  # tokens dropped by the pack_len cap

    @property
    def grid_tokens(self) -> int:
        return self.rows * self.pack_len

    def meta(self, mode: int) -> np.ndarray:
        """The ``_host_pack_meta`` header the batch carries."""
        return np.array(
            [self.rows, self.pack_len, self.payload_tokens, int(mode)],
            dtype=np.int32,
        )


@dataclasses.dataclass
class TokenPackConfig:
    """Pack knobs: ``pack_len`` caps the slot length; ``rows_multiple`` is
    the slot-count rounding quantum; ``len_bucket_lo`` floors the slot
    length ladder; ``rows_align`` is a divisibility floor on the row count
    applied after the rounding."""

    pack_len: int = 128
    rows_multiple: int = 8
    len_bucket_lo: int = 32
    pad_id: int = 0
    rows_align: int = 1

    def fingerprint(self) -> str:
        return (
            f"ffd/{self.pack_len}/{self.rows_multiple}/"
            f"{self.len_bucket_lo}/{self.pad_id}/{self.rows_align}"
        )


class TokenPackPlanner:
    """Deterministic first-fit-decreasing sequence packing: ``plan`` is a
    pure function of its argument and the config."""

    def __init__(self, config: Optional[TokenPackConfig] = None):
        self.config = config if config is not None else TokenPackConfig()

    def fingerprint(self) -> str:
        return self.config.fingerprint()

    def set_pack_len(self, value: int) -> int:
        value = max(8, int(value))
        self.config.pack_len = value
        return value

    def set_rows_multiple(self, value: int) -> int:
        value = max(1, int(value))
        self.config.rows_multiple = value
        return value

    def plan(self, lengths: Sequence[int]) -> PackPlan:
        """FFD packing of ``lengths`` into slots of the bucketed length:
        longest first (ties by original index), each into the first open
        slot with room; over-long sequences are truncated to the slot
        length and counted."""
        cfg = self.config
        n = len(lengths)
        arr = np.asarray(lengths, dtype=np.int64)
        if n == 0:
            return PackPlan(
                np.zeros(0, np.int32), np.zeros(0, np.int32),
                rows=max(1, cfg.rows_multiple), pack_len=cfg.len_bucket_lo,
                payload_tokens=0, truncated_tokens=0,
            )
        pack_len = length_bucket(
            int(arr.max()), lo=cfg.len_bucket_lo, hi=max(cfg.pack_len, 8)
        )
        clipped = np.minimum(arr, pack_len)
        truncated = int((arr - clipped).sum())
        order = np.lexsort((np.arange(n), -clipped))
        slot = np.zeros(n, np.int32)
        start = np.zeros(n, np.int32)
        fill: List[int] = []  # used length of each open slot
        for i in order:
            length = int(clipped[i])
            placed = -1
            for s, used in enumerate(fill):
                if used + length <= pack_len:
                    placed = s
                    break
            if placed < 0:
                placed = len(fill)
                fill.append(0)
            slot[i] = placed
            start[i] = fill[placed]
            fill[placed] += length
        rows = -(-max(len(fill), 1) // cfg.rows_multiple) * cfg.rows_multiple
        align = max(1, cfg.rows_align)
        rows = -(-rows // align) * align
        return PackPlan(slot, start, rows=rows, pack_len=pack_len,
                        payload_tokens=int(clipped.sum()),
                        truncated_tokens=truncated)

    def plan_bucket(self, lengths: Sequence[int]) -> PackPlan:
        """Row-preserving variant: sequence ``i`` occupies slot ``i``; the
        slot length is bucketed to the batch max."""
        cfg = self.config
        n = len(lengths)
        arr = np.asarray(lengths, dtype=np.int64)
        pack_len = length_bucket(
            int(arr.max()) if n else 1,
            lo=cfg.len_bucket_lo, hi=max(cfg.pack_len, 8),
        )
        clipped = np.minimum(arr, pack_len)
        return PackPlan(
            np.arange(n, dtype=np.int32), np.zeros(n, np.int32),
            rows=max(n, 1), pack_len=pack_len,
            payload_tokens=int(clipped.sum()),
            truncated_tokens=int((arr - clipped).sum()),
        )


# -- the decode hook ---------------------------------------------------------


class TokenDecoder:
    """Arrow token batches → host numpy arrays, ragged-aware.

    ``"pad"`` pads variable-length list columns to ``seq_len`` (with an
    ``attention_mask`` synthesised when the schema lacks one);
    fixed-size-list columns become zero-copy ``[B, L]`` views. ``"pack"``
    emits the ragged convention and an FFD :class:`PackPlan`; ``"bucket"``
    a row-preserving plan. Every mode adds to the ``pack_*`` counters
    (:data:`COUNTER_NAMES`, plain integer attributes, safe under several
    producer threads). With ``buffer_pool`` the pages it writes are
    leased."""

    def __init__(
        self,
        mode: str = "pad",
        seq_len: int = 128,
        planner: Optional[TokenPackPlanner] = None,
        buffer_pool=None,
        pad_id: int = 0,
    ):
        if mode not in ("pad", "pack", "bucket"):
            raise ValueError(f"invalid TokenDecoder mode: {mode!r}")
        self.mode = mode
        self.seq_len = int(seq_len)
        self.planner = (
            planner if planner is not None
            else TokenPackPlanner(TokenPackConfig(pack_len=self.seq_len))
        )
        self.buffer_pool = buffer_pool
        self.pad_id = int(pad_id)
        self._count_lock = threading.Lock()
        for name in COUNTER_NAMES:
            setattr(self, name, 0)

    def counters(self) -> Dict[str, int]:
        """The waste counters, by name."""
        return {name: getattr(self, name) for name in COUNTER_NAMES}

    def _add(self, payload: int, grid: int, seqs: int, truncated: int,
             batches: int = 1) -> None:
        with self._count_lock:
            self.pack_payload_tokens_total += int(payload)
            self.pack_grid_tokens_total += int(grid)
            self.pack_sequences_total += int(seqs)
            self.pack_truncated_tokens_total += int(truncated)
            self.pack_batches_total += int(batches)

    def _lease(self, shape, dtype) -> np.ndarray:
        if self.buffer_pool is None:
            return np.empty(tuple(shape), np.dtype(dtype))
        return self.buffer_pool.lease(shape, dtype)

    def cache_fingerprint(self) -> str:
        """Everything that can change the bytes this decoder emits."""
        return (
            f"TokenDecoder/{self.mode}/{self.seq_len}/{self.pad_id}/"
            f"{self.planner.fingerprint()}"
        )

    def __call__(self, batch) -> Dict[str, np.ndarray]:
        table = (
            pa.Table.from_batches([batch])
            if isinstance(batch, pa.RecordBatch) else batch
        )
        fixed: Dict[str, np.ndarray] = {}
        ragged: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for name in table.column_names:
            col = table.column(name).combine_chunks()
            if pa.types.is_fixed_size_list(col.type):
                flat = _single(col)
                values, _ = primitive_view(flat.flatten())
                fixed[name] = values.reshape(len(flat), col.type.list_size)
            elif pa.types.is_list(col.type) or pa.types.is_large_list(
                col.type
            ):
                values, offsets, _ = list_column_parts(col)
                ragged[name] = (values, offsets)
            else:
                fixed[name], _ = primitive_view(_single(col))
        if not ragged:
            self._count_fixed(fixed)
            return fixed
        if self.mode == "pad":
            return self._emit_padded(fixed, ragged)
        return self._emit_ragged(fixed, ragged)

    def _count_fixed(self, out: Dict[str, np.ndarray]) -> None:
        ids = out.get("input_ids")
        if ids is None or ids.ndim != 2:
            return
        mask = out.get("attention_mask")
        real = int(np.count_nonzero(mask)) if mask is not None \
            else int(ids.size)
        self._add(real, ids.size, ids.shape[0], 0)

    def _emit_padded(self, fixed, ragged) -> Dict[str, np.ndarray]:
        """Pad every ragged column to ``seq_len``."""
        out = dict(fixed)
        lengths = None
        base_offsets = None
        total_real = 0
        truncated = 0
        for name, (values, offsets) in sorted(ragged.items()):
            n = len(offsets) - 1
            col_lengths = np.minimum(
                offsets[1:] - offsets[:-1], self.seq_len
            )
            if lengths is None:
                lengths = col_lengths
                base_offsets = offsets
            elif not np.array_equal(offsets, base_offsets):
                # One length vector must describe every ragged column, or
                # the synthesised attention_mask would mark the wrong
                # positions valid for the others.
                raise ValueError(
                    f"ragged column {name!r} has different row lengths "
                    "than its siblings — the padded arm synthesizes one "
                    "attention_mask for the whole batch"
                )
            page = self._lease((n, self.seq_len), values.dtype)
            # In the batch before it is filled: the consumer's release
            # reclaims it on every path.
            out[name] = page
            page[...] = self.pad_id
            fill_padded(page, values, offsets, col_lengths)
            total_real += int(col_lengths.sum())
            truncated += int((offsets[1:] - offsets[:-1] - col_lengths).sum())
        if "attention_mask" not in out and lengths is not None:
            mask = self._lease((len(lengths), self.seq_len), np.int8)
            out["attention_mask"] = mask
            mask[...] = np.arange(self.seq_len)[None, :] < lengths[:, None]
        if lengths is not None:
            # The grid counts every padded token column; the payload
            # mirrors it, so the two compare like with like.
            self._add(total_real, len(lengths) * self.seq_len * len(ragged),
                      len(lengths), truncated)
        return out

    def _emit_ragged(self, fixed, ragged) -> Dict[str, np.ndarray]:
        # The device regenerates the mask; a stored variable-length one
        # would double the bytes for no information.
        ragged.pop("attention_mask", None)
        if not ragged:
            return self._emit_padded(fixed, {})
        if self.mode == "pack" and fixed:
            extra = sorted(fixed)
            raise ValueError(
                "token_pack (FFD) reorders sequences into packed slots and "
                f"cannot carry per-row fixed columns {extra} alongside "
                "ragged ones; use bucket mode (row-preserving) for paired "
                "modalities"
            )
        out: Dict[str, np.ndarray] = dict(fixed)
        plan: Optional[PackPlan] = None
        base_offsets: Optional[np.ndarray] = None
        for name, (values, offsets) in sorted(ragged.items()):
            if base_offsets is None:
                base_offsets = offsets
                lengths = offsets[1:] - offsets[:-1]
                plan = (
                    self.planner.plan(lengths)
                    if self.mode == "pack"
                    else self.planner.plan_bucket(lengths)
                )
            elif not np.array_equal(offsets, base_offsets):
                raise ValueError(
                    f"ragged column {name!r} has different row lengths "
                    "than its siblings — one pack plan must place every "
                    "ragged column"
                )
            total = int(offsets[-1])
            if self.buffer_pool is not None:
                page = self.buffer_pool.lease_ragged(
                    total, len(offsets) - 1, values.dtype)
                vpage, opage = page.values, page.offsets
            else:
                vpage = np.empty((ragged_capacity(total),), values.dtype)
                opage = np.empty((len(offsets),), np.int32)
            # Both pages ride the batch before they are filled.
            out[name + VALUES_SUFFIX] = vpage
            out[name + OFFSETS_SUFFIX] = opage
            np.copyto(vpage[:total], values)
            vpage[total:] = 0  # a deterministic tail: digests stay stable
            np.copyto(opage, offsets.astype(np.int32))
        if plan is None:
            raise AssertionError("no ragged column planned")
        out[PACK_SLOT_KEY] = plan.slot
        out[PACK_START_KEY] = plan.start
        mode = PACK_MODE_FFD if self.mode == "pack" else PACK_MODE_BUCKET
        out[PACK_META_KEY] = plan.meta(mode)
        self._add(plan.payload_tokens * len(ragged),
                  plan.grid_tokens * len(ragged), len(plan.slot),
                  plan.truncated_tokens * len(ragged))
        return out
