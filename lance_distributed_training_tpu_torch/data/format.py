"""Fragmented columnar storage — the port's copy of the JAX package's format.

Counterpart of ``lance_distributed_training_tpu/data/format.py``. The
on-disk layout is the same, so each package reads the other's datasets::

    <uri>/
      manifest.json             # latest version pointer + schema + fragments
      _versions/<n>.json        # immutable per-version manifests
      fragments/frag-<id>.arrow # Arrow IPC file, record batches of <=chunk rows

Fragment reads are zero-copy memory maps; a range read slices the
overlapping record batches.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc

__all__ = ["Dataset", "Fragment", "read_ranges", "write_dataset"]

_MANIFEST = "manifest.json"
_VERSIONS_DIR = "_versions"
_FRAGMENT_DIR = "fragments"
# Rows per Arrow record batch inside a fragment file: small enough that a
# row-range read touches few surplus rows, large enough to amortise framing.
_DEFAULT_CHUNK = 4096


def _schema_to_json(schema: pa.Schema) -> str:
    """Serialize a schema via Arrow IPC (hex) so all logical types round-trip."""
    return schema.serialize().to_pybytes().hex()


def _schema_from_json(payload: str) -> pa.Schema:
    return ipc.read_schema(pa.BufferReader(bytes.fromhex(payload)))


@dataclass(frozen=True)
class Fragment:
    """One immutable fragment: a contiguous slab of rows in its own file."""

    fragment_id: int
    path: str
    num_rows: int

    def open(self) -> ipc.RecordBatchFileReader:
        return ipc.open_file(pa.memory_map(self.path, "r"))


def _grouped_take(group_ids: np.ndarray, local: np.ndarray,
                  take_group) -> pa.Table:
    """Rows gathered group by group (a fragment, or a record batch of one)
    with ``take_group(group, local indices)``, in the order of the caller's
    indices: each group keeps its rows' order, and one take over the
    gathered rows alone restores the caller's."""
    order = np.argsort(group_ids, kind="stable")
    pieces = [take_group(int(g), local[order[group_ids[order] == g]])
              for g in np.unique(group_ids)]
    combined = pa.concat_tables(pieces).combine_chunks()  # row k: order[k]
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.size)
    return combined.take(pa.array(inverse))


class _FragmentReader:
    """Zero-copy row-range reads over one fragment's Arrow IPC file."""

    def __init__(self, fragment: Fragment):
        self.fragment = fragment
        self._reader = fragment.open()
        counts = [
            self._reader.get_batch(i).num_rows
            for i in range(self._reader.num_record_batches)
        ]
        self._offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._table: Optional[pa.Table] = None

    @property
    def num_rows(self) -> int:
        return int(self._offsets[-1])

    def read_range(self, start: int, stop: int) -> pa.Table:
        """Rows [start, stop) of this fragment as a table of zero-copy slices."""
        if not (0 <= start <= stop <= self.num_rows):
            raise IndexError(
                f"range [{start}, {stop}) out of bounds for fragment "
                f"{self.fragment.fragment_id} with {self.num_rows} rows"
            )
        if start == stop:
            return pa.table(
                {f.name: pa.array([], type=f.type) for f in self._reader.schema}
            )
        first = int(np.searchsorted(self._offsets, start, side="right")) - 1
        last = int(np.searchsorted(self._offsets, stop, side="left"))
        pieces = []
        for b in range(first, last):
            batch = self._reader.get_batch(b)
            b_start, b_stop = int(self._offsets[b]), int(self._offsets[b + 1])
            lo = max(start, b_start) - b_start
            hi = min(stop, b_stop) - b_start
            pieces.append(batch.slice(lo, hi - lo))
        return pa.Table.from_batches(pieces, schema=self._reader.schema)

    def table(self) -> pa.Table:
        """The whole fragment as a table of zero-copy views (cached)."""
        if self._table is None:
            self._table = pa.Table.from_batches(
                [
                    self._reader.get_batch(i)
                    for i in range(self._reader.num_record_batches)
                ],
                schema=self._reader.schema,
            )
        return self._table

    def take(self, indices: Sequence[int],
             columns: Optional[Sequence[str]] = None) -> pa.Table:
        """Rows ``indices`` of this fragment, in their order: gathered
        record batch by record batch, so only the chosen rows are copied
        (a take over the whole chunked fragment first concatenates its
        chunks, a copy of the entire column)."""
        indices = np.asarray(indices, dtype=np.int64)
        batch_ids = np.searchsorted(self._offsets, indices, side="right") - 1

        def take_batch(b: int, local: np.ndarray) -> pa.Table:
            table = pa.Table.from_batches([self._reader.get_batch(b)])
            if columns is not None:
                table = table.select(columns)
            return table.take(pa.array(local))

        return _grouped_take(batch_ids, indices - self._offsets[batch_ids],
                             take_batch)


class Dataset:
    """A fragmented columnar dataset — reader side: manifest metadata
    (``fragment_rows``, ``count_rows``, ``fingerprint``), row-range reads,
    sequential scans, global random-access ``take`` and row filters
    resolved to an index pool (``filter_indices``). ``version`` opens an
    earlier snapshot."""

    def __init__(self, uri: Union[str, os.PathLike],
                 version: Optional[int] = None):
        self.uri = str(uri)
        if version is None:
            manifest_path = os.path.join(self.uri, _MANIFEST)
        else:
            manifest_path = os.path.join(
                self.uri, _VERSIONS_DIR, f"{version}.json"
            )
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(f"no dataset manifest at {manifest_path}")
        with open(manifest_path) as f:
            manifest = json.load(f)
        self.version: int = manifest["version"]
        self.schema: pa.Schema = _schema_from_json(manifest["schema"])
        self.fragments: list[Fragment] = [
            Fragment(
                fragment_id=frag["id"],
                path=os.path.join(self.uri, frag["path"]),
                num_rows=frag["num_rows"],
            )
            for frag in manifest["fragments"]
        ]
        self._row_offsets = np.concatenate(
            [[0], np.cumsum([f.num_rows for f in self.fragments])]
        ).astype(np.int64)
        self._readers: dict[int, _FragmentReader] = {}
        self._lock = threading.Lock()
        # Content identity, computed once here: version, schema, and each
        # fragment's id, file name, rows and file size (size, not mtime, so
        # two hosts holding the same copy agree). The JAX package's
        # fingerprint of the same snapshot.
        h = hashlib.sha256()
        h.update(str(self.version).encode())
        h.update(manifest["schema"].encode())
        for frag in self.fragments:
            try:
                size = os.path.getsize(frag.path)
            except OSError:
                size = -1
            h.update(f"{frag.fragment_id}:{os.path.basename(frag.path)}:"
                     f"{frag.num_rows}:{size};".encode())
        self._fingerprint = h.hexdigest()

    def fingerprint(self) -> str:
        """Stable content identity of this dataset snapshot."""
        return self._fingerprint

    def get_fragments(self) -> list[Fragment]:
        return list(self.fragments)

    def fragment_rows(self) -> list[int]:
        """Per-fragment row counts — the sampler-plan input."""
        return [f.num_rows for f in self.fragments]

    def count_rows(self) -> int:
        return int(self._row_offsets[-1])

    def __len__(self) -> int:
        return self.count_rows()

    def _reader(self, fragment_id: int) -> _FragmentReader:
        with self._lock:
            reader = self._readers.get(fragment_id)
            if reader is None:
                reader = _FragmentReader(self.fragments[fragment_id])
                self._readers[fragment_id] = reader
            return reader

    def read_range(self, fragment_id: int, start: int, stop: int,
                   columns: Optional[Sequence[str]] = None) -> pa.Table:
        """Rows [start, stop) of one fragment (zero-copy slices)."""
        table = self._reader(fragment_id).read_range(start, stop)
        return table.select(columns) if columns is not None else table

    def scan(self, fragment_ids: Optional[Sequence[int]] = None,
             batch_size: int = _DEFAULT_CHUNK,
             columns: Optional[Sequence[str]] = None
             ) -> Iterator[pa.RecordBatch]:
        """Sequential streaming scan over (selected) fragments, in order."""
        ids = (range(len(self.fragments)) if fragment_ids is None
               else fragment_ids)
        for fid in ids:
            reader = self._reader(fid)
            for start in range(0, reader.num_rows, batch_size):
                stop = min(start + batch_size, reader.num_rows)
                table = reader.read_range(start, stop)
                if columns is not None:
                    table = table.select(columns)
                yield from table.to_batches()

    def take(self, indices: Sequence[int],
             columns: Optional[Sequence[str]] = None) -> pa.Table:
        """Random-access global rows, result in the order of ``indices``.
        ``columns`` projects at the fragment readers, before the gather, so
        unused columns are never copied."""
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size == 0:
            fields = (
                self.schema if columns is None
                else [self.schema.field(c) for c in columns]
            )
            return pa.table({f.name: pa.array([], type=f.type) for f in fields})
        if indices.min() < 0 or indices.max() >= self.count_rows():
            raise IndexError("take index out of bounds")
        frag_ids = np.searchsorted(self._row_offsets, indices, side="right") - 1
        return _grouped_take(
            frag_ids, indices - self._row_offsets[frag_ids],
            lambda fid, local: self._reader(fid).take(local, columns=columns))

    def take_batch(self, indices: Sequence[int]) -> pa.RecordBatch:
        return self.take(indices).combine_chunks().to_batches()[0]

    def filter_indices(self, predicate) -> np.ndarray:
        """Global row indices satisfying ``predicate``, ascending, as int64.

        ``predicate`` is a string in the mini-grammar (``"label < 50"``), a
        pyarrow compute Expression, or a callable ``table -> bool mask``
        (:mod:`.filters`). It is resolved once, fragment by fragment in
        order, to an index pool that the map-style loader deals batches
        from."""
        from .filters import predicate_mask

        out = []
        for fid in range(len(self.fragments)):
            mask = predicate_mask(self._reader(fid).table(), predicate)
            (local,) = np.nonzero(mask)
            out.append(local + self._row_offsets[fid])
        return (np.concatenate(out).astype(np.int64) if out
                else np.empty(0, np.int64))


def _iter_record_batches(
    data: Union[pa.Table, pa.RecordBatch, Iterable[pa.RecordBatch]],
) -> Iterator[pa.RecordBatch]:
    if isinstance(data, pa.Table):
        yield from data.to_batches()
    elif isinstance(data, pa.RecordBatch):
        yield data
    else:
        yield from data


def write_dataset(
    data: Union[pa.Table, pa.RecordBatch, Iterable[pa.RecordBatch]],
    uri: Union[str, os.PathLike],
    schema: Optional[pa.Schema] = None,
    mode: str = "create",
    max_rows_per_file: int = 1024 * 1024,
    chunk_rows: int = _DEFAULT_CHUNK,
) -> Dataset:
    """Streaming writer: consume record batches, shard into fragments of at
    most ``max_rows_per_file`` rows; ``mode`` is ``create``, ``overwrite``
    or ``append``. The manifest is swapped in atomically."""
    uri = str(uri)
    if mode not in ("create", "overwrite", "append"):
        raise ValueError(f"unknown mode {mode!r}")
    manifest_path = os.path.join(uri, _MANIFEST)
    exists = os.path.exists(manifest_path)
    if mode == "create" and exists:
        raise FileExistsError(f"dataset exists at {uri} (use mode='overwrite')")

    prev_fragments: list[dict] = []
    version = 1
    if mode == "append" and exists:
        with open(manifest_path) as f:
            prev = json.load(f)
        prev_fragments = prev["fragments"]
        version = prev["version"] + 1
        if schema is not None and _schema_to_json(schema) != prev["schema"]:
            raise ValueError("append schema mismatch")
        schema = _schema_from_json(prev["schema"])
    elif mode == "overwrite" and exists:
        with open(manifest_path) as f:
            version = json.load(f)["version"] + 1

    os.makedirs(os.path.join(uri, _FRAGMENT_DIR), exist_ok=True)
    os.makedirs(os.path.join(uri, _VERSIONS_DIR), exist_ok=True)

    next_id = max((f["id"] for f in prev_fragments), default=-1) + 1
    fragments = list(prev_fragments)
    writer: Optional[ipc.RecordBatchFileWriter] = None
    frag_rows = 0
    frag_path = ""

    def _open_fragment() -> None:
        nonlocal writer, frag_rows, frag_path
        frag_path = os.path.join(_FRAGMENT_DIR, f"frag-{next_id:05d}.arrow")
        writer = ipc.new_file(os.path.join(uri, frag_path), schema)
        frag_rows = 0

    def _close_fragment() -> None:
        nonlocal writer, next_id
        writer.close()
        fragments.append({"id": next_id, "path": frag_path, "num_rows": frag_rows})
        next_id += 1
        writer = None

    for batch in _iter_record_batches(data):
        if schema is None:
            schema = batch.schema
        elif batch.schema != schema:
            batch = batch.cast(schema)
        cursor = 0
        while cursor < batch.num_rows:
            if writer is None:
                _open_fragment()
            room = max_rows_per_file - frag_rows
            piece = batch.slice(cursor, min(room, batch.num_rows - cursor))
            for start in range(0, piece.num_rows, chunk_rows):
                writer.write_batch(
                    piece.slice(start, min(chunk_rows, piece.num_rows - start))
                )
            frag_rows += piece.num_rows
            cursor += piece.num_rows
            if frag_rows >= max_rows_per_file:
                _close_fragment()
    if writer is not None:
        _close_fragment()
    if schema is None:
        raise ValueError("empty input and no schema given")

    manifest = {
        "version": version,
        "schema": _schema_to_json(schema),
        "fragments": fragments,
    }
    with open(os.path.join(uri, _VERSIONS_DIR, f"{version}.json"), "w") as f:
        json.dump(manifest, f)
    fd, tmp = tempfile.mkstemp(dir=uri, suffix=".manifest.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, manifest_path)
    return Dataset(uri)


def read_ranges(dataset: Dataset, ranges, columns: Optional[Sequence[str]]
                = None) -> pa.Table:
    """Concatenate one step's row ranges (``samplers.ReadRange``s),
    projected to ``columns``: the iterable path's read, shared by the
    loaders and the data service's server (which loads no torch)."""
    tables = [dataset.read_range(r.fragment, r.start, r.stop,
                                 columns=columns) for r in ranges]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]
