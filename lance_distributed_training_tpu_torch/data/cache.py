"""Epoch-coherent decoded-batch cache — the tiered RAM/disk plane.

Counterpart of ``lance_distributed_training_tpu/data/cache.py``: the same
fingerprints, entry names, segment format and budgets, so for the same
inputs a key names the same entry in both packages. The port spills under
a directory of its own (:func:`default_cache_dir`), so the two packages
never share entries. :class:`DeviceReplayCache` keeps torch tensors on the
card (the HBM tier of ``--device_cache``); its budget clamps to the card's
free memory (``torch.cuda.mem_get_info``) on CUDA and is the configured
one alone on the CPU.

Every epoch after the first re-pays the full source→decode cost for
byte-identical content: the pipelines re-read fragments and re-run entropy
decode for batches whose plan items are already known. The tf.data-service
paper (PAPERS.md 2210.14826) makes the case that caching materialized input
batches behind the plan key is the single biggest lever in a disaggregated
input plane; this module is that cache node, shared by every loader arm at
the decode boundary (``data/pipeline.py``, ``data/folder.py``).

Key model — ``(dataset_fingerprint, plan_fingerprint, epoch_key,
item_key)``:

* ``dataset_fingerprint`` — the content identity of the source
  (``Dataset.fingerprint()``: version + schema + fragment table, computed
  once at construction; ``folder_fingerprint(samples)`` for the file arm).
  A rewritten dataset at the same path can never serve stale hits.
* ``plan_fingerprint`` — everything else that shapes decoded bytes: the
  decode hook's :func:`decode_fingerprint` (image size, columns, pixel vs
  coefficient-page mode, native-vs-PIL availability) and the read
  projection. Two plans that decode the same rows the same way share it.
* ``epoch_key`` — reserved for plans whose items cannot be content-hashed
  (pinned to the epoch there); 0 for every current loader, because
* ``item_key`` — the *content hash of the plan item itself* (the
  ``ReadRange`` list or the index array) stands in for the raw step
  index. Decode is a pure function of (dataset, plan item, decode config)
  — pinned by the LDT1301 content-purity gate — so identical items map to
  identical bytes **regardless of which epoch, step position, resumed
  run, or client asks**: a second epoch hits, a batch-order-shuffled
  epoch hits, a restarted job (resume cursors) hits from disk, and a second
  ``serve-data`` client streaming the same plan hits server-side.

Tiers: a RAM ring of ``BufferPool``-leased pages first (budget-bounded,
LRU — under in-order epoch streams LRU order *is* batch_seq distance),
spilling to content-hashed local-disk segment files. Spills are atomic
(``tempfile`` + ``os.replace``, the LDT901 discipline) and sha256-verified
on load, so a torn spill — SIGKILL mid-write, full disk — reads as a
*miss*, never as corrupt content. Disk entries survive process death:
that is what makes a restarted run's warm epochs decode-free.

Bit-identity contract: a hit must be byte-equal to what decode would have
produced. ``get`` returns *fresh copies* (leased from the caller's pool),
never the cache's own pages — the consumer releases them exactly as it
releases decoded batches, and the RAM ring's pages stay cache-owned until
eviction releases them (the ``cache-entry`` LDT1201 resource kind).
Caveat, documented honestly: the device-decode coefficient pages are
padded to the decoder's *monotonically growing* canonical grid, so a
mixed hit/miss epoch can pad a missed batch differently than an
uninterrupted decode run would (the decoded images are identical either
way — geometry rides the batch); full warm epochs and stable-knob runs
are bit-identical at the page level too, which is what the parity tests
pin.

Metrics (process registry, on /metrics): ``cache_hit_total`` /
``cache_miss_total`` / ``cache_disk_hit_total`` / ``cache_store_total`` /
``cache_spill_total`` / ``cache_evict_total`` / ``cache_torn_total`` /
``cache_spill_errors_total`` counters, ``cache_ram_bytes`` /
``cache_disk_bytes`` / ``cache_ram_entries`` / ``cache_disk_entries``
occupancy gauges, and the ``cache_lookup_ms`` histogram.

Thread & lock policy: one mutex guards the RAM ring, the disk index, and
the budgets; the pool's own lock nests under it (cache lock → pool lock,
acyclic — the pool never calls back into the cache). Disk I/O for spills
and loads runs under the cache lock: correctness over concurrency here —
the cache is consulted by producer threads that would otherwise be
*decoding*, so a few ms of serialized memcpy/IO per hit is the cheap side
of the trade (and the bench measures the net win).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..obs.registry import MetricsRegistry, default_registry
from ..utils import leaktrack

__all__ = [
    "BatchCache",
    "PlanCache",
    "DeviceReplayCache",
    "plan_fingerprint",
    "decode_fingerprint",
    "item_fingerprint",
    "folder_fingerprint",
    "default_cache_dir",
    "per_device_batch_bytes",
]

_MAGIC = b"LDTC0001"
_SUFFIX = ".ldtc"


# -- fingerprints -----------------------------------------------------------


def _hexdigest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
        h.update(b"\x00")
    return h.hexdigest()


def folder_fingerprint(samples) -> str:
    """Content identity of an image-folder corpus: the walk-ordered
    ``(path, label, size)`` list — file size included so a corpus
    regenerated in place under the same filenames changes identity (the
    restart-persistent disk tier must never serve the old pixels); size,
    not mtime, so two mounts of the same corpus agree. Computed once per
    pipeline (lazily, only when a cache is actually bound) and reused for
    every epoch's keys."""
    h = hashlib.sha256()
    for path, label in samples:
        try:
            size = os.path.getsize(path)
        except OSError:
            size = -1
        h.update(str(path).encode())
        h.update(str(int(label)).encode())
        h.update(str(size).encode())
        h.update(b"\x00")
    return h.hexdigest()


def decode_fingerprint(decode_fn) -> str:
    """The decode hook's contribution to the plan fingerprint. Decoder
    classes declare ``cache_fingerprint()`` (image size, column names,
    native availability, coefficient-page chunking); plain functions fall
    back to their qualified name. Anything that can change the *bytes* a
    decode produces must land in this string — a stale collapse here would
    serve a differently-decoded batch as a hit."""
    probe = getattr(decode_fn, "cache_fingerprint", None)
    if callable(probe):
        return str(probe())
    name = getattr(decode_fn, "__qualname__", None)
    if name is not None:
        return f"fn:{getattr(decode_fn, '__module__', '?')}.{name}"
    cls = type(decode_fn)
    return f"obj:{cls.__module__}.{cls.__qualname__}"


def plan_fingerprint(**scope) -> str:
    """Hash of everything besides the dataset and the plan item that shapes
    decoded bytes (decode fingerprint, column projection, eval weighting).
    Canonical-JSON over the keyword scope, so key order can't alias."""
    return _hexdigest(
        json.dumps(scope, sort_keys=True, default=str).encode()
    )


def item_fingerprint(item) -> Optional[str]:
    """Content hash of one plan item — the key component that makes the
    cache epoch-coherent (module docstring). ``None`` marks an item shape
    the cache cannot address (the pipeline then just decodes it)."""
    if isinstance(item, np.ndarray):
        return _hexdigest(
            b"ix", str(item.dtype).encode(), str(item.shape).encode(),
            np.ascontiguousarray(item),
        )
    if isinstance(item, (list, tuple)) and item and all(
        hasattr(r, "fragment") and hasattr(r, "start") and hasattr(r, "stop")
        for r in item
    ):
        h = hashlib.sha256(b"rr")
        for r in item:
            h.update(f"{int(r.fragment)}:{int(r.start)}:{int(r.stop)};"
                     .encode())
        return h.hexdigest()
    if (
        isinstance(item, tuple) and len(item) == 2
        and all(isinstance(x, np.ndarray) for x in item)
    ):
        # Eval plan entry: (index array, pad-weight array).
        return _hexdigest(
            b"ev",
            item_fingerprint(item[0]).encode(),
            item_fingerprint(item[1]).encode(),
        )
    return None


def default_cache_dir() -> str:
    """The stable default spill directory — stable across restarts on
    purpose (a restarted job's warm epochs come from here)."""
    return os.path.expanduser(
        os.path.join("~", ".cache", "lance_distributed_training_tpu_torch",
                     "batch-cache")
    )


# -- the tiered cache -------------------------------------------------------


class BatchCache:
    """Tiered RAM/disk cache of decoded host batches.

    ``get(key, pool=)`` returns a fresh copy of a cached batch (pages
    leased from ``pool`` when given) or ``None``; ``put(key, batch)``
    copies the batch into cache-owned pages (leased from the cache's own
    bound pool). RAM overflows spill to disk; disk overflows evict oldest.
    One instance serves every loader of a process (train + eval + all of a
    ``serve-data``'s client sessions) — entries are content-keyed, so
    sharing can only add hits, never wrong ones.

    Sharing ``cache_dir`` across PROCESSES is safe but uncoordinated:
    writes are atomic and content-keyed (a concurrent writer of the same
    key commits identical bytes), but each process enforces its own disk
    budget over its own index, so two busy sharers can evict each other's
    live segments — the victim sees a plain miss (a vanished file is NOT
    counted torn) and re-fills. Degrades to extra decodes, never wrong
    content; give heavy co-located jobs separate dirs (or budget
    headroom) if the thrash shows up in ``cache_evict_total``.
    """

    def __init__(
        self,
        cache_dir: Optional[str] = None,
        ram_budget_mb: int = 512,
        disk_budget_mb: int = 2048,
        buffer_pool=None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.cache_dir = cache_dir or default_cache_dir()
        os.makedirs(self.cache_dir, exist_ok=True)
        self.buffer_pool = buffer_pool
        self._lock = threading.Lock()
        # name -> {"arrays": {col: ndarray}, "nbytes": int, "token": int}
        self._ram: "OrderedDict[str, dict]" = OrderedDict()
        self._ram_bytes = 0
        self._disk: "OrderedDict[str, int]" = OrderedDict()  # name -> bytes
        self._disk_bytes = 0
        self._token = 0  # leaktrack identity for cache-entry leases
        self.ram_budget_bytes = max(0, int(ram_budget_mb)) * (1 << 20)
        self.disk_budget_bytes = max(0, int(disk_budget_mb)) * (1 << 20)
        reg = registry if registry is not None else default_registry()
        self._hits = reg.counter("cache_hit_total")
        self._disk_hits = reg.counter("cache_disk_hit_total")
        self._misses = reg.counter("cache_miss_total")
        self._stores = reg.counter("cache_store_total")
        self._spills = reg.counter("cache_spill_total")
        self._evicts = reg.counter("cache_evict_total")
        self._torn = reg.counter("cache_torn_total")
        self._spill_errors = reg.counter("cache_spill_errors_total")
        self._ram_bytes_g = reg.gauge("cache_ram_bytes")
        self._disk_bytes_g = reg.gauge("cache_disk_bytes")
        self._ram_entries_g = reg.gauge("cache_ram_entries")
        self._disk_entries_g = reg.gauge("cache_disk_entries")
        self._lookup_ms = reg.histogram("cache_lookup_ms")
        with self._lock:
            self._scan_disk_locked()

    # -- key plumbing ------------------------------------------------------

    @staticmethod
    def entry_name(key: Tuple[str, str, int, str]) -> str:
        """Key tuple → stable file/ring name (sha256, truncated: 160 bits
        is far past birthday range for any realistic entry count)."""
        dataset_fp, plan_fp, epoch_key, item_key = key
        return _hexdigest(
            str(dataset_fp).encode(), str(plan_fp).encode(),
            str(int(epoch_key)).encode(), str(item_key).encode(),
        )[:40]

    def _path(self, name: str) -> str:
        return os.path.join(self.cache_dir, name + _SUFFIX)

    # -- occupancy bookkeeping --------------------------------------------

    def _publish_gauges_locked(self) -> None:
        self._ram_bytes_g.set(self._ram_bytes)
        self._disk_bytes_g.set(self._disk_bytes)
        self._ram_entries_g.set(len(self._ram))
        self._disk_entries_g.set(len(self._disk))

    def _scan_disk_locked(self) -> None:
        """Adopt segments a previous process left behind (restart-warm).
        Sorted by mtime then name — deterministic adoption order, and the
        oldest files sit first in LRU order so budget pressure evicts
        them first. Orphaned ``.tmp`` spill files (a SIGKILL between
        ``mkstemp`` and ``os.replace``) are swept here — they sit outside
        the budget accounting and would otherwise accumulate across
        preemptions forever. (Racing a LIVE writer's in-flight temp in a
        shared dir just fails that one spill's ``os.replace``, which the
        writer already counts and degrades on.)"""
        try:
            entries = []
            for e in sorted(os.scandir(self.cache_dir),
                            key=lambda e: e.name):
                if not e.is_file():
                    continue
                if e.name.endswith(".tmp"):
                    try:
                        os.remove(e.path)
                    except OSError:
                        pass
                    continue
                if e.name.endswith(_SUFFIX):
                    st = e.stat()
                    entries.append((st.st_mtime, e.name, st.st_size))
            entries.sort()
        except OSError:
            entries = []
        for _mtime, fname, size in entries:
            self._disk[fname[: -len(_SUFFIX)]] = size
            self._disk_bytes += size
        self._enforce_disk_budget_locked()
        self._publish_gauges_locked()

    # -- entry lease lifecycle (the LDT1201 `cache-entry` resource kind) ---

    def _lease_entry(self, batch: Dict[str, np.ndarray],
                     adopt: bool = False) -> dict:
        """Copy ``batch`` into cache-owned pages (leased from the cache's
        bound pool when present). The returned entry OWNS those leases
        until :meth:`_release_entry` — every caller must store it into the
        ring or release it on all paths. ``adopt=True`` takes ownership of
        the arrays AS-IS (no copy, no pool lease) — for arrays the caller
        just allocated privately (the disk-load promote path, which would
        otherwise pay a third full-batch memcpy); ``_release_entry`` stays
        uniform because ``BufferPool.release`` ignores foreign arrays."""
        if adopt:
            arrays = dict(batch)
            nbytes = sum(int(a.nbytes) for a in arrays.values())
        else:
            arrays = {}
            nbytes = 0
            try:
                for name, arr in batch.items():
                    if self.buffer_pool is not None:
                        dst = self.buffer_pool.lease(arr.shape, arr.dtype)
                    else:
                        dst = np.empty(arr.shape, arr.dtype)
                    # Park ownership in `arrays` BEFORE the copy (the
                    # ShmRing idiom): a raising copyto must not strand the
                    # lease.
                    arrays[name] = dst
                    np.copyto(dst, arr)
                    nbytes += dst.nbytes
            except BaseException:
                for arr in arrays.values():
                    if self.buffer_pool is not None:
                        self.buffer_pool.release(arr)
                raise
        self._token += 1
        entry = {"arrays": arrays, "nbytes": nbytes, "token": self._token}
        if leaktrack.enabled():
            leaktrack.track_acquire("cache-entry", entry["token"], depth=3)
        return entry

    def _release_entry(self, entry: dict) -> None:
        """Give an entry's pages back to the pool. Idempotent (a cleared
        entry releases nothing)."""
        arrays = entry.pop("arrays", None)
        if arrays is None:
            return
        if self.buffer_pool is not None:
            for arr in arrays.values():
                self.buffer_pool.release(arr)
        if leaktrack.enabled():
            leaktrack.track_release("cache-entry", entry.get("token"))

    # -- tiers -------------------------------------------------------------

    @staticmethod
    def _copy_out(arrays: Dict[str, np.ndarray], pool) -> Dict[str, np.ndarray]:
        """Cached pages → a fresh batch the consumer owns (and releases)
        exactly like a decoded one. Never hands out the cache's pages: the
        pipelines release batches after device_put/yield, and a released
        ring page would recycle under the cache's feet."""
        out: Dict[str, np.ndarray] = {}
        try:
            for name, arr in arrays.items():
                dst = (
                    pool.lease(arr.shape, arr.dtype)
                    if pool is not None
                    else np.empty(arr.shape, arr.dtype)
                )
                out[name] = dst  # park before copy: release-safe on raise
                np.copyto(dst, arr)
        except BaseException:
            if pool is not None:
                for arr in out.values():
                    pool.release(arr)
            raise
        return out

    def get(self, key, pool=None) -> Optional[Dict[str, np.ndarray]]:
        """RAM first, then disk (sha256-verified; torn/corrupt = miss).
        Disk hits are promoted into the RAM ring so steady-state warm
        epochs serve from memory."""
        t0 = time.monotonic_ns()
        name = self.entry_name(key)
        out: Optional[Dict[str, np.ndarray]] = None
        with self._lock:
            entry = self._ram.get(name)
            if entry is not None:
                self._ram.move_to_end(name)
                out = self._copy_out(entry["arrays"], pool)
                self._hits.inc()
            else:
                arrays = self._load_disk_locked(name)
                if arrays is not None:
                    self._disk_hits.inc()
                    self._hits.inc()
                    out = self._copy_out(arrays, pool)
                    self._promote_locked(name, arrays)
                else:
                    self._misses.inc()
            self._publish_gauges_locked()
        self._lookup_ms.observe((time.monotonic_ns() - t0) / 1e6)
        return out

    def contains(self, key) -> bool:
        """Membership probe, no fetch (the worker-pool paths use it to
        build the miss list an ``imap`` decodes). A positive can still
        miss at ``get`` time under concurrent eviction — probers fall back
        to inline decode there."""
        name = self.entry_name(key)
        with self._lock:
            return name in self._ram or name in self._disk

    def note_miss(self) -> None:
        """Count a miss resolved WITHOUT a ``get`` — the worker-pool
        paths route probed misses straight to ``imap`` and would
        otherwise report a 100% hit rate on a stone-cold cache."""
        self._misses.inc()

    def put(self, key, batch) -> bool:
        """Admit a decoded batch (copied; the caller keeps full ownership
        of ``batch`` and its leases). Returns whether the entry was
        admitted — non-array values, duplicate keys, and a zero RAM budget
        with an unwritable spill dir all decline harmlessly."""
        if not isinstance(batch, dict) or not batch or not all(
            isinstance(v, np.ndarray) for v in batch.values()
        ):
            return False
        name = self.entry_name(key)
        nbytes = sum(int(v.nbytes) for v in batch.values())
        with self._lock:
            if name in self._ram or name in self._disk:
                return False
            if nbytes > self.ram_budget_bytes:
                # Bigger than the whole ring: straight to disk from the
                # caller's own arrays — no ring lease is ever taken, so
                # there is no eviction churn and nothing to strand.
                spilled = self._spill_locked(name, batch)
                if spilled:
                    # Count only REAL admissions: a declined/failed spill
                    # must not show cache_store_total climbing while the
                    # occupancy gauges sit at zero. (The RAM path below
                    # counts after its store, for the same reason.)
                    self._stores.inc()
                self._publish_gauges_locked()
                return spilled
            # Acquire-then-store with NOTHING in between that can raise:
            # the ring owns the entry the instant it exists (the LDT1201
            # exception-edge discipline — this gate flagged the first
            # draft of this function). A failed admission COPY declines
            # the put (the _lease_entry unwind already released its
            # partial leases) — cache admission must degrade, never kill
            # the epoch, same contract as the spill path.
            try:
                entry = self._lease_entry(batch)
            except MemoryError:
                self._publish_gauges_locked()
                return False
            self._ram[name] = entry
            self._ram_bytes += nbytes
            self._stores.inc()
            self._enforce_ram_budget_locked()
            self._publish_gauges_locked()
        return True

    def _promote_locked(self, name: str, arrays: Dict[str, np.ndarray]) -> None:
        """Disk hit → RAM ring (so the next epoch's hit skips the disk
        read and the hash verify). The loaded arrays are already fresh
        allocations; wrap them as a cache-owned entry via the lease path
        so the ownership/leaktrack accounting stays uniform."""
        if name in self._ram:
            return
        nbytes = sum(int(v.nbytes) for v in arrays.values())
        if nbytes > self.ram_budget_bytes:
            return
        # Adopt, don't copy: the loaded arrays are already this cache's
        # private fresh allocations — re-leasing would be a third
        # full-batch memcpy under the lock on the restart-warm hot path.
        entry = self._lease_entry(arrays, adopt=True)
        self._ram[name] = entry
        self._ram_bytes += nbytes
        self._enforce_ram_budget_locked()

    def _enforce_ram_budget_locked(self) -> None:
        """Evict LRU RAM entries over budget: spill to disk, then release
        the pages' leases (the eviction edge LDT1201 pins)."""
        while self._ram and self._ram_bytes > self.ram_budget_bytes:
            name, entry = self._ram.popitem(last=False)
            self._ram_bytes -= entry["nbytes"]
            try:
                if name not in self._disk:
                    self._spill_locked(name, entry.get("arrays"))
                self._evicts.inc()
            finally:
                self._release_entry(entry)

    def _spill_locked(self, name: str, arrays) -> bool:
        """Arrays → one atomic content-hashed segment file (LDT901:
        tempfile + ``os.replace``; a SIGKILL mid-write leaves only a temp
        file the next scan ignores). Spill failures (full/readonly disk)
        degrade to a dropped entry, never a dead epoch."""
        if arrays is None or self.disk_budget_bytes <= 0:
            return False
        payload_hash = hashlib.sha256()
        metas = []
        offset = 0
        views = []
        for col, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            metas.append([col, arr.dtype.str, list(arr.shape), offset])
            offset += arr.nbytes
            payload_hash.update(arr)
            views.append(arr)
        header = json.dumps({
            "tensors": metas,
            "payload_sha256": payload_hash.hexdigest(),
            "nbytes": offset,
        }).encode()
        path = self._path(name)
        fd = None
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                fd = None  # fdopen owns it now
                f.write(_MAGIC)
                f.write(len(header).to_bytes(4, "big"))
                f.write(header)
                for arr in views:
                    f.write(memoryview(arr).cast("B"))
            os.replace(tmp, path)
            tmp = None
        except OSError:
            self._spill_errors.inc()
            if fd is not None:
                os.close(fd)
            if tmp is not None:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            return False
        size = len(_MAGIC) + 4 + len(header) + offset
        self._disk_bytes += size - self._disk.pop(name, 0)
        self._disk[name] = size
        self._spills.inc()
        self._enforce_disk_budget_locked()
        return True

    def _load_disk_locked(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        """Segment file → arrays, sha256-verified. ANY defect — missing
        file, bad magic, torn header, short payload, hash mismatch — is a
        miss (counted, file retired), never corrupt content."""
        if name not in self._disk:
            return None
        path = self._path(name)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            # Not corruption: a sibling process sharing this cache_dir
            # evicted the segment under ITS disk budget (or a manual
            # clean). Degrade to a plain miss — counting it torn would
            # make cache_torn_total scream "corruption" at healthy
            # mutual eviction (see the class docstring's sharing note).
            self._drop_disk_locked(name)
            return None
        except OSError:
            self._drop_disk_locked(name, torn=True)
            return None
        try:
            if raw[: len(_MAGIC)] != _MAGIC:
                raise ValueError("bad magic")
            hlen = int.from_bytes(raw[len(_MAGIC): len(_MAGIC) + 4], "big")
            hstart = len(_MAGIC) + 4
            header = json.loads(raw[hstart: hstart + hlen])
            payload = memoryview(raw)[hstart + hlen:]
            if len(payload) != int(header["nbytes"]):
                raise ValueError("short payload")
            if hashlib.sha256(payload).hexdigest() != header["payload_sha256"]:
                raise ValueError("payload hash mismatch")
            arrays: Dict[str, np.ndarray] = {}
            for col, dtype_str, shape, offset in header["tensors"]:
                dt = np.dtype(dtype_str)
                count = int(np.prod(shape, dtype=np.int64))
                arr = np.frombuffer(
                    payload, dtype=dt, count=count, offset=offset
                ).reshape(shape)
                arrays[col] = arr.copy()  # own pages; raw is released
        except (ValueError, KeyError, TypeError, json.JSONDecodeError):
            self._drop_disk_locked(name, torn=True)
            return None
        self._disk.move_to_end(name)
        return arrays

    def _drop_disk_locked(self, name: str, torn: bool = False) -> None:
        size = self._disk.pop(name, 0)
        self._disk_bytes -= size
        if torn:
            self._torn.inc()
        try:
            os.remove(self._path(name))
        except OSError:
            pass

    def _enforce_disk_budget_locked(self) -> None:
        while self._disk and self._disk_bytes > self.disk_budget_bytes:
            name = next(iter(self._disk))
            self._drop_disk_locked(name)
            self._evicts.inc()

    # -- knobs (tune/) -----------------------------------------------------

    def set_ram_budget_mb(self, mb: int) -> int:
        """Autotune actuator: resize the RAM ring, live. Shrinking evicts
        (spill → lease release) immediately; in-flight ``get`` copies are
        unaffected (they complete under the lock before eviction runs)."""
        mb = max(0, int(mb))
        with self._lock:
            self.ram_budget_bytes = mb * (1 << 20)
            self._enforce_ram_budget_locked()
            self._publish_gauges_locked()
        return mb

    def set_disk_budget_mb(self, mb: int) -> int:
        """Autotune actuator: resize the disk tier, live (oldest segments
        unlinked immediately when shrinking)."""
        mb = max(0, int(mb))
        with self._lock:
            self.disk_budget_bytes = mb * (1 << 20)
            self._enforce_disk_budget_locked()
            self._publish_gauges_locked()
        return mb

    def tunables(self):
        """Autotune registration surface (tune/): both tier budgets, with
        hard actuation bounds (LDT1101)."""
        from ..tune.tunable import Tunable

        return [
            Tunable(
                "cache_ram_budget_mb",
                lambda: self.ram_budget_bytes >> 20,
                self.set_ram_budget_mb,
                lo=8, hi=16384,
                doc="decoded-batch cache RAM ring budget (MiB)",
            ),
            Tunable(
                "cache_disk_budget_mb",
                lambda: self.disk_budget_bytes >> 20,
                self.set_disk_budget_mb,
                lo=64, hi=262144,
                doc="decoded-batch cache disk-spill budget (MiB)",
            ),
        ]

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "ram_entries": len(self._ram),
                "ram_bytes": self._ram_bytes,
                "disk_entries": len(self._disk),
                "disk_bytes": self._disk_bytes,
            }

    def clear(self, disk: bool = False) -> None:
        """Drop the RAM ring (releasing every lease); ``disk=True`` also
        unlinks every segment file."""
        with self._lock:
            while self._ram:
                _name, entry = self._ram.popitem(last=False)
                self._release_entry(entry)
            self._ram_bytes = 0
            if disk:
                for name in list(self._disk):
                    self._drop_disk_locked(name)
            self._publish_gauges_locked()

    def close(self) -> None:
        """Release every RAM lease back to the pool. Disk segments stay —
        they are the restart-warm tier. Idempotent."""
        self.clear(disk=False)


class PlanCache:
    """One plan's binding of a :class:`BatchCache`: the dataset
    fingerprint is fixed, items map to keys via their content hash, and
    ``plan_fp`` may be a ZERO-ARG CALLABLE evaluated per key — so a live
    decoder actuation mid-epoch (the autotuner moving ``coeff_chunk``,
    which changes page geometry) moves later entries to a NEW key space
    instead of aliasing differently-shaped bytes under the old one.
    Constructed per iteration by the pipelines; all methods are safe from
    concurrent producer threads (the cache's own lock serializes)."""

    def __init__(self, cache: BatchCache, dataset_fp: str, plan_fp,
                 epoch_key: int = 0):
        self.cache = cache
        self.dataset_fp = str(dataset_fp)
        self.plan_fp = plan_fp  # str, or () -> str for live decode knobs
        self.epoch_key = int(epoch_key)

    def key_for(self, item) -> Optional[tuple]:
        fp = item_fingerprint(item)
        if fp is None:
            return None
        plan_fp = self.plan_fp() if callable(self.plan_fp) else self.plan_fp
        return (self.dataset_fp, str(plan_fp), self.epoch_key, fp)

    def contains(self, item) -> bool:
        key = self.key_for(item)
        return key is not None and self.cache.contains(key)

    def get(self, item, pool=None) -> Optional[dict]:
        key = self.key_for(item)
        if key is None:
            return None
        return self.cache.get(key, pool=pool)

    def put(self, item, batch) -> bool:
        key = self.key_for(item)
        if key is None:
            return False
        return self.cache.put(key, batch)

    def note_miss(self) -> None:
        self.cache.note_miss()


# -- the HBM replay tier (--device_cache) -----------------------------------


def per_device_batch_bytes(batch) -> int:
    """Bytes this process keeps resident for a cached batch: every tensor
    leaf of its batch (``numel × element_size``), and every numpy leaf
    (host metadata) at its size. Each process caches its own share of the
    global batch, so this is the per-card cost."""
    import torch

    total = 0
    for leaf in batch.values():
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(getattr(leaf, "nbytes", 0))
    return total


def _batch_device(batch):
    """The device of the batch's first tensor leaf (``None``: no tensor)."""
    import torch

    for leaf in batch.values():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _device_budget_bytes(budget_gb: float, device=None) -> float:
    """Replay budget: the configured GB, clamped on a card to 90% of its
    free memory (``torch.cuda.mem_get_info``: 10% headroom for activations
    and fragmentation); the configured GB alone on the CPU."""
    budget = budget_gb * 1e9
    if device is not None and device.type == "cuda":
        import torch

        free, _total = torch.cuda.mem_get_info(device)
        budget = min(budget, max(free, 0) * 0.9)
    return budget


class DeviceReplayCache:
    """The HBM tier of the cache plane — ``--device_cache``'s replay fill:
    epoch-``start`` batches are kept as this process's device tensors
    (after the trainer's transform stage, so a replayed coefficient batch
    is already an image and K2 does not run again) and replayed in later
    epochs
    (no host decode, no H2D; shuffle degrades to batch-order permutation,
    membership frozen at the fill epoch), with the projected-size guard
    falling back to streaming when the dataset won't fit, and a partially
    *resumed* epoch never seeding the replay set (it would capture only
    the post-resume tail and later epochs would silently train on a
    subset). Admission is all-or-nothing by projection — the replay set is
    only ever a complete epoch, so there is no partial-eviction rule to
    diverge from the host tiers'."""

    def __init__(self, enabled: bool, budget_gb: float, seed: int,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = bool(enabled)
        self.budget_gb = float(budget_gb)
        self.seed = int(seed)
        self._batches: list = []
        self._filling = False
        reg = registry if registry is not None else default_registry()
        self._count_g = reg.gauge("cache_device_batches")
        self._replays = reg.counter("cache_device_replay_epochs_total")

    def __len__(self) -> int:
        return len(self._batches)

    def replay_iter(self, epoch: int, start_epoch: int,
                    shuffled: bool) -> Optional[Iterator]:
        """The epoch's replay iterator, or ``None`` when this epoch must
        stream from storage (first executed epoch, cache disabled or
        empty). Shuffled configs get a seeded batch-order permutation —
        deterministic, distinct per epoch."""
        if not (self.enabled and epoch > start_epoch and self._batches):
            return None
        self._replays.inc()
        if shuffled:
            order = np.random.default_rng(
                self.seed + epoch
            ).permutation(len(self._batches))
            return iter([self._batches[i] for i in order])
        return iter(list(self._batches))

    def start_fill(self, replaying: bool, resume_step: int) -> bool:
        """Arm the fill for this epoch. A partially-resumed epoch must not
        seed the replay set — the partial-epoch exclusion, in one
        place."""
        self._filling = (
            self.enabled and not replaying and not resume_step
        )
        return self._filling

    def admit(self, batch, total_steps: int) -> Optional[dict]:
        """Offer one consumed batch to the fill. Returns ``None`` when
        admitted (or when not filling); a ``{projected, budget}`` dict
        exactly once when the first batch's projection just disabled the
        cache (the caller logs it)."""
        if not self._filling:
            return None
        if not self._batches:
            per_batch = per_device_batch_bytes(batch)
            projected = per_batch * max(int(total_steps), 1)
            budget = _device_budget_bytes(self.budget_gb,
                                          _batch_device(batch))
            if projected > budget:
                self.enabled = False
                self._filling = False
                return {"projected": projected, "budget": budget}
        self._batches.append(batch)
        self._count_g.set(len(self._batches))
        return None
