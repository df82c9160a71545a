"""Pooled decode pages and the shared-memory ring of the worker pool.

Counterpart of ``lance_distributed_training_tpu/data/buffers.py``. Each
decoded batch used to fault a fresh array (about 77 MB a ResNet-50 batch
of 512 at 224 px); :class:`BufferPool` hands the warm pages of earlier
batches back out instead: lease-based, keyed by ``(shape, dtype)``,
thread-safe, bounded. :class:`ShmRing` and :class:`ShmSlotWriter` carry
decoded batches from worker processes (``data/workers.py``) through
``multiprocessing.shared_memory`` slots: the worker writes the tensors
into a slot and returns a small descriptor, the consumer copies once out
of the mapped pages into a lease of its own pool and hands the slot back.

Pinned pages: a pool made with ``pin_memory=True`` (the trainer's on CUDA)
leases numpy views of page-locked tensors (``torch.empty(...,
pin_memory=True)``), so a decoder writes straight into memory the copy
engine reads and the host batch needs no second copy before its H2D.
Page-locking is slow the first time (``miss_ms`` sums the time spent
allocating missed pages); a recycled page costs nothing.

Lease safety: a released page is recycled only once the pool is its sole
referent (``sys.getrefcount``, as the JAX pool does) **and** the CUDA
event of the copy that read it has completed (``release(arr, event)``).
So a caller may release right after it queues a ``non_blocking`` copy, or
while a consumer still holds a batch that aliases the page: the page parks
on a pending list until both hold. A lease dropped without a release is
garbage, not a leak: the pool keeps only a weak reference to it.

Counters: per pool, plain integers (:meth:`BufferPool.counters`:
``hits``, ``misses``, ``evicts``, ``miss_ms``, ``ragged_leases``,
``ragged_slack_bytes``); per process, the JAX pool's registry series
(``bufpool_hit_total``, ``bufpool_miss_total``, ``bufpool_evict_total``,
``bufpool_in_use``, ``bufpool_pending``, ``bufpool_ragged_leases_total``,
``bufpool_ragged_slack_bytes_total``) and the ring's (``shm_batches_total``,
``shm_bytes_total``, ``shm_slot_resizes_total``, ``shm_fallback_total``,
``shm_slot_wait_ms``), which the autotuner reads.

Shared-memory lifecycle and queue policy are the JAX ring's: slot names are
deterministic (``ldtshm_<session>_<slot>``), every segment is unlinked once
in :meth:`ShmRing.cleanup` (driven by ``WorkerPool.shutdown`` or its
finalizer), the free-slot queue is bounded and every blocking ``get``
carries a timeout with a pickle fallback (``shm_fallback_total``), so a
lost token or a full ``/dev/shm`` degrades throughput instead of hanging.
A page-locked pool is never re-bound in a worker: ``_init_worker`` gives
each worker a plain one, because page-locking initialises CUDA.
"""

from __future__ import annotations

import sys
import threading
import time
import uuid
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..obs.registry import MetricsRegistry, default_registry
from ..utils import leaktrack

__all__ = ["BufferPool", "RaggedPage", "ShmRing", "ShmSlotWriter",
           "default_buffer_pool", "shm_available"]


class RaggedPage(NamedTuple):
    """One variable-length column's pooled pages: a flat ``values`` page
    sized to a capacity bucket (so batches of nearby token counts recycle
    the same pages) and an exact ``offsets`` page. Both are ordinary
    leases, released with ``release``/``release_batch``."""

    values: np.ndarray  # [capacity_bucket]; the caller fills [:total]
    offsets: np.ndarray  # int32 [n_sequences + 1]
    capacity: int  # the bucket the values page was keyed under


# 64-byte alignment of tensor offsets inside a shm slot (a cache line; also
# every numpy dtype's alignment).
_ALIGN = 64


def _solo_refcount() -> int:
    """The refcount a pending-list entry shows when the pool is its sole
    owner: the list, the loop variable and ``getrefcount``'s argument.
    Computed, so an interpreter that counts differently cannot make the
    sweep recycle a page that something still reads."""
    lst = [object()]
    for x in lst:
        return sys.getrefcount(x)
    raise AssertionError("unreachable")


_SOLO_REFS = _solo_refcount()


class BufferPool:
    """Lease-based pool of recycled numpy pages.

    ``lease(shape, dtype)`` returns a warm page when one is free (a hit) or
    allocates one (a miss). ``release(arr, event=None)`` gives it back; it
    is recycled once the pool is its sole referent and ``event`` (the CUDA
    event of a copy that reads it) has completed. Arrays the pool never
    leased are ignored, so a whole batch dict can be released blindly.
    ``pin_memory`` makes every page a view of a page-locked tensor."""

    def __init__(self, max_free_per_key: int = 8, max_pending: int = 32,
                 pin_memory: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._free: Dict[Tuple, List[np.ndarray]] = {}
        # id(arr) -> weakref. Weak on purpose: a lease dropped without a
        # release must degrade to ordinary garbage, never to a page the
        # pool pins forever. The callback retires the entry.
        self._outstanding: Dict[int, weakref.ref] = {}
        self._pending: List[np.ndarray] = []  # released, still referenced
        self._events: Dict[int, object] = {}  # id(pending page) -> event
        self.max_free_per_key = max(0, max_free_per_key)
        self.max_pending = max(1, max_pending)
        self.pin_memory = bool(pin_memory)
        self.hits = 0
        self.misses = 0
        self.evicts = 0
        self.miss_ms = 0.0
        self.ragged_leases = 0
        self.ragged_slack_bytes = 0
        reg = registry if registry is not None else default_registry()
        self._hits = reg.counter("bufpool_hit_total")
        self._misses = reg.counter("bufpool_miss_total")
        self._evicts = reg.counter("bufpool_evict_total")
        self._in_use = reg.gauge("bufpool_in_use")
        self._pending_gauge = reg.gauge("bufpool_pending")
        self._ragged_leases = reg.counter("bufpool_ragged_leases_total")
        self._ragged_slack = reg.counter("bufpool_ragged_slack_bytes_total")

    @staticmethod
    def _key(shape, dtype) -> Tuple:
        return (tuple(int(s) for s in shape), np.dtype(dtype).str)

    def _allocate(self, shape, dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.empty(tuple(shape), np.dtype(dtype))
        import torch

        dtype = np.dtype(dtype)
        pages = torch.empty(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize,
                            dtype=torch.uint8, pin_memory=True)
        # The view's base is the pinned tensor: it lives as long as the page.
        return pages.numpy().view(dtype).reshape(tuple(shape))

    def _stash_locked(self, arr: np.ndarray) -> None:
        free = self._free.setdefault(self._key(arr.shape, arr.dtype), [])
        if len(free) < self.max_free_per_key:
            free.append(arr)
        else:
            self.evicts += 1  # cap reached: the page becomes garbage
            self._evicts.inc()

    def _sweep_locked(self) -> None:
        still: List[np.ndarray] = []
        for arr in self._pending:
            # One ref each from self._pending, the loop variable and
            # getrefcount's argument: _SOLO_REFS exactly. More means a
            # batch, a consumer or a tensor aliasing it still holds it.
            if sys.getrefcount(arr) <= _SOLO_REFS and self._copied(arr):
                self._events.pop(id(arr), None)
                self._stash_locked(arr)
            else:
                still.append(arr)
        if len(still) > self.max_pending:
            # Bound the deferred set: the overflow leaves the pool (its
            # holders keep it alive; it just never recycles).
            self.evicts += len(still) - self.max_pending
            self._evicts.inc(len(still) - self.max_pending)
            for arr in still[:-self.max_pending]:
                self._events.pop(id(arr), None)
            still = still[-self.max_pending:]
        self._pending = still
        self._pending_gauge.set(len(still))

    def _copied(self, arr: np.ndarray) -> bool:
        event = self._events.get(id(arr))
        return event is None or event.query()

    def lease(self, shape: Sequence[int], dtype) -> np.ndarray:
        key = self._key(shape, dtype)
        arr: Optional[np.ndarray] = None
        with self._lock:
            self._sweep_locked()
            free = self._free.get(key)
            if free:
                arr = free.pop()
                self.hits += 1
                self._hits.inc()
            else:
                self.misses += 1
                self._misses.inc()
        if arr is None:
            t0 = time.perf_counter()
            arr = self._allocate(shape, dtype)
            elapsed = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.miss_ms += elapsed
        outstanding = self._outstanding
        gauge = self._in_use

        def _dropped(_ref, _key=id(arr)):
            # The lease died unreleased: retire its entry (no pool lock,
            # this runs from the garbage collector).
            outstanding.pop(_key, None)
            gauge.set(len(outstanding))
            if leaktrack.enabled():
                leaktrack.track_dropped("pool-page", _key)

        with self._lock:
            outstanding[id(arr)] = weakref.ref(arr, _dropped)
            gauge.set(len(outstanding))
        if leaktrack.enabled():
            leaktrack.track_acquire("pool-page", id(arr), depth=3)
        return arr

    def lease_ragged(self, total: int, n_sequences: int,
                     values_dtype) -> RaggedPage:
        """Lease one variable-length column's page pair
        (:class:`RaggedPage`). The values page is keyed by its capacity
        bucket (the next power of two >= ``total``), so that batches of
        different token totals recycle the same pages."""
        from .token_pack import ragged_capacity

        cap = ragged_capacity(int(total))
        values = self.lease((cap,), values_dtype)
        try:
            offsets = self.lease((int(n_sequences) + 1,), np.int32)
        except BaseException:
            # The pair is leased whole or not at all.
            self.release(values)
            raise
        try:
            # Counted once both pages are held; a failure here must not
            # strand the pair either.
            slack = (cap - int(total)) * np.dtype(values_dtype).itemsize
            with self._lock:
                self.ragged_leases += 1
                self.ragged_slack_bytes += slack
            self._ragged_leases.inc()
            self._ragged_slack.inc(slack)
        except BaseException:
            self.release(values)
            self.release(offsets)
            raise
        return RaggedPage(values, offsets, cap)

    def owns(self, arr) -> bool:
        """Whether ``arr`` is a page this pool leased and has not had
        back."""
        if not isinstance(arr, np.ndarray):
            return False
        with self._lock:
            ref = self._outstanding.get(id(arr))
            return ref is not None and ref() is arr

    def release(self, arr, event=None) -> bool:
        """Return a leased page; ``event`` (a CUDA event recorded after the
        copies that read it) defers its recycling until it completes.
        ``False`` (and a no-op) for arrays this pool does not own. A view
        of a leased page releases its base."""
        if not isinstance(arr, np.ndarray):
            return False
        with self._lock:
            ref = self._outstanding.pop(id(arr), None)
            if ref is None or ref() is not arr:  # foreign (or id reuse)
                # Walk the view chain: releasing page[:n] finds the page.
                base = arr.base
                hops = 0
                while isinstance(base, np.ndarray) and hops < 4:
                    ref = self._outstanding.pop(id(base), None)
                    if ref is not None and ref() is base:
                        arr = base
                        break
                    base = base.base
                    hops += 1
                else:
                    return False
                if ref is None or ref() is not arr:
                    return False
            self._in_use.set(len(self._outstanding))
            if event is not None:
                self._events[id(arr)] = event
            self._pending.append(arr)
            self._sweep_locked()
        if leaktrack.enabled():
            leaktrack.track_release("pool-page", id(arr))
        return True

    def release_batch(self, batch, event=None) -> int:
        """Release every pooled value of a ``{name: array}`` batch dict
        (after ``event``); returns how many were pool-owned."""
        if not isinstance(batch, dict):
            return 0
        return sum(self.release(v, event) for v in list(batch.values()))

    def set_budget(self, max_free_per_key: int) -> int:
        """Resize the recycled-page budget: shrinking trims every free list
        at once (counted as evictions); outstanding leases are untouched."""
        cap = max(0, int(max_free_per_key))
        with self._lock:
            self.max_free_per_key = cap
            for free in self._free.values():
                if len(free) > cap:
                    self.evicts += len(free) - cap
                    self._evicts.inc(len(free) - cap)
                    del free[cap:]
        return cap

    def tunables(self):
        """The autotuner's knob: the per-(shape, dtype) free-page
        budget."""
        from ..tune.tunable import Tunable

        return [Tunable(
            "bufpool_pages",
            lambda: self.max_free_per_key,
            self.set_budget,
            lo=2, hi=64,
            doc="recycled pages kept warm per (shape, dtype) key",
        )]

    def sweep(self) -> None:
        """Run one pending → free sweep now (it also rides every lease and
        release): teardown paths and tests call it to observe every page
        recycled without leasing again."""
        with self._lock:
            self._sweep_locked()

    def stats(self) -> dict:
        with self._lock:
            return {
                "outstanding": len(self._outstanding),
                "pending": len(self._pending),
                "free": sum(len(v) for v in self._free.values()),
            }

    def counters(self) -> dict:
        """The lease counters since the pool was made."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evicts": self.evicts, "miss_ms": self.miss_ms,
                    "ragged_leases": self.ragged_leases,
                    "ragged_slack_bytes": self.ragged_slack_bytes}


_DEFAULT_POOLS: Dict[bool, BufferPool] = {}
_DEFAULT_POOL_LOCK = threading.Lock()


def default_buffer_pool(pin_memory: bool = False) -> BufferPool:
    """The process-wide pool every layer shares (decoder output pages and
    the loaders that release them), one so that a page freed by one batch
    warms the next; ``pin_memory`` selects the page-locked one that feeds a
    card."""
    pin_memory = bool(pin_memory)
    with _DEFAULT_POOL_LOCK:
        pool = _DEFAULT_POOLS.get(pin_memory)
        if pool is None:
            pool = _DEFAULT_POOLS[pin_memory] = BufferPool(
                pin_memory=pin_memory)
        return pool


# -- shared-memory ring -----------------------------------------------------


def shm_available() -> bool:
    """Can this platform back a shm ring? (POSIX shared memory present and
    writable — containers occasionally mount /dev/shm noexec/ro.)"""
    try:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True, size=16)
        try:
            seg.unlink()
        finally:
            seg.close()
        return True
    except (ImportError, OSError):
        return False


def _slot_name(session: str, slot: int) -> str:
    return f"ldtshm_{session}_{slot}"


def _round_slot_size(nbytes: int) -> int:
    """Slot capacity for a batch of ``nbytes``: 25% headroom rounded up to
    4 KiB pages, so steady-state jitter in batch size (ragged label widths,
    contrastive text columns) doesn't resize every other batch."""
    padded = nbytes + nbytes // 4
    return max(4096, (padded + 4095) // 4096 * 4096)


def _plan_layout(batch: dict) -> Optional[Tuple[list, int]]:
    """``(tensor_metas, total_bytes)`` for writing ``batch`` into one slot;
    ``None`` when the batch isn't a pure dict of numpy arrays (the caller
    then falls back to the pickle transport)."""
    metas = []
    offset = 0
    for name, arr in batch.items():
        if not isinstance(arr, np.ndarray):
            return None
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        metas.append([name, arr.dtype.str, list(arr.shape), offset])
        offset += arr.nbytes
    return metas, offset


class ShmSlotWriter:
    """Worker-process half of the ring: acquire a free slot token, size the
    slot's segment to the batch, copy the tensors in, and return a small
    picklable descriptor. Falls back (returns ``None``) when no slot frees
    up within the acquire timeout — liveness is never hostage to a lost
    token."""

    def __init__(self, session: str, free_q, acquire_timeout_s: float = 10.0):
        self.session = session
        self._free_q = free_q
        self.acquire_timeout_s = acquire_timeout_s
        # slot -> (SharedMemory, size) as last seen by THIS process.
        self._segments: Dict[int, Tuple[object, int]] = {}

    def _acquire(self):
        import queue as _queue

        deadline = time.monotonic() + self.acquire_timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                tok = self._free_q.get(timeout=min(0.25, remaining))
            except _queue.Empty:
                continue
            return tok  # (slot, gen, size) or None = shutdown poison

    def _ensure(self, slot: int, gen: int, size: int, needed: int):
        """Attach (or create/resize) the slot's segment with capacity for
        ``needed`` bytes. Returns ``(seg, gen, size)``."""
        from multiprocessing import shared_memory

        name = _slot_name(self.session, slot)
        cached = self._segments.get(slot)
        if needed > size:
            # Resize = unlink + recreate under the same name. Only the
            # token holder touches a slot, so no other process can be
            # mid-write; readers detect staleness by the size change
            # (sizes strictly grow).
            if size > 0:
                if cached is not None and cached[1] == size:
                    old = cached[0]
                else:
                    if cached is not None:
                        cached[0].close()
                    old = shared_memory.SharedMemory(name=name)
                try:
                    old.unlink()
                except FileNotFoundError:
                    pass  # earlier failed resize already removed it
                finally:
                    old.close()
                self._segments.pop(slot, None)
            size = _round_slot_size(needed)
            gen += 1
            seg = self._create(name, size)
            self._segments[slot] = (seg, size)
            return seg, gen, size
        if cached is not None and cached[1] == size:
            return cached[0], gen, size
        if cached is not None:
            cached[0].close()
        if size == 0:
            # A (slot, gen, 0) token after a failed write: the segment may
            # or may not exist — _create below reconciles either way.
            size = _round_slot_size(needed)
            gen += 1
            seg = self._create(name, size)
            self._segments[slot] = (seg, size)
            return seg, gen, size
        seg = shared_memory.SharedMemory(name=name)
        self._segments[slot] = (seg, size)
        return seg, gen, size

    @staticmethod
    def _create(name: str, size: int):
        """Create a segment, reconciling a leftover from a failed earlier
        write (same name, unknown size): unlink it and retry once."""
        from multiprocessing import shared_memory

        try:
            return shared_memory.SharedMemory(name=name, create=True,
                                              size=size)
        except FileExistsError:
            stale = shared_memory.SharedMemory(name=name)
            try:
                stale.unlink()
            finally:
                stale.close()
            return shared_memory.SharedMemory(name=name, create=True,
                                              size=size)

    def write_batch(self, batch: dict) -> Optional[dict]:
        plan = _plan_layout(batch)
        if plan is None:
            return None
        metas, total = plan
        t0 = time.monotonic_ns()
        tok = self._acquire()
        if tok is None:  # timeout or shutdown poison: pickle fallback
            return None
        # Unpack the token FIRST (pure tuple destructuring, cannot raise):
        # from here down the requeue in the except arm owns the slot, so
        # no statement between acquire and the try can strand it (LDT1201).
        slot, gen, size = tok
        wait_ms = (time.monotonic_ns() - t0) / 1e6
        try:
            seg, gen, size = self._ensure(slot, gen, size, total)
            resized = size != tok[2]
            for name, dtype_str, shape, offset in metas:
                dst = np.ndarray(
                    tuple(shape), np.dtype(dtype_str),
                    buffer=seg.buf, offset=offset,
                )
                np.copyto(dst, batch[name])
        except BaseException as exc:
            # Requeue a RESET token (size 0), not the one we were handed:
            # _ensure may have already unlinked the slot's old segment, so
            # the stale (slot, gen, size) would poison every later writer
            # with FileNotFoundError. Size 0 makes the next holder create
            # fresh (reconciling any leftover segment).
            self._segments.pop(slot, None)
            self._free_q.put((slot, gen + 1, 0))
            if isinstance(exc, OSError):
                # E.g. ENOSPC on an undersized /dev/shm (64 MB docker
                # default vs ~48 MB slots): degrade to the pickle
                # transport for this batch instead of killing the epoch —
                # the documented fallback policy.
                return None
            raise
        return {
            "slot": slot, "gen": gen, "size": size, "total": total,
            "wait_ms": round(wait_ms, 3), "resized": resized,
            "tensors": metas,
        }

    def close(self) -> None:
        for seg, _ in self._segments.values():
            try:
                seg.close()
            except (OSError, BufferError):  # BufferError: copy in flight
                pass
        self._segments.clear()


class ShmRing:
    """Parent/consumer half of the ring: owns the slot-token queue and the
    segments' lifecycle. ``read_batch`` maps a descriptor's slot, copies
    the tensors out (into ``BufferPool`` pages when given), and returns the
    token to the free queue — the consumer ack that lets a worker reuse the
    slot."""

    def __init__(
        self,
        nslots: int,
        ctx,
        acquire_timeout_s: float = 10.0,
        registry: Optional[MetricsRegistry] = None,
    ):
        if nslots < 1:
            raise ValueError("ShmRing needs nslots >= 1")
        self.session = uuid.uuid4().hex[:12]
        self.nslots = nslots
        self.acquire_timeout_s = acquire_timeout_s
        # Bounded: at most nslots tokens circulate; the headroom absorbs
        # shutdown poison pills without ever blocking.
        self._free_q = ctx.Queue(maxsize=nslots + 64)
        for slot in range(nslots):
            self._free_q.put((slot, 0, 0))  # size 0 = not yet created
        self._segments: Dict[int, Tuple[object, int]] = {}
        self._closed = False
        self._lock = threading.Lock()
        reg = registry if registry is not None else default_registry()
        self._batches = reg.counter("shm_batches_total")
        self._bytes = reg.counter("shm_bytes_total")
        self._resizes = reg.counter("shm_slot_resizes_total")
        self._fallbacks = reg.counter("shm_fallback_total")
        self._wait_hist = reg.histogram("shm_slot_wait_ms")

    def writer_args(self) -> tuple:
        """The picklable bits a worker needs to build its
        :class:`ShmSlotWriter` (rides ``ProcessPoolExecutor`` initargs —
        legal because initargs travel as spawn-time ``Process`` arguments,
        the one context where an ``mp.Queue`` may be pickled)."""
        return (self.session, self._free_q, self.acquire_timeout_s)

    def _attach(self, slot: int, size: int):
        from multiprocessing import shared_memory

        cached = self._segments.get(slot)
        if cached is not None and cached[1] == size:
            return cached[0]
        if cached is not None:
            cached[0].close()
            self._segments.pop(slot, None)
        seg = shared_memory.SharedMemory(name=_slot_name(self.session, slot))
        self._segments[slot] = (seg, size)
        return seg

    def read_batch(
        self, desc: dict, buffer_pool: Optional[BufferPool] = None
    ) -> dict:
        """Descriptor → ``{name: np.ndarray}`` (freshly owned arrays; the
        slot is released back to the ring before returning)."""
        if self._closed:
            raise RuntimeError("ShmRing is closed")
        slot, gen, size = desc["slot"], desc["gen"], desc["size"]
        out: Dict[str, np.ndarray] = {}
        try:
            # Lock only the attach-cache lookup: the slot's CONTENT is
            # exclusively ours while we hold its token, and serialising
            # the multi-MB copies would bottleneck multi-client servers
            # on one reader thread's memcpy. The attach lives INSIDE the
            # requeue-protected try: a vanished segment (worker died
            # mid-epoch, FileNotFoundError here) must return the token
            # too, not just copy failures.
            with self._lock:
                seg = self._attach(slot, size)
            for name, dtype_str, shape, offset in desc["tensors"]:
                shape = tuple(shape)
                src = np.ndarray(
                    shape, np.dtype(dtype_str), buffer=seg.buf, offset=offset
                )
                if buffer_pool is not None:
                    dst = buffer_pool.lease(shape, dtype_str)
                else:
                    dst = np.empty(shape, np.dtype(dtype_str))
                # Park ownership in `out` BEFORE the copy: if copyto raises
                # (a torn/stale descriptor), the except arm below can
                # release every page it leased so far, dst included.
                out[name] = dst
                np.copyto(dst, src)
        except BaseException:
            # A failed copy-out must not strand resources: return the
            # leased pages to the pool and — critically — the slot token
            # to the ring (a lost token shrinks the ring FOREVER; the
            # writer side already requeues a reset token on its own
            # failures, this is the reader-side mirror).
            if buffer_pool is not None:
                for arr in out.values():
                    buffer_pool.release(arr)
            self._free_q.put((slot, gen, size))
            if leaktrack.enabled():
                leaktrack.track_release("shm-token",
                                        (self.session, slot, gen))
            raise
        self._free_q.put((slot, gen, size))
        if leaktrack.enabled():
            leaktrack.track_release("shm-token", (self.session, slot, gen))
        self._batches.inc()
        self._bytes.inc(desc["total"])
        if desc.get("resized"):
            self._resizes.inc()
        self._wait_hist.observe(desc.get("wait_ms", 0.0))
        return out

    def release_token(self, desc: dict) -> None:
        """Return a descriptor's slot without reading it (teardown path for
        completed-but-unconsumed futures)."""
        if self._closed:
            return
        self._free_q.put((desc["slot"], desc["gen"], desc["size"]))
        if leaktrack.enabled():
            leaktrack.track_release(
                "shm-token", (self.session, desc["slot"], desc["gen"])
            )

    def count_fallback(self) -> None:
        self._fallbacks.inc()

    def poison(self, n: int) -> None:
        """Wake ``n`` workers potentially blocked on slot acquisition so
        executor shutdown can join them."""
        import queue as _queue

        for _ in range(n):
            try:
                self._free_q.put_nowait(None)
            except _queue.Full:
                break

    def cleanup(self) -> None:
        """Unlink every slot segment (whichever process created it — names
        are deterministic) and close the token queue. Idempotent; ignores
        already-gone segments, so it is safe after worker crashes."""
        from multiprocessing import shared_memory

        with self._lock:
            if self._closed:
                return
            self._closed = True
            for seg, _ in self._segments.values():
                try:
                    seg.close()
                except (OSError, BufferError):  # BufferError: copy in flight
                    pass
            self._segments.clear()
            for slot in range(self.nslots):
                try:
                    seg = shared_memory.SharedMemory(
                        name=_slot_name(self.session, slot)
                    )
                except FileNotFoundError:
                    continue
                except OSError:
                    continue
                try:
                    seg.unlink()  # unregisters: balances the create-time register
                finally:
                    seg.close()
            try:
                self._free_q.close()
                self._free_q.cancel_join_thread()
            except (OSError, AttributeError):
                pass
