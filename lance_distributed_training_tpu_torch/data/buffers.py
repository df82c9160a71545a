"""Pooled decode pages: recycled host buffers for the decoders' output.

Counterpart of ``RaggedPage``, ``BufferPool`` and ``default_buffer_pool``
in ``lance_distributed_training_tpu/data/buffers.py``. Each decoded batch
used to fault a fresh array (about 77 MB a ResNet-50 batch of 512 at 224
px); the pool hands the warm pages of earlier batches back out instead:
lease-based, keyed by ``(shape, dtype)``, thread-safe, bounded. The
shared-memory ring of the JAX module (``ShmRing``, ``ShmSlotWriter``) is
not ported: the port has no worker processes yet.

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

Counters (plain integers, :meth:`BufferPool.counters`): ``hits``,
``misses``, ``evicts``, ``miss_ms``, ``ragged_leases`` and
``ragged_slack_bytes``; the JAX pool's registry series are not ported.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BufferPool", "RaggedPage", "default_buffer_pool"]


class RaggedPage(NamedTuple):
    """One variable-length column's pooled pages: a flat ``values`` page
    sized to a capacity bucket (so batches of nearby token counts recycle
    the same pages) and an exact ``offsets`` page. Both are ordinary
    leases, released with ``release``/``release_batch``."""

    values: np.ndarray  # [capacity_bucket]; the caller fills [:total]
    offsets: np.ndarray  # int32 [n_sequences + 1]
    capacity: int  # the bucket the values page was keyed under


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
                 pin_memory: bool = False):
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
            for arr in still[:-self.max_pending]:
                self._events.pop(id(arr), None)
            still = still[-self.max_pending:]
        self._pending = still

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
            else:
                self.misses += 1
        if arr is None:
            t0 = time.perf_counter()
            arr = self._allocate(shape, dtype)
            elapsed = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.miss_ms += elapsed
        outstanding = self._outstanding

        def _dropped(_ref, _key=id(arr)):
            # The lease died unreleased: retire its entry (no pool lock,
            # this runs from the garbage collector).
            outstanding.pop(_key, None)

        with self._lock:
            outstanding[id(arr)] = weakref.ref(arr, _dropped)
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
        with self._lock:
            self.ragged_leases += 1
            self.ragged_slack_bytes += ((cap - int(total))
                                        * np.dtype(values_dtype).itemsize)
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
            if event is not None:
                self._events[id(arr)] = event
            self._pending.append(arr)
            self._sweep_locked()
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
                    del free[cap:]
        return cap

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
