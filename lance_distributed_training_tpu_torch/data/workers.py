"""Process-pool decode workers: read and decode in spawned processes.

Counterpart of ``lance_distributed_training_tpu/data/workers.py``, the
reference's ``get_safe_loader``/``num_workers`` path. A
:class:`WorkerPool` is N **spawned** processes; each re-opens the columnar
store by URI (or takes the folder arm's sample list) in its initializer,
reads and decodes whole plan items, and streams the results back **in plan
order** with a bounded in-flight window (``imap``). With the default
``transport="shm"`` a decoded batch crosses the process boundary through a
shared-memory ring slot (:class:`~.buffers.ShmRing`): the worker returns a
small descriptor and the consumer copies once out of the mapped pages into
a lease of its own pool; ``transport="pickle"`` pickles every batch (the
control arm, and the fallback when POSIX shared memory is missing).

Workers never touch the card. Spawned children import the port's package
(torch included, which initialises no CUDA context), unpickle the decoder
(:meth:`__getstate__` drops its pool, native bindings and registry
handles) and re-bind a plain, unpinned :class:`~.buffers.BufferPool` under
the shm transport: page-locking a page would create a CUDA context in the
child. Nothing here builds or loads a kernel. Inside a worker a decoder
runs its own threads as in the trainer's process (the PIL arm's pool of
``max(4, cpus // 2)``, the coefficient extractor's one thread a hardware
thread), as the JAX workers do, so N workers oversubscribe the host N-fold.

The coefficient grid is per process: each worker's
:class:`~.device_decode.CoeffImageDecoder` grows its page grid to the
largest image that worker has seen, so on a mixed-size corpus pages from
different workers can differ in shape (never in pixels after K2). The JAX
workers behave the same way.

The registry series a worker observes (``decode_entropy_ms``, the
``pack_*`` counters) land in the worker's own registry; the consumer's
holds ``workers_result_wait_ms``, ``workers_resizes_total``,
``workers_pool_size`` and the ring's ``shm_*`` series.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from ..obs.registry import default_registry
from ..utils import leaktrack

__all__ = ["WorkerPool", "columnar_spec", "folder_spec", "RETRYABLE_READ_ERRORS"]

# The transient-read failure set shared by every retry surface (in-worker
# retries here, the data-service server's read_item): one definition so the
# policies cannot drift.
RETRYABLE_READ_ERRORS = (OSError, pa.ArrowInvalid)

# Per-worker state, set by the pool initializer (module-global because
# ProcessPoolExecutor task functions must be importable module-level names).
_STATE: Optional[tuple] = None


def columnar_spec(uri: str) -> Tuple[str, object]:
    """Reader spec for a columnar dataset: workers re-open by URI."""
    return ("columnar", str(uri))


def folder_spec(samples: Sequence[Tuple[str, int]]) -> Tuple[str, object]:
    """Reader spec for the folder control arm: (path, label) samples."""
    return ("folder", list(samples))


def _init_worker(reader_spec, decode_fn, columns=None,
                 read_retries=1, retry_backoff_s=0.05,
                 shm_args=None) -> None:
    global _STATE
    kind, payload = reader_spec
    if kind == "columnar":
        from .format import Dataset

        reader = Dataset(payload)
    elif kind == "folder":
        reader = payload
    else:
        raise ValueError(f"unknown reader spec kind {kind!r}")
    writer = None
    if shm_args is not None:
        from .buffers import BufferPool, ShmSlotWriter

        writer = ShmSlotWriter(*shm_args)
        # Worker-local decode pages: the decoder writes into warm pooled
        # buffers, the slot write is one memcpy out of them, and the pages
        # recycle immediately after (pickling never sees them).
        if hasattr(decode_fn, "buffer_pool"):
            decode_fn.buffer_pool = BufferPool()
    _STATE = (kind, reader, decode_fn, columns, read_retries,
              retry_backoff_s, writer)


def _read_item(kind: str, reader, item, columns=None) -> pa.Table:
    if kind == "folder":
        # Folder reads always produce exactly {image, label}; nothing to
        # project.
        payloads, labels = [], []
        for i in np.asarray(item):
            path, label = reader[int(i)]
            with open(path, "rb") as f:
                payloads.append(f.read())
            labels.append(label)
        return pa.table(
            {"image": pa.array(payloads, pa.binary()),
             "label": pa.array(labels, pa.int64())}
        )
    if isinstance(item, np.ndarray):  # map-style: global-index take
        return reader.take(item, columns=columns)
    # iterable-style: list of ReadRange
    tables = [
        reader.read_range(r.fragment, r.start, r.stop, columns=columns)
        for r in item
    ]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


def _run_item(item):
    """One plan item → a tagged result: ``("shm", descriptor)`` when the
    batch rode a shared-memory slot, ``("raw", batch)`` when it must be
    pickled (shm off, non-dict batch, or no slot freed up in time)."""
    assert _STATE is not None, "worker not initialized"
    (kind, reader, decode_fn, columns, read_retries, backoff_s,
     writer) = _STATE
    retries = max(1, read_retries)
    last = None
    for attempt in range(retries):
        try:
            table = _read_item(kind, reader, item, columns)
            break
        except RETRYABLE_READ_ERRORS as exc:  # transient storage blip
            last = exc
            if attempt + 1 < retries:  # no pointless sleep after the last try
                import time

                time.sleep(backoff_s * (2**attempt))
    else:
        raise RuntimeError(
            f"worker read failed after {retries} attempts: {last}"
        ) from last
    batch = decode_fn(table)
    if writer is not None and isinstance(batch, dict):
        desc = writer.write_batch(batch)
        pool = getattr(decode_fn, "buffer_pool", None)
        if pool is not None:
            # Recycle the decode pages either way: after a slot write they
            # are free immediately; on the pickle fallback the executor's
            # return pickling still holds the dict, so the refcount guard
            # defers the actual reuse until that copy is done.
            pool.release_batch(batch)
        if desc is not None:
            return ("shm", desc)
    return ("raw", batch)


class _PoolState:
    """The mutable teardown target shared by :meth:`WorkerPool.shutdown`,
    :meth:`WorkerPool.resize`, and the GC-time finalizer. The finalizer must
    NOT close over the pool (that would pin it alive forever) and must NOT
    bind a fixed executor (``resize`` swaps executors) — so everything
    teardown needs lives here, behind one lock."""

    __slots__ = ("executor", "ring", "workers", "retired", "lanes", "lock")

    def __init__(self, executor, ring, workers: int):
        self.executor = executor
        self.ring = ring
        self.workers = workers
        # Executors retired by resize(), still draining their in-flight
        # items: (executor, joiner thread, worker count). shutdown() joins
        # these BEFORE unlinking shm segments — a retired worker mid-slot-
        # write racing ring.cleanup() was the shutdown-during-resize bug.
        self.retired: list = []
        # Dedicated lanes (ensure_lane): name -> (executor, worker count).
        # Same spawn context + initargs as the main executor, so lane
        # workers share the shm ring by session name exactly like resize's
        # replacement executors do.
        self.lanes: dict = {}
        self.lock = threading.Lock()


def _drain_retired(executor) -> None:
    """Retire-thread body: wait out the retired executor's in-flight items
    (their results are still owed to an ``imap`` consumer — dropping them
    would hole the plan), then join its workers."""
    executor.shutdown(wait=True, cancel_futures=False)


def _teardown_pool(state: _PoolState) -> None:
    """Shutdown body shared by :meth:`WorkerPool.shutdown` and the GC-time
    finalizer. Order matters: poison the slot queue FIRST (sized for every
    worker, current AND retired) so any worker blocked waiting for a free
    slot wakes and finishes, then join the retired executors' drains, then
    the live executor, and only then unlink the segments — a worker still
    writing a slot when the segment unlinks degrades that batch to the
    pickle fallback at best."""
    with state.lock:
        executor = state.executor
        ring = state.ring
        retired = list(state.retired)
        lanes = list(state.lanes.values())
        total_workers = (state.workers + sum(n for _, _, n in retired)
                         + sum(n for _, n in lanes))
    if ring is not None:
        ring.poison(total_workers)
    for old, joiner, _ in retired:
        joiner.join(timeout=30.0)
        # Idempotent (the joiner already ran shutdown); cancel_futures covers
        # a joiner that timed out wedged.
        old.shutdown(wait=True, cancel_futures=True)
    for lane_executor, _ in lanes:
        lane_executor.shutdown(wait=True, cancel_futures=True)
    executor.shutdown(wait=True, cancel_futures=True)
    if ring is not None:
        ring.cleanup()


class WorkerPool:
    """Persistent spawn-context process pool running read+decode.

    ``persistent_workers=True`` parity: create once, reuse across epochs
    (the reference's ``lance_map_style.py:68``); workers keep their dataset
    handle and decoder warm between epochs.
    """

    def __init__(
        self,
        reader_spec: Tuple[str, object],
        decode_fn: Callable,
        num_workers: int,
        columns: Optional[Sequence[str]] = None,
        read_retries: int = 1,
        retry_backoff_s: float = 0.05,
        transport: str = "shm",
        buffer_pool=None,
        shm_slots: int = 0,
        shm_acquire_timeout_s: float = 10.0,
    ):
        """``read_retries > 1`` retries transient in-worker read failures
        (OSError) with exponential backoff — the data-service server passes
        its retry policy through so remote streams survive storage blips.

        ``transport="shm"`` (default) moves decoded batches through
        shared-memory ring slots (:mod:`.buffers`) instead of pickling
        them; ``"pickle"`` is the legacy path (and the automatic fallback
        when POSIX shm is unavailable). ``buffer_pool`` receives the
        consumer-side copies so pages recycle across batches; ``shm_slots``
        sizes the ring (default ``2 × num_workers`` — one slot per
        in-flight item at imap's default window)."""
        if num_workers < 1:
            raise ValueError("WorkerPool needs num_workers >= 1")
        if transport not in ("shm", "pickle"):
            raise ValueError(
                f"transport must be 'shm' or 'pickle', got {transport!r}"
            )
        self.num_workers = num_workers
        self.columns = list(columns) if columns is not None else None
        self.buffer_pool = buffer_pool
        ctx = mp.get_context("spawn")
        self._ring = None
        if transport == "shm":
            from .buffers import ShmRing, shm_available

            if shm_available():
                self._ring = ShmRing(
                    shm_slots or 2 * num_workers, ctx,
                    acquire_timeout_s=shm_acquire_timeout_s,
                )
            else:
                import warnings

                warnings.warn(
                    "POSIX shared memory unavailable — WorkerPool falling "
                    "back to the pickle transport (every decoded batch is "
                    "serialised across the IPC boundary)",
                    stacklevel=2,
                )
        self.transport = "shm" if self._ring is not None else "pickle"
        shm_args = self._ring.writer_args() if self._ring is not None else None
        # Spawn, not fork: fork would inherit locks/ctypes handles mid-state —
        # the exact hazard upstream's SafeLanceDataset exists to avoid.
        # (shm_args carries an mp.Queue: initargs travel as spawn-time
        # Process arguments, the one context where that pickle is legal.)
        # Kept so resize() can build replacement executors with the same
        # worker environment.
        self._ctx = ctx
        self._initargs = (reader_spec, decode_fn,
                          list(columns) if columns is not None else None,
                          read_retries, retry_backoff_s, shm_args)
        self._pool = ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=ctx,
            initializer=_init_worker,
            initargs=self._initargs,
        )
        # Leak guard: if the owning trainer crashes (or simply drops the
        # pool without shutdown()), the finalizer still tears the executor
        # down at GC / interpreter exit — spawned decode processes never
        # outlive their parent as orphans and shm slots never outlive the
        # pool. Registered against a shared state holder (not `self`, which
        # the finalizer would pin alive forever; not the executor, which
        # resize() swaps out from under a long-lived pool).
        self._state = _PoolState(self._pool, self._ring, num_workers)
        self._finalizer = weakref.finalize(self, _teardown_pool, self._state)

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    @property
    def dispatch_capacity(self) -> Optional[int]:
        """Hard ceiling on concurrently-held in-flight items, or None
        (pickle transport — unbounded). On the shm transport this is the
        ring's slot count: a dispatcher holding results out of order
        (the straggler scheduler) pins one slot per undelivered batch,
        so exceeding it wedges workers on slot acquire until the 10 s
        timeout drops them to the pickle fallback."""
        return self._ring.nslots if self._ring is not None else None

    def resize(self, num_workers: int) -> int:
        """Grow or shrink the decode pool to ``num_workers`` WITHOUT
        dropping in-flight batches — the autotuner's actuator.

        Mechanism: a fresh spawn-context executor replaces the live one, so
        every subsequent ``imap`` submission lands on the new width, while
        the old executor *retires*: a daemon joiner thread waits out its
        in-flight items (their results are still owed, in order, to the
        consumer's future deque) and joins its workers. The shm ring is
        shared by session name + token queue, so old and new workers
        interleave slot writes safely; the consumer acks tokens regardless
        of which executor produced the descriptor.

        Shutdown ordering (the regression this API shipped with a fix for):
        ``shutdown()`` joins every retired executor's drain BEFORE
        unlinking the shm segments, so a retired worker mid-slot-write can
        never race ``ring.cleanup()``.

        Note the ring's slot count is fixed at construction (default
        ``2 × initial workers``): growing far beyond the initial width
        still works, but workers then contend for slots — size
        ``shm_slots`` generously when a run expects to be autotuned up.

        Returns the applied worker count. No-op (same count) returns
        immediately.
        """
        if num_workers < 1:
            raise ValueError("WorkerPool needs num_workers >= 1")
        if self.closed:
            raise RuntimeError("WorkerPool is shut down")
        state = self._state
        with state.lock:
            if num_workers == state.workers:
                return num_workers
            old = state.executor
            old_workers = state.workers
            new = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=self._ctx,
                initializer=_init_worker,
                initargs=self._initargs,
            )
            state.executor = new
            state.workers = num_workers
            # Handle swap is GIL-atomic; imap reads it per submission, so
            # pending futures from the old executor and new submissions on
            # the new one interleave in the consumer's deque in plan order.
            self._pool = new  # ldt: ignore[LDT1002] -- atomic handle swap under state.lock; imap's per-submit read tolerates either executor
            self.num_workers = num_workers  # ldt: ignore[LDT1002] -- monotonic int swap, advisory reads only
            joiner = threading.Thread(
                target=_drain_retired, args=(old,), daemon=True,
                name="ldt-workerpool-retire",
            )
            state.retired.append((old, joiner, old_workers))
            joiner.start()
        default_registry().counter("workers_resizes_total").inc()
        default_registry().gauge("workers_pool_size").set(num_workers)
        return num_workers

    def tunables(self):
        """The autotuner's knob: decode worker count, bounded by the host's
        core count (growing decode processes past the cores that would run
        them only adds contention)."""
        from ..tune.tunable import Tunable

        return [Tunable(
            "workers",
            lambda: self.num_workers,
            self.resize,
            lo=1,
            hi=max(2, os.cpu_count() or 2, self.num_workers),
            doc="decode worker processes (WorkerPool.resize)",
        )]

    def imap(self, items: Iterable, window: int = 0) -> Iterator[dict]:
        """Ordered streaming map: results yielded in submission order, at most
        ``window`` items in flight (default: 2× workers).

        On iterator abandonment (generator ``close()``) or a raised decode
        error, in-flight futures are cancelled so the pool drains instead of
        decoding an epoch nobody will consume; the pool itself stays warm for
        the next epoch (``persistent_workers`` parity) — only
        :meth:`shutdown` / context-manager exit / GC tears it down.

        Telemetry: each head-of-line result wait lands in the
        ``workers_result_wait_ms`` histogram (process registry) — near-zero
        means workers outrun the consumer, sustained large values mean the
        pool (or the IPC pickling) is the bottleneck.
        """
        if self.closed:
            raise RuntimeError("WorkerPool is shut down")
        window = window or 2 * self.num_workers
        wait_hist = default_registry().histogram("workers_result_wait_ms")

        def _result(fut):
            t0 = time.monotonic_ns()
            out = fut.result()
            wait_hist.observe((time.monotonic_ns() - t0) / 1e6)
            return self._unwrap(out)

        it = iter(items)
        pending: deque = deque()
        try:
            for item in it:
                pending.append(self._submit(item))
                if len(pending) >= window:
                    yield _result(pending.popleft())
            while pending:
                yield _result(pending.popleft())
        finally:
            self.abandon(pending)

    def abandon(self, futs) -> None:
        """Hand back in-flight futures nobody will consume (generator
        close, decode error): cancel what hasn't started; running/done
        futures may hold shm slot tokens — reclaim them (non-blocking:
        the pool is persistent across epochs, so a lost token would
        shrink the ring forever; a blocking wait here would stall
        generator close behind in-flight decodes). Shared by
        :meth:`imap` and the straggler scheduler's dispatch loop."""
        for fut in futs:
            if not fut.cancel() and self._ring is not None:
                fut.add_done_callback(self._reclaim_slot)

    def ensure_lane(self, lane: str, num_workers: int = 1) -> int:
        """Create (idempotently) a dedicated named lane: a second
        executor sharing this pool's spawn context, initargs, and shm
        ring — the straggler scheduler's heavy lane, so one predicted
        straggler never queues behind another. Sized once at first use;
        torn down with the pool (:func:`_teardown_pool` poisons the slot
        queue for lane workers too). Returns the lane's worker count."""
        if num_workers < 1:
            raise ValueError("lane needs num_workers >= 1")
        if self.closed:
            raise RuntimeError("WorkerPool is shut down")
        state = self._state
        with state.lock:
            existing = state.lanes.get(lane)
            if existing is not None:
                return existing[1]
            executor = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=self._ctx,
                initializer=_init_worker,
                initargs=self._initargs,
            )
            state.lanes[lane] = (executor, num_workers)
        default_registry().gauge("workers_lane_size").set(num_workers)
        return num_workers

    def submit_lane(self, item, lane: str = "default"):
        """Submit one plan item to a named lane (``"default"`` is the
        main executor — identical to the submission path :meth:`imap`
        uses). Non-default lanes must exist (:meth:`ensure_lane`)."""
        if lane == "default":
            return self._submit(item)
        with self._state.lock:
            entry = self._state.lanes.get(lane)
            if entry is None:
                raise ValueError(
                    f"unknown lane {lane!r} — call ensure_lane first"
                )
            return entry[0].submit(_run_item, item)

    def _submit(self, item):
        """Submit under the pool-state lock: ``resize`` swaps the executor
        and then (from its joiner thread, after releasing the lock) shuts
        the old one down — an unlocked read-then-submit could land on the
        retired executor *after* its shutdown and raise. Serialized here, a
        submit either lands on the old executor before the swap (its work
        item is already enqueued, so the retire drain completes it) or on
        the new one after."""
        with self._state.lock:
            return self._state.executor.submit(_run_item, item)

    def _unwrap(self, out):
        """Tagged worker result → batch dict (shm read + slot ack, or the
        pickled payload on the fallback path)."""
        if isinstance(out, tuple) and len(out) == 2 and out[0] == "shm":
            if leaktrack.enabled():
                # Parent-side token custody starts when the descriptor
                # lands here and ends at read_batch's ack-put (or
                # release_token on the abandon path) — the LDT1201 shm
                # witness half.
                desc = out[1]
                leaktrack.track_acquire(
                    "shm-token",
                    (self._ring.session, desc["slot"], desc["gen"]),
                )
            return self._ring.read_batch(out[1], self.buffer_pool)
        if isinstance(out, tuple) and len(out) == 2 and out[0] == "raw":
            if self._ring is not None:
                self._ring.count_fallback()
            return out[1]
        return out  # pre-tag worker build (defensive)

    def _reclaim_slot(self, fut) -> None:
        """Done-callback for abandoned in-flight futures: return the shm
        token their descriptor holds. Runs on the executor's collector
        thread the moment the result lands (immediately for already-done
        futures); release_token is a no-op after ring cleanup."""
        try:
            out = fut.result(timeout=0)
        except Exception:
            return  # worker error/cancel: shutdown's cleanup unlinks slots
        if isinstance(out, tuple) and len(out) == 2 and out[0] == "shm":
            self._ring.release_token(out[1])

    def shutdown(self) -> None:
        # wait=True: join the workers — abandoning spawn children mid-task
        # makes them die noisily ("Fatal Python error") at interpreter exit.
        # Routed through the finalizer so shutdown is idempotent and the
        # GC-time teardown never runs twice.
        self._finalizer()

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
