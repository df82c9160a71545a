"""Input pipeline: read plan → read → decode → prefetch → H2D.

Counterpart of ``make_train_pipeline``, ``make_map_style_pipeline`` and
``make_eval_pipeline`` in ``lance_distributed_training_tpu/data/
pipeline.py``. As there, each factory composes a
:class:`~.graph.LoaderGraph` and compiles it at once; the classes here are
the engines a graph compiles to. For the same arguments each yields the
JAX loader's batches in the same order:

- the iterable loader (:class:`TrainLoader`) reads this process's range
  plan (``sampler_type``, ``shuffle`` permuting batch order);
- the map-style loader (:class:`MapStylePipeline`) deals a seeded
  ``DistributedSampler`` permutation of the rows (or of an index pool, from
  a row filter or a val split), reshuffled each epoch, and gathers each
  batch with ``Dataset.take``;
- the eval loader (:class:`EvalLoader`) covers every row (or every pool
  position) once, the tail padded by wrap-around rows of weight 0.

``producers`` daemon threads (``ldt-producer``, or ``ldt-producer-<k>``
when there are several) read and decode the plan: thread ``k`` takes plan
items ``k, k + N, …`` into its own bounded queue and the consumer
round-robins the queues, so batches come out in plan order for any N, with
about ``max(prefetch, producers)`` buffered (a thread reads its next item
only once its queue has room). The reads run concurrently; the calls to
the decoder start in plan order (each decode runs beside the others), so
a decoder that counts its calls sees the plan's order. With ``device=None`` a loader
yields host numpy batches (the placement plane, ``data/placement.py``,
places them); with a device it places each batch itself through the
synchronous :func:`~..parallel.mesh.make_global_batch` (the
``--no_global_batch`` arm): on the consumer thread with one producer, in the
producer threads with several, each with its own pinned staging ring. Pages
leased from ``buffer_pool`` go back after the consumer's turn (host
batches), at placement (the synchronous arm), or as drained at teardown.

Worker processes (``workers``, a :class:`~.workers.WorkerPool`): read and
decode run in the pool instead; one producer thread (``ldt-producer``)
takes its results in plan order (``imap``) into a bounded queue, and
placement stays downstream, as in the JAX pipeline. With ``producers > 1``
it warns (the pool already decodes in parallel), and when the loader's
read projection differs from the pool's ``columns`` it warns too (reads
run inside the pool). The iterable, map-style and folder loaders take a
pool; the eval loader decodes on its own threads. A ``scheduler`` (a
:class:`~.schedule.DecodeScheduler`) reorders the pool's dispatch,
predicted-heaviest first within its lookahead; results still come in plan
order, so the batches are the same bit for bit (without a pool it is not
used: in-process decode has no dispatch to reorder).

Batch cache (``batch_cache``, a :class:`~.cache.BatchCache`): consulted at
the decode boundary of every loader through a per-iteration
:class:`~.cache.PlanCache` (the dataset's fingerprint, the decoder's and
the read projection's, the plan item's content hash): a hit skips the read
and the decode and returns a byte-identical copy in pages of
``buffer_pool``; a miss decodes and fills. Under a worker pool the plan is
probed once and only the misses go to the pool.

The autotuner's knobs (``tunables()``): ``prefetch`` (the producers' queues
are :class:`~..tune.tunable.AdjustableQueue` objects, moved live) and the
decoder's own. Each batch's read and decode time (under a pool, the wait
for its result) is observed into the registry's ``pipeline_decode_ms`` and
recorded as a ``pipeline.decode`` span.

Resume cursor (the JAX loaders' contract): ``state_dict()`` is ``{"epoch",
"step"}``, ``step`` counting the batches handed to the consumer (not those
prefetched), so read between steps it names the next batch.
``load_state_dict`` positions the next iteration there: the plan is sliced
(:func:`~.samplers.slice_plan`, which refuses a cursor beyond the plan),
and the skipped batches are never read or decoded. A map-style cursor
carries its epoch: the plan is a pure function of (pool, shard, seed,
epoch).
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from ..obs.costs import cost_context
from ..obs.registry import default_registry
from ..obs.spans import span
from ..tune.tunable import AdjustableQueue, Tunable, _LiveQueues
from .cache import (
    PlanCache,
    decode_fingerprint,
    item_fingerprint,
    plan_fingerprint,
)
from .format import Dataset, read_ranges
from .samplers import distributed_index_batches, slice_plan
from ..parallel.mesh import PinnedStager, indexed_device, make_global_batch

__all__ = ["EvalLoader", "MapStylePipeline", "TrainLoader",
           "make_eval_pipeline", "make_map_style_pipeline",
           "make_train_pipeline", "refuse_empty_plan"]




class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` once ``q`` has room, unless ``stop`` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class TrainLoader:
    """Iterate batches of this process's plan, in plan order, from the
    resume cursor on (the module's docstring): host batches with
    ``device=None``, else tensors on ``device``. A plan item is one step's
    ``ReadRange`` list, read projected to ``columns``; subclasses change
    what a plan item is and how it is read and decoded (:meth:`_plan`,
    :meth:`_read`, :meth:`_decode`) and how it is keyed in a batch cache
    (:meth:`_plan_cache`). ``workers``, ``scheduler`` and ``batch_cache``
    are the module docstring's."""

    def __init__(self, dataset: Dataset, plan: Optional[Sequence],
                 decode_fn: Callable[[pa.Table], dict],
                 device: Optional[torch.device], prefetch: int = 2,
                 epoch: int = 0, producers: int = 1, buffer_pool=None,
                 workers=None, batch_cache=None,
                 columns: Optional[Sequence[str]] = None, scheduler=None):
        self.dataset = dataset
        self.plan = list(plan) if plan is not None else None
        self.decode_fn = decode_fn
        self.device = indexed_device(device) if device is not None else None
        self.prefetch = max(1, int(prefetch))
        self.producers = max(1, int(producers))
        self.buffer_pool = buffer_pool
        self.workers = workers
        self.scheduler = scheduler
        self.batch_cache = batch_cache
        self.columns = list(columns) if columns is not None else None
        self.epoch = epoch
        self._start_step = 0  # where the next iteration starts in the plan
        self._yielded = 0  # batches handed out, absolute within the plan
        # The live prefetch queues of the current iteration, so that
        # set_prefetch moves their bound mid-epoch.
        self._live = _LiveQueues()

    def _plan(self) -> list:
        return self.plan

    def _read(self, item):
        """One plan item's rows (an Arrow table)."""
        return read_ranges(self.dataset, item, self.columns)

    def _decode(self, item, table) -> dict:
        """One plan item's rows decoded into a host numpy batch."""
        return self.decode_fn(table)

    def _load(self, item) -> dict:
        return self._decode(item, self._read(item))

    def _plan_cache(self) -> Optional[PlanCache]:
        """This iteration's binding of the batch cache: the dataset's
        fingerprint, and (evaluated per key, so that a live decoder knob
        re-scopes later entries) the decoder's and the projection's."""
        if self.batch_cache is None:
            return None
        columns = self.columns
        return PlanCache(
            self.batch_cache, self.dataset.fingerprint(),
            lambda: plan_fingerprint(
                decode=decode_fingerprint(self.decode_fn), columns=columns))

    def __len__(self) -> int:
        return len(self._plan())

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self._yielded}

    def load_state_dict(self, state: dict) -> None:
        step = int(state.get("step", 0))
        if step < 0:
            raise ValueError(f"negative resume cursor: {step}")
        epoch = int(state.get("epoch", self.epoch))
        if epoch != self.epoch:
            raise ValueError(f"cursor of epoch {epoch} loaded into the "
                             f"loader of epoch {self.epoch}")
        self._start_step = step
        self._yielded = step

    def set_prefetch(self, depth: int) -> int:
        """Move the prefetch bound, live: it takes effect on the current
        iteration's queues (growing wakes a waiting producer, shrinking
        lets the backlog drain; no batch is dropped or reordered) and on
        later iterations."""
        depth = max(1, int(depth))
        self.prefetch = depth
        self._live.resize_total(depth)
        return depth

    def tunables(self):
        """The autotuner's knobs: the prefetch depth, then the decoder's
        (the coefficient grid's rounding, the pack plan's shape), then the
        scheduler's (its lookahead and heavy-lane share)."""
        out = [Tunable(
            "prefetch", lambda: self.prefetch, self.set_prefetch,
            lo=1, hi=16,
            doc="decoded host batches buffered ahead of the consumer",
        )]
        decoder = getattr(self.decode_fn, "tunables", None)
        if decoder is not None:
            out.extend(decoder())
        if self.scheduler is not None:
            out.extend(self.scheduler.tunables())
        return out

    def host_batches(self) -> Iterator[dict]:
        """Decoded host numpy batches from the cursor on, read and decoded
        as they are iterated. The plan is sliced at the call, so a cursor
        beyond it raises here."""
        return map(self._load, slice_plan(self._plan(), self._start_step))

    def _release(self, batch) -> None:
        if self.buffer_pool is not None and isinstance(batch, dict):
            self.buffer_pool.release_batch(batch)

    def _place(self, batch: dict, stager) -> dict:
        return make_global_batch(batch, self.device, stager=stager,
                                 buffer_pool=self.buffer_pool)

    def _stager(self) -> Optional[PinnedStager]:
        if self.device is None or self.device.type != "cuda":
            return None
        return PinnedStager(self.device)

    def __iter__(self) -> Iterator[dict]:
        plan = slice_plan(self._plan(), self._start_step)
        base = self._start_step
        self._yielded = base
        if self.workers is not None:
            self._check_workers()
            yield from self._iter_workers(plan, base)
        else:
            yield from self._iter_threads(plan, base)

    def _check_workers(self) -> None:
        """The JAX pipeline's warnings about a worker pool's seam."""
        if self.producers > 1:
            warnings.warn(
                "producers>1 has no effect with a WorkerPool: worker "
                "processes already decode in parallel (and H2D lives in "
                "the placement plane, or on the consumer thread for the "
                "synchronous arm). Drop num_workers to use producer "
                "threads instead.",
                stacklevel=3,
            )
        if self.dataset is not None:
            # Reads run inside the pool with the pool's projection.
            pool_cols = getattr(self.workers, "columns", None)
            if self.columns != pool_cols:
                warnings.warn(
                    f"pipeline columns {self.columns} differ from the "
                    f"WorkerPool's {pool_cols}; reads run inside the pool, "
                    "so pass the same columns= to WorkerPool(...) for the "
                    "projection to apply.",
                    stacklevel=3,
                )

    def _consume(self, item, stager):
        """A produced item on the consumer's side: raised, placed (the
        synchronous arm) or handed out as it is."""
        if isinstance(item, _Failure):
            raise item.exc
        if self.device is not None and stager is not False:
            item = self._place(item, stager)
        return item

    def _iter_threads(self, plan: list, base: int) -> Iterator[dict]:
        n = self.producers
        per = max(1, -(-max(self.prefetch, n) // n))
        # A bounded queue a thread; a thread reads its next item only once
        # its queue has room.
        queues = [AdjustableQueue(per) for _ in range(n)]
        self._live.install(queues)
        stop = threading.Event()
        turn = [0]  # the next plan item whose decode may start
        failed = [len(plan)]  # the first plan item that raised
        turn_cv = threading.Condition()
        cache = self._plan_cache()
        decode_ms = default_registry().histogram("pipeline_decode_ms")
        # The synchronous arm places on the consumer thread with one
        # producer, in the producers with several (each its own stager).
        place_in_producer = self.device is not None and n > 1

        def wait_room(k: int) -> bool:
            q = queues[k]
            with q.not_full:
                while not stop.is_set():
                    if q._qsize() < q.maxsize:
                        return True
                    q.not_full.wait(0.1)
            return False

        def wait_turn(j: int) -> bool:
            with turn_cv:
                while turn[0] != j:
                    # The consumer stops at the first item that raised: the
                    # items before it are still needed, those after not.
                    if stop.is_set() or j > failed[0]:
                        return False
                    turn_cv.wait(timeout=0.1)
                turn[0] = j + 1
                turn_cv.notify_all()
            return True

        def load(j: int):
            """Plan item ``j``'s batch (``None`` when told to stop): a
            cache hit, else read, then decoded in its turn."""
            item = plan[j]
            out = cache.get(item, pool=self.buffer_pool) \
                if cache is not None else None
            if out is not None:
                if not wait_turn(j):
                    self._release(out)
                    return None
                return out
            table = self._read(item)
            if not wait_turn(j):
                return None
            with cost_context(item_fingerprint(item), step=base + j) as cost:
                t0 = time.perf_counter()
                out = self._decode(item, table)
                cost.note(decode_ms=round((time.perf_counter() - t0) * 1e3,
                                          3),
                          bytes=sum(getattr(v, "nbytes", 0)
                                    for v in out.values()))
            if cache is not None:
                cache.put(item, out)
            return out

        def produce(k: int) -> None:
            j = k
            try:
                stager = None
                if place_in_producer:
                    if self.device.type == "cuda":
                        torch.cuda.set_device(self.device)
                    stager = self._stager()
                for j in range(k, len(plan), n):
                    if not wait_room(k):
                        return
                    t0 = time.perf_counter()
                    with span("pipeline.decode", batch_seq=base + j,
                              producer=k):
                        out = load(j)
                    if out is None:
                        return
                    decode_ms.observe((time.perf_counter() - t0) * 1e3)
                    if place_in_producer:
                        out = self._place(out, stager)
                    if not _put(queues[k], out, stop):
                        self._release(out)
                        return
                _put(queues[k], _DONE, stop)
            except BaseException as exc:  # handed to the consumer, re-raised
                _put(queues[k], _Failure(exc), stop)
                with turn_cv:
                    failed[0] = min(failed[0], j)
                    turn_cv.notify_all()

        threads = [
            threading.Thread(
                target=produce, args=(k,), daemon=True,
                name="ldt-producer" if n == 1 else f"ldt-producer-{k}")
            for k in range(n)
        ]
        stager = False if place_in_producer else self._stager()
        for t in threads:
            t.start()
        try:
            active = [True] * n
            done = i = 0
            while done < n:
                k = i % n
                i += 1
                if not active[k]:
                    continue
                item = queues[k].get()
                if item is _DONE:
                    active[k] = False
                    done += 1
                    continue
                item = self._consume(item, stager)
                # Counted as handed out: between steps the cursor names the
                # next batch.
                self._yielded += 1
                yield item
                if self.device is None:
                    # A host batch: the consumer had its turn. A reference
                    # it kept defers the page's recycling, never its safety.
                    self._release(item)
                del item
        finally:
            stop.set()
            self._live.clear()
            # The threads observe the stop flag within a read or a decode;
            # the batches they left go back to the pool.
            for t in threads:
                t.join()
            for q in queues:
                while not q.empty():
                    self._release(q.get_nowait())

    def _worker_imap(self, items):
        """The pool's dispatch seam: straggler-aware when a scheduler is
        attached (dispatch reordered; results still come in plan order)."""
        if self.scheduler is not None:
            return self.scheduler.imap(self.workers, items)
        return self.workers.imap(items)

    def _iter_workers(self, plan: list, base: int) -> Iterator[dict]:
        """The worker pool's seam: one producer thread takes the pool's
        results in plan order (only the cache's misses go to the pool);
        the consumer places (synchronous arm) and hands them out."""
        q = AdjustableQueue(self.prefetch)
        self._live.install([q])
        stop = threading.Event()
        cache = self._plan_cache()
        decode_ms = default_registry().histogram("pipeline_decode_ms")

        def produce() -> None:
            try:
                if cache is not None:
                    # Probe once: result k of the pool's iterator is the
                    # k-th probed miss. A probed hit evicted before its
                    # fetch decodes here, never off the iterator (that
                    # would shift every later batch).
                    probed = [cache.contains(item) for item in plan]
                    results = self._worker_imap(
                        [i for i, hit in zip(plan, probed) if not hit])
                else:
                    probed = None
                    results = self._worker_imap(plan)
                try:
                    for off, item in enumerate(plan):
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        with span("pipeline.decode", batch_seq=base + off):
                            if probed is not None and probed[off]:
                                out = cache.get(item, pool=self.buffer_pool)
                                if out is None:  # evicted since the probe
                                    out = self._load(item)
                                    cache.put(item, out)
                            else:
                                out = next(results)
                                if cache is not None:
                                    # A miss that never went through get().
                                    cache.note_miss()
                                    cache.put(item, out)
                        # The wait for the pool's result, not decode time.
                        decode_ms.observe((time.perf_counter() - t0) * 1e3)
                        if not _put(q, out, stop):
                            self._release(out)
                            return
                    _put(q, _DONE, stop)
                finally:
                    # Hands in-flight items (and their shm slots) back.
                    results.close()
            except BaseException as exc:  # handed to the consumer, re-raised
                _put(q, _Failure(exc), stop)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="ldt-producer")
        stager = self._stager()
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                item = self._consume(item, stager)
                self._yielded += 1
                yield item
                if self.device is None:
                    self._release(item)
                del item
        finally:
            stop.set()
            self._live.clear()
            while thread.is_alive():
                try:
                    self._release(q.get_nowait())
                except queue.Empty:
                    thread.join(timeout=0.1)
            while not q.empty():
                self._release(q.get_nowait())


class EvalLoader(TrainLoader):
    """Iterate the eval plan's batches: each plan item is ``(indices,
    weights)``, read through ``read_fn`` and decoded, with the weights
    riding the batch as ``_weight``. With a ``batch_cache`` and the
    ``dataset_fingerprint`` its entries are scoped ``eval=1``: they carry
    ``_weight`` and never alias a train entry over the same rows."""

    def __init__(self, read_fn: Callable[[np.ndarray], pa.Table],
                 plan: Sequence, decode_fn: Callable[[pa.Table], dict],
                 device: Optional[torch.device], prefetch: int = 2,
                 producers: int = 1, buffer_pool=None, batch_cache=None,
                 dataset_fingerprint: Optional[str] = None):
        super().__init__(None, plan, decode_fn, device, prefetch,
                         producers=producers, buffer_pool=buffer_pool,
                         batch_cache=batch_cache)
        self.read_fn = read_fn
        self.dataset_fingerprint = dataset_fingerprint

    def _plan_cache(self) -> Optional[PlanCache]:
        if self.batch_cache is None or self.dataset_fingerprint is None:
            return None
        return PlanCache(
            self.batch_cache, self.dataset_fingerprint,
            lambda: plan_fingerprint(
                decode=decode_fingerprint(self.decode_fn), eval=1))

    def _read(self, item):
        return self.read_fn(item[0])

    def _decode(self, item, table) -> dict:
        out = dict(self.decode_fn(table))
        out["_weight"] = item[1]
        return out


def make_eval_pipeline(
    read_fn: Callable[[np.ndarray], pa.Table],
    num_rows: int,
    global_batch: int,
    process_index: int,
    process_count: int,
    decode_fn: Callable,
    device: Optional[torch.device],
    prefetch: int = 2,
    *,
    index_pool: Optional[np.ndarray] = None,
    producers: int = 1,
    buffer_pool=None,
    batch_cache=None,
    dataset_fingerprint: Optional[str] = None,
):
    """Full-coverage eval loader: every row exactly once, one batch shape.

    The tail is padded back to a full global batch by wrap-around rows and
    each batch carries ``_weight`` in {0, 1}^[B] marking the pads, which
    the weighted eval step uses. ``read_fn`` maps an index array to an
    Arrow table (``Dataset.take``, or the folder arm's file read). With
    ``index_pool`` every position of the pool is covered once instead of
    every row, and ``num_rows`` is not read. Batches, order and weights
    are the JAX package's ``make_eval_pipeline``'s; ``device``,
    ``producers``, ``buffer_pool`` and ``batch_cache`` are
    :class:`TrainLoader`'s (the eval takes no worker pool, as in JAX), the
    cache keyed by ``dataset_fingerprint``. A compiled
    :class:`~.graph.LoaderGraph` over an :class:`~.graph.EvalSource`."""
    from .graph import (Buffers, Cache, Decode, DevicePut, EvalSource,
                        InProcess, LoaderGraph, Prefetch)

    graph = LoaderGraph(
        EvalSource(read_fn, num_rows, global_batch, process_index,
                   process_count, index_pool=index_pool),
        Decode(decode_fn),
        Cache(batch_cache, dataset_fingerprint=dataset_fingerprint),
        Buffers(buffer_pool),
        Prefetch(prefetch, producers=producers),
        DevicePut(device),
        InProcess(),
    )
    graph.compile()
    return graph


class EpochLoader(TrainLoader):
    """A loader whose plan is a pure function of its epoch, rebuilt when
    iterated: the cursor carries the epoch, ``load_state_dict`` adopts it
    and ``set_epoch`` starts a new epoch at its step 0, as
    ``DistributedSampler.set_epoch`` reshuffles."""

    def set_epoch(self, epoch: int) -> None:
        if epoch != self.epoch:
            self.epoch = epoch
            # A new epoch's plan starts at its own step 0; a stale cursor
            # must not slice it.
            self._start_step = 0
            self._yielded = 0

    def state_dict(self) -> dict:
        return {"epoch": int(self.epoch), "step": int(self._yielded)}

    def load_state_dict(self, state: dict) -> None:
        if "epoch" in state:
            self.epoch = int(state["epoch"])
        step = int(state.get("step", 0))
        if step < 0:
            raise ValueError(f"negative resume cursor: {step}")
        self._start_step = step
        self._yielded = step


class MapStylePipeline(EpochLoader):
    """Random-access loader: permuted indices → ``take`` → decode → device.

    The JAX package's ``MapStylePipeline``, ``DistributedSampler``
    semantics: each epoch deals a ``seed + epoch`` permutation of the rows
    (``shuffle``), or of ``index_pool``'s positions (a row filter's pool, a
    val split), ``batch_size`` rows a step to each process; ``drop_last``
    drops the ragged tail. ``columns`` is projected before the gather.
    Row reshuffles change the plan items each epoch, so a batch cache hits
    only unshuffled or repeated items (content keys)."""

    def __init__(self, dataset: Dataset, batch_size: int, process_index: int,
                 process_count: int, decode_fn: Callable,
                 device: Optional[torch.device], *, shuffle: bool = True,
                 seed: int = 0, epoch: int = 0, drop_last: bool = True,
                 prefetch: int = 2,
                 columns: Optional[Sequence[str]] = None,
                 index_pool: Optional[np.ndarray] = None,
                 producers: int = 1, buffer_pool=None, workers=None,
                 batch_cache=None, scheduler=None):
        super().__init__(dataset, None, decode_fn, device, prefetch, epoch,
                         producers=producers, buffer_pool=buffer_pool,
                         workers=workers, batch_cache=batch_cache,
                         columns=columns, scheduler=scheduler)
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # Every process derives the same pool, so the equal-step invariant
        # holds unchanged: positions in the pool are dealt, then mapped
        # back to global rows.
        self.index_pool = (np.asarray(index_pool, dtype=np.int64)
                           if index_pool is not None else None)

    def _plan(self) -> list[np.ndarray]:
        pool = self.index_pool
        n = self.dataset.count_rows() if pool is None else len(pool)
        batches = distributed_index_batches(
            n, self.batch_size, self.process_index, self.process_count,
            shuffle=self.shuffle, seed=self.seed, epoch=self.epoch,
            drop_last=self.drop_last)
        if pool is not None:
            batches = [pool[b] for b in batches]
        return batches

    def _read(self, item):
        return self.dataset.take(item, columns=self.columns)


def make_map_style_pipeline(dataset: Dataset, *args, **kwargs):
    """The map-style loader as a compiled :class:`~.graph.LoaderGraph`
    (``MapStyleSource → Decode → … → InProcess``): it takes
    :class:`MapStylePipeline`'s signature and streams bit-identically to a
    direct construction. The signature's ``scheduler`` rides the Decode
    node."""
    import inspect

    from .graph import (Buffers, Cache, Decode, DevicePut, InProcess,
                        LoaderGraph, MapStyleSource, Pool, Prefetch)

    bound = inspect.signature(MapStylePipeline.__init__).bind(
        None, dataset, *args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    graph = LoaderGraph(
        MapStyleSource(dataset, a["batch_size"], a["process_index"],
                       a["process_count"], shuffle=a["shuffle"],
                       seed=a["seed"], epoch=a["epoch"],
                       drop_last=a["drop_last"],
                       index_pool=a["index_pool"]),
        Decode(a["decode_fn"], columns=a["columns"],
               schedule=a["scheduler"]),
        Cache(a["batch_cache"]),
        Pool(a["workers"]),
        Buffers(a["buffer_pool"]),
        Prefetch(a["prefetch"], producers=a["producers"]),
        DevicePut(a["device"]),
        InProcess(),
    )
    graph.compile()
    return graph


def refuse_empty_plan(loader, dataset: Dataset, batch_size: int,
                      process_count: int) -> None:
    """The port's refusal of an iterable plan without one batch."""
    if len(loader) == 0:
        raise ValueError(
            f"empty plan: {dataset.count_rows()} rows cannot fill one batch "
            f"of {batch_size} on each of {process_count} processes"
        )


def make_train_pipeline(
    dataset: Dataset,
    sampler_type: str,
    batch_size: int,
    process_index: int,
    process_count: int,
    decode_fn: Callable,
    device: Optional[torch.device],
    prefetch: int = 2,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
    producers: int = 1,
    buffer_pool=None,
    workers=None,
    batch_cache=None,
    columns: Optional[Sequence[str]] = None,
    schedule=None,
):
    """Iterable-style loader over this process's plan, as a compiled
    :class:`~.graph.LoaderGraph` over a :class:`~.graph.LanceSource`.
    ``batch_size`` is the per-process batch. Every process's plan is
    checked for equal step and row counts before the first batch (unequal
    counts hang a collective). ``device=None`` yields host batches;
    ``columns`` projects the reads (pass the worker pool's); ``schedule``
    attaches the straggler scheduler to the pool's dispatch. Compiled here,
    so the refusals (a full scan across processes, an empty plan) surface
    at construction."""
    from .graph import (Buffers, Cache, Decode, DevicePut, InProcess,
                        LanceSource, LoaderGraph, Pool, Prefetch)

    graph = LoaderGraph(
        LanceSource(dataset, sampler_type, batch_size, process_index,
                    process_count, shuffle=shuffle, seed=seed, epoch=epoch),
        Decode(decode_fn, columns=columns, schedule=schedule),
        Cache(batch_cache),
        Pool(workers),
        Buffers(buffer_pool),
        Prefetch(prefetch, producers=producers),
        DevicePut(device),
        InProcess(),
    )
    graph.compile()
    refuse_empty_plan(graph, dataset, batch_size, process_count)
    return graph
