"""Input pipeline: read plan → read → decode → prefetch → H2D.

Counterpart of ``make_train_pipeline``, ``make_map_style_pipeline`` and
``make_eval_pipeline`` in ``lance_distributed_training_tpu/data/
pipeline.py``. For the same arguments each yields the JAX loader's batches
in the same order:

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
No worker pool, cache or autotuner yet.

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
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from .format import Dataset
from .samplers import (
    ReadRange,
    assert_equal_step_counts,
    distributed_index_batches,
    make_plan,
    padded_eval_index_batches,
    slice_plan,
)
from ..parallel.mesh import PinnedStager, indexed_device, make_global_batch

__all__ = ["EvalLoader", "MapStylePipeline", "TrainLoader",
           "make_eval_pipeline", "make_map_style_pipeline",
           "make_train_pipeline"]


def _range_read(dataset: Dataset, ranges: Sequence[ReadRange]) -> pa.Table:
    """Concatenate one step's row ranges."""
    tables = [dataset.read_range(r.fragment, r.start, r.stop) for r in ranges]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class TrainLoader:
    """Iterate batches of this process's plan, in plan order, from the
    resume cursor on (the module's docstring): host batches with
    ``device=None``, else tensors on ``device``. A plan item is one step's
    ``ReadRange`` list; subclasses change what a plan item is and how it is
    read and decoded (:meth:`_plan`, :meth:`_read`, :meth:`_decode`)."""

    def __init__(self, dataset: Dataset, plan: Optional[Sequence],
                 decode_fn: Callable[[pa.Table], dict],
                 device: Optional[torch.device], prefetch: int = 2,
                 epoch: int = 0, producers: int = 1, buffer_pool=None):
        self.dataset = dataset
        self.plan = list(plan) if plan is not None else None
        self.decode_fn = decode_fn
        self.device = indexed_device(device) if device is not None else None
        self.prefetch = max(1, int(prefetch))
        self.producers = max(1, int(producers))
        self.buffer_pool = buffer_pool
        self.epoch = epoch
        self._start_step = 0  # where the next iteration starts in the plan
        self._yielded = 0  # batches handed out, absolute within the plan

    def _plan(self) -> list:
        return self.plan

    def _read(self, item):
        """One plan item's rows (an Arrow table)."""
        return _range_read(self.dataset, item)

    def _decode(self, item, table) -> dict:
        """One plan item's rows decoded into a host numpy batch."""
        return self.decode_fn(table)

    def _load(self, item) -> dict:
        return self._decode(item, self._read(item))

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
        n = self.producers
        plan = slice_plan(self._plan(), self._start_step)
        self._yielded = self._start_step
        per = max(1, -(-max(self.prefetch, n) // n))
        # A queue a thread; its free slots are counted by a semaphore that
        # the thread takes before it reads an item and the consumer gives
        # back when it takes one.
        queues = [queue.Queue() for _ in range(n)]
        room = [threading.Semaphore(per) for _ in range(n)]
        stop = threading.Event()
        turn = [0]  # the next plan item whose decode may start
        failed = [len(plan)]  # the first plan item that raised
        turn_cv = threading.Condition()
        # The synchronous arm places on the consumer thread with one
        # producer, in the producers with several (each its own stager).
        place_in_producer = self.device is not None and n > 1

        def wait_room(k: int) -> bool:
            while not stop.is_set():
                if room[k].acquire(timeout=0.1):
                    return True
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
                    table = self._read(plan[j])
                    if not wait_turn(j):
                        return
                    out = self._decode(plan[j], table)
                    del table
                    if place_in_producer:
                        out = self._place(out, stager)
                    queues[k].put(out)
                queues[k].put(_DONE)
            except BaseException as exc:  # handed to the consumer, re-raised
                queues[k].put(_Failure(exc))
                with turn_cv:
                    failed[0] = min(failed[0], j)
                    turn_cv.notify_all()

        threads = [
            threading.Thread(
                target=produce, args=(k,), daemon=True,
                name="ldt-producer" if n == 1 else f"ldt-producer-{k}")
            for k in range(n)
        ]
        stager = None if place_in_producer else self._stager()
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
                room[k].release()
                if item is _DONE:
                    active[k] = False
                    done += 1
                    continue
                if isinstance(item, _Failure):
                    raise item.exc
                if self.device is not None and not place_in_producer:
                    item = self._place(item, stager)
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
            # The threads observe the stop flag within a read or a decode;
            # the batches they left go back to the pool.
            for t in threads:
                t.join()
            for q in queues:
                while not q.empty():
                    self._release(q.get_nowait())


class EvalLoader(TrainLoader):
    """Iterate the eval plan's batches: each plan item is ``(indices,
    weights)``, read through ``read_fn`` and decoded, with the weights
    riding the batch as ``_weight``."""

    def __init__(self, read_fn: Callable[[np.ndarray], pa.Table],
                 plan: Sequence, decode_fn: Callable[[pa.Table], dict],
                 device: Optional[torch.device], prefetch: int = 2,
                 producers: int = 1, buffer_pool=None):
        super().__init__(None, plan, decode_fn, device, prefetch,
                         producers=producers, buffer_pool=buffer_pool)
        self.read_fn = read_fn

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
) -> EvalLoader:
    """Full-coverage eval loader: every row exactly once, one batch shape.

    The tail is padded back to a full global batch by wrap-around rows and
    each batch carries ``_weight`` in {0, 1}^[B] marking the pads, which
    the weighted eval step uses. ``read_fn`` maps an index array to an
    Arrow table (``Dataset.take``, or the folder arm's file read). With
    ``index_pool`` every position of the pool is covered once instead of
    every row, and ``num_rows`` is not read. Batches, order and weights
    are the JAX package's ``make_eval_pipeline``'s; ``device``,
    ``producers`` and ``buffer_pool`` are :class:`TrainLoader`'s."""
    if index_pool is not None:
        num_rows = len(index_pool)
    plan = padded_eval_index_batches(num_rows, global_batch, process_index,
                                     process_count, index_pool=index_pool)
    return EvalLoader(read_fn, plan, decode_fn, device, prefetch=prefetch,
                      producers=producers, buffer_pool=buffer_pool)


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
    drops the ragged tail. ``columns`` is projected before the gather."""

    def __init__(self, dataset: Dataset, batch_size: int, process_index: int,
                 process_count: int, decode_fn: Callable,
                 device: Optional[torch.device], *, shuffle: bool = True,
                 seed: int = 0, epoch: int = 0, drop_last: bool = True,
                 prefetch: int = 2,
                 columns: Optional[Sequence[str]] = None,
                 index_pool: Optional[np.ndarray] = None,
                 producers: int = 1, buffer_pool=None):
        super().__init__(dataset, None, decode_fn, device, prefetch, epoch,
                         producers=producers, buffer_pool=buffer_pool)
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.columns = list(columns) if columns is not None else None
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


def make_map_style_pipeline(dataset: Dataset, *args,
                            **kwargs) -> MapStylePipeline:
    """The map-style loader: :class:`MapStylePipeline`'s signature. The
    JAX package assembles a ``LoaderGraph`` here, which the port does not
    have yet; its batches are this loader's."""
    return MapStylePipeline(dataset, *args, **kwargs)


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
) -> TrainLoader:
    """Iterable-style loader over this process's plan. ``batch_size`` is
    the per-process batch. Every process's plan is checked for equal step
    and row counts before the first batch (unequal counts hang a
    collective). ``device=None`` yields host batches."""
    if sampler_type in ("full", "full_scan") and process_count > 1:
        raise ValueError(
            "sampler_type='full' is not DP-aware (every process scans the "
            f"whole dataset) and cannot run across {process_count} processes"
        )
    rows = dataset.fragment_rows()
    plans = [
        make_plan(sampler_type, rows, batch_size, p, process_count,
                  shuffle=shuffle, seed=seed, epoch=epoch)
        for p in range(process_count)
    ]
    if sampler_type not in ("full", "full_scan"):
        assert_equal_step_counts(plans, batch_size)
    plan = plans[process_index]
    if not plan:
        raise ValueError(
            f"empty plan: {dataset.count_rows()} rows cannot fill one batch "
            f"of {batch_size} on each of {process_count} processes"
        )
    return TrainLoader(dataset, plan, decode_fn, device, prefetch=prefetch,
                       epoch=epoch, producers=producers,
                       buffer_pool=buffer_pool)
