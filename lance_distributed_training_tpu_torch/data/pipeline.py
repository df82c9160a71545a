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

One daemon thread reads and decodes the plan into a bounded queue; the
consumer copies each batch into pinned staging buffers and on to the device
with ``non_blocking`` copies on the current stream. No worker pool, cache
or autotuner yet.

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
from .token_pack import is_host_meta_key

__all__ = ["EvalLoader", "MapStylePipeline", "PinnedStager", "TrainLoader",
           "make_eval_pipeline", "make_map_style_pipeline",
           "make_train_pipeline"]

_JOIN_TIMEOUT_S = 10.0


def _range_read(dataset: Dataset, ranges: Sequence[ReadRange]) -> pa.Table:
    """Concatenate one step's row ranges."""
    tables = [dataset.read_range(r.fragment, r.start, r.stop) for r in ranges]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class PinnedStager:
    """Host numpy batch → device tensors through a ring of pinned buffers.

    Each slot holds one pinned tensor per key and the CUDA event of the copy
    that last read it; a slot is refilled only after that event completes, so
    a ``non_blocking`` copy never reads a buffer being overwritten. On the
    CPU the batch is copied into fresh tensors. Keys with the host-meta
    prefix (``_host_*``, e.g. the pack plan's header) stay host numpy, so
    the device-side transforms read them without a sync. A batch's shapes
    may change from one batch to the next (the ragged pages and the packed
    plan do): a slot's pinned buffer is replaced when its shape or type
    changes."""

    depth = 2  # one slot being copied from while the next is filled

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._slots: list[dict] = [{} for _ in range(self.depth)]
        self._events: list[Optional[torch.cuda.Event]] = [None] * self.depth
        self._next = 0

    def __call__(self, batch: dict) -> dict:
        if self.device.type != "cuda":
            return {k: np.asarray(v) if is_host_meta_key(k)
                    else torch.from_numpy(np.array(v))
                    for k, v in batch.items()}
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()
        slot = self._slots[i]
        out = {}
        for name, arr in batch.items():
            arr = np.asarray(arr)
            if is_host_meta_key(name):
                out[name] = arr
                continue
            pinned = slot.get(name)
            if pinned is None or tuple(pinned.shape) != arr.shape or (
                pinned.numpy().dtype != arr.dtype
            ):
                pinned = torch.from_numpy(np.empty(arr.shape, arr.dtype))
                pinned = pinned.pin_memory()
                slot[name] = pinned
            pinned.numpy()[...] = arr
            out[name] = pinned.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = event
        return out


class TrainLoader:
    """Iterate device batches for this process's plan, in plan order, from
    the resume cursor on (the module's docstring). A plan item is one
    step's ``ReadRange`` list; subclasses change what a plan item is and
    how it is read (:meth:`_plan`, :meth:`_load`)."""

    def __init__(self, dataset: Dataset, plan: Optional[Sequence],
                 decode_fn: Callable[[pa.Table], dict],
                 device: torch.device, prefetch: int = 2, epoch: int = 0):
        self.dataset = dataset
        self.plan = list(plan) if plan is not None else None
        self.decode_fn = decode_fn
        self.device = torch.device(device)
        self.prefetch = max(1, int(prefetch))
        self.epoch = epoch
        self._start_step = 0  # where the next iteration starts in the plan
        self._yielded = 0  # batches handed out, absolute within the plan

    def _plan(self) -> list:
        return self.plan

    def _load(self, item) -> dict:
        """One plan item, read and decoded into a host numpy batch."""
        return self.decode_fn(_range_read(self.dataset, item))

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

    def _produce(self, batches: Iterator[dict], q: queue.Queue,
                 stop: threading.Event) -> None:
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for batch in batches:
                if not put(batch):
                    return
        except BaseException as exc:  # handed to the consumer, re-raised there
            put(_Failure(exc))
            return
        put(_DONE)

    def __iter__(self) -> Iterator[dict]:
        batches = self.host_batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        producer = threading.Thread(target=self._produce,
                                    args=(batches, q, stop),
                                    name="ldt-torch-prefetch", daemon=True)
        stage = PinnedStager(self.device)
        self._yielded = self._start_step
        producer.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                batch = stage(item)
                # Counted as handed out: between steps the cursor names the
                # next batch.
                self._yielded += 1
                yield batch
        finally:
            stop.set()
            while producer.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
                producer.join(timeout=0.05)
            producer.join(timeout=_JOIN_TIMEOUT_S)


class EvalLoader(TrainLoader):
    """Iterate the eval plan's device batches: each plan item is
    ``(indices, weights)``, read through ``read_fn`` and decoded, with the
    weights riding the batch as ``_weight``."""

    def __init__(self, read_fn: Callable[[np.ndarray], pa.Table],
                 plan: Sequence, decode_fn: Callable[[pa.Table], dict],
                 device: torch.device, prefetch: int = 2):
        super().__init__(None, plan, decode_fn, device, prefetch)
        self.read_fn = read_fn

    def _load(self, item) -> dict:
        idx, weights = item
        out = dict(self.decode_fn(self.read_fn(idx)))
        out["_weight"] = weights
        return out


def make_eval_pipeline(
    read_fn: Callable[[np.ndarray], pa.Table],
    num_rows: int,
    global_batch: int,
    process_index: int,
    process_count: int,
    decode_fn: Callable,
    device: torch.device,
    prefetch: int = 2,
    *,
    index_pool: Optional[np.ndarray] = None,
) -> EvalLoader:
    """Full-coverage eval loader: every row exactly once, one batch shape.

    The tail is padded back to a full global batch by wrap-around rows and
    each batch carries ``_weight`` in {0, 1}^[B] marking the pads, which
    the weighted eval step uses. ``read_fn`` maps an index array to an
    Arrow table (``Dataset.take``, or the folder arm's file read). With
    ``index_pool`` every position of the pool is covered once instead of
    every row, and ``num_rows`` is not read. Batches, order and weights
    are the JAX package's ``make_eval_pipeline``'s."""
    if index_pool is not None:
        num_rows = len(index_pool)
    plan = padded_eval_index_batches(num_rows, global_batch, process_index,
                                     process_count, index_pool=index_pool)
    return EvalLoader(read_fn, plan, decode_fn, device, prefetch=prefetch)


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
                 device: torch.device, *, shuffle: bool = True,
                 seed: int = 0, epoch: int = 0, drop_last: bool = True,
                 prefetch: int = 2,
                 columns: Optional[Sequence[str]] = None,
                 index_pool: Optional[np.ndarray] = None):
        super().__init__(dataset, None, decode_fn, device, prefetch, epoch)
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

    def _load(self, item) -> dict:
        return self.decode_fn(self.dataset.take(item, columns=self.columns))


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
    device: torch.device,
    prefetch: int = 2,
    shuffle: bool = False,
    seed: int = 0,
    epoch: int = 0,
) -> TrainLoader:
    """Iterable-style loader over this process's plan. ``batch_size`` is
    the per-process batch. Every process's plan is checked for equal step
    and row counts before the first batch (unequal counts hang a
    collective)."""
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
                       epoch=epoch)
