"""Placement plane: host batches → device tensors, H2D off the step.

Counterpart of ``lance_distributed_training_tpu/data/placement.py``. Without
it the consumer thread copies each host batch into pinned memory and queues
its H2D on the compute stream (:func:`~..parallel.mesh.make_global_batch`,
the ``--no_global_batch`` arm): every copy waits behind the previous step's
kernels, the next step's kernels wait behind it, and the host copy delays
the next step's dispatch. Here:

* :class:`PlacementPlane` places each batch on a dedicated **placement
  thread** (``ldt-placement``, daemon) with ``non_blocking`` copies on the
  plane's own **side stream**, and keeps a bounded ring of ``depth``
  (default 2) device-resident batches ahead of the consumer, so that
  ``next(loader)`` returns a batch already on the card and the copies of
  batches n+1 and n+2 overlap step n's kernels. Leaves that are page-locked
  pool pages are copied straight from their pages; every other leaf (labels,
  weights, all leaves under ``--no_buffer_pool``) goes through a pinned
  staging slot filled by ``Tensor.copy_``. ``_host_*`` keys stay numpy and
  ragged pages move whole.
* :class:`PlacedLoader` wraps every loader the trainer builds (iterable,
  map-style, folder, eval): they yield host batches and the plane places
  them. Its resume cursor counts the batches the consumer took, not those
  placed: the ring runs ``depth`` batches ahead.

Stream and lifetime contract (CUDA): the placement thread sets its device
(the current device is per thread), records an event after a batch's
copies on the side stream and waits for it before the batch enters the
ring, so a batch in the ring is resident; the pool pages it read go back
with that event (:class:`~.buffers.BufferPool` recycles a page only once
the event has completed). The consumer's stream ``wait_event``\\ s the event
and every device tensor is ``record_stream``\\ ed on it before K1, K2 or the
model reads it: the caching allocator then cannot hand batch n's blocks to
the copy of batch n + 2 while step n still reads them. Each process places
its own share; there is no global array.

The plane never falls back to the synchronous arm: an error of the
placement thread, or of the loader behind it, is raised on the consumer.
Teardown is drain-then-join, and the inner iterator is closed from the
placement thread, so that no ``ldt-placement`` or ``ldt-producer-*``
thread outlives the iteration.

Telemetry: a ``placement_*`` :class:`~..utils.metrics.ServiceCounters`
(``placement_h2d_s``, ``placement_batches_placed``, the
``placement_buffer_depth`` gauge, mirrored into the process registry),
which ``StepTimer.attach_counters`` merges into the progress lines
(``h2d_pct``); :attr:`PlacementPlane.h2d_ms`, each batch's time on the
placement thread from its host batch to its copies' completion, also
observed into the registry's ``trainer_h2d_ms`` histogram and recorded as
a ``placement.h2d`` span. The ring is an
:class:`~..tune.tunable.AdjustableQueue`: ``ring_depth`` is an autotuner
knob (``tunables()``), moved live without dropping or reordering a batch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

import torch

from ..obs.registry import MetricsRegistry, default_registry
from ..obs.spans import span
from ..parallel.mesh import PinnedStager, indexed_device, make_global_batch
from ..tune.tunable import AdjustableQueue, Tunable, _LiveQueues
from ..utils import compiletrack
from ..utils.metrics import ServiceCounters

__all__ = ["PlacementPlane", "PlacedLoader"]

_SENTINEL = object()


class PlacementPlane:
    """Batch placement on a side stream with a ring of ``depth`` placed
    batches.

    Parameters
    ----------
    device: where the batches go (this process's card, or the CPU, where a
        batch is copied into fresh tensors).
    depth: ring size — placed batches kept ahead of the consumer. 2 double
        buffers (one being consumed, one transferred).
    buffer_pool: the :class:`~.buffers.BufferPool` the decoders leased
        their pages from; the pages go back once their copies are done.
    """

    def __init__(self, device: torch.device, *, depth: int = 2,
                 buffer_pool=None,
                 registry: Optional[MetricsRegistry] = None):
        self.device = indexed_device(device)
        self.depth = max(1, int(depth))
        self.buffer_pool = buffer_pool
        self.registry = registry if registry is not None else default_registry()
        self.counters = ServiceCounters(prefix="placement",
                                        registry=self.registry)
        self._h2d_hist = self.registry.histogram("trainer_h2d_ms")
        self.h2d_ms: list[float] = []
        self._cuda = self.device.type == "cuda"
        self._stager = PinnedStager(self.device) if self._cuda else None
        self._stream: Optional[torch.cuda.Stream] = None
        # The live ring of the current iteration, for set_ring_depth.
        self._live = _LiveQueues()

    def set_ring_depth(self, depth: int) -> int:
        """Move the ring's bound, live: growing wakes the placement
        thread, shrinking lets the ring drain through the consumer (placed
        batches are never dropped)."""
        depth = max(1, int(depth))
        self.depth = depth
        self._live.resize_total(depth)
        return depth

    def tunables(self):
        """The autotuner's knob: the ring depth."""
        return [Tunable(
            "ring_depth", lambda: self.depth, self.set_ring_depth,
            lo=1, hi=8,
            doc="device-resident global batches kept ahead of the step",
        )]

    # -- single-batch placement --------------------------------------------

    def _place(self, host_batch: dict):
        """``(placed, event)``: the batch's copies queued on the side
        stream and completed (``event`` is ``None`` on the CPU)."""
        if not self._cuda:
            return make_global_batch(host_batch, self.device,
                                     buffer_pool=self.buffer_pool), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._stream):
            placed = make_global_batch(host_batch, self.device,
                                       stager=self._stager,
                                       buffer_pool=self.buffer_pool)
        event = self._stager.last_event
        event.synchronize()
        if compiletrack.enabled():
            compiletrack.track_transfer("h2d", sum(
                v.numel() * v.element_size() for v in placed.values()
                if isinstance(v, torch.Tensor) and v.is_cuda))
        return placed, event

    def _adopt(self, placed: dict, event) -> dict:
        """On the consumer's thread: its current stream waits for the
        copies, and owns the batch's blocks until its work on them ends."""
        if event is None:
            return placed
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for value in placed.values():
            if isinstance(value, torch.Tensor) and value.is_cuda:
                value.record_stream(stream)
        return placed

    def place_batch(self, host_batch: dict) -> dict:
        """One host batch (a dict of numpy arrays) → this process's tensors
        on the device, placed on the side stream and handed to the
        caller's stream. Bit-identical to
        :func:`~..parallel.mesh.make_global_batch`; ``_host_*`` keys stay
        numpy."""
        return self._adopt(*self._place(host_batch))

    # -- the ring ----------------------------------------------------------

    def iter_placed(self, inner) -> Iterator[dict]:
        """Iterate ``inner``'s host batches as placed batches: the
        placement thread pulls from ``inner``, places each batch and fills
        the ring; the consumer pops placed batches. Teardown is
        drain-then-join, and ``inner``'s iterator is closed from the
        placement thread, so its producer threads observe their stop
        flags."""
        q: queue.Queue = AdjustableQueue(self.depth)
        self._live.install([q])
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                if self._cuda:
                    torch.cuda.set_device(self.device)
                it = iter(inner)
                try:
                    for seq, host in enumerate(it):
                        if stop.is_set():
                            if self.buffer_pool is not None:
                                self.buffer_pool.release_batch(host)
                            return
                        t0 = time.perf_counter()
                        with span("placement.h2d", batch_seq=seq):
                            placed = self._place(host)
                        seconds = time.perf_counter() - t0
                        del host
                        self.h2d_ms.append(seconds * 1e3)
                        self._h2d_hist.observe(seconds * 1e3)
                        self.counters.add("h2d_s", seconds)
                        self.counters.add("batches_placed")
                        if not put(placed):
                            return
                        self._set_depth(q.qsize())
                    put(_SENTINEL)
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
            except BaseException as exc:  # raised on the consumer
                put(exc)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="ldt-placement")
        thread.start()
        try:
            while True:
                item = q.get()
                self._set_depth(q.qsize())
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield self._adopt(*item)
        finally:
            stop.set()
            # Drain so that a blocked put observes the stop flag; drained
            # items are placed batches whose pages went back already.
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
            self._live.clear()
            self._set_depth(0)

    def _set_depth(self, n: int) -> None:
        self.counters.gauge("buffer_depth", n)

    def wrap(self, inner) -> "PlacedLoader":
        return PlacedLoader(self, inner)


class PlacedLoader:
    """A loader that yields host batches, placed through a
    :class:`PlacementPlane`. Delegates ``len`` and ``set_epoch``; exposes
    the inner loader's ``counters`` and the plane's
    ``placement_counters`` for ``StepTimer.attach_counters``."""

    def __init__(self, plane: PlacementPlane, inner):
        self.plane = plane
        self.inner = inner
        self._start = 0
        self._yielded = 0

    def __len__(self) -> int:
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        set_epoch = getattr(self.inner, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        self._start = 0
        self._yielded = 0

    # The count lives here, not on the inner loader: the placement thread
    # runs the inner iterator up to `depth` batches ahead of the consumer,
    # so the inner cursor counts placed batches while a checkpoint needs
    # the batches the consumer took. On a restore the ring's batches are
    # decoded again; device state is never part of the cursor.

    def state_dict(self) -> dict:
        state = {}
        inner_state = getattr(self.inner, "state_dict", None)
        if inner_state is not None:
            state.update(inner_state())
        state["step"] = int(self._yielded)
        return state

    def load_state_dict(self, state: dict) -> None:
        inner_load = getattr(self.inner, "load_state_dict", None)
        if inner_load is not None:
            inner_load(state)
        self._start = int(state.get("step", 0))
        self._yielded = self._start

    def tunables(self):
        """The plane's ring depth, then the wrapped loader's knobs."""
        out = list(self.plane.tunables())
        inner = getattr(self.inner, "tunables", None)
        if inner is not None:
            out.extend(inner())
        return out

    @property
    def counters(self):
        return getattr(self.inner, "counters", None)

    @property
    def placement_counters(self) -> ServiceCounters:
        return self.plane.counters

    def __iter__(self) -> Iterator[dict]:
        self._yielded = self._start
        for batch in self.plane.iter_placed(self.inner):
            self._yielded += 1
            yield batch
