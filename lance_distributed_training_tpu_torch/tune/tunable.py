"""``Tunable`` — the registration surface between pipeline knobs and the

A copy of ``lance_distributed_training_tpu/tune/tunable.py`` for the port.
The owners of knobs in the port: ``WorkerPool`` (``workers``), the loaders
(``prefetch``, and their decoders' ``coeff_chunk``, ``pack_len`` and
``pack_rows_quantum``), ``BufferPool`` (``bufpool_pages``),
``PlacementPlane``/``PlacedLoader`` (``ring_depth``) and ``BatchCache``
(``cache_ram_budget_mb``, ``cache_disk_budget_mb``).

autotuner.

Every live knob the controller may actuate (decode worker count, prefetch
depth, buffer-pool page budget, placement ring depth, fleet stripe width) is
exposed by its owning component as a :class:`Tunable`: a name, a getter, a
setter, and **mandatory** ``lo``/``hi`` bounds. Bounds are not optional by
design — an autotuner with an unbounded actuator is how a controller melts
a host (grow-on-stall against a saturated disk grows forever) — and the
LDT1101 lint enforces that every ``Tunable(...)`` construction site in the
package declares both.

Components expose their knobs via a ``tunables() -> list[Tunable]`` method
(``WorkerPool``, ``DataPipeline``, ``MapStylePipeline``, ``RemoteLoader``,
``FleetLoader``, ``BufferPool``, ``PlacementPlane``, ``PlacedLoader`` — and
the JAX package's ``LoaderGraph``, the graph root whose single ``tunables()``
aggregation is what the trainer registers); the trainer gathers them with
:func:`collect_tunables` and hands the set to the
:class:`~.controller.AutoTuner`. Nothing registers globally: with
``--no_autotune`` no Tunable is ever constructed and the pipeline runs the
exact fixed-knob configuration it always did.

:class:`AdjustableQueue` is the mechanism behind the prefetch/ring-depth
actuators: a bounded ``queue.Queue`` whose ``maxsize`` can be changed while
producers and consumers are live. Growing notifies blocked producers;
shrinking just lets the excess drain (puts block until the backlog is below
the new bound) — items are never dropped, so actuation can never reorder or
lose a batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List

__all__ = ["Tunable", "AdjustableQueue", "collect_tunables"]

class Tunable:
    """One live integer knob with hard actuation bounds.

    ``getter()`` returns the current value; ``setter(v)`` applies a new one
    and may return the value actually applied (clamping happens here anyway,
    so setters can be plain attribute writes). ``set`` is what the
    controller calls; it clamps to ``[lo, hi]`` and returns the applied
    value, so a policy can observe that its request hit a bound.
    """

    def __init__(
        self,
        name: str,
        getter: Callable[[], int],
        setter: Callable[[int], object],
        *,
        lo: int,
        hi: int,
        doc: str = "",
    ):
        lo, hi = int(lo), int(hi)
        if lo >= hi:
            raise ValueError(
                f"tunable {name!r} needs lo < hi, got [{lo}, {hi}] — a "
                "degenerate range means the knob is not tunable; don't "
                "register it"
            )
        self.name = str(name)
        self.lo = lo
        self.hi = hi
        self.doc = doc
        self._getter = getter
        self._setter = setter

    def get(self) -> int:
        return int(self._getter())

    def set(self, value: int) -> int:
        """Clamp to ``[lo, hi]``, actuate, return the applied value."""
        value = min(self.hi, max(self.lo, int(value)))
        applied = self._setter(value)
        return int(applied) if applied is not None else value

    def __repr__(self) -> str:  # debugging/`ldt fleet`-style dumps
        return (
            f"Tunable({self.name!r}, value={self.get()}, "
            f"lo={self.lo}, hi={self.hi})"
        )


def collect_tunables(*components) -> List[Tunable]:
    """Gather every component's ``tunables()`` into one list, first
    registration of a name wins (a ``PlacedLoader`` wrapping a
    ``FleetLoader`` yields the plane's knobs before the inner loader's, and
    an eval loader built later must not steal the train loader's names).
    ``None`` components and components without a ``tunables`` method are
    skipped, so callers can pass whatever the config happened to build."""
    out: List[Tunable] = []
    seen: set = set()
    for c in components:
        if c is None:
            continue
        fn = getattr(c, "tunables", None)
        if fn is None:
            continue
        for t in fn():
            if t.name not in seen:
                seen.add(t.name)
                out.append(t)
    return out


class AdjustableQueue(queue.Queue):
    """Bounded queue whose bound can move while threads are blocked on it.

    The live half of the prefetch/ring-depth actuators: ``set_maxsize``
    takes the queue's own mutex, so it serializes correctly against
    concurrent ``put``/``get``, and notifies ``not_full`` so producers
    blocked against the OLD bound wake up immediately when the bound grows.
    Shrinking never drops items: the backlog above the new bound drains
    through the consumer while further puts block — the stream stays intact
    and ordered through any actuation.

    Always bounded: the constructor and ``set_maxsize`` clamp to >= 1
    (``maxsize=0`` is stdlib for *infinite*, which would void the
    backpressure contract LDT202 exists to protect).
    """

    def __init__(self, maxsize: int):
        super().__init__(maxsize=max(1, int(maxsize)))

    def set_maxsize(self, maxsize: int) -> int:
        with self.mutex:
            self.maxsize = max(1, int(maxsize))
            # Wake every blocked producer: with a grown bound several puts
            # may now proceed, and a notify_all costs nothing here (resize
            # is a control-plane event, not a hot-path one).
            self.not_full.notify_all()
            return self.maxsize


class _LiveQueues:
    """Tiny holder a pipeline shares between its iterating thread (which
    installs the epoch's live queues) and a controller thread calling
    ``set_prefetch`` — one lock so install/adjust/clear never interleave."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: List[AdjustableQueue] = []

    def install(self, queues: Iterable[AdjustableQueue]) -> None:
        with self._lock:
            self._queues = list(queues)

    def clear(self) -> None:
        with self._lock:
            self._queues = []

    def resize_total(self, depth: int) -> None:
        """Split ``depth`` across the live queues (ceil-divided, min 1 each
        — the multi-producer pipeline's total-buffered-depth convention)."""
        with self._lock:
            qs = list(self._queues)
        if not qs:
            return
        per = max(1, -(-max(1, int(depth)) // len(qs)))
        for q in qs:
            q.set_maxsize(per)
