"""Straggler-aware decode scheduling: cost-model-driven dispatch order.

A copy of ``lance_distributed_training_tpu/data/schedule.py``. Batch
assembly stalls at the slowest plan item: the miss list is dispatched in
plan order, so one oversized JPEG or long token tail pins the whole window
while cheap rows sit decoded (the MinatoLoader problem, PAPERS.md
2509.10712). The fix is pure capacity: dispatch the predicted-heaviest
first inside a bounded lookahead window so that stragglers get a head
start, then let assembly restore plan order. The yielded stream is
bit-identical to the unscheduled one: nothing here feeds plan, batch or
cursor bytes; only the dispatch ORDER moves.

Two pieces:

* :class:`CostModel`: per-item decode-cost predictions keyed by the same
  ``item_fingerprint`` content hash that :class:`~.cache.BatchCache` and
  the cost ledger (``obs/costs.py``) use, so a prediction, a ledger row
  and a cache entry all name the same work. Warm priors load from the
  ``LDT_COST_PATH`` JSONL (:meth:`CostModel.from_env`); unseen items get
  deterministic cold-start estimates from what is known (the plan item's
  row count, the ledger's byte size, token length or re-encode flag);
  observations fold in as exponentially-decayed online updates.
* :class:`DecodeScheduler`: an ordered streaming map with the contract of
  :meth:`~.workers.WorkerPool.imap` (results in plan order, a bounded
  in-flight window) but dispatch reordered heaviest-first within
  ``lookahead`` buffered candidates. Items predicted far above the
  running mean can route to a dedicated *heavy lane* of the pool
  (:meth:`~.workers.WorkerPool.ensure_lane`), so that one straggler never
  queues behind another. The yield head is force-submitted if it is still
  buffered when assembly needs it: the starvation guard that bounds how
  long a cheap item can be deferred.

Telemetry: ``sched_dispatch_reorders_total`` (an out-of-plan-order
dispatch happened), ``sched_heavy_lane_batches_total`` (heavy-lane
routes), ``sched_predicted_error_ms`` (|predicted - actual| an item, the
misprediction signal). The autotuner's straggler rung
(``tune/policy.py``) reads the first.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from ..obs.costs import note_cost
from ..obs.registry import default_registry
from .cache import item_fingerprint

__all__ = ["CostModel", "DecodeScheduler", "plan_item_hints"]

# Cold-start rate constants (ms). Fixed, not learned: they only need to
# RANK unseen items sensibly, and determinism matters more than accuracy
# (the same corpus must schedule the same way run over run).
_BYTES_MS = 1.0 / 100_000.0  # ~10 ms per decoded MB of source bytes
_TOKEN_MS = 0.01             # per token of recorded token_len
_REENCODE_FACTOR = 2.0       # re-encode path roughly doubles decode
_DEFAULT_ROW_MS = 0.05       # per plan row before any observation


def plan_item_hints(item) -> Dict[str, float]:
    """Deterministic cold-start hints derivable from a plan item alone
    (before any decode ran): just the row count, in every plan shape the
    engine dispatches — ReadRange lists (iterable-style), index arrays
    (map-style/folder), and eval ``(inputs, labels)`` index pairs."""
    if isinstance(item, np.ndarray):
        return {"rows": float(len(item))}
    if isinstance(item, (list, tuple)):
        if (len(item) == 2 and isinstance(item[0], np.ndarray)
                and isinstance(item[1], np.ndarray)):
            return {"rows": float(len(item[0]))}
        stops = [getattr(r, "stop", None) for r in item]
        starts = [getattr(r, "start", None) for r in item]
        if stops and all(s is not None for s in stops + starts):
            return {"rows": float(sum(t - s for s, t in zip(starts, stops)))}
    return {}


class CostModel:
    """Per-item decode-cost predictor keyed by content hash.

    No locks: one produce loop owns the model; concurrent ``observe``
    calls would race benignly (dict and float updates are GIL-atomic,
    and predictions are capacity-only advice: yield order never depends
    on them). Priors and online
    updates use the same exponentially-decayed merge, so a restarted job
    warm-started from ``LDT_COST_PATH`` ranks items exactly as the job
    that wrote the ledger would have.
    """

    def __init__(self, decay: float = 0.25, base_ms: float = 1.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self._decay = decay
        self._base_ms = base_ms
        self._ema: Dict[str, float] = {}      # key -> decayed decode_ms
        self._hints: Dict[str, dict] = {}     # key -> ledger-known fields
        self._row_ms = _DEFAULT_ROW_MS        # learned global per-row rate

    # -- priors -------------------------------------------------------------

    def load_priors(self, path: str) -> int:
        """Fold a cost-ledger JSONL (the ``LDT_COST_PATH`` file) into the
        model: ``decode_ms`` lines seed the per-key EMA in file order;
        ``bytes``/``token_len``/``reencode`` fields are kept as cold-start
        hints for keys the ledger saw but never timed. Undecodable lines
        are skipped. Returns the number of lines consumed."""
        lines = 0
        try:
            f = open(path, encoding="utf-8")
        except OSError:
            return 0
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not (isinstance(rec, dict)
                        and isinstance(rec.get("key"), str)):
                    continue
                key = rec["key"]
                hints = {
                    k: rec[k] for k in ("bytes", "token_len", "reencode")
                    if isinstance(rec.get(k), (int, float))
                }
                if hints:
                    self._hints[key] = {**self._hints.get(key, {}), **hints}
                ms = rec.get("decode_ms")
                if isinstance(ms, (int, float)):
                    self._fold(key, float(ms))
                lines += 1
        return lines

    @classmethod
    def from_env(cls, **kwargs) -> "CostModel":
        """Model warm-started from ``$LDT_COST_PATH`` when that file
        exists — epoch 1 of a restarted job schedules from history."""
        model = cls(**kwargs)
        path = os.environ.get("LDT_COST_PATH")
        if path and os.path.exists(path):
            model.load_priors(path)
        return model

    # -- updates ------------------------------------------------------------

    def _fold(self, key: str, ms: float) -> None:
        prev = self._ema.get(key)
        self._ema[key] = ms if prev is None else (
            prev + self._decay * (ms - prev)
        )

    def observe(self, key: Optional[str], ms: float,
                hints: Optional[dict] = None) -> None:
        """Online update after an item's decode completed: decay the
        per-key EMA toward ``ms`` and refresh the learned per-row rate
        the cold-start estimator uses for unseen items."""
        if key is None or ms < 0.0:
            return
        self._fold(key, ms)
        rows = float((hints or {}).get("rows") or 0.0)
        if rows > 0.0:
            self._row_ms += self._decay * (ms / rows - self._row_ms)

    # -- prediction ---------------------------------------------------------

    def rate_snapshot(self) -> float:
        """The current learned per-row rate. The scheduler freezes this
        per dispatch loop (one ``imap`` call): otherwise two items with
        IDENTICAL hints pulled at different times would get different
        cold-start estimates as the rate drifts — spurious reorders that
        move nothing and cost determinism."""
        return self._row_ms

    def predict(self, key: Optional[str], hints: Optional[dict] = None,
                row_ms: Optional[float] = None) -> float:
        """Predicted decode cost in ms. Known key → its EMA; key the
        ledger described but never timed → estimate from its recorded
        bytes / token_len / reencode flag; otherwise the deterministic
        row-count estimate (``row_ms`` overrides the live learned rate —
        see :meth:`rate_snapshot`). Pure function of model state +
        arguments."""
        if key is not None:
            ema = self._ema.get(key)
            if ema is not None:
                return ema
        merged = dict(self._hints.get(key, ())) if key is not None else {}
        if hints:
            merged.update(hints)
        est = self._base_ms
        rate = self._row_ms if row_ms is None else row_ms
        est += rate * float(merged.get("rows") or 0.0)
        est += _BYTES_MS * float(merged.get("bytes") or 0.0)
        est += _TOKEN_MS * float(merged.get("token_len") or 0.0)
        if merged.get("reencode"):
            est *= _REENCODE_FACTOR
        return est

    def __len__(self) -> int:
        return len(self._ema)


class DecodeScheduler:
    """Dispatch reorderer over a :class:`~.workers.WorkerPool`.

    :meth:`imap` keeps the pool's ordered-streaming contract — results
    yield strictly in plan order, at most ``window`` items in flight —
    but chooses WHICH buffered item to dispatch next by predicted cost,
    heaviest first (ties break on plan position, so a cold model with
    uniform predictions dispatches in plan order and the reorder counter
    honestly reads zero). ``heavy_share`` > 0 routes items predicted
    well above the running mean to a dedicated pool lane sized at that
    percentage of the worker count.

    The scheduler carries no cursor state: resume is entirely the plan
    slice the pipeline feeds it, so ``state_dict`` round-trips are
    untouched by reordered dispatch.
    """

    # Route to the heavy lane only when predicted cost clears this
    # multiple of the running mean prediction (after a short warmup so
    # the first few items cannot monopolise the lane).
    _HEAVY_RATIO = 2.0
    _HEAVY_WARMUP = 4

    def __init__(self, model: Optional[CostModel] = None, *,
                 lookahead: int = 8, heavy_share: int = 0,
                 registry=None):
        if lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {lookahead}")
        if not 0 <= heavy_share <= 100:
            raise ValueError(
                f"heavy_share must be a percentage in [0, 100], "
                f"got {heavy_share}"
            )
        self.model = model if model is not None else CostModel()
        self.lookahead = int(lookahead)
        self.heavy_share = int(heavy_share)
        self._registry = registry
        # Running mean of submitted predictions — the heavy-lane routing
        # baseline. Scheduler-lifetime (like the model), NOT per imap
        # loop: epochs dispatch heaviest-first, so a per-epoch mean
        # would hold every epoch's heaviest items out of the lane while
        # the warmup count rebuilds.
        self._pred_sum = 0.0
        self._pred_n = 0

    # -- knobs --------------------------------------------------------------

    def set_lookahead(self, n: int) -> int:
        self.lookahead = max(1, int(n))
        return self.lookahead

    def set_heavy_share(self, pct: int) -> int:
        self.heavy_share = min(100, max(0, int(pct)))
        return self.heavy_share

    def tunables(self):
        from ..tune.tunable import Tunable

        return [
            Tunable(
                "sched_lookahead",
                lambda: self.lookahead,
                self.set_lookahead,
                lo=1,
                hi=64,
                doc="straggler scheduler dispatch-reorder window (plan "
                    "items buffered as dispatch candidates)",
            ),
            Tunable(
                "sched_heavy_share",
                lambda: self.heavy_share,
                self.set_heavy_share,
                lo=0,
                hi=50,
                doc="percent of decode workers reserved as the heavy "
                    "lane (0 = single lane)",
            ),
        ]

    # -- the dispatch loop --------------------------------------------------

    def imap(self, pool, items: Iterable, window: int = 0) -> Iterator[dict]:
        """Ordered streaming map through ``pool`` with reordered
        dispatch. Same contract as ``pool.imap(items, window)``: yields
        in plan order, bounded in-flight window, abandoned in-flight
        futures handed back to the pool's reclaim discipline on
        generator close or error."""
        window = window or 2 * pool.num_workers
        # Out-of-order completion pins one shm slot per undelivered
        # result, and the starvation guard may briefly hold window + 1
        # in flight — cap at capacity - 1 so the forced head always
        # finds a free slot (exceeding it wedges workers on slot
        # acquire until the ring's timeout drops them to pickle).
        capacity = getattr(pool, "dispatch_capacity", None)
        if capacity is not None:
            window = min(window, capacity - 1)
        window = max(1, window)
        reg = self._registry if self._registry is not None else (
            default_registry()
        )
        reorders = reg.counter("sched_dispatch_reorders_total")
        heavy_ctr = reg.counter("sched_heavy_lane_batches_total")
        err_hist = reg.histogram("sched_predicted_error_ms")
        wait_hist = reg.histogram("workers_result_wait_ms")

        heavy_workers = 0
        if self.heavy_share > 0:
            heavy_workers = max(1, pool.num_workers * self.heavy_share // 100)

        it = iter(items)
        buffered: list = []   # [idx, item, key, pred, hints] — unsubmitted
        inflight: dict = {}   # idx -> (fut, key, pred, hints, t0_ns, done)
        state = {"pulled": 0, "exhausted": False}
        # Frozen per loop: cold-start estimates stay a pure function of
        # the item, so identical items always tie (→ plan order) even
        # while this loop's own observations drift the learned rate.
        rate = self.model.rate_snapshot()

        def _refill() -> None:
            while not state["exhausted"] and len(buffered) < self.lookahead:
                try:
                    item = next(it)
                except StopIteration:
                    state["exhausted"] = True
                    return
                key = item_fingerprint(item)
                hints = plan_item_hints(item)
                pred = self.model.predict(key, hints, row_ms=rate)
                buffered.append([state["pulled"], item, key, pred, hints])
                state["pulled"] += 1

        def _submit(entry, *, forced: bool) -> None:
            idx, item, key, pred, hints = entry
            if not forced and buffered and idx != min(
                    e[0] for e in buffered + [entry]):
                reorders.inc()
            lane = "default"
            if heavy_workers and self._pred_n >= self._HEAVY_WARMUP:
                mean = self._pred_sum / self._pred_n
                if pred > self._HEAVY_RATIO * mean:
                    pool.ensure_lane("heavy", heavy_workers)
                    lane = "heavy"
                    heavy_ctr.inc()
            self._pred_sum += pred
            self._pred_n += 1
            t0 = time.monotonic_ns()
            fut = pool.submit_lane(item, lane)
            done = [0]
            fut.add_done_callback(
                lambda _f, _d=done: _d.__setitem__(0, time.monotonic_ns())
            )
            inflight[idx] = (fut, key, pred, hints, t0, done)

        def _submit_best() -> None:
            # Heaviest predicted first; ties break on plan position so a
            # uniform (cold) model degenerates to plan order.
            best = max(buffered, key=lambda e: (e[3], -e[0]))
            buffered.remove(best)
            _submit(best, forced=False)

        next_yield = 0
        try:
            _refill()
            while buffered or inflight:
                while buffered and len(inflight) < window:
                    _submit_best()
                    _refill()
                if next_yield not in inflight:
                    # Starvation guard: assembly needs the plan head NOW
                    # — submit it even if heavier candidates deferred it
                    # (briefly exceeding the window by one is the bounded
                    # price of never deferring the head indefinitely).
                    head = next(e for e in buffered if e[0] == next_yield)
                    buffered.remove(head)
                    _submit(head, forced=True)
                fut, key, pred, hints, t0, done = inflight.pop(next_yield)
                w0 = time.monotonic_ns()
                out = fut.result()
                wait_hist.observe((time.monotonic_ns() - w0) / 1e6)
                actual_ms = ((done[0] or time.monotonic_ns()) - t0) / 1e6
                self.model.observe(key, actual_ms, hints)
                err_hist.observe(abs(pred - actual_ms))
                # Ledger tie-in: when a cost_context is open around this
                # consumption the prediction rides the item's record (and
                # is a two-attribute-load no-op otherwise).
                note_cost(sched_pred_ms=round(pred, 3))
                yield pool._unwrap(out)
                next_yield += 1
                _refill()
        finally:
            pool.abandon(fut for fut, *_ in inflight.values())
