"""Metrics and timing: the ``[metrics]`` line, its JSONL copy, step timers.

Counterpart of ``MetricLogger``, ``StepTimer`` and ``ServiceCounters`` in
``lance_distributed_training_tpu/utils/metrics.py``, without the wandb sink
(wandb is not a dependency of the port) and the metrics registry: a
:class:`ServiceCounters` keeps its per-instance half (``add``, ``gauge``,
``snapshot``, ``window``) and mirrors nothing into a registry. The
progress window adds ``step_ms`` and, for image batches,
``images_per_sec`` (the trainer counts token rates from each step's grid);
counters attached to a :class:`StepTimer` (the placement plane's
``placement_*``) ride every window.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["MetricLogger", "ServiceCounters", "StepTimer"]


class ServiceCounters:
    """Thread-safe counters and gauges of one loader stage, keyed
    ``<prefix>_<key>`` in :meth:`snapshot` and :meth:`window`. The
    placement plane counts ``placement_h2d_s`` and
    ``placement_batches_placed`` here and gauges
    ``placement_buffer_depth``; attached to a :class:`StepTimer`, their
    window deltas land in the progress lines."""

    def __init__(self, prefix: str = "svc"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counts: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._window: dict[str, float] = {}

    def add(self, key: str, value: float = 1.0) -> None:
        """Accumulate a monotonically growing counter."""
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + value

    def gauge(self, key: str, value: float) -> None:
        """Set an instantaneous gauge."""
        with self._lock:
            self._gauges[key] = float(value)

    def snapshot(self) -> dict:
        """Current totals and gauges, keys prefixed."""
        with self._lock:
            out = {f"{self.prefix}_{k}": v for k, v in self._counts.items()}
            out.update(
                {f"{self.prefix}_{k}": v for k, v in self._gauges.items()})
        return out

    def window(self) -> dict:
        """Counter deltas since the previous ``window()`` call, plus the
        current gauges."""
        with self._lock:
            out = {}
            for k, v in self._counts.items():
                out[f"{self.prefix}_{k}"] = v - self._window.get(k, 0.0)
                self._window[k] = v
            out.update(
                {f"{self.prefix}_{k}": v for k, v in self._gauges.items()})
        return out


class MetricLogger:
    """Metric sink: one ``[metrics] k=v, …`` line on stdout per record and
    the record as one JSON line in ``jsonl_path`` (default
    ``$LDT_METRICS_PATH`` or ``metrics.jsonl``). Under data parallelism
    only process 0 logs (``active=False`` elsewhere), as the JAX logger
    does.

    ``run_name`` and ``config`` (the JAX logger hands them to ``wandb.init``)
    ride the first JSON record as ``run_name``, ``config`` and ``wandb``
    (``enabled``: the ``--no_wandb`` flag's inverse), not the stdout line.
    The port has no wandb sink, so with ``enabled`` that record also says
    why, as the JAX logger's first record does when ``wandb.init`` fails."""

    def __init__(self, jsonl_path: Optional[str] = None, active: bool = True,
                 run_name: Optional[str] = None,
                 config: Optional[dict] = None, enabled: bool = True):
        self._jsonl = None
        self.active = active
        self._header: Optional[dict] = None
        if not active:
            return
        if run_name is not None or config is not None:
            self._header = {"run_name": run_name, "config": config or {},
                            "wandb": enabled}
            if enabled:
                self._header["wandb_disabled_reason"] = (
                    "the PyTorch port has no wandb sink: JSONL and stdout "
                    "only")
        path = jsonl_path or os.environ.get("LDT_METRICS_PATH", "metrics.jsonl")
        try:
            self._jsonl = open(path, "a")
        except OSError:
            self._jsonl = None

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if not self.active:
            return
        record = dict(metrics)
        if step is not None:
            record["step"] = step
        if self._jsonl is not None:
            header, self._header = self._header, None
            self._jsonl.write(json.dumps({**record, **(header or {})}) + "\n")
            self._jsonl.flush()
        pretty = ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
        )
        print(f"[metrics] {pretty}", flush=True)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StepTimer:
    """Separates loader-stall time from step time, on the host clock::

        timer.loader_start(); batch = next(it); timer.loader_stop()
        timer.step_start();   loss = step(batch); timer.step_stop()

    Steps are dispatched asynchronously on the card, so a step segment
    covers host dispatch; :meth:`window` rates divide by the window's wall
    width, which a value fetch at the log point closes honestly."""

    def __init__(self):
        self.loader_s = 0.0
        self.step_s = 0.0
        self.steps = 0
        self._t = 0.0
        self._w_loader = 0.0
        self._w_step = 0.0
        self._w_steps = 0
        self._w_wall = time.perf_counter()
        self._counters: list[ServiceCounters] = []

    def attach_counters(self, *counters: Optional[ServiceCounters]) -> None:
        """Merge one or more :class:`ServiceCounters` windows into every
        :meth:`window`; ``None`` entries are skipped, and a call with none
        detaches."""
        self._counters = [c for c in counters if c is not None]

    def loader_start(self) -> None:
        self._t = time.perf_counter()

    def loader_stop(self) -> None:
        self.loader_s += time.perf_counter() - self._t

    def step_start(self) -> None:
        self._t = time.perf_counter()

    def step_stop(self) -> None:
        self.step_s += time.perf_counter() - self._t
        self.steps += 1

    @property
    def loader_stall_pct(self) -> float:
        total = self.loader_s + self.step_s
        return 100.0 * self.loader_s / total if total > 0 else 0.0

    def window(self, batch_size: Optional[int] = None,
               images: bool = False) -> dict:
        """Deltas since the previous call: ``steps``, ``loader_s``,
        ``step_s``, ``wall_s``, ``step_ms`` (wall time per step), and with
        ``batch_size`` ``examples_per_sec`` against the wall width, named
        again as ``images_per_sec`` (``images``: a batch of images), and
        the attached counters' windows."""
        now = time.perf_counter()
        out = {
            "steps": self.steps - self._w_steps,
            "loader_s": self.loader_s - self._w_loader,
            "step_s": self.step_s - self._w_step,
            "wall_s": now - self._w_wall,
        }
        steps, wall = out["steps"], out["wall_s"]
        out["step_ms"] = 1e3 * wall / steps if steps else 0.0
        if batch_size:
            out["examples_per_sec"] = steps * batch_size / wall if wall > 0 else 0.0
            if images:
                out["images_per_sec"] = out["examples_per_sec"]
        self._w_loader = self.loader_s
        self._w_step = self.step_s
        self._w_steps = self.steps
        self._w_wall = now
        for counters in self._counters:
            out.update(counters.window())
        return out
