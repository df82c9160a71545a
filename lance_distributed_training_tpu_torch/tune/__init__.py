"""Closed-loop pipeline autotuning: copies of the JAX package's ``tune/``
modules. A per-process :class:`~.controller.AutoTuner` thread reads
windowed deltas of the metrics registry (:mod:`..obs.registry`),
attributes the bottleneck and moves the live knobs the port's components
register as :class:`~.tunable.Tunable`\\ s — decode worker count, prefetch
depth, buffer-pool page budget, placement ring depth, cache budgets, the
coefficient grid's rounding and the pack plan's shape. Every knob but
``pack_len`` moves capacity, not content. ``LDT_AUTOTUNE_TRACE=<path>``
records each tick for :func:`~.controller.verify_trace`."""

from .controller import (  # noqa: F401
    TRACE_ENV,
    AutoTuner,
    derive_window,
    read_trace,
    replay_trace,
    verify_trace,
)
from .policy import (  # noqa: F401
    BOTTLENECK_CODES,
    Decision,
    HillClimbPolicy,
    PolicyConfig,
)
from .tunable import AdjustableQueue, Tunable, collect_tunables  # noqa: F401

__all__ = [
    "AutoTuner",
    "AdjustableQueue",
    "BOTTLENECK_CODES",
    "Decision",
    "HillClimbPolicy",
    "PolicyConfig",
    "TRACE_ENV",
    "Tunable",
    "collect_tunables",
    "derive_window",
    "read_trace",
    "replay_trace",
    "verify_trace",
]
