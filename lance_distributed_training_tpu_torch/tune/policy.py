"""Hill-climbing autotune policy — gradient-free, hysteretic, deterministic.

A copy of ``lance_distributed_training_tpu/tune/policy.py`` for the port:
pure Python, so its decisions equal the JAX policy's for the same inputs
(``tests/test_torch_tune.py`` holds them equal).

The controller (:mod:`.controller`) reduces each windowed registry delta to
a small ``window`` dict (steps, stall_pct, h2d_pct, bufpool_hit_rate,
decode/queue-wait percentiles); this module owns the *decision function*:

    decide(window, knobs, bounds) -> [Decision, ...]

``decide`` is a pure function of the policy's internal state and its
arguments — no clocks, no randomness, no registry reads — which is what
makes ``LDT_AUTOTUNE_TRACE`` replay possible: feed the recorded
(window, knobs, bounds) sequence to a fresh policy and the identical
decision sequence must come out (pinned by ``tests/test_tune.py``).

The shape is tf.data's autotuner translated to this pipeline's knobs
(PAPERS.md, arxiv 2101.12127 — hill climbing over parallelism/prefetch with
hysteresis, not a model), with MinatoLoader's lesson (2509.10712) that the
same stall signals drive adaptation when per-item cost varies:

* **attribution first** — a high loader stall is classified before any knob
  moves: H2D-bound (h2d share of busy time high) grows the placement ring;
  pool-bound (bufpool hit rate collapsed) grows the page budget;
  otherwise decode/transport-bound walks the capacity ladder
  ``workers → stripe_width → prefetch`` (more decode processes, more fleet
  members striped, deeper prefetch — in order of expected payoff).
* **hysteresis** — grow only above ``stall_hi_pct``, consider shrinking
  only after ``shrink_patience`` consecutive windows below
  ``stall_lo_pct``; the band between is deliberately dead.
* **cooldown** — after any actuation the policy sits out
  ``cooldown_ticks`` windows so the change can show up in the signal
  before the next move (a controller reacting to its own transient is the
  classic oscillation failure).
* **revert** — the first evaluated window after an actuation is compared
  to the window that triggered it; if stall worsened by more than
  ``revert_margin_pct`` points the knob goes back and is blocked for
  ``blocked_ticks`` windows (hill climbing needs a way back down).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["Decision", "PolicyConfig", "HillClimbPolicy", "BOTTLENECK_CODES"]

# Bottleneck attribution → the code the autotune_bottleneck gauge carries
# (a gauge must be a number; the glossary in README maps it back).
BOTTLENECK_CODES = {
    "none": 0,
    "decode_bound": 1,
    "transport_bound": 2,
    "h2d_bound": 3,
    "pool_bound": 4,
    "train_bound": 5,
    # --device_decode runs: stalled while the device transform (not the
    # host entropy half) dominates per-batch decode — more decode workers
    # cannot help, the ladder skips that rung.
    "device_transform_bound": 6,
    # --token_pack runs: the packed grid carries too much dead padding —
    # tighten the row-count quantum (finer rounding, more shapes).
    "pad_waste_bound": 7,
    # --token_pack runs: the pack transform is paying fresh jit traces
    # every window — coarsen the quantum (fewer shapes, more padding).
    "recompile_bound": 8,
    # Stalled while per-item decode cost is heavily skewed (p95/p50 of
    # the decode series high): a few stragglers pin batch assembly —
    # grow the scheduler's dispatch-reorder lookahead before throwing
    # uniform capacity at a non-uniform problem.
    "straggler_bound": 9,
    # Multi-tenant data plane: calm window, but >1 jobs share this
    # server's produce capacity — shrink is withheld (the fair scheduler
    # would hand the freed capacity to other jobs, so calm proves no
    # headroom of our own).
    "multi_tenant_hold": 10,
}

# Capacity ladder for decode/transport-bound growth, in expected-payoff
# order: more decode processes first, then more fleet members striped, then
# deeper prefetch (prefetch only papers over variance once throughput is
# actually matched). Only knobs present in the run's tunable set are
# considered.
_GROW_LADDER = ("workers", "stripe_width", "prefetch")
# Shrink order when train-bound: cheapest-to-give-back first.
_SHRINK_LADDER = (
    "prefetch", "workers", "stripe_width", "ring_depth", "bufpool_pages",
)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One actuation: set ``knob`` to ``target`` because ``reason``."""

    knob: str
    target: int
    reason: str


@dataclasses.dataclass
class PolicyConfig:
    """Thresholds — all hysteresis bands and patience counters in one
    place so a trace header can pin them for replay."""

    stall_hi_pct: float = 30.0  # grow above this loader stall
    stall_lo_pct: float = 5.0  # shrink candidate below this
    h2d_hi_pct: float = 15.0  # H2D share of busy time that means H2D-bound
    hit_rate_lo: float = 0.6  # bufpool hit rate that means pool-bound
    min_steps: int = 2  # windows with fewer train steps carry no signal
    cooldown_ticks: int = 2  # sit-out windows after any actuation
    shrink_patience: int = 6  # calm windows before giving capacity back
    revert_margin_pct: float = 10.0  # stall worsening that reverts a move
    revert_patience: int = 2  # consecutive worsened windows before the
    # revert fires — a heavyweight actuation (worker respawn) shows a
    # transient stall spike in its first window; one clean window clears
    # the verdict (reacting to the transient is the classic oscillation)
    blocked_ticks: int = 8  # windows a reverted knob stays off-limits
    decode_split_lo: float = 0.35  # --device_decode attribution: when the
    # host entropy share of decode falls below this, the bottleneck is the
    # device kernel, not host decode — the capacity ladder skips the
    # workers rung (spawning decode processes cannot move a device-bound
    # stall; the prefetch/stripe rungs still apply)
    pad_waste_hi: float = 30.0  # --token_pack: dead-token share of the
    # packed grid above which the pack rung tightens pack_rows_quantum
    # (finer row rounding = less waste, more compiled shapes). Evaluated
    # only OUTSIDE the stalled band — padding waste is a FLOP tax, not a
    # stall, and the capacity rungs keep priority when the loader starves.
    recompile_hi: float = 3.0  # --token_pack: fresh pack-transform jit
    # traces per window above which the rung coarsens pack_rows_quantum
    # (the opposite trade). Steady state sees 0 new shapes per window.
    decode_skew_hi: float = 4.0  # straggler attribution: decode-latency
    # tail-to-median ratio (decode_skew = p95/p50) above which a stall
    # is straggler_bound — a few heavy items pin assembly, so the
    # scheduler's sched_lookahead rung fires before the capacity ladder
    # (growing workers adds uniform capacity; a skewed stall needs
    # reordered dispatch). Uniform corpora sit near 1-2; the skewed
    # bench corpus clears 4 comfortably.

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _grow(value: int, hi: int) -> int:
    """Multiplicative-ish climb: 1→2→4→8 … (a decode pool at 1 worker on a
    97%-stalled host needs to move in doublings, not +1 crawls), capped."""
    return min(hi, max(value + 1, value * 2))


class HillClimbPolicy:
    """Stateful but deterministic: state evolves only through
    :meth:`decide` calls, each a pure function of its arguments."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config if config is not None else PolicyConfig()
        self.last_bottleneck = "none"
        self._cooldown = 0
        self._calm = 0
        # (knob, previous value, stall_pct at decision time, consecutive
        # worsened windows seen) — judged on post-cooldown signal windows;
        # None when nothing is pending.
        self._pending: Optional[Tuple[str, int, float, int]] = None
        self._blocked: Dict[str, int] = {}  # knob -> windows remaining

    # -- helpers -----------------------------------------------------------

    def _tick_blocked(self) -> None:
        for knob in list(self._blocked):
            self._blocked[knob] -= 1
            if self._blocked[knob] <= 0:
                del self._blocked[knob]

    def _growable(self, knob: str, knobs: Dict[str, int],
                  bounds: Dict[str, Tuple[int, int]]) -> bool:
        return (
            knob in knobs
            and knob not in self._blocked
            and knobs[knob] < bounds.get(knob, (1, knobs[knob]))[1]
        )

    def _shrinkable(self, knob: str, knobs: Dict[str, int],
                    bounds: Dict[str, Tuple[int, int]]) -> bool:
        return (
            knob in knobs
            and knob not in self._blocked
            and knobs[knob] > bounds.get(knob, (knobs[knob], knobs[knob]))[0]
        )

    def _act(self, knob: str, target: int, reason: str,
             stall: float, knobs: Dict[str, int]) -> List[Decision]:
        self._pending = (knob, knobs[knob], stall, 0)
        self._cooldown = self.config.cooldown_ticks
        return [Decision(knob, target, reason)]

    # -- the decision function ---------------------------------------------

    def decide(
        self,
        window: Dict[str, float],
        knobs: Dict[str, int],
        bounds: Dict[str, Tuple[int, int]],
    ) -> List[Decision]:
        """``window``: the controller's derived signals. ``knobs``: current
        value per registered tunable. ``bounds``: (lo, hi) per tunable.
        Returns the actuations for this window (usually zero or one)."""
        c = self.config
        self._tick_blocked()
        steps = window.get("steps", 0.0)
        if steps < c.min_steps:
            # No traffic, no signal — also freezes cooldown/patience so a
            # paused trainer doesn't age the controller's state.
            return []
        stall = window.get("stall_pct", 0.0)
        if self._cooldown > 0:
            self._cooldown -= 1
            return []
        if self._pending is not None:
            knob, prev_value, prev_stall, worse = self._pending
            if (
                stall > prev_stall + c.revert_margin_pct
                and knob in knobs
                and knobs[knob] != prev_value
            ):
                worse += 1
                if worse >= c.revert_patience:
                    # Persistently worse: back off and block the knob so
                    # the climb explores elsewhere.
                    self._pending = None
                    self._blocked[knob] = c.blocked_ticks
                    self._cooldown = c.cooldown_ticks
                    self.last_bottleneck = "none"
                    return [Decision(knob, prev_value, "revert")]
                # Could be the actuation's own transient (a worker respawn
                # stalls its first window): hold the verdict, act on
                # nothing until it resolves.
                self._pending = (knob, prev_value, prev_stall, worse)
                return []
            # One clean window acquits the move.
            self._pending = None
        if stall >= c.stall_hi_pct:
            self._calm = 0
            h2d = window.get("h2d_pct", 0.0)
            if h2d >= c.h2d_hi_pct and self._growable(
                "ring_depth", knobs, bounds
            ):
                self.last_bottleneck = "h2d_bound"
                return self._act(
                    "ring_depth",
                    _grow(knobs["ring_depth"], bounds["ring_depth"][1]),
                    "h2d_bound", stall, knobs,
                )
            hit_rate = window.get("bufpool_hit_rate")
            if (
                hit_rate is not None
                and hit_rate < c.hit_rate_lo
                and self._growable("bufpool_pages", knobs, bounds)
            ):
                self.last_bottleneck = "pool_bound"
                return self._act(
                    "bufpool_pages",
                    _grow(knobs["bufpool_pages"],
                          bounds["bufpool_pages"][1]),
                    "pool_bound", stall, knobs,
                )
            skew = window.get("decode_skew", 0.0)
            if skew >= c.decode_skew_hi and self._growable(
                "sched_lookahead", knobs, bounds
            ):
                # Straggler rung: a skewed decode tail means a FEW items
                # pin assembly — widen the scheduler's dispatch-reorder
                # window before the uniform-capacity ladder (more workers
                # cannot move a stall caused by one heavy item at the
                # head of the line).
                self.last_bottleneck = "straggler_bound"
                return self._act(
                    "sched_lookahead",
                    _grow(knobs["sched_lookahead"],
                          bounds["sched_lookahead"][1]),
                    "straggler_bound", stall, knobs,
                )
            device_bound = (
                window.get("decode_split", 1.0) < c.decode_split_lo
            )
            for knob in _GROW_LADDER:
                if knob == "workers" and device_bound:
                    # decode_split attribution: the device kernel, not the
                    # host entropy half, owns the decode cost — a bigger
                    # worker pool cannot move this stall. Skip to the
                    # transport rungs.
                    continue
                if self._growable(knob, knobs, bounds):
                    reason = (
                        "decode_bound" if knob == "workers"
                        else "device_transform_bound" if device_bound
                        else "transport_bound"
                    )
                    self.last_bottleneck = reason
                    return self._act(
                        knob, _grow(knobs[knob], bounds[knob][1]),
                        reason, stall, knobs,
                    )
            # Stalled with every knob at its ceiling (or blocked): nothing
            # left to actuate — the fleet half's scale-up recommendation is
            # the next lever (Coordinator pressure aggregation).
            self.last_bottleneck = (
                "device_transform_bound" if device_bound else "decode_bound"
            )
            return []
        # Pack rung (--token_pack, outside the stalled band): trade the
        # packed row-count quantum between padding waste (a FLOP tax the
        # stall signal never sees) and recompile churn. Same hysteresis/
        # cooldown/revert machinery as every other knob — _act arms the
        # pending-revert judgment and the cooldown sit-out.
        if "pack_rows_quantum" in knobs:
            shapes = window.get("pack_new_shapes", 0.0)
            if shapes >= c.recompile_hi and self._growable(
                "pack_rows_quantum", knobs, bounds
            ):
                self._calm = 0
                self.last_bottleneck = "recompile_bound"
                return self._act(
                    "pack_rows_quantum",
                    _grow(knobs["pack_rows_quantum"],
                          bounds["pack_rows_quantum"][1]),
                    "recompile_bound", stall, knobs,
                )
            waste = window.get("pad_waste_pct")
            if (
                waste is not None
                and waste >= c.pad_waste_hi
                and self._shrinkable("pack_rows_quantum", knobs, bounds)
            ):
                self._calm = 0
                self.last_bottleneck = "pad_waste_bound"
                return self._act(
                    "pack_rows_quantum",
                    max(bounds["pack_rows_quantum"][0],
                        knobs["pack_rows_quantum"] // 2),
                    "pad_waste_bound", stall, knobs,
                )
        if stall <= c.stall_lo_pct:
            if window.get("jobs_active", 0) > 1:
                # Multi-tenant data plane: this process looks calm,
                # but the capacity a shrink would "give back" is shared —
                # the fair scheduler hands it to the OTHER jobs, so a calm
                # window proves nothing about this job's own headroom.
                # Hold every knob instead of ratcheting down (windows with
                # no jobs_active signal — no DataService in-process —
                # keep the exact single-tenant shrink behavior).
                self._calm = 0
                self.last_bottleneck = "multi_tenant_hold"
                return []
            self._calm += 1
            if self._calm >= c.shrink_patience:
                self._calm = 0
                for knob in _SHRINK_LADDER:
                    if self._shrinkable(knob, knobs, bounds):
                        self.last_bottleneck = "train_bound"
                        return self._act(
                            knob, knobs[knob] - 1,
                            "train_bound", stall, knobs,
                        )
            else:
                self.last_bottleneck = "train_bound"
            return []
        # Dead band: healthy, leave everything alone.
        self._calm = 0
        self.last_bottleneck = "none"
        return []
