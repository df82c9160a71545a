"""The port's observability copies against the JAX package's: the metrics
registry (Prometheus text, windowed deltas, percentiles), span tracing,
the per-item cost ledger and the lease tracker, fed the same seeded
sequence of observations on both sides."""

import json

import numpy as np
import pytest

from lance_distributed_training_tpu.obs import costs as jax_costs
from lance_distributed_training_tpu.obs import registry as jax_registry
from lance_distributed_training_tpu.obs import spans as jax_spans
from lance_distributed_training_tpu.utils import leaktrack as jax_leaktrack
from lance_distributed_training_tpu_torch.obs import costs, registry, spans
from lance_distributed_training_tpu_torch.utils import leaktrack

# Series the port's planes publish, by the JAX package's names.
_COUNTERS = ("bufpool_hit_total", "bufpool_miss_total", "cache_hit_total",
             "shm_fallback_total", "pack_payload_tokens_total")
_GAUGES = ("bufpool_in_use", "placement_buffer_depth", "autotune_bottleneck")
_HISTOGRAMS = ("trainer_loader_ms", "trainer_step_ms", "trainer_h2d_ms",
               "pipeline_decode_ms", "workers_result_wait_ms",
               "shm_slot_wait_ms", "decode_entropy_ms")


def _observe(reg, rng) -> None:
    """One seeded round of observations into every kind of series."""
    for name in _COUNTERS:
        reg.counter(name).inc(float(rng.integers(0, 50)))
    for name in _GAUGES:
        reg.gauge(name).set(float(rng.integers(0, 9)))
    for name in _HISTOGRAMS:
        for value in rng.gamma(2.0, 40.0, size=int(rng.integers(1, 40))):
            reg.histogram(name).observe(float(value))


def _both(seed: int):
    """A JAX and a port registry after the same observations."""
    regs = (jax_registry.MetricsRegistry(), registry.MetricsRegistry())
    for reg in regs:
        _observe(reg, np.random.default_rng(seed))
    return regs


@pytest.mark.parametrize("seed", [0, 1])
def test_prometheus_text_equals_jax(seed):
    want, got = _both(seed)
    text = registry.render_prometheus(got)
    assert text == jax_registry.render_prometheus(want)
    assert "trainer_step_ms_bucket" in text and "bufpool_hit_total" in text


def test_registry_delta_equals_jax():
    regs = (jax_registry.MetricsRegistry(), registry.MetricsRegistry())
    deltas = (jax_registry.RegistryDelta(regs[0]),
              registry.RegistryDelta(regs[1]))
    for window in range(3):
        for reg in regs:
            _observe(reg, np.random.default_rng(10 + window))
        want, got = deltas[0].delta(), deltas[1].delta()
        assert got == want
        assert got["trainer_step_ms_count"] > 0


def test_percentile_from_counts_equals_jax():
    rng = np.random.default_rng(3)
    edges = jax_registry.DEFAULT_MS_BUCKETS
    assert registry.DEFAULT_MS_BUCKETS == edges
    assert registry.Histogram("h").bounds == jax_registry.Histogram("h").bounds
    for _ in range(20):
        counts = [int(c) for c in rng.integers(0, 30, size=len(edges) + 1)]
        total, peak = sum(counts), float(rng.uniform(1e4, 3e4))
        for q in (50, 95, 99):
            assert (registry.percentile_from_counts(edges, counts, total, q,
                                                    peak)
                    == jax_registry.percentile_from_counts(
                        edges, counts, total, q, peak))


def _trace(module, tracer_cls):
    tracer = tracer_cls()
    with tracer.span("train.loader", step=0):
        with tracer.span("pipeline.decode", batch_seq=0) as attrs:
            attrs["cache_hit"] = True
    with tracer.span("placement.h2d", batch_seq=0):
        pass
    events = module.chrome_trace([s.to_event() for s in tracer.spans()])
    return [(e["name"], e["ph"], e["args"]) for e in events["traceEvents"]
            if e.get("ph") == "X"]


def test_spans_nest_and_export_as_jax():
    got = _trace(spans, spans.SpanTracer)
    assert got == _trace(jax_spans, jax_spans.SpanTracer)
    names = [name for name, _, _ in got]
    assert sorted(names) == ["pipeline.decode", "placement.h2d",
                             "train.loader"]
    decode = next(a for n, _, a in got if n == "pipeline.decode")
    loader = next(a for n, _, a in got if n == "train.loader")
    assert decode["parent_id"] == loader["span_id"] and decode["cache_hit"]


def _ledger(module, path):
    ledger = module.CostLedger(capacity=3, jsonl_path=str(path))
    for i, ms in enumerate([5.0, 40.0, 7.5, 12.0, 40.0]):
        with module.cost_context(f"item{i % 4}", ledger=ledger,
                                 step=i) as cost:
            module.note_cost(entropy_ms=ms / 2, reencode=i == 2)
            cost.note(decode_ms=ms)
    module.note_cost(decode_ms=1.0)  # no open context: dropped
    records = ledger.records()
    ledger.close()
    return records, ledger.top(2), path.read_text().splitlines()


def test_cost_ledger_records_as_jax(tmp_path):
    want = _ledger(jax_costs, tmp_path / "jax.jsonl")
    got = _ledger(costs, tmp_path / "port.jsonl")
    assert got[0] == want[0] and got[1] == want[1]
    assert len(got[0]) == 3  # capacity-bounded
    strip = [{k: v for k, v in json.loads(line).items() if k != "ns"}
             for line in got[2]]
    assert strip == [{k: v for k, v in json.loads(line).items()
                      if k != "ns"} for line in want[2]]


def _leaks(module, path):
    module.reset()
    module.enable()
    try:
        for key in range(4):
            module.track_acquire("pool-page", key)
        module.track_release("pool-page", 1)
        module.track_release("pool-page", 3)
        module.track_dropped("pool-page", 2)
        module.track_release("pool-page", 99)  # never acquired
        outstanding = module.outstanding()
        sites = module.sites()
        module.dump(str(path))
    finally:
        module.disable()
        module.reset()
    return outstanding, sites, json.loads(path.read_text())


def test_leaktrack_counts_as_jax(tmp_path):
    want = _leaks(jax_leaktrack, tmp_path / "jax.json")
    got = _leaks(leaktrack, tmp_path / "port.json")
    assert got[0] == want[0] == 1
    # The acquire site is this file's line in both: the records match.
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    assert not leaktrack.enabled()
