"""The port's straggler scheduler (``data/schedule.py``) against the JAX
package's.

``plan_item_hints``, cold-start estimates, the EMA fold and the priors
round-trip equal JAX's on the same items, exactly. Through a fake pool that
records submissions (one worker: dispatch order is observable), the port's
``DecodeScheduler`` dispatches in JAX's order for the same predictions,
heavy lane and starvation guard included, and yields plan order; a cold
model reorders nothing. Then real two-worker pools on the CPU: the
iterable (with a resume), map-style and folder engines stream the same
batches bit for bit with and without a scheduler, and the autotuner's
straggler rung fires on a skewed window, as in JAX.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from lance_distributed_training_tpu.data import schedule as jax_schedule
from lance_distributed_training_tpu.data.cache import (
    item_fingerprint as jax_item_fingerprint,
)
from lance_distributed_training_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from lance_distributed_training_tpu_torch.data.cache import item_fingerprint
from lance_distributed_training_tpu_torch.data.decode import (
    ImageClassificationDecoder,
)
from lance_distributed_training_tpu_torch.data.folder import (
    FolderDataPipeline,
)
from lance_distributed_training_tpu_torch.data.format import Dataset
from lance_distributed_training_tpu_torch.data.pipeline import (
    MapStylePipeline,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data.samplers import ReadRange
from lance_distributed_training_tpu_torch.data.schedule import (
    CostModel,
    DecodeScheduler,
    plan_item_hints,
)
from lance_distributed_training_tpu_torch.data.workers import (
    WorkerPool,
    columnar_spec,
    folder_spec,
)
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.utils.chaos import batch_digest
from test_torch_threads import _one_torch_thread  # noqa: F401


class FakePool:
    """Thread-backed stand-in with exactly the WorkerPool surface the
    scheduler drives; ``submitted`` records each submission's lane and
    first index, in dispatch order."""

    def __init__(self, fn, num_workers=2):
        self._fn = fn
        self.num_workers = num_workers
        self._exec = ThreadPoolExecutor(num_workers)
        self._lanes = {}
        self.submitted = []
        self._lock = threading.Lock()

    def ensure_lane(self, lane, num_workers=1):
        self._lanes.setdefault(lane, ThreadPoolExecutor(num_workers))
        return num_workers

    def submit_lane(self, item, lane="default"):
        with self._lock:
            self.submitted.append((lane, int(np.asarray(item).ravel()[0])))
        ex = self._exec if lane == "default" else self._lanes[lane]
        return ex.submit(self._fn, item)

    def abandon(self, futs):
        for fut in futs:
            fut.cancel()

    def _unwrap(self, out):
        return out

    def shutdown(self):
        for ex in [self._exec, *self._lanes.values()]:
            ex.shutdown(wait=True)


def _items(n, rows=4):
    return [np.arange(i * rows, (i + 1) * rows, dtype=np.int64)
            for i in range(n)]


def _echo(item):
    return {"ix": np.asarray(item)}


# -- plan-item hints and the cost model --------------------------------------


def test_plan_item_hints_equal_jax():
    ranges = [ReadRange(0, 0, 10), ReadRange(2, 20, 25)]
    cases = [np.arange(6), (np.arange(4), np.ones(4, np.float32)), ranges,
             "garbage", [object()], []]
    for item in cases:
        assert plan_item_hints(item) == jax_schedule.plan_item_hints(item)
    assert plan_item_hints(ranges) == {"rows": 15.0}


def test_cold_start_estimates_and_the_ema_fold_equal_jax():
    got, want = CostModel(decay=0.5), jax_schedule.CostModel(decay=0.5)
    hints = [{"rows": 16.0, "bytes": 200_000.0}, {"rows": 4.0},
             {"rows": 4.0, "token_len": 2048}, {"rows": 4.0, "reencode": 1},
             {}]
    for h in hints:
        assert got.predict("k", h) == want.predict("k", h)
        assert got.predict(None, h, row_ms=0.3) == \
            want.predict(None, h, row_ms=0.3)
    rng = np.random.default_rng(0)
    for i in range(40):
        key, ms = f"k{i % 7}", float(rng.exponential(20.0))
        h = {"rows": float(rng.integers(1, 64))}
        got.observe(key, ms, h)
        want.observe(key, ms, h)
    got.observe(None, 5.0)
    want.observe(None, 5.0)
    got.observe("neg", -1.0)
    want.observe("neg", -1.0)
    assert got.rate_snapshot() == want.rate_snapshot()
    assert len(got) == len(want) == 7
    for i in range(9):
        assert got.predict(f"k{i}", {"rows": 8.0}) == \
            want.predict(f"k{i}", {"rows": 8.0})
    with pytest.raises(ValueError, match="decay"):
        CostModel(decay=0.0)


def test_priors_roundtrip_equal_jax(tmp_path, monkeypatch):
    path = tmp_path / "costs.jsonl"
    lines = [
        json.dumps({"key": "hot", "decode_ms": 80.0, "bytes": 500_000}),
        "not json at all {{{",
        json.dumps(["not", "a", "dict"]),
        json.dumps({"no_key_field": 1}),
        json.dumps({"key": "hot", "decode_ms": 40.0}),
        json.dumps({"key": "described", "bytes": 900_000, "reencode": 1}),
        "",
    ]
    path.write_text("\n".join(lines) + "\n")
    got, want = CostModel(decay=0.5), jax_schedule.CostModel(decay=0.5)
    assert got.load_priors(str(path)) == want.load_priors(str(path)) == 3
    for key in ("hot", "described", "never-seen"):
        assert got.predict(key) == want.predict(key)
    assert got.predict("hot") == 60.0
    monkeypatch.setenv("LDT_COST_PATH", str(path))
    assert CostModel.from_env(decay=0.5).predict("hot") == \
        jax_schedule.CostModel.from_env(decay=0.5).predict("hot")
    monkeypatch.setenv("LDT_COST_PATH", str(tmp_path / "absent.jsonl"))
    assert len(CostModel.from_env()) == 0
    assert CostModel().load_priors(str(tmp_path / "absent.jsonl")) == 0


def test_item_fingerprints_key_the_models_alike():
    items = _items(3) + [[ReadRange(1, 0, 8)],
                         (np.arange(4), np.ones(4, np.float32))]
    for item in items:
        assert item_fingerprint(item) == jax_item_fingerprint(item)


# -- dispatch order against JAX's ---------------------------------------------


def _models(observed):
    """The same observations folded into a port and a JAX model."""
    got, want = CostModel(), jax_schedule.CostModel()
    for key, ms, hints in observed:
        got.observe(key, ms, hints)
        want.observe(key, ms, hints)
    return got, want


def _dispatch(sched, items, num_workers=1, **kw):
    pool = FakePool(_echo, num_workers=num_workers)
    try:
        out = list(sched.imap(pool, items, **kw))
    finally:
        pool.shutdown()
    for got, item in zip(out, items):  # yield order: the plan's
        np.testing.assert_array_equal(got["ix"], item)
    assert len(out) == len(items)
    return pool.submitted


SCENARIOS = {
    # one known straggler in the window
    "one-heavy": (8, dict(lookahead=8), dict(window=4),
                  [(5, 500.0, {"rows": 4.0})] * 3),
    # every later item heavier: the starvation guard forces the head
    "starvation": (9, dict(lookahead=9), dict(window=2),
                   [(i, 1.0 + i * 100.0, {"rows": 4.0}) for i in range(9)]),
    # two far-above-mean stragglers routed to a heavy lane
    "heavy-lane": (10, dict(lookahead=4, heavy_share=50), {},
                   [(6, 400.0, None), (8, 400.0, None)]),
    # mixed costs, a narrow lookahead
    "mixed": (16, dict(lookahead=3), dict(window=2),
              [(i, float((i * 37) % 11) * 10.0, {"rows": 4.0})
               for i in range(16)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dispatch_order_equals_jax(name):
    n, opts, kw, observed = SCENARIOS[name]
    items = _items(n)
    keys = [item_fingerprint(i) for i in items]
    got_model, want_model = _models(
        [(keys[i], ms, h) for i, ms, h in observed])
    reg, jreg = MetricsRegistry(), JaxRegistry()
    got = _dispatch(DecodeScheduler(got_model, registry=reg, **opts), items,
                    num_workers=4 if "heavy_share" in opts else 1, **kw)
    want = _dispatch(jax_schedule.DecodeScheduler(
        want_model, registry=jreg, **opts), items,
        num_workers=4 if "heavy_share" in opts else 1, **kw)
    assert got == want
    for series in ("sched_dispatch_reorders_total",
                   "sched_heavy_lane_batches_total"):
        assert reg.counter(series).value == jreg.counter(series).value
    assert reg.counter("sched_dispatch_reorders_total").value > 0
    assert reg.histogram("sched_predicted_error_ms").count == n
    if "heavy_share" in opts:
        lane = [i for lane, i in got if lane == "heavy"]
        assert lane and set(lane) <= {items[6][0], items[8][0]}
        assert reg.counter("sched_heavy_lane_batches_total").value \
            == len(lane)


def test_cold_model_dispatches_in_plan_order_zero_reorders():
    reg = MetricsRegistry()
    items = _items(12)
    got = _dispatch(DecodeScheduler(registry=reg), items, num_workers=2)
    assert [i for _, i in got] == [int(x[0]) for x in items]
    assert reg.counter("sched_dispatch_reorders_total").value == 0


def test_generator_close_abandons_inflight():
    abandoned = []
    pool = FakePool(lambda item: (time.sleep(0.01), _echo(item))[1])
    inner = pool.abandon
    pool.abandon = lambda futs: (abandoned.extend(futs), inner(abandoned))
    try:
        it = DecodeScheduler(registry=MetricsRegistry()).imap(pool,
                                                              _items(16))
        next(it)
        it.close()  # must not hang; in-flight futures go to abandon()
        assert abandoned
    finally:
        pool.shutdown()


def test_constructor_and_tunables_clamp_as_jax():
    with pytest.raises(ValueError, match="lookahead"):
        DecodeScheduler(lookahead=0)
    with pytest.raises(ValueError, match="heavy_share"):
        DecodeScheduler(heavy_share=101)
    sched = DecodeScheduler(lookahead=8, heavy_share=10)
    knobs = {t.name: t for t in sched.tunables()}
    want = {t.name: t for t in jax_schedule.DecodeScheduler().tunables()}
    assert set(knobs) == set(want) == {"sched_lookahead",
                                       "sched_heavy_share"}
    for name, knob in knobs.items():
        assert (knob.lo, knob.hi, knob.doc) == (want[name].lo,
                                                want[name].hi,
                                                want[name].doc)
    assert knobs["sched_lookahead"].set(10_000) == 64 == sched.lookahead
    assert knobs["sched_lookahead"].set(0) == 1 == sched.lookahead
    assert knobs["sched_heavy_share"].set(200) == 50 == sched.heavy_share
    assert knobs["sched_heavy_share"].set(-3) == 0 == sched.heavy_share


# -- real worker pools: the same batches with and without a scheduler ---------

SCHED = {"lookahead": 6, "heavy_share": 50}


def _digests(loader):
    return [batch_digest(b) for b in loader]


@pytest.fixture(scope="module")
def sched_dataset(tmp_path_factory):
    import pyarrow as pa

    from lance_distributed_training_tpu_torch.data import write_dataset
    from tests.conftest import make_jpeg

    rng = np.random.default_rng(11)
    images = [make_jpeg(rng) for _ in range(96)]
    labels = rng.integers(0, 10, 96)
    table = pa.table({"image": pa.array(images, pa.binary()),
                      "label": pa.array(labels, pa.int64())})
    uri = str(tmp_path_factory.mktemp("sched") / "ds")
    write_dataset(table, uri, max_rows_per_file=40)
    return Dataset(uri)


def _decoder():
    return ImageClassificationDecoder(32, use_native=False)


def _warm(model, plan):
    """A model that has seen each item once, with uneven costs, so the
    scheduler reorders."""
    for i, item in enumerate(plan):
        model.observe(item_fingerprint(item), float((i * 7) % 5) * 3.0)
    return model


def test_engines_stream_the_same_batches_with_a_scheduler(sched_dataset,
                                                          tmp_path):
    ds = sched_dataset
    reg = MetricsRegistry()
    with WorkerPool(columnar_spec(ds.uri), _decoder(), 2) as pool:
        # Iterable: the factory's schedule= on the Decode node.
        kw = dict(workers=pool, shuffle=True, seed=3)
        ref = _digests(make_train_pipeline(ds, "batch", 16, 0, 1, _decoder(),
                                           None, **kw))
        assert len(ref) == 6
        plan = make_train_pipeline(ds, "batch", 16, 0, 1, _decoder(), None,
                                   **kw).plan
        sched = DecodeScheduler(_warm(CostModel(), plan), registry=reg,
                                **SCHED)
        graph = make_train_pipeline(ds, "batch", 16, 0, 1, _decoder(), None,
                                    schedule=sched, **kw)
        assert {"sched_lookahead", "sched_heavy_share"} <= {
            t.name for t in graph.tunables()}
        assert _digests(graph) == ref
        assert reg.counter("sched_dispatch_reorders_total").value > 0
        # The cursor is plan position, which dispatch order never moves.
        resumed = make_train_pipeline(ds, "batch", 16, 0, 1, _decoder(),
                                      None, schedule=sched, **kw)
        resumed.load_state_dict({"epoch": 0, "step": 3})
        assert _digests(resumed) == ref[3:]
        assert resumed.state_dict() == {"epoch": 0, "step": 6}
        # Map-style: the engine's scheduler= seam.
        kw = dict(workers=pool, seed=5, columns=None)
        ref = _digests(MapStylePipeline(ds, 16, 0, 1, _decoder(), None,
                                        **kw))
        got = _digests(MapStylePipeline(
            ds, 16, 0, 1, _decoder(), None,
            scheduler=DecodeScheduler(**SCHED), **kw))
        assert got == ref and len(ref) == 6


def test_folder_engine_streams_the_same_batches_with_a_scheduler(tmp_path):
    from lance_distributed_training_tpu_torch.data import (
        create_synthetic_image_folder,
    )

    root = str(tmp_path / "tree")
    create_synthetic_image_folder(root, rows=30, num_classes=3,
                                  image_size=32)
    pipe = FolderDataPipeline(root, 10, 0, 1, _decoder(), None, seed=2)
    ref = _digests(pipe)
    with WorkerPool(folder_spec(pipe.samples), _decoder(), 2) as pool:
        got = _digests(FolderDataPipeline(
            root, 10, 0, 1, _decoder(), None, seed=2, workers=pool,
            scheduler=DecodeScheduler(**SCHED)))
    assert got == ref and len(ref) == 3


# -- the autotuner's straggler rung -------------------------------------------


def test_policy_straggler_rung_fires_on_skew():
    from lance_distributed_training_tpu_torch.tune.controller import (
        derive_window,
    )
    from lance_distributed_training_tpu_torch.tune.policy import (
        BOTTLENECK_CODES,
        HillClimbPolicy,
        PolicyConfig,
    )

    assert BOTTLENECK_CODES["straggler_bound"] == 9
    bounds = {"workers": (1, 8), "prefetch": (1, 16),
              "sched_lookahead": (1, 64)}
    knobs = {"workers": 2, "prefetch": 2, "sched_lookahead": 8}
    window = {"steps": 10.0, "stall_pct": 80.0, "h2d_pct": 0.0,
              "decode_skew": 5.0}
    out = HillClimbPolicy(PolicyConfig(min_steps=1)).decide(window, knobs,
                                                             bounds)
    assert [(d.knob, d.target, d.reason) for d in out] == [
        ("sched_lookahead", 16, "straggler_bound")]
    calm = dict(window, decode_skew=1.2)
    assert HillClimbPolicy(PolicyConfig(min_steps=1)).decide(
        calm, knobs, bounds)[0].knob == "workers"
    w = derive_window({
        "trainer_step_ms_count": 10.0,
        "pipeline_decode_ms_p95": 80.0,
        "pipeline_decode_ms_p50": 10.0,
        "sched_dispatch_reorders_total": 3.0,
    })
    assert w["decode_skew"] == pytest.approx(8.0)
    assert w["sched_reorders"] == 3.0
