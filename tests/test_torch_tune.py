"""The port's autotuner copies against the JAX package's: ``derive_window``
on seeded registry deltas, the hill-climbing policy's decisions over one
seeded sequence of windows, tuner traces that verify across packages, the
adjustable queue, and the live knobs of the port's loaders, placement
plane, buffer pool and trainer."""

import json
import queue
import threading

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from lance_distributed_training_tpu.tune import controller as jax_controller
from lance_distributed_training_tpu.tune import policy as jax_policy
from lance_distributed_training_tpu.tune import tunable as jax_tunable
from lance_distributed_training_tpu_torch import cli
from lance_distributed_training_tpu_torch.data import (
    BufferPool,
    Dataset,
    ImageClassificationDecoder,
    PlacementPlane,
    create_synthetic_classification_dataset,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.tune import (
    AdjustableQueue,
    AutoTuner,
    HillClimbPolicy,
    PolicyConfig,
    Tunable,
    collect_tunables,
    derive_window,
    replay_trace,
    verify_trace,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


# Every series derive_window reads, with the suffixes a delta carries.
_DELTA_KEYS = (
    "trainer_step_ms_count", "trainer_loader_ms_sum", "trainer_step_ms_sum",
    "trainer_h2d_ms_sum", "bufpool_hit_total", "bufpool_miss_total",
    "pipeline_decode_ms_p95", "pipeline_decode_ms_p50",
    "lineage_decode_ms_p95", "decode_entropy_ms_p50", "decode_device_ms_p50",
    "pack_payload_tokens_total", "pack_grid_tokens_total",
    "pack_new_shapes_total", "sched_dispatch_reorders_total",
    "svc_queue_wait_ms_p95", "shm_slot_wait_ms_p95",
    "placement_buffer_depth", "svc_jobs_active",
)


def _delta(rng) -> dict:
    """A seeded registry delta: each series present or absent at random."""
    out = {}
    for key in _DELTA_KEYS:
        if rng.random() < 0.7:
            out[key] = float(np.round(rng.gamma(2.0, 30.0), 3))
    if "pack_grid_tokens_total" in out:
        out["pack_payload_tokens_total"] = float(
            rng.uniform(0.2, 1.0) * out["pack_grid_tokens_total"])
    return out


def test_derive_window_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        delta = _delta(rng)
        assert derive_window(delta) == jax_controller.derive_window(delta)


_KNOBS = {"workers": (1, 8), "prefetch": (1, 16), "bufpool_pages": (2, 64),
          "ring_depth": (1, 8), "coeff_chunk": (1, 16),
          "pack_rows_quantum": (1, 64), "cache_ram_budget_mb": (8, 16384)}


def _window(rng) -> dict:
    """A seeded policy window: stalled, calm, H2D- or pool-bound, padded,
    skewed, or with too few steps to carry a signal."""
    w = {"steps": float(rng.integers(0, 12)),
         "stall_pct": float(rng.choice([2.0, 12.0, 45.0, 80.0])),
         "h2d_pct": float(rng.choice([1.0, 20.0]))}
    for key, values in (("bufpool_hit_rate", [0.3, 0.95]),
                        ("decode_split", [0.1, 0.9]),
                        ("decode_skew", [1.5, 6.0]),
                        ("pad_waste_pct", [10.0, 50.0]),
                        ("pack_new_shapes", [0.0, 5.0]),
                        ("decode_ms_p95", [20.0, 200.0])):
        if rng.random() < 0.5:
            w[key] = float(rng.choice(values))
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_decisions_equal_jax_over_a_seeded_sequence(seed):
    rng = np.random.default_rng(seed)
    config = dict(min_steps=2, cooldown_ticks=1, shrink_patience=3)
    ours = HillClimbPolicy(PolicyConfig(**config))
    theirs = jax_policy.HillClimbPolicy(jax_policy.PolicyConfig(**config))
    knobs = {name: lo + 1 for name, (lo, _hi) in _KNOBS.items()}
    decided = 0
    for _ in range(300):
        window = _window(rng)
        got = ours.decide(window, dict(knobs), dict(_KNOBS))
        want = theirs.decide(window, dict(knobs), dict(_KNOBS))
        assert ([(d.knob, d.target, d.reason) for d in got]
                == [(d.knob, d.target, d.reason) for d in want])
        assert ours.last_bottleneck == theirs.last_bottleneck
        for d in got:
            lo, hi = _KNOBS[d.knob]
            knobs[d.knob] = min(hi, max(lo, d.target))
        decided += len(got)
    assert decided > 5  # the sequence exercised the policy


class _Holder:
    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value

    def set(self, v):
        self.value = v
        return v


def _record(tuner_cls, tunable_cls, config_cls, registry, path):
    """Ticks of a tuner over a stalled, idle, then calm sequence; the
    trace's records."""
    knobs = [_Holder(1), _Holder(2)]
    tuner = tuner_cls(
        [tunable_cls("workers", knobs[0].get, knobs[0].set, lo=1, hi=8),
         tunable_cls("prefetch", knobs[1].get, knobs[1].set, lo=1, hi=16)],
        registry=registry, trace_path=str(path),
        policy_config=config_cls(min_steps=1, cooldown_ticks=1))
    loader = registry.histogram("trainer_loader_ms")
    step = registry.histogram("trainer_step_ms")
    for loader_ms in (90.0, None, 90.0, 90.0, 5.0, 5.0, 90.0):
        if loader_ms is not None:
            for _ in range(5):
                loader.observe(loader_ms)
                step.observe(95.0 if loader_ms == 5.0 else 10.0)
        tuner.tick()
    tuner.stop()
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_traces_verify_across_packages(tmp_path):
    config = dict(min_steps=1, cooldown_ticks=1)
    ours = _record(AutoTuner, Tunable, PolicyConfig, MetricsRegistry(),
                   tmp_path / "p.jsonl")
    theirs = _record(jax_controller.AutoTuner, jax_tunable.Tunable,
                     jax_policy.PolicyConfig, JaxRegistry(),
                     tmp_path / "j.jsonl")
    # The same observations give the same records, decisions included.
    assert ours == theirs
    assert any(r["applied"] for r in ours)
    # Each package's trace verifies under the other's replay.
    assert verify_trace(str(tmp_path / "j.jsonl"), PolicyConfig(**config)) \
        == (True, [])
    assert jax_controller.verify_trace(
        str(tmp_path / "p.jsonl"), jax_policy.PolicyConfig(**config)) \
        == (True, [])
    assert ([[list(d) for d in tick] for tick in replay_trace(
        str(tmp_path / "j.jsonl"), PolicyConfig(**config))]
        == [r["decisions"] for r in theirs])


def test_adjustable_queue_grows_live_and_shrinks_without_loss():
    q = AdjustableQueue(1)
    q.put(0)
    done = threading.Event()

    def producer():
        for i in range(1, 5):
            q.put(i)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    assert not done.wait(0.2)  # blocked against the bound of 1
    assert q.set_maxsize(8) == 8
    assert done.wait(5.0)
    q.set_maxsize(2)  # shrinking drops nothing
    assert [q.get_nowait() for _ in range(5)] == [0, 1, 2, 3, 4]
    assert AdjustableQueue(0).maxsize == 1  # always bounded
    with pytest.raises(queue.Empty):
        q.get_nowait()
    t.join()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    path = tmp_path_factory.mktemp("tune") / "food"
    create_synthetic_classification_dataset(str(path), rows=48,
                                            num_classes=4, image_size=32,
                                            fragment_size=20)
    return Dataset(path)


def _digests(batches):
    return [(b["image"].numpy().tobytes(), b["label"].numpy().tobytes())
            for b in batches]


def test_live_ring_and_prefetch_resize_keep_the_stream(images):
    decode = ImageClassificationDecoder(image_size=32, use_native=False)
    want = _digests(
        PlacementPlane("cpu", depth=2).wrap(make_train_pipeline(
            images, "batch", 8, 0, 1, decode, None, producers=2)))
    plane = PlacementPlane("cpu", depth=1, registry=MetricsRegistry())
    loader = plane.wrap(make_train_pipeline(images, "batch", 8, 0, 1, decode,
                                            None, prefetch=1, producers=2))
    knobs = {t.name: t for t in loader.tunables()}
    assert list(knobs) == ["ring_depth", "prefetch"]
    got = []
    for i, batch in enumerate(loader):
        got.append(batch)
        if i == 1:
            assert knobs["ring_depth"].set(4) == 4 and plane.depth == 4
            assert knobs["prefetch"].set(6) == 6
        if i == 3:
            assert knobs["ring_depth"].set(100) == 8  # clamped at hi
            knobs["prefetch"].set(1)
    assert _digests(got) == want and len(want) == 6


def test_pool_and_trainer_knobs(tmp_path):
    pool = BufferPool(registry=MetricsRegistry())
    [t] = pool.tunables()
    assert t.name == "bufpool_pages" and (t.lo, t.hi) == (2, 64)
    for _ in range(6):
        pool.release(pool.lease((4,), np.uint8))
    assert t.set(3) == 3 and pool.max_free_per_key == 3
    plane = PlacementPlane("cpu")
    names = [t.name for t in collect_tunables(plane, None, pool, plane)]
    assert names == ["ring_depth", "bufpool_pages"]
    # The JAX CLI's defaults: the tuner on, a one-second tick.
    args = cli.build_parser().parse_args(["--dataset_path", "x"])
    assert not args.no_autotune and args.autotune_interval_s == 1.0
    config = cli.TrainConfig(dataset_path="x")
    assert config.autotune and config.autotune_interval_s == 1.0
    assert torch.device(config.device).type == "cuda"


_NEW_FLAGS = ("num_workers", "no_shm_workers", "batch_cache",
              "no_batch_cache", "cache_dir", "cache_ram_budget_mb",
              "cache_disk_budget_mb", "device_cache", "device_cache_gb",
              "data_echo", "no_autotune", "autotune_interval_s")


def test_the_twelve_flags_take_the_jax_cli_defaults():
    from lance_distributed_training_tpu.cli import (
        build_parser as jax_build_parser,
    )
    from lance_distributed_training_tpu.trainer import (
        TrainConfig as JaxTrainConfig,
    )

    ours = vars(cli.build_parser().parse_args(["--dataset_path", "x"]))
    theirs = vars(jax_build_parser().parse_args(["--dataset_path", "x"]))
    assert {k: ours[k] for k in _NEW_FLAGS} \
        == {k: theirs[k] for k in _NEW_FLAGS}
    fields = ("num_workers", "shm_workers", "batch_cache", "cache_dir",
              "cache_ram_budget_mb", "cache_disk_budget_mb", "device_cache",
              "device_cache_gb", "data_echo", "autotune",
              "autotune_interval_s")
    config, jax_config = cli.TrainConfig("x"), JaxTrainConfig("x")
    assert {f: getattr(config, f) for f in fields} \
        == {f: getattr(jax_config, f) for f in fields}
    # The exclusive pair, as in the JAX CLI.
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--dataset_path", "x",
                                       "--batch_cache", "--no_batch_cache"])
