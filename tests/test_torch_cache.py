"""The port's cache plane against the JAX package's: every fingerprint and
entry name as the same string, the RAM and disk tiers (budgets, spills,
torn files, restart-warm adoption) driven through one scripted sequence
on both sides, the HBM replay tier's admission, refusal and replay order,
and the loaders' cached epochs bit for bit against the JAX loaders."""

import os

import numpy as np
import pytest

from lance_distributed_training_tpu.data import cache as jax_cache
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.folder import (
    FolderDataPipeline as JaxFolderPipeline,
)
from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.data.samplers import (
    ReadRange as JaxReadRange,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenDecoder as JaxTokenDecoder,
    TokenPackConfig as JaxTokenPackConfig,
    TokenPackPlanner as JaxTokenPackPlanner,
)
from lance_distributed_training_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from lance_distributed_training_tpu_torch.data import (
    BufferPool,
    Dataset,
    FolderDataPipeline,
    ImageClassificationDecoder,
    LoaderGraph,
    ReadRange,
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    create_synthetic_classification_dataset,
    create_synthetic_image_folder,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data import cache
from lance_distributed_training_tpu_torch.data.authoring import (
    _folder_samples,
)
from lance_distributed_training_tpu_torch.obs.registry import MetricsRegistry
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE = 32


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    create_synthetic_classification_dataset(
        str(root / "food"), rows=40, num_classes=4, image_size=SIZE,
        fragment_size=12)
    create_synthetic_image_folder(str(root / "tree"), rows=18,
                                  num_classes=3, image_size=SIZE)
    return root


def _plain(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _plain(g), _plain(w)
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])


def _token_decoders(mode):
    if mode == "pad":
        return (JaxTokenDecoder(mode="pad", seq_len=24),
                TokenDecoder(mode="pad", seq_len=24))
    return (JaxTokenDecoder(mode=mode, seq_len=24, planner=JaxTokenPackPlanner(
                JaxTokenPackConfig(pack_len=24, rows_multiple=2))),
            TokenDecoder(mode=mode, seq_len=24, planner=TokenPackPlanner(
                TokenPackConfig(pack_len=24, rows_multiple=2))))


def _local_decode(batch):
    return batch


def test_fingerprints_and_entry_names_equal_jax(corpora):
    samples, _ = _folder_samples(str(corpora / "tree"))
    assert cache.folder_fingerprint(samples) \
        == jax_cache.folder_fingerprint(samples)
    assert Dataset(corpora / "food").fingerprint() \
        == JaxDataset(corpora / "food").fingerprint()
    decoders = [
        (JaxImageDecoder(image_size=SIZE, use_native=False),
         ImageClassificationDecoder(image_size=SIZE, use_native=False)),
        (JaxImageDecoder(image_size=64, label_column=None, use_native=False),
         ImageClassificationDecoder(image_size=64, label_column=None,
                                    use_native=False)),
        *(_token_decoders(mode) for mode in ("pad", "pack", "bucket")),
        (_local_decode, _local_decode),
    ]
    for want, got in decoders:
        assert cache.decode_fingerprint(got) \
            == jax_cache.decode_fingerprint(want)
    rng = np.random.default_rng(0)
    items = [
        (rng.permutation(40)[:8], None),
        ([JaxReadRange(0, 0, 8), JaxReadRange(1, 4, 12)],
         [ReadRange(0, 0, 8), ReadRange(1, 4, 12)]),
        ((np.arange(8), np.ones(8, np.float32)), None),
        ("not an item", None),
    ]
    for want_item, got_item in items:
        got_item = want_item if got_item is None else got_item
        assert cache.item_fingerprint(got_item) \
            == jax_cache.item_fingerprint(want_item)
    scope = dict(decode=cache.decode_fingerprint(decoders[0][1]),
                 columns=["image", "label"], eval=1)
    assert cache.plan_fingerprint(**scope) \
        == jax_cache.plan_fingerprint(**dict(reversed(scope.items())))
    key = ("ds", cache.plan_fingerprint(**scope), 0,
           cache.item_fingerprint(items[0][0]))
    assert cache.BatchCache.entry_name(key) \
        == jax_cache.BatchCache.entry_name(key)
    # The port spills under a directory of its own.
    assert cache.default_cache_dir() != jax_cache.default_cache_dir()
    assert cache.default_cache_dir().endswith(os.path.join(
        "lance_distributed_training_tpu_torch", "batch-cache"))


def _batch(seed, rows=4):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (rows, 16, 16, 3), np.uint8),
            "label": rng.integers(0, 9, rows).astype(np.int32)}


def _script(module, registry, directory, pool):
    """One sequence of cache operations; every observable outcome."""
    log = []
    c = module.BatchCache(cache_dir=str(directory), ram_budget_mb=1,
                          disk_budget_mb=1, buffer_pool=pool,
                          registry=registry)
    big = {"x": np.arange(300_000, dtype=np.int32)}  # 1.2 MB: over RAM
    for i in range(6):
        log.append(("put", i, c.put(("d", "p", 0, f"k{i}"), _batch(i, 40))))
    log.append(("put-dup", c.put(("d", "p", 0, "k1"), _batch(1, 40))))
    log.append(("put-big", c.put(("d", "p", 0, "big"), big)))
    log.append(("put-bad", c.put(("d", "p", 0, "bad"), {"x": [1, 2]})))
    log.append(("stats", c.stats()))
    for i in list(range(6)) + ["big", "nope"]:
        got = c.get(("d", "p", 0, f"k{i}" if isinstance(i, int) else i),
                    pool=pool)
        log.append(("get", i, None if got is None else
                    {k: v.tobytes() for k, v in got.items()}))
    log.append(("contains", c.contains(("d", "p", 0, "k0")),
                c.contains(("d", "p", 0, "zz"))))
    log.append(("shrink", c.set_ram_budget_mb(0), c.stats()))
    # A torn segment (a write cut short) reads as a miss, never as data.
    name = c.entry_name(("d", "p", 0, "k5"))
    path = os.path.join(str(directory), name + ".ldtc")
    if os.path.exists(path):
        with open(path, "r+b") as f:
            f.truncate(40)
    log.append(("torn", c.get(("d", "p", 0, "k5")) is None))
    log.append(("knobs", [(t.name, t.get(), t.lo, t.hi)
                          for t in c.tunables()]))
    c.close()
    # A restarted process adopts what the first left on disk, and reads it.
    c2 = module.BatchCache(cache_dir=str(directory), ram_budget_mb=1,
                           disk_budget_mb=4, registry=registry)
    log.append(("restart", c2.stats()))
    hit = c2.get(("d", "p", 0, "k4"))
    log.append(("restart-get", None if hit is None else
                {k: v.tobytes() for k, v in hit.items()}))
    log.append(("disk-shrink", c2.set_disk_budget_mb(0), c2.stats()))
    c2.close()
    names = ["cache_hit_total", "cache_disk_hit_total", "cache_miss_total",
             "cache_store_total", "cache_spill_total", "cache_evict_total",
             "cache_torn_total", "cache_spill_errors_total"]
    log.append(("counters", [registry.counter(n).value for n in names]))
    log.append(("files", sorted(os.listdir(directory))))
    log.append(("bytes", {f: (directory / f).read_bytes()
                          for f in sorted(os.listdir(directory))}))
    return log


def test_ram_and_disk_tiers_behave_as_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    from lance_distributed_training_tpu.data.buffers import (
        BufferPool as JaxBufferPool,
    )

    want = _script(jax_cache, JaxRegistry(), tmp_path / "jax",
                   JaxBufferPool(registry=JaxRegistry()))
    got = _script(cache, MetricsRegistry(), tmp_path / "port",
                  BufferPool(registry=MetricsRegistry()))
    assert got == want
    kinds = dict((entry[0], entry[1:]) for entry in got)
    assert kinds["put-big"] == (True,) and kinds["put-bad"] == (False,)
    assert kinds["torn"] == (True,)
    counters = kinds["counters"][0]
    assert counters[0] > 0 and counters[4] > 0 and counters[6] == 1
    assert kinds["restart"][0]["disk_entries"] > 0
    assert kinds["restart-get"][0] is not None  # a disk hit after restart


def _admit_all(module, budget_gb, batches, registry, resume_step=0):
    dev = module.DeviceReplayCache(enabled=True, budget_gb=budget_gb,
                                   seed=5, registry=registry)
    filling = dev.start_fill(False, resume_step)
    refused = [dev.admit(b, len(batches)) for b in batches] if filling \
        else []
    return dev, filling, refused


@pytest.mark.parametrize("shuffled", [False, True])
def test_device_replay_cache_equals_jax(shuffled):
    batches = [_batch(i) for i in range(7)]
    want, _, want_refused = _admit_all(jax_cache, 1.0, batches, JaxRegistry())
    got, _, got_refused = _admit_all(cache, 1.0, batches, MetricsRegistry())
    assert got_refused == want_refused == [None] * 7
    assert len(got) == len(want) == 7
    # Not the first executed epoch: replay, in the same seeded order.
    assert got.replay_iter(0, 0, shuffled) is None
    for epoch in (1, 2):
        order_got = [b["label"].tobytes()
                     for b in got.replay_iter(epoch, 0, shuffled)]
        order_want = [b["label"].tobytes()
                      for b in want.replay_iter(epoch, 0, shuffled)]
        assert order_got == order_want
    assert (order_got != [b["label"].tobytes() for b in batches]) == shuffled
    assert cache.per_device_batch_bytes(batches[0]) \
        == jax_cache.per_device_batch_bytes(batches[0])


def test_device_replay_refusal_and_resumed_epoch_equal_jax():
    batches = [_batch(i) for i in range(3)]
    budget = 2.5 * cache.per_device_batch_bytes(batches[0]) / 1e9
    want, _, want_refused = _admit_all(jax_cache, budget, batches,
                                       JaxRegistry())
    got, _, got_refused = _admit_all(cache, budget, batches,
                                     MetricsRegistry())
    assert got_refused == want_refused
    assert got_refused[0]["projected"] > got_refused[0]["budget"]
    assert len(got) == 0 and not got.enabled
    assert got.replay_iter(1, 0, False) is None
    # A partially resumed epoch does not seed the replay set.
    got, filling, _ = _admit_all(cache, 1.0, batches, MetricsRegistry(),
                                 resume_step=2)
    want, want_filling, _ = _admit_all(jax_cache, 1.0, batches,
                                       JaxRegistry(), resume_step=2)
    assert filling is want_filling is False
    assert len(got) == len(want) == 0


def _two_epochs(make, batch_cache):
    out = []
    for epoch in range(2):
        loader = make(epoch)
        # A factory's loader is a compiled LoaderGraph: the cache binds to
        # the engine it compiled to.
        engine = (loader.compile() if isinstance(loader, LoaderGraph)
                  else loader)
        engine.batch_cache = batch_cache
        out.append([_plain(dict(b)) for b in loader])
    return out


@pytest.mark.parametrize("arm", ["iterable", "folder"])
def test_cached_epochs_equal_the_jax_loaders(corpora, tmp_path, arm):
    decode = ImageClassificationDecoder(image_size=SIZE, use_native=False)
    jax_decode = JaxImageDecoder(image_size=SIZE, use_native=False)
    registry = MetricsRegistry()
    batch_cache = cache.BatchCache(cache_dir=str(tmp_path / "bc"),
                                   registry=registry)
    if arm == "iterable":
        ds, jax_ds = Dataset(corpora / "food"), JaxDataset(corpora / "food")

        def make(epoch):
            return make_train_pipeline(ds, "batch", 8, 0, 1, decode, None,
                                       shuffle=True, seed=3, epoch=epoch,
                                       producers=2,
                                       columns=decode.required_columns)

        want = [[_plain(b) for b in jax_make_train_pipeline(
            jax_ds, "batch", 8, 0, 1, jax_decode, shuffle=True, seed=3,
            epoch=epoch)] for epoch in range(2)]
    else:
        root = str(corpora / "tree")

        def make(epoch):
            return FolderDataPipeline(root, 4, 0, 1, decode, None,
                                      loader_style="iterable", shuffle=True,
                                      seed=3, epoch=epoch, producers=2)

        want = [[_plain(b) for b in JaxFolderPipeline(
            root, 4, 0, 1, jax_decode, loader_style="iterable",
            shuffle=True, seed=3, epoch=epoch)] for epoch in range(2)]
    got = _two_epochs(make, batch_cache)
    for g, w in zip(got, want):
        _equal(g, w)
    steps = len(want[0])
    # Epoch 1 filled the cache, epoch 2 read every batch from it (the
    # batch order differs, the content keys do not).
    assert registry.counter("cache_miss_total").value == steps
    assert registry.counter("cache_hit_total").value == steps
    assert registry.counter("cache_store_total").value == steps
    batch_cache.close()
