"""The port's worker pool against the JAX package's in-process loaders.

Two spawned workers a pool (module-scoped; the workers import the port,
never JAX), over both transports (shared-memory slots and pickles) and the
three loaders that take a pool (iterable, map-style, folder): every batch
equals the JAX in-process loader's bit for bit. Also the slot layout
against the JAX ring's, the reclaim of abandoned slots, a live resize,
the seam's warnings, decoder pickling, and teardown leaving no process
and no shared-memory segment behind. (The JAX package's own tests hold
its pool to the same in-process loaders, so no JAX worker is spawned.)"""

import glob
import pickle
import time

import numpy as np
import pytest

from lance_distributed_training_tpu.data import buffers as jax_buffers
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.folder import (
    FolderDataPipeline as JaxFolderPipeline,
)
from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.data.pipeline import (
    MapStylePipeline as JaxMapStylePipeline,
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data import (
    BufferPool,
    Dataset,
    FolderDataPipeline,
    ImageClassificationDecoder,
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    create_synthetic_classification_dataset,
    create_synthetic_image_folder,
    create_variable_length_token_dataset,
    make_map_style_pipeline,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.data import buffers
from lance_distributed_training_tpu_torch.data.authoring import (
    _folder_samples,
)
from lance_distributed_training_tpu_torch.data.cache import BatchCache
from lance_distributed_training_tpu_torch.data.workers import (
    WorkerPool,
    columnar_spec,
    folder_spec,
)
from lance_distributed_training_tpu_torch.obs.registry import (
    MetricsRegistry,
    default_registry,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE = 32
COLUMNS = ["image", "label"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("workers")
    create_synthetic_classification_dataset(
        str(root / "food"), rows=40, num_classes=4, image_size=SIZE,
        fragment_size=12)
    create_synthetic_image_folder(str(root / "tree"), rows=18, num_classes=3,
                                  image_size=SIZE)
    return root


def _decoders():
    return (ImageClassificationDecoder(image_size=SIZE, use_native=False),
            JaxImageDecoder(image_size=SIZE, use_native=False))


@pytest.fixture(scope="module")
def pools(corpora):
    """``pools(kind, transport)``: one two-worker pool per pair, spawned at
    first use and shut down with the module."""
    made = {}

    def get(kind, transport):
        if (kind, transport) not in made:
            decode, _ = _decoders()
            if kind == "folder":
                samples, _ = _folder_samples(str(corpora / "tree"))
                spec, columns = folder_spec(samples), None
            else:
                spec, columns = columnar_spec(str(corpora / "food")), COLUMNS
            made[kind, transport] = WorkerPool(
                spec, decode, 2, columns=columns, transport=transport,
                buffer_pool=BufferPool())
        return made[kind, transport]

    yield get
    for pool in made.values():
        pool.shutdown()


def _copies(batches):
    return [{k: np.array(v) for k, v in b.items()} for b in batches]


def _equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], np.asarray(w[key]))


def _fallbacks():
    return default_registry().counter("shm_fallback_total").value


def _loaders(corpora, arm, decode, jax_decode, workers=None, epoch=1):
    """``(port loader, JAX in-process loader)`` of one arm and epoch."""
    if arm == "iterable":
        port = make_train_pipeline(
            Dataset(corpora / "food"), "batch", 8, 0, 1, decode, None,
            shuffle=True, seed=3, epoch=epoch, workers=workers,
            columns=COLUMNS)
        jax = jax_make_train_pipeline(
            JaxDataset(corpora / "food"), "batch", 8, 0, 1, jax_decode,
            shuffle=True, seed=3, epoch=epoch, columns=COLUMNS)
    elif arm == "map":
        port = make_map_style_pipeline(
            Dataset(corpora / "food"), 8, 0, 1, decode, None, seed=3,
            epoch=epoch, columns=COLUMNS, workers=workers)
        jax = JaxMapStylePipeline(
            JaxDataset(corpora / "food"), 8, 0, 1, jax_decode, seed=3,
            epoch=epoch, columns=COLUMNS)
    else:
        root = str(corpora / "tree")
        port = FolderDataPipeline(root, 4, 0, 1, decode, None, seed=3,
                                  epoch=epoch, workers=workers)
        jax = JaxFolderPipeline(root, 4, 0, 1, jax_decode, seed=3,
                                epoch=epoch)
    return port, jax


@pytest.mark.parametrize("transport", ["shm", "pickle"])
@pytest.mark.parametrize("arm", ["iterable", "map", "folder"])
def test_worker_batches_equal_the_jax_in_process_loader(corpora, pools, arm,
                                                        transport):
    decode, jax_decode = _decoders()
    pool = pools("folder" if arm == "folder" else "columnar", transport)
    assert pool.transport == transport
    fallbacks = _fallbacks()
    port, jax = _loaders(corpora, arm, decode, jax_decode, workers=pool)
    _equal(_copies(port), list(jax))
    assert _fallbacks() == fallbacks  # every shm batch rode a slot


def test_cached_second_epoch_skips_the_pool(corpora, pools, tmp_path):
    decode, jax_decode = _decoders()
    pool = pools("columnar", "shm")
    registry = MetricsRegistry()
    batch_cache = BatchCache(cache_dir=str(tmp_path / "bc"),
                             registry=registry)
    results = default_registry().histogram("workers_result_wait_ms")
    for epoch in (1, 2):
        before = results.count
        port, jax = _loaders(corpora, "iterable", decode, jax_decode,
                             workers=pool, epoch=epoch)
        # A factory's loader is a compiled LoaderGraph: the cache binds to
        # the engine it compiled to.
        port.compile().batch_cache = batch_cache
        _equal(_copies(port), list(jax))
        # Epoch 1 decodes every batch in the pool; epoch 2 none.
        assert results.count - before == (len(port) if epoch == 1 else 0)
    assert registry.counter("cache_hit_total").value == len(port)
    assert registry.counter("cache_miss_total").value == len(port)
    batch_cache.close()


@pytest.mark.parametrize("transport", ["shm", "pickle"])
def test_workers_import_no_torch_and_no_jax(corpora, pools, transport):
    """A worker loads the data plane it needs and nothing of torch (no CUDA
    library, so no context and a short spawn) nor of JAX."""
    pool = pools("columnar", transport)
    assert len(list(pool.imap([np.arange(4)]))) == 1
    probe = ("sorted(m for m in __import__('sys').modules if m in "
             "('torch', 'jax', 'lance_distributed_training_tpu'))")
    assert pool._pool.submit(eval, probe).result(timeout=60) == []


def test_slot_layout_equals_the_jax_ring():
    rng = np.random.default_rng(0)
    for n in (0, 1, 4095, 4096, 4097, 77 * 2 ** 20, 123457):
        assert buffers._round_slot_size(n) == jax_buffers._round_slot_size(n)
    batch = {"image": rng.integers(0, 256, (3, 7, 5, 3), np.uint8),
             "label": np.arange(3, dtype=np.int32),
             "jpeg_quant": np.ones((3, 3, 64), np.int32)}
    assert buffers._plan_layout(batch) == jax_buffers._plan_layout(batch)
    assert buffers._plan_layout({"x": [1]}) is None
    assert buffers._slot_name("abc", 3) == jax_buffers._slot_name("abc", 3)


def test_abandoned_items_hand_their_slots_back(corpora, pools):
    pool = pools("columnar", "shm")
    ring = pool._ring
    plan = list(make_train_pipeline(Dataset(corpora / "food"), "batch", 8, 0,
                                    1, _decoders()[0], None).plan) * 3
    it = pool.imap(plan, window=4)
    next(it)
    it.close()  # four in flight, abandoned
    deadline = time.monotonic() + 30
    while ring._free_q.qsize() < ring.nslots and time.monotonic() < deadline:
        time.sleep(0.05)
    assert ring._free_q.qsize() == ring.nslots
    assert len(list(pool.imap(plan[:3]))) == 3  # the ring still serves


def test_resize_keeps_the_stream(corpora, pools):
    decode, jax_decode = _decoders()
    pool = pools("columnar", "pickle")
    [knob] = pool.tunables()
    assert knob.name == "workers" and knob.lo == 1
    assert pool.resize(3) == 3 and pool.num_workers == 3
    port, jax = _loaders(corpora, "map", decode, jax_decode, workers=pool)
    _equal(_copies(port), list(jax))
    assert knob.set(2) == 2 and pool.resize(2) == 2


def test_the_seam_warns_as_jax(corpora, pools):
    decode, _ = _decoders()
    pool = pools("columnar", "pickle")
    loader = make_train_pipeline(Dataset(corpora / "food"), "batch", 8, 0, 1,
                                 decode, None, workers=pool, producers=4,
                                 columns=["image"])
    with pytest.warns(UserWarning) as caught:
        it = iter(loader)
        next(it)
        it.close()
    text = " ".join(str(w.message) for w in caught)
    assert "producers>1 has no effect" in text
    assert "differ from the WorkerPool's" in text


def test_decoders_pickle_without_their_pool(corpora, tmp_path):
    table = Dataset(corpora / "food").take(np.arange(6), columns=COLUMNS)
    pool = BufferPool()
    image = ImageClassificationDecoder(image_size=SIZE, buffer_pool=pool)
    copy = pickle.loads(pickle.dumps(image))
    assert copy.buffer_pool is None and copy.arm == image.arm
    assert copy.cache_fingerprint() == image.cache_fingerprint()
    np.testing.assert_array_equal(copy(table)["image"], image(table)["image"])
    create_variable_length_token_dataset(str(tmp_path / "toks"), rows=12,
                                         vocab_size=50, max_len=16,
                                         mean_len=6)
    tokens = Dataset(tmp_path / "toks").take(np.arange(12))
    text = TokenDecoder(mode="pack", seq_len=16, buffer_pool=pool,
                        planner=TokenPackPlanner(TokenPackConfig(
                            pack_len=16, rows_multiple=2)))
    text_copy = pickle.loads(pickle.dumps(text))
    assert text_copy.buffer_pool is None
    a, b = text(tokens), text_copy(tokens)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert text_copy.counters() == text.counters()
    assert [t.name for t in text_copy.tunables()] == ["pack_len",
                                                      "pack_rows_quantum"]


def test_shutdown_leaves_no_process_and_no_segment(corpora):
    pool = WorkerPool(columnar_spec(str(corpora / "food")), _decoders()[0],
                      2, columns=COLUMNS, buffer_pool=BufferPool())
    plan = make_train_pipeline(Dataset(corpora / "food"), "batch", 8, 0, 1,
                               _decoders()[0], None).plan
    assert len(list(pool.imap(plan))) == len(plan)
    session = pool._ring.session
    procs = list(pool._pool._processes.values())
    assert procs and all(p.is_alive() for p in procs)
    assert glob.glob(f"/dev/shm/ldtshm_{session}_*")
    pool.shutdown()
    assert pool.closed
    for p in procs:
        p.join(timeout=10)
        assert not p.is_alive()
    assert glob.glob(f"/dev/shm/ldtshm_{session}_*") == []
    pool.shutdown()  # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        next(pool.imap(plan))
