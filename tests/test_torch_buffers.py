"""The port's buffer pool and pooled decode pages against the JAX package's.

The BufferPool cases of the JAX package's ``tests/test_buffers.py`` run on
both pools side by side and must leave the same ``stats()`` (lease,
release and recycle; the refcount guard; a dropped lease is garbage; a
foreign or double release is a no-op; the free-list cap; keying by shape and
dtype; no two live leases alias one page under threads). The port's own
rule: a page released with a CUDA event recycles only once the event has
completed. Decoding into pool pages equals decoding into fresh pages, and
the JAX decoders, bit for bit, for the pixel, coefficient and token
decoders; the loaders release their host batches; and on the CPU a batch
handed out never aliases a page that goes back to the pool.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.data.buffers import (
    BufferPool as JaxBufferPool,
)
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.device_decode import (
    CoeffImageDecoder as JaxCoeffDecoder,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenDecoder as JaxTokenDecoder,
)
from lance_distributed_training_tpu.obs.registry import MetricsRegistry
from lance_distributed_training_tpu_torch.data import (
    BufferPool,
    CoeffImageDecoder,
    Dataset,
    ImageClassificationDecoder,
    TokenDecoder,
    create_synthetic_classification_dataset,
    create_variable_length_token_dataset,
    default_buffer_pool,
    make_eval_pipeline,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.parallel import make_global_batch
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE = 32


def _pools(**kw):
    return [JaxBufferPool(registry=MetricsRegistry(), **kw), BufferPool(**kw)]


def _both(case, **kw):
    """Run ``case(pool)`` on the JAX pool and on the port's; both return
    the same observations."""
    want, got = (case(pool) for pool in _pools(**kw))
    assert got == want


# -------------------------------------------------------- the JAX pool cases


def test_lease_release_recycle():
    def case(pool):
        a = pool.lease((4, 8), np.uint8)
        first_id = id(a)
        a[:] = 7
        out = [pool.stats()]
        pool.release(a)
        del a
        b = pool.lease((4, 8), np.uint8)
        return out + [id(b) == first_id, pool.stats()]

    _both(case)


def test_release_deferred_while_externally_referenced():
    def case(pool):
        a = pool.lease((16,), np.float32)
        holder = {"x": a}
        pool.release(a)
        del a
        b = pool.lease((16,), np.float32)
        out = [id(b) != id(holder["x"]), pool.stats()]
        del holder
        pool.release(b)
        del b
        c = pool.lease((16,), np.float32)
        d = pool.lease((16,), np.float32)
        out.append(pool.stats())
        del c, d
        return out

    _both(case)


def test_dropped_lease_is_garbage_not_a_leak():
    def case(pool):
        for _ in range(5):
            pool.lease((1024,), np.uint8)
        gc.collect()
        out = [pool.stats()["outstanding"]]
        a = pool.lease((1024,), np.uint8)
        return out + [pool.release(a)]

    _both(case)


def test_release_foreign_and_double_release_are_noops():
    def case(pool):
        a = pool.lease((8,), np.float64)
        return [pool.release(np.zeros(8)), pool.release(a), pool.release(a),
                pool.release_batch({"x": np.ones(3), "y": None}),
                pool.release_batch([a])]

    _both(case)


def test_free_list_cap_evicts():
    def case(pool):
        a, b = pool.lease((8,), np.uint8), pool.lease((8,), np.uint8)
        pool.release(a), pool.release(b)
        del a, b
        pool.lease((4,), np.uint8)
        return pool.stats()

    _both(case, max_free_per_key=1)


def test_keying_by_shape_and_dtype():
    def case(pool):
        a = pool.lease((8,), np.uint8)
        pool.release(a)
        a_id = id(a)
        del a
        b = pool.lease((8,), np.int32)
        c = pool.lease((8,), np.uint8)
        return [id(b) != a_id, id(c) == a_id]

    _both(case)


def test_views_release_their_base_and_ragged_pages_bucket():
    def case(pool):
        page = pool.lease_ragged(300, 5, np.int32)
        out = [page.capacity, page.values.shape, page.offsets.shape,
               pool.release(page.values[:300]), pool.release(page.offsets)]
        del page
        again = pool.lease_ragged(400, 5, np.int32)  # the same bucket
        return out + [pool.stats(), again.capacity]

    _both(case)


@pytest.mark.parametrize("pool_index", [0, 1], ids=["jax", "port"])
def test_concurrent_lease_safety(pool_index):
    """No two live leases alias one page, under threads."""
    pool = _pools()[pool_index]
    errors = []
    live_lock = threading.Lock()
    live = set()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            arr = pool.lease((int(rng.integers(1, 4)), 16), np.uint8)
            addr = arr.__array_interface__["data"][0]
            with live_lock:
                if addr in live:
                    errors.append(addr)
                live.add(addr)
            with live_lock:
                live.discard(addr)
            pool.release(arr)
            del arr

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert pool.stats()["outstanding"] == 0


# ------------------------------------------------------ the port's own rules


class _FakeEvent:
    """A CUDA event's ``query()`` stand-in: done once ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_a_page_recycles_only_after_its_copy_event():
    pool = BufferPool()
    a = pool.lease((32,), np.uint8)
    a_id = id(a)
    event = _FakeEvent()
    assert pool.release(a, event) is True
    del a
    b = pool.lease((32,), np.uint8)  # the copy still reads the old page
    assert id(b) != a_id and pool.stats()["pending"] == 1
    event.done = True
    pool.sweep()
    assert pool.stats() == {"outstanding": 1, "pending": 0, "free": 1}
    c = pool.lease((32,), np.uint8)
    assert id(c) == a_id
    assert pool.counters()["hits"] == 1 and pool.counters()["misses"] == 2


def test_default_pools_are_process_wide_and_split_by_pinning():
    assert default_buffer_pool() is default_buffer_pool()
    assert default_buffer_pool() is not default_buffer_pool(pin_memory=True)
    assert default_buffer_pool(pin_memory=True).pin_memory


def test_cpu_batch_does_not_alias_a_recycled_page():
    """On the CPU ``torch.from_numpy`` would alias the page: the batch
    handed to the step is a copy, so releasing and re-leasing the page
    leaves it unchanged."""
    pool = BufferPool()
    page = pool.lease((4, SIZE, SIZE, 3), np.uint8)
    page[...] = 5
    host = {"image": page, "label": np.arange(4, dtype=np.int32)}
    placed = make_global_batch(host, "cpu", buffer_pool=pool)
    del host, page
    again = pool.lease((4, SIZE, SIZE, 3), np.uint8)  # the same page back
    assert pool.counters()["hits"] == 1
    again[...] = 200
    assert int(placed["image"].min()) == int(placed["image"].max()) == 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pinned_pages_are_page_locked_views(cuda_device):
    pool = BufferPool(pin_memory=True)
    page = pool.lease((3, 5), np.int16)
    page[...] = 3
    assert page.shape == (3, 5) and page.dtype == np.int16
    assert torch.from_numpy(page).is_pinned()
    placed = make_global_batch({"x": page}, cuda_device, buffer_pool=pool)
    torch.cuda.synchronize()
    assert pool.stats()["outstanding"] == 0
    assert int(placed["x"].sum()) == 45


# ------------------------------------------------------------ pooled decode


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("images") / "food")
    create_synthetic_classification_dataset(path, rows=40, num_classes=7,
                                            image_size=SIZE, fragment_size=20,
                                            unique_images=9, seed=4)
    return path


@pytest.fixture(scope="module")
def token_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "ragged")
    create_variable_length_token_dataset(path, rows=48, vocab_size=60,
                                         max_len=40, mean_len=12.0, seed=3,
                                         fragment_size=24)
    return path


def _decoders(kind):
    """``(port decoder with a pool, the pool, port decoder without one,
    the JAX decoder with a pool)``."""
    pool = BufferPool()
    jax_pool = JaxBufferPool(registry=MetricsRegistry())
    if kind == "pixel":
        return (ImageClassificationDecoder(SIZE, use_native=False,
                                           buffer_pool=pool), pool,
                ImageClassificationDecoder(SIZE, use_native=False),
                JaxImageDecoder(image_size=SIZE, use_native=False,
                                buffer_pool=jax_pool))
    if kind == "native":
        return (ImageClassificationDecoder(SIZE, buffer_pool=pool), pool,
                ImageClassificationDecoder(SIZE),
                JaxImageDecoder(image_size=SIZE, buffer_pool=jax_pool))
    if kind == "coeff":
        return (CoeffImageDecoder(SIZE, buffer_pool=pool), pool,
                CoeffImageDecoder(SIZE),
                JaxCoeffDecoder(image_size=SIZE, buffer_pool=jax_pool))
    mode = kind.split("_")[1]
    return (TokenDecoder(mode=mode, seq_len=40, buffer_pool=pool), pool,
            TokenDecoder(mode=mode, seq_len=40),
            JaxTokenDecoder(mode=mode, seq_len=40, buffer_pool=jax_pool))


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("kind", ["pixel", "native", "coeff", "tokens_pad",
                                  "tokens_pack", "tokens_bucket"])
def test_decode_into_pool_pages_is_bit_identical(kind, image_path,
                                                 token_path):
    pooled_dec, pool, plain_dec, jax_dec = _decoders(kind)
    if kind == "native" and plain_dec.arm != "native":
        pytest.skip("the native decoder did not build here")
    ds = Dataset(token_path if kind.startswith("tokens") else image_path)
    table = ds.read_range(0, 0, 16)
    plain = plain_dec(table)
    pooled = pooled_dec(table)
    _same(pooled, plain)
    _same(pooled, jax_dec(table))
    leased = pool.stats()["outstanding"]
    assert leased >= 1
    # Released and decoded again (other rows first, so that a recycled
    # page holds another batch's bytes): still identical.
    assert pool.release_batch(pooled) == leased
    del pooled
    pool.release_batch(pooled_dec(ds.read_range(0, 4, 20)))
    again = pooled_dec(table)
    assert pool.counters()["hits"] >= leased
    _same(again, plain)


def test_coeff_pages_go_back_when_a_later_lease_fails(image_path):
    class FailingPool(BufferPool):
        def lease(self, shape, dtype):
            if self.misses == 3:
                raise MemoryError("pool exhausted")
            return super().lease(shape, dtype)

    pool = FailingPool()
    decoder = CoeffImageDecoder(SIZE, buffer_pool=pool)
    with pytest.raises(MemoryError, match="pool exhausted"):
        decoder(Dataset(image_path).read_range(0, 0, 8))
    assert pool.stats()["outstanding"] == 0 and pool.counters()["misses"] == 3


@pytest.mark.parametrize("producers", [1, 3])
def test_pipeline_releases_host_batches(image_path, producers):
    """Host batches go back after the consumer's turn: the second pass
    rides recycled pages and nothing stays leased."""
    pool = BufferPool()
    decode = ImageClassificationDecoder(SIZE, use_native=False,
                                        buffer_pool=pool)
    pipe = make_train_pipeline(Dataset(image_path), "batch", 8, 0, 1, decode,
                               None, producers=producers, buffer_pool=pool)
    for batch in pipe:
        assert batch["image"].shape == (8, SIZE, SIZE, 3)
        del batch
    for batch in pipe:
        del batch
    assert pool.counters()["hits"] > 0
    assert pool.stats()["outstanding"] == 0
    # The synchronous arm releases at placement, the eval loader as well.
    placed = make_eval_pipeline(
        lambda idx: Dataset(image_path).take(idx), 40, 16, 0, 1, decode,
        "cpu", producers=producers, buffer_pool=pool)
    assert len(list(placed)) == 3
    assert pool.stats()["outstanding"] == 0
