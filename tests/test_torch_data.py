"""The port's data plane against the JAX package's, bit for bit.

Each package reads the datasets the other writes; the port's sampler plans,
decoders and loader yield exactly the JAX package's plans and batches for
the same ``(sampler_type, batch_size, process_index, process_count,
shuffle, seed, epoch)``. The image half: both packages author the same
JPEG bytes from a seed, the image decoder gives the JAX decoder's pixels in
its native and its PIL arm, and the eval loader the JAX eval loader's
batches, order, pads and ``_weight``.
"""

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.data import authoring as jax_authoring
from lance_distributed_training_tpu.data import format as jax_format
from lance_distributed_training_tpu.data import samplers as jax_samplers
from lance_distributed_training_tpu.data.decode import (
    decoder_for_task as jax_decoder_for_task,
)
from lance_distributed_training_tpu.data.decode import (
    numeric_decoder as jax_numeric_decoder,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenDecoder as JaxTokenDecoder,
)
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    create_text_token_dataset,
    decoder_for_task,
    make_plan,
    make_train_pipeline,
    numeric_decoder,
)
from lance_distributed_training_tpu_torch.data.token_pack import TokenDecoder
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import privatise_jax_native


SEQ = 12
ROWS = 61  # 5 fragments of 13 rows, the last one short


def _docs(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 1000, int(n)).tolist()
            for n in rng.integers(3, SEQ + 4, rows)]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same documents written once by each package."""
    root = tmp_path_factory.mktemp("tokens")
    docs = _docs()
    jax_authoring.create_text_token_dataset(
        str(root / "by_jax"), docs, seq_len=SEQ, fragment_size=13, pack=False)
    create_text_token_dataset(str(root / "by_port"), docs, seq_len=SEQ,
                              fragment_size=13, pack=False)
    return root / "by_jax", root / "by_port"


def _tables_equal(a, b):
    assert a.schema == b.schema
    assert a.to_pydict() == b.to_pydict()


@pytest.mark.parametrize("writer", ["by_jax", "by_port"])
def test_each_package_reads_the_others_dataset(datasets, writer):
    path = datasets[0] if writer == "by_jax" else datasets[1]
    port, jax_ds = Dataset(path), jax_format.Dataset(path)
    assert port.fragment_rows() == jax_ds.fragment_rows() == [13] * 4 + [9]
    assert port.count_rows() == jax_ds.count_rows() == ROWS
    _tables_equal(port.read_range(1, 2, 11), jax_ds.read_range(1, 2, 11))
    idx = [60, 0, 14, 27, 13]
    _tables_equal(port.take(idx), jax_ds.take(idx))


def test_writers_produce_the_same_rows(datasets):
    by_jax, by_port = Dataset(datasets[0]), Dataset(datasets[1])
    assert by_jax.fragment_rows() == by_port.fragment_rows()
    _tables_equal(by_jax.take(range(ROWS)), by_port.take(range(ROWS)))


PLANS = [
    ("batch", False, 0, 1),
    ("batch", True, 0, 1),
    ("batch", True, 1, 2),
    ("batch", False, 2, 3),
    ("fragment", False, 0, 1),
    ("fragment", False, 1, 2),
    ("full", False, 0, 1),
]


@pytest.mark.parametrize("sampler,shuffle,index,count", PLANS)
def test_plans_match(sampler, shuffle, index, count):
    rows = [13, 13, 13, 13, 9, 0, 4]
    for epoch in (0, 3):
        want = jax_samplers.make_plan(sampler, rows, 5, index, count,
                                      shuffle=shuffle, seed=11, epoch=epoch)
        got = make_plan(sampler, rows, 5, index, count, shuffle=shuffle,
                        seed=11, epoch=epoch)
        assert [[tuple(r) for r in step] for step in got] == \
            [[tuple(r) for r in step] for step in want]


@pytest.mark.parametrize("sampler,shuffle,index,count",
                         [p for p in PLANS if p[0] != "full"])
def test_loader_batches_match_jax_bit_for_bit(datasets, sampler, shuffle,
                                              index, count):
    path = datasets[1]
    kw = dict(shuffle=shuffle, seed=5, epoch=2)
    want = list(jax_make_train_pipeline(
        jax_format.Dataset(path), sampler, 7, index, count,
        jax_decoder_for_task("masked_lm", seq_len=SEQ), **kw))
    got = list(make_train_pipeline(
        Dataset(path), sampler, 7, index, count,
        decoder_for_task("masked_lm", seq_len=SEQ), "cpu", **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            arr = g[key].numpy()
            assert arr.dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(arr, np.asarray(w[key]))


def test_decoders_match_on_variable_length_rows(tmp_path):
    jax_authoring.create_variable_length_token_dataset(
        str(tmp_path / "ragged"), rows=40, max_len=30, mean_len=10, seed=2,
        include_mask=True)
    table = Dataset(tmp_path / "ragged").take(range(40))
    want = JaxTokenDecoder(mode="pad", seq_len=16)(table)
    got = TokenDecoder(mode="pad", seq_len=16)(table)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    want = jax_numeric_decoder(table)
    got = numeric_decoder(table)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_pack_mode_and_image_tasks_not_yet_ported():
    # Pack mode is ported (tests/test_torch_token_pack.py); an unknown mode
    # raises as in the JAX package. The contrastive decoder is ported
    # (tests/test_torch_contrastive.py).
    assert TokenDecoder(mode="pack").mode == "pack"
    with pytest.raises(ValueError, match="invalid TokenDecoder mode"):
        TokenDecoder(mode="ffd")
    assert type(decoder_for_task("contrastive")).__name__ == "ImageTextDecoder"
    # Device decode is ported for classification and for nothing else.
    for task_type in ("masked_lm", "contrastive"):
        with pytest.raises(ValueError, match="classification"):
            decoder_for_task(task_type, device_decode=True)


# ------------------------------------------------------------- image data

IMAGE_SIZE = 32
IMAGE_ROWS = 45  # fragments of 20, 20, 5


@pytest.fixture(scope="module")
def image_datasets(tmp_path_factory):
    """The same synthetic JPEG dataset written once by each package."""
    from lance_distributed_training_tpu_torch.data import (
        create_synthetic_classification_dataset,
    )

    root = tmp_path_factory.mktemp("images")
    kw = dict(rows=IMAGE_ROWS, num_classes=7, image_size=IMAGE_SIZE,
              fragment_size=20, unique_images=12, seed=3)
    jax_authoring.create_synthetic_classification_dataset(
        str(root / "by_jax"), **kw)
    create_synthetic_classification_dataset(str(root / "by_port"), **kw)
    return root / "by_jax", root / "by_port"


def test_image_writers_produce_the_same_bytes(image_datasets):
    from lance_distributed_training_tpu_torch.data import IMAGE_SCHEMA

    by_jax, by_port = (Dataset(p) for p in image_datasets)
    assert by_port.schema == IMAGE_SCHEMA == jax_authoring.IMAGE_SCHEMA
    assert by_jax.fragment_rows() == by_port.fragment_rows() == [20, 20, 5]
    _tables_equal(by_jax.take(range(IMAGE_ROWS)),
                  by_port.take(range(IMAGE_ROWS)))


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native decoder, built privately for this test:
    its own build links every process into one shared temp file, which
    concurrent test workers can break (``native/jpeg.py:52``)."""
    return privatise_jax_native(monkeypatch, tmp_path)


@pytest.mark.parametrize("arm", ["native", "pil"])
@pytest.mark.parametrize("size", [IMAGE_SIZE, 24, 40])
def test_image_decoder_matches_jax_bit_for_bit(image_datasets, jax_native,
                                               arm, size):
    from lance_distributed_training_tpu.data.decode import (
        ImageClassificationDecoder as JaxImageDecoder,
    )
    from lance_distributed_training_tpu_torch.data import (
        ImageClassificationDecoder,
    )

    table = Dataset(image_datasets[1]).take(range(IMAGE_ROWS))
    use_native = arm == "native"
    want_dec = JaxImageDecoder(image_size=size, use_native=use_native)
    got_dec = ImageClassificationDecoder(image_size=size,
                                         use_native=use_native)
    assert got_dec.arm == arm
    assert (want_dec._native is not None) == use_native
    want, got = want_dec(table), got_dec(table)
    assert sorted(got) == sorted(want) == ["image", "label"]
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    assert got["image"].shape == (IMAGE_ROWS, size, size, 3)
    # The per-payload entry point gives the same pixels as the column one.
    payloads = table.column("image").to_pylist()[:5]
    np.testing.assert_array_equal(got_dec.decode_payloads(payloads),
                                  want["image"][:5])


def test_image_decoder_arm_and_task_dispatch():
    from lance_distributed_training_tpu_torch.data import (
        ImageClassificationDecoder,
    )
    from lance_distributed_training_tpu_torch.native import native_available

    dec = decoder_for_task("classification", image_size=48)
    assert isinstance(dec, ImageClassificationDecoder)
    assert dec.image_size == 48 and dec.required_columns == ["image", "label"]
    assert dec.arm == ("native" if native_available() else "pil")
    assert ImageClassificationDecoder(use_native=False).arm == "pil"
    with pytest.raises(ValueError, match="classification"):
        decoder_for_task("masked_lm", device_decode=True)


@pytest.mark.parametrize("rows,batch,count", [(45, 8, 1), (45, 8, 2),
                                              (40, 8, 4), (3, 6, 3),
                                              (0, 4, 1)])
def test_eval_plans_match(rows, batch, count):
    from lance_distributed_training_tpu_torch.data import (
        padded_eval_index_batches,
    )

    for index in range(count):
        want = jax_samplers.padded_eval_index_batches(rows, batch, index,
                                                      count)
        got = padded_eval_index_batches(rows, batch, index, count)
        assert len(got) == len(want)
        for (gi, gw), (wi, ww) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gw, ww)
            assert gw.dtype == ww.dtype == np.float32


@pytest.mark.parametrize("index,count", [(0, 1), (1, 2)])
def test_eval_loader_matches_jax(image_datasets, index, count):
    from lance_distributed_training_tpu.data.pipeline import (
        make_eval_pipeline as jax_make_eval_pipeline,
    )
    from lance_distributed_training_tpu_torch.data import (
        ImageClassificationDecoder,
        make_eval_pipeline,
    )

    path = image_datasets[1]
    jax_ds, port_ds = jax_format.Dataset(path), Dataset(path)
    dec = ImageClassificationDecoder(image_size=IMAGE_SIZE, use_native=False)
    want = list(jax_make_eval_pipeline(
        lambda idx: jax_ds.take(idx), IMAGE_ROWS, 16, index, count, dec))
    got = list(make_eval_pipeline(
        lambda idx: port_ds.take(idx), IMAGE_ROWS, 16, index, count, dec,
        "cpu"))
    assert len(got) == len(want) == 3  # 45 rows: 48 slots, 3 of them pads
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["_weight", "image", "label"]
        for key in w:
            arr = g[key].numpy()
            assert arr.dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(arr, np.asarray(w[key]))
    # Rank 1 of 2 holds rows 8-15, 24-31 and 40-47 of the padded 48.
    weights = np.concatenate([g["_weight"].numpy() for g in got])
    assert weights.sum() == (IMAGE_ROWS if count == 1 else 21)


def test_train_pipeline_carries_image_pages_unchanged(image_datasets):
    from lance_distributed_training_tpu_torch.data import (
        ImageClassificationDecoder,
    )

    dec = ImageClassificationDecoder(image_size=IMAGE_SIZE)
    ds = Dataset(image_datasets[1])
    loader = make_train_pipeline(ds, "batch", 16, 0, 1, dec, "cpu")
    host = list(loader.host_batches())
    staged = list(loader)
    assert len(staged) == len(host) == 2
    for g, w in zip(staged, host):
        assert g["image"].dtype == torch.uint8
        assert tuple(g["image"].shape) == (16, IMAGE_SIZE, IMAGE_SIZE, 3)
        assert g["label"].dtype == torch.int32
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])
