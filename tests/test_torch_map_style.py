"""The port's map-style loader, row filters and val split against the JAX
package's, on the CPU.

The samplers (``distributed_indices``, ``distributed_index_batches``,
``slice_plan``), the filter grammar and pools, the seeded val split, the
map-style loader's host batches (one and two processes, epochs 0 and 1, a
filter pool, a resume cursor, the image and text decoders), the pooled eval
loader, three SGD steps on map-style batches (float64 trunk, ``rtol
1e-5``), the CLI under ``--loader_style map --filter --val_fraction``, a
drain and resume under it bit for bit, and every refusal of the loader
combinations with the JAX trainer's message.
"""

import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data import filters as jax_filters
from lance_distributed_training_tpu.data import format as jax_format
from lance_distributed_training_tpu.data import samplers as jax_samplers
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.decode import (
    decoder_for_task as jax_decoder_for_task,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_eval_pipeline as jax_make_eval_pipeline,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_map_style_pipeline as jax_make_map_style_pipeline,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenPackConfig as JaxTokenPackConfig,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    ImageClassificationDecoder,
    TokenPackConfig,
    create_synthetic_classification_dataset,
    create_variable_length_token_dataset,
    decoder_for_task,
    distributed_index_batches,
    distributed_indices,
    make_eval_pipeline,
    make_map_style_pipeline,
    parse_predicate,
    predicate_mask,
    slice_plan,
    write_dataset,
)
from test_torch_classification import BATCH, RTOL, SIZE, _three_sgd_steps
from test_torch_resume import (
    _assert_resumed_equals,
    _assert_same_params,
    _run,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROWS = 45  # fragments of 20, 20, 5


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_samplers_match_jax(shuffle, epoch, drop_last, count):
    for rows in (0, 1, 10, 31):
        for rank in range(count):
            kw = dict(shuffle=shuffle, seed=11, epoch=epoch,
                      drop_last=drop_last)
            want = jax_samplers.distributed_indices(rows, rank, count, **kw)
            got = distributed_indices(rows, rank, count, **kw)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            for batch in (1, 4, 7):
                want_b = jax_samplers.distributed_index_batches(
                    rows, batch, rank, count, **kw)
                got_b = distributed_index_batches(rows, batch, rank, count,
                                                  **kw)
                assert len(got_b) == len(want_b)
                for g, w in zip(got_b, want_b):
                    np.testing.assert_array_equal(g, w)
                for start in range(len(want_b) + 1):
                    assert [b.tolist() for b in slice_plan(got_b, start)] \
                        == [b.tolist() for b in
                            jax_samplers.slice_plan(want_b, start)]


@pytest.mark.parametrize("start", [-1, 5])
def test_slice_plan_refuses_a_cursor_outside_the_plan(start):
    plan = [[0], [1], [2], [3]]
    with pytest.raises(ValueError) as want:
        jax_samplers.slice_plan(plan, start)
    with pytest.raises(ValueError) as got:
        slice_plan(plan, start)
    assert str(got.value) == str(want.value)
    assert "outside plan of 4 steps" in str(got.value)


# ----------------------------------------------------------------- filters


@pytest.fixture(scope="module")
def table_path(tmp_path_factory):
    """Labels, names and scores over 37 rows in fragments of 10."""
    rng = np.random.default_rng(4)
    rows = 37
    table = pa.table({
        "label": pa.array(rng.integers(0, 8, rows), pa.int64()),
        "name": pa.array([f"n{int(i)}" for i in rng.integers(0, 4, rows)]),
        "score": pa.array(rng.random(rows)),
    })
    path = str(tmp_path_factory.mktemp("table") / "t")
    write_dataset(table, path, max_rows_per_file=10, chunk_rows=4)
    return path


PREDICATES = [
    "label < 3",
    "label >= 2 & label != 4",
    " label == 5 ",
    "name == 'n2'",
    'name != "n1" & score > 0.25',
    "score <= 0.5 & label > 1 & label < 7",
    "label > 100",
]


@pytest.mark.parametrize("predicate", PREDICATES + ["expr", "callable"])
def test_filter_pools_match_jax(table_path, predicate):
    jax_ds, port_ds = jax_format.Dataset(table_path), Dataset(table_path)
    if predicate == "expr":
        want = jax_ds.filter_indices(pc.field("label") < 4)
        got = port_ds.filter_indices(pc.field("label") < 4)
    elif predicate == "callable":
        def odd(table):
            return np.asarray(table.column("label")) % 2 == 1
        want, got = jax_ds.filter_indices(odd), port_ds.filter_indices(odd)
    else:
        assert parse_predicate(predicate).equals(
            jax_filters.parse_predicate(predicate))
        want = jax_ds.filter_indices(predicate)
        got = port_ds.filter_indices(predicate)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) > 0)
    if predicate == "label > 100":
        assert got.size == 0


@pytest.mark.parametrize("predicate,match", [
    ("label ~ 3", "bad predicate term"),
    ("label <", "bad predicate term"),
    ("3 < label", "bad predicate term"),
    ("label < foo", "unparseable literal"),
    ("label < 'x", "unparseable literal"),
    (" & ", "empty predicate"),
])
def test_filter_errors_match_jax(predicate, match):
    with pytest.raises(ValueError) as want:
        jax_filters.parse_predicate(predicate)
    with pytest.raises(ValueError, match=match) as got:
        parse_predicate(predicate)
    assert str(got.value) == str(want.value)


def test_callable_predicate_of_the_wrong_shape_raises_as_jax(table_path):
    table = Dataset(table_path).take(np.arange(5))
    with pytest.raises(ValueError) as want:
        jax_filters.predicate_mask(table, lambda t: np.ones(3, bool))
    with pytest.raises(ValueError) as got:
        predicate_mask(table, lambda t: np.ones(3, bool))
    assert str(got.value) == str(want.value)


def test_dataset_metadata_methods_match_jax(table_path):
    jax_ds, port_ds = jax_format.Dataset(table_path), Dataset(table_path)
    assert port_ds.fingerprint() == jax_ds.fingerprint()
    assert [tuple(f.__dict__.values()) for f in port_ds.get_fragments()] == \
        [tuple(f.__dict__.values()) for f in jax_ds.get_fragments()]
    for kw in ({}, dict(fragment_ids=[2, 0], batch_size=3,
                        columns=["label"])):
        got = [b.to_pydict() for b in port_ds.scan(**kw)]
        want = [b.to_pydict() for b in jax_ds.scan(**kw)]
        assert got == want
    idx = [36, 0, 11, 5]
    assert port_ds.take_batch(idx).equals(jax_ds.take_batch(idx))


# --------------------------------------------------------------- val split


def _split_config(**kw):
    base = dict(dataset_path="-", batch_size=8, seed=3, val_fraction=0.25)
    base.update(kw)
    return (jax_trainer.TrainConfig(**base), trainer.TrainConfig(**base))


@pytest.mark.parametrize("pool", ["all", "filtered"])
@pytest.mark.parametrize("fraction", [0.25, 0.5])
def test_val_split_matches_jax(table_path, pool, fraction):
    ds = Dataset(table_path)
    index_pool = ds.filter_indices("label != 3") if pool == "filtered" \
        else None
    want_cfg, got_cfg = _split_config(val_fraction=fraction)
    want = jax_trainer._split_val_pool(want_cfg, jax_format.Dataset(
        table_path), index_pool)
    got = trainer._split_val_pool(got_cfg, ds, index_pool)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    train, val = got
    assert np.intersect1d(train, val).size == 0
    assert len(train) + len(val) == (ds.count_rows() if index_pool is None
                                     else len(index_pool))


def test_val_split_warns_as_jax_when_raised_to_one_batch(table_path):
    ds = Dataset(table_path)
    want_cfg, got_cfg = _split_config(val_fraction=0.05)
    with pytest.warns(UserWarning) as want:
        jax_trainer._split_val_pool(want_cfg, ds, None)
    with pytest.warns(UserWarning, match="raised to one global batch") as got:
        _, val = trainer._split_val_pool(got_cfg, ds, None)
    assert str(got[0].message) == str(want[0].message)
    assert len(val) == 8


@pytest.mark.parametrize("kw,match", [
    (dict(batch_size=20), "at least two global batches"),
    (dict(val_fraction=0.9), "leaves fewer than one global batch"),
])
def test_val_split_errors_match_jax(table_path, kw, match):
    ds = Dataset(table_path)
    want_cfg, got_cfg = _split_config(**kw)
    with pytest.raises(ValueError) as want:
        jax_trainer._split_val_pool(want_cfg, ds, None)
    with pytest.raises(ValueError, match=match) as got:
        trainer._split_val_pool(got_cfg, ds, None)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------- map-style loader


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("images") / "food")
    create_synthetic_classification_dataset(path, rows=ROWS, num_classes=7,
                                            image_size=SIZE, fragment_size=20,
                                            unique_images=12, seed=3)
    return path


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            arr = g[key] if key.startswith("_host_") else g[key].numpy()
            assert arr.dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(arr, np.asarray(w[key]),
                                          err_msg=key)


def _image_decoders():
    return (JaxImageDecoder(image_size=SIZE, use_native=False),
            ImageClassificationDecoder(image_size=SIZE, use_native=False))


@pytest.mark.parametrize("count,epoch,pool,cursor", [
    (1, 0, False, 0), (1, 1, False, 0), (2, 0, False, 0), (2, 1, False, 0),
    (1, 1, True, 0), (2, 0, True, 0), (1, 0, False, 2), (2, 1, True, 1),
])
def test_map_style_batches_match_jax(image_path, count, epoch, pool, cursor):
    jax_ds, port_ds = jax_format.Dataset(image_path), Dataset(image_path)
    index_pool = port_ds.filter_indices("label < 5") if pool else None
    want_dec, got_dec = _image_decoders()
    for rank in range(count):
        kw = dict(seed=5, epoch=epoch, columns=["image", "label"],
                  index_pool=index_pool)
        want_loader = jax_make_map_style_pipeline(jax_ds, 6, rank, count,
                                                  want_dec, **kw)
        got_loader = make_map_style_pipeline(port_ds, 6, rank, count,
                                             got_dec, "cpu", **kw)
        assert len(got_loader) == len(want_loader)
        if cursor:
            state = {"epoch": epoch, "step": cursor}
            want_loader.load_state_dict(state)
            got_loader.load_state_dict(state)
        _assert_batches_equal(list(got_loader), list(want_loader))
        assert got_loader.state_dict() == want_loader.state_dict() == {
            "epoch": epoch, "step": len(got_loader)}


def test_map_style_epochs_reshuffle_and_the_cursor_carries_the_epoch(
        image_path):
    ds = Dataset(image_path)
    decode = ImageClassificationDecoder(image_size=SIZE, use_native=False)
    loader = make_map_style_pipeline(ds, 8, 0, 1, decode, "cpu", seed=1)
    epoch0 = [b["label"].tolist() for b in loader]
    loader.set_epoch(1)
    assert loader.state_dict() == {"epoch": 1, "step": 0}
    epoch1 = [b["label"].tolist() for b in loader]
    assert len(epoch0) == len(epoch1) == ROWS // 8 and epoch0 != epoch1
    # A cursor names its epoch: loading it rebuilds that epoch's plan.
    loader.load_state_dict({"epoch": 0, "step": 3})
    assert [b["label"].tolist() for b in loader] == epoch0[3:]
    loader.load_state_dict({"epoch": 0, "step": 9})
    with pytest.raises(ValueError, match="outside plan of 5 steps"):
        iter(loader).__next__()
    with pytest.raises(ValueError, match="negative resume cursor"):
        loader.load_state_dict({"epoch": 0, "step": -1})


@pytest.mark.parametrize("task", ["masked_lm", "causal_lm_pack"])
def test_map_style_text_batches_match_jax(tmp_path, task):
    path = str(tmp_path / "ragged")
    create_variable_length_token_dataset(path, rows=70, vocab_size=50,
                                         max_len=40, mean_len=10.0, seed=2,
                                         fragment_size=25)
    if task == "masked_lm":
        want_dec = jax_decoder_for_task("masked_lm", seq_len=40)
        got_dec = decoder_for_task("masked_lm", seq_len=40)
    else:
        cfg = dict(pack_len=40, rows_multiple=2)
        want_dec = jax_decoder_for_task(
            "causal_lm", seq_len=40, token_pack=JaxTokenPackConfig(**cfg))
        got_dec = decoder_for_task("causal_lm", seq_len=40,
                                   token_pack=TokenPackConfig(**cfg))
    kw = dict(seed=2, epoch=1)
    want = list(jax_make_map_style_pipeline(jax_format.Dataset(path), 16, 0,
                                            1, want_dec, **kw))
    got = list(make_map_style_pipeline(Dataset(path), 16, 0, 1, got_dec,
                                       "cpu", **kw))
    assert len(got) == 4
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("count", [1, 2])
def test_pooled_eval_loader_matches_jax(image_path, count):
    port_ds, jax_ds = Dataset(image_path), jax_format.Dataset(image_path)
    pool = port_ds.filter_indices("label >= 2")
    want_dec, got_dec = _image_decoders()
    for rank in range(count):
        want = list(jax_make_eval_pipeline(
            lambda idx: jax_ds.take(idx), ROWS, 16, rank, count, want_dec,
            index_pool=pool))
        got = list(make_eval_pipeline(
            lambda idx: port_ds.take(idx), ROWS, 16, rank, count, got_dec,
            "cpu", index_pool=pool))
        _assert_batches_equal(got, want)
        weights = np.concatenate([g["_weight"].numpy() for g in got])
        if count == 1:
            assert weights.sum() == len(pool)
            labels = np.concatenate([g["label"].numpy() for g in got])
            assert np.all(labels[weights > 0] >= 2)


def test_three_sgd_steps_on_map_style_batches_match_jax(monkeypatch,
                                                        tmp_path):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=40, num_classes=10,
                                            image_size=SIZE, fragment_size=16)
    port_ds = Dataset(path)
    pool = port_ds.filter_indices("label != 0")
    want_dec, got_dec = _image_decoders()
    kw = dict(seed=9, epoch=1, index_pool=pool)
    want = list(jax_make_map_style_pipeline(jax_format.Dataset(path), BATCH,
                                            0, 1, want_dec, **kw))[:3]
    got = list(make_map_style_pipeline(port_ds, BATCH, 0, 1, got_dec, "cpu",
                                       **kw))[:3]
    _assert_batches_equal(got, want)
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in want]
    want_l, got_l, want_var, _, task = _three_sgd_steps(monkeypatch, 0.0,
                                                        batches)
    assert want_l[0] != want_l[2]
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL)
    np.testing.assert_allclose(task.model.bn1.running_var.numpy(), want_var,
                               rtol=RTOL)


# ----------------------------------------------------------------- trainer


def _cli_args(path, *extra):
    return ["train", "--dataset_path", path, "--device", "cpu",
            "--model_name", "resnet18", "--image_size", str(SIZE),
            "--num_classes", "10", "--batch_size", str(BATCH),
            "--log_every", "1", *extra]


def test_cli_map_style_filter_and_val_fraction_on_cpu(tmp_path, monkeypatch,
                                                      capsys):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=64, num_classes=10,
                                            image_size=SIZE, fragment_size=24)
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(path, "--loader_style", "map", "--filter",
                                "label < 7", "--val_fraction", "0.3",
                                "--max_steps", "2", "--eval_every", "1",
                                "--epochs", "1"))
    ds = Dataset(path)
    config = trainer.TrainConfig(dataset_path=path, batch_size=BATCH,
                                 val_fraction=0.3)
    train_pool, val_pool = trainer._split_val_pool(
        config, ds, ds.filter_indices("label < 7"))
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    # The eval at the epoch's end and at the end cover the val split once.
    assert result["history"][0]["val_rows"] == len(val_pool)
    assert result["eval_rows"] == len(val_pool)
    assert np.intersect1d(train_pool, val_pool).size == 0
    out = capsys.readouterr().out
    assert "val_rows=" in out and "eval_rows=" in out
    header = (tmp_path / "m.jsonl").read_text().splitlines()[0]
    assert '"run_name": "DP-map-batch-resnet18"' in header


@pytest.mark.parametrize("drain", [4, 9])
def test_map_style_drain_and_resume_is_bit_identical(tmp_path, monkeypatch,
                                                     drain):
    """Drained mid-epoch 0 and mid-epoch 1 (another permutation): the
    resumed run continues at the next batch, losses and batches equal the
    uninterrupted run's bit for bit."""
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=60, num_classes=10,
                                            image_size=SIZE, fragment_size=25)
    cfg = dict(dataset_path=path, num_classes=10, model_name="resnet18",
               image_size=SIZE, batch_size=BATCH, epochs=2, lr=0.01,
               eval_at_end=False, log_every=0, seed=7, loader_style="map",
               filter="label < 8")
    steps = len(Dataset(path).filter_indices("label < 8")) // BATCH
    control_result, control = _run(tmp_path, monkeypatch, "control.jsonl",
                                   **cfg)
    assert len(control) == 2 * steps
    ck = str(tmp_path / "ck")
    r1, pre = _run(tmp_path, monkeypatch, "pre.jsonl", chaos=f"drain@{drain}",
                   checkpoint_dir=ck, checkpoint_every_steps=3, **cfg)
    assert r1["preempted"] is True and r1["global_step"] == drain
    r2, resumed = _run(tmp_path, monkeypatch, "resume.jsonl",
                       checkpoint_dir=ck, checkpoint_every_steps=3, **cfg)
    assert r2["start_epoch"] == drain // steps
    assert r2["steps"] == 2 * steps - drain
    _assert_resumed_equals(control, resumed, first=drain + 1)
    _assert_same_params(r2["model"], control_result["model"])


def _jax_refusal(kw, path):
    """The JAX trainer's message for the combination ``kw``: ``train``'s
    checks before any I/O, else its loader build's."""
    config = jax_trainer.TrainConfig(dataset_path=path, batch_size=BATCH,
                                     num_classes=10, **kw)
    with pytest.raises(ValueError) as err:
        if config.val_fraction:
            jax_trainer.train(config)
        else:
            pool = None
            if config.loader_style == "map" and config.filter and \
                    config.data_format == "columnar":
                pool = jax_format.Dataset(path).filter_indices(config.filter)
            dataset = (jax_format.Dataset(path)
                       if config.data_format == "columnar" else None)
            jax_trainer._build_loader(config, dataset, None,
                                      index_pool=pool)
    return str(err.value)


REFUSALS = [
    (dict(val_fraction=1.5, loader_style="map"), "must be in \\(0, 1\\)"),
    (dict(val_fraction=-0.1, loader_style="map"), "must be in \\(0, 1\\)"),
    (dict(val_fraction=0.2, loader_style="map", val_dataset_path="v"),
     "mutually exclusive"),
    (dict(val_fraction=0.2), "needs the map-style columnar path"),
    (dict(val_fraction=0.2, loader_style="map", data_format="folder"),
     "needs the map-style columnar path"),
    (dict(filter="label < 3", data_format="folder", loader_style="map"),
     "needs the columnar store"),
    (dict(filter="label < 3"), "needs the map-style loader"),
    (dict(filter="label < 1", loader_style="map"),
     "fewer than one global batch"),
]


@pytest.mark.parametrize("kw,match", REFUSALS,
                         ids=[f"refuse{i}" for i in range(len(REFUSALS))])
def test_loader_refusals_match_jax(tmp_path, monkeypatch, kw, match):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=24, num_classes=10,
                                            image_size=SIZE, fragment_size=10)
    if kw.get("data_format") == "folder":
        path = str(tmp_path)  # a tree whose one class is "food"
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    want = _jax_refusal(kw, path)
    with pytest.raises(ValueError, match=match) as got:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer.train(trainer.TrainConfig(
                dataset_path=path, batch_size=BATCH, num_classes=10,
                model_name="resnet18", image_size=SIZE, device="cpu",
                max_steps=1, **kw))
    assert str(got.value) == want


def test_cli_loader_flags_take_the_jax_defaults_and_choices():
    from lance_distributed_training_tpu import cli as jax_cli

    port, jax = cli.build_parser(), jax_cli.build_parser()
    for flag in ("loader_style", "filter", "data_format", "val_fraction"):
        assert port.get_default(flag) == jax.get_default(flag), flag
        got = [a for a in port._actions if a.dest == flag][0]
        want = [a for a in jax._actions if a.dest == flag][0]
        assert got.choices == want.choices and got.type == want.type, flag
    with pytest.raises(SystemExit):
        cli.main(["train", "--dataset_path", "-", "--loader_style", "random"])
