"""The port's file-based control arm and folder authoring against the JAX
package's, on the CPU.

``FolderDataPipeline`` in both loader styles (one and two processes,
epochs 0 and 1, a resume cursor), ``read_sample_batch`` under the eval
loader, the authoring functions (an image-folder tree, the synthetic tree,
the Food-101 tree and tarball, ``ingest_on_process_zero``) and the
authoring CLI, which must give the same rows and bytes, three SGD steps on
folder batches (float64 trunk, ``rtol 1e-5``), the CLI under
``--data_format folder`` in both styles, and the refusal of a folder with
more classes than ``--num_classes``.
"""

import io
import os
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data import authoring as jax_authoring
from lance_distributed_training_tpu.data import folder as jax_folder
from lance_distributed_training_tpu.data import format as jax_format
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_eval_pipeline as jax_make_eval_pipeline,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    FolderDataPipeline,
    ImageClassificationDecoder,
    authoring,
    create_dataset_from_image_folder,
    create_food101_datasets,
    create_synthetic_image_folder,
    ingest_on_process_zero,
    make_eval_pipeline,
    read_sample_batch,
)
from test_torch_classification import BATCH, RTOL, SIZE, _three_sgd_steps
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]


def _jpeg(rng, size=40, fmt="JPEG"):
    from PIL import Image

    arr = (rng.random((size, size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``root/<class>/<files>``: 3 classes of 9 JPEGs, a PNG and a file
    that is no image (the walk skips it)."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("tree") / "folder"
    for cls in ("cherry", "apple", "banana"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(9):
            (d / f"{i:02d}.jpg").write_bytes(_jpeg(rng))
        (d / "z.png").write_bytes(_jpeg(rng, fmt="PNG"))
        (d / "notes.txt").write_text("not an image")
    return str(root)


def _decoders():
    return (JaxImageDecoder(image_size=SIZE, use_native=False),
            ImageClassificationDecoder(image_size=SIZE, use_native=False))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            arr = g[key].numpy()
            assert arr.dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(arr, np.asarray(w[key]),
                                          err_msg=key)


def test_folder_samples_match_jax(tree):
    got, want = authoring._folder_samples(tree), \
        jax_authoring._folder_samples(tree)
    assert got == want
    samples, classes = got
    assert classes == ["apple", "banana", "cherry"] and len(samples) == 30


@pytest.mark.parametrize("style,shuffle", [("map", True), ("map", False),
                                           ("iterable", False),
                                           ("iterable", True)])
@pytest.mark.parametrize("count,epoch,cursor", [(1, 0, 0), (1, 1, 1),
                                                (2, 0, 0), (2, 1, 1)])
def test_folder_batches_match_jax(tree, style, shuffle, count, epoch, cursor):
    want_dec, got_dec = _decoders()
    for rank in range(count):
        kw = dict(loader_style=style, shuffle=shuffle, seed=4, epoch=epoch)
        want_loader = jax_folder.FolderDataPipeline(tree, 4, rank, count,
                                                    want_dec, **kw)
        got_loader = FolderDataPipeline(tree, 4, rank, count, got_dec,
                                        "cpu", **kw)
        assert got_loader.num_classes == want_loader.num_classes == 3
        assert len(got_loader) == len(want_loader)
        if cursor:
            state = {"epoch": epoch, "step": cursor}
            want_loader.load_state_dict(state)
            got_loader.load_state_dict(state)
        _assert_batches_equal(list(got_loader), list(want_loader))
        assert got_loader.state_dict() == want_loader.state_dict()


def test_folder_styles_and_refusals(tree):
    _, decode = _decoders()
    walk = FolderDataPipeline(tree, 10, 0, 1, decode, "cpu",
                              loader_style="iterable", shuffle=False)
    # Sorted walk, contiguous batches: batch k is class k's ten files.
    assert [b["label"].tolist() for b in walk] == [[k] * 10 for k in range(3)]
    loader = FolderDataPipeline(tree, 10, 0, 1, decode, "cpu", seed=1)
    loader.set_epoch(1)
    assert loader.state_dict() == {"epoch": 1, "step": 0}
    with pytest.raises(ValueError, match="loader_style must be"):
        FolderDataPipeline(tree, 10, 0, 1, decode, "cpu",
                           loader_style="stream")
    with pytest.raises(ValueError, match="no images under"):
        FolderDataPipeline(os.path.join(tree, "apple"), 10, 0, 1, decode,
                           "cpu")


def test_folder_eval_loader_matches_jax(tree):
    samples, _ = authoring._folder_samples(tree)
    want_dec, got_dec = _decoders()
    table = read_sample_batch(samples, np.array([29, 0, 14]))
    assert table.equals(jax_folder.read_sample_batch(samples,
                                                     np.array([29, 0, 14])))
    want = list(jax_make_eval_pipeline(
        lambda idx: jax_folder.read_sample_batch(samples, idx),
        len(samples), 8, 0, 1, want_dec))
    got = list(make_eval_pipeline(
        lambda idx: read_sample_batch(samples, idx), len(samples), 8, 0, 1,
        got_dec, "cpu"))
    assert len(got) == 4  # 30 files: 32 slots, 2 of them pads
    _assert_batches_equal(got, want)


# --------------------------------------------------------------- authoring


def _rows(path):
    ds = Dataset(path)
    return ds.fragment_rows(), ds.take(np.arange(ds.count_rows()))


@pytest.mark.parametrize("kw", [{}, dict(shuffle_seed=3),
                                dict(reencode_jpeg_quality=70)])
def test_dataset_from_image_folder_matches_jax(tree, tmp_path, kw):
    kw = dict(fragment_size=12, batch_size=7, **kw)
    create_dataset_from_image_folder(tree, str(tmp_path / "port"), **kw)
    jax_authoring.create_dataset_from_image_folder(tree, str(tmp_path / "jax"),
                                                   **kw)
    (got_frags, got), (want_frags, want) = (_rows(tmp_path / "port"),
                                            _rows(tmp_path / "jax"))
    assert got_frags == want_frags == [12, 12, 6]
    assert got.equals(want)
    if not kw.get("reencode_jpeg_quality") and "shuffle_seed" not in kw:
        # JPEGs pass through byte for byte.
        samples, _ = authoring._folder_samples(tree)
        with open(samples[0][0], "rb") as f:
            assert got.column("image")[0].as_py() == f.read()


def _tree_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = (f.read(),
                                                    os.stat(path).st_nlink)
    return out


@pytest.mark.parametrize("rows,classes,unique", [(20, 3, 4), (7, 8, 64)])
def test_synthetic_image_folder_matches_jax(tmp_path, rows, classes, unique):
    kw = dict(num_classes=classes, image_size=24, unique_images=unique,
              seed=5)
    create_synthetic_image_folder(str(tmp_path / "port"), rows, **kw)
    jax_authoring.create_synthetic_image_folder(str(tmp_path / "jax"), rows,
                                                **kw)
    got, want = _tree_files(tmp_path / "port"), _tree_files(tmp_path / "jax")
    assert got == want
    assert sum(1 for n in got if n.endswith(".jpg")) == rows
    if rows > unique:
        # Each pool image is written once and hard-linked into its slots.
        assert max(links for _, links in got.values()) == -(-rows // unique)


@pytest.fixture(scope="module")
def food101(tmp_path_factory):
    """A Food-101-shaped tree (meta/classes.txt, train.txt, test.txt,
    images/<class>/<id>.jpg) and its tarball."""
    rng = np.random.default_rng(1)
    base = tmp_path_factory.mktemp("food101")
    root = base / "food-101"
    classes = ["waffles", "apple_pie", "ramen"]
    (root / "meta").mkdir(parents=True)
    (root / "meta" / "classes.txt").write_text("\n".join(classes) + "\n")
    train, test = [], []
    for cls in classes:
        (root / "images" / cls).mkdir(parents=True)
        for i in range(5):
            (root / "images" / cls / f"{100 + i}.jpg").write_bytes(
                _jpeg(rng, size=24))
            (train if i < 3 else test).append(f"{cls}/{100 + i}")
    (root / "meta" / "train.txt").write_text("\n".join(train) + "\n")
    (root / "meta" / "test.txt").write_text("\n".join(test) + "\n")
    tarball = base / "food-101.tar.gz"
    with tarfile.open(tarball, "w:gz") as tar:
        tar.add(root, arcname="food-101")
    return str(root), str(tarball)


@pytest.mark.parametrize("source", ["tree", "tarball"])
def test_food101_datasets_match_jax(food101, tmp_path, source):
    src = food101[0] if source == "tree" else food101[1]
    got = create_food101_datasets(src, str(tmp_path / "port"),
                                  fragment_size=4, batch_size=3)
    want = jax_authoring.create_food101_datasets(src, str(tmp_path / "jax"),
                                                 fragment_size=4,
                                                 batch_size=3)
    for split, g, w in zip(("train", "test"), got, want):
        assert g.count_rows() == w.count_rows() == (9 if split == "train"
                                                    else 6)
        assert _rows(tmp_path / "port" / split)[1].equals(
            _rows(tmp_path / "jax" / split)[1])
    # Sorted classes.txt indexes the labels: apple_pie 0, ramen 1, waffles 2.
    labels = got[0].take(np.arange(9)).column("label").to_pylist()
    assert labels == [2] * 3 + [0] * 3 + [1] * 3
    with pytest.raises(FileNotFoundError, match="not a food-101 tree"):
        create_food101_datasets(str(tmp_path), str(tmp_path / "x"))


def test_ingest_on_process_zero_runs_once(tmp_path):
    calls = []

    def ingest():
        calls.append(1)
        create_synthetic_image_folder(str(tmp_path / "tree"), 6,
                                      num_classes=2, image_size=16)
        create_dataset_from_image_folder(str(tmp_path / "tree"),
                                         str(tmp_path / "ds"))

    ds = ingest_on_process_zero(tmp_path / "ds", ingest)
    again = ingest_on_process_zero([str(tmp_path / "ds")], ingest)
    assert calls == [1] and ds.count_rows() == again.count_rows() == 6


@pytest.mark.parametrize("kind", ["folder", "synthetic", "tokens",
                                  "food101"])
def test_authoring_cli_matches_jax(tree, food101, tmp_path, kind):
    def args(out):
        if kind == "folder":
            return ["folder", "--root_path", tree, "--output_path", out,
                    "--fragment_size", "8", "--shuffle_seed", "2"]
        if kind == "synthetic":
            return ["synthetic", "--output_path", out, "--rows", "10",
                    "--num_classes", "4", "--image_size", "16",
                    "--fragment_size", "4"]
        if kind == "tokens":
            return ["tokens", "--output_path", out, "--rows", "30",
                    "--vocab_size", "50", "--max_len", "12", "--seed", "3",
                    "--fragment_size", "8"]
        return ["food101", "--source", food101[0], "--output_root", out,
                "--fragment_size", "4"]

    authoring.main(args(str(tmp_path / "port")))
    jax_authoring.main(args(str(tmp_path / "jax")))
    sub = ("train",) if kind == "food101" else ("",)
    for s in sub:
        got = _rows(tmp_path / "port" / s)
        want = _rows(tmp_path / "jax" / s)
        assert got[0] == want[0] and got[1].equals(want[1])


def test_authoring_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path / "toks")
    proc = subprocess.run(
        [sys.executable, "-m",
         "lance_distributed_training_tpu_torch.data.authoring", "tokens",
         "--output_path", out, "--rows", "12", "--max_len", "8"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert Dataset(out).count_rows() == 12


# ----------------------------------------------------------------- trainer


def test_three_sgd_steps_on_folder_batches_match_jax(monkeypatch, tmp_path):
    root = str(tmp_path / "tree")
    create_synthetic_image_folder(root, 40, num_classes=10, image_size=SIZE,
                                  unique_images=10, seed=2)
    want_dec, got_dec = _decoders()
    kw = dict(seed=6, epoch=1)
    want = list(jax_folder.FolderDataPipeline(root, BATCH, 0, 1, want_dec,
                                              **kw))[:3]
    got = list(FolderDataPipeline(root, BATCH, 0, 1, got_dec, "cpu",
                                  **kw))[:3]
    _assert_batches_equal(got, want)
    batches = [{k: np.asarray(v) for k, v in b.items()} for b in want]
    want_l, got_l, want_var, _, task = _three_sgd_steps(monkeypatch, 0.0,
                                                        batches)
    assert want_l[0] != want_l[2]
    np.testing.assert_allclose(got_l, want_l, rtol=RTOL)
    np.testing.assert_allclose(task.model.bn1.running_var.numpy(), want_var,
                               rtol=RTOL)


@pytest.fixture(scope="module")
def learnable_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("learn") / "tree")
    create_synthetic_image_folder(root, 48, num_classes=6, image_size=SIZE,
                                  unique_images=6, seed=3)
    return root


def _cli_args(path, *extra):
    return ["train", "--dataset_path", path, "--device", "cpu",
            "--data_format", "folder", "--model_name", "resnet18",
            "--image_size", str(SIZE), "--num_classes", "10",
            "--batch_size", str(BATCH), "--max_steps", "2",
            "--log_every", "1", *extra]


@pytest.mark.parametrize("style", ["map", "iterable"])
def test_cli_trains_on_a_folder_two_steps_on_cpu(learnable_tree, tmp_path,
                                                 monkeypatch, capsys, style):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(learnable_tree, "--loader_style", style,
                                "--shuffle"))
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    assert result["eval_rows"] == 48  # every file of the tree once
    assert result["decoder_arm"] in ("native", "pil")
    out = capsys.readouterr().out
    assert "images_per_sec=" in out and "eval_accuracy=" in out
    header = (tmp_path / "m.jsonl").read_text().splitlines()[0]
    assert f'"run_name": "DP-{style}-batch-resnet18"' in header


def test_folder_with_more_classes_than_num_classes_raises_as_jax(
        learnable_tree, monkeypatch):
    monkeypatch.setenv("LDT_METRICS_PATH", os.devnull)
    config = jax_trainer.TrainConfig(dataset_path=learnable_tree,
                                     data_format="folder", loader_style="map",
                                     batch_size=BATCH, num_classes=4)
    with pytest.raises(ValueError) as want:
        jax_trainer._build_loader(config, None, None)
    with pytest.raises(ValueError, match="6 class directories") as got:
        cli.main(_cli_args(learnable_tree, "--num_classes", "4"))
    assert str(got.value) == str(want.value)
    # A folder smaller than one global batch is refused too.
    with pytest.raises(ValueError, match="folder smaller than one global"):
        trainer.train(trainer.TrainConfig(
            dataset_path=learnable_tree, data_format="folder",
            batch_size=64, num_classes=10, model_name="resnet18",
            image_size=SIZE, device="cpu"))


def test_folder_datasets_read_by_both_packages(tree, tmp_path):
    """A dataset authored from the tree by the port opens in the JAX
    package with the same fingerprint."""
    create_dataset_from_image_folder(tree, str(tmp_path / "ds"))
    assert Dataset(tmp_path / "ds").fingerprint() == \
        jax_format.Dataset(str(tmp_path / "ds")).fingerprint()


def test_folder_arm_feeds_the_coefficient_decoder(learnable_tree, tmp_path,
                                                  monkeypatch):
    """``--device_decode`` under the folder arm: the file batches go
    through the coefficient extractor and K2's plain version."""
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(learnable_tree, "--device_decode"))
    assert result["decoder_arm"] == "coeff" and result["steps"] == 2
    assert all(np.isfinite(result["losses"])) and result["eval_rows"] == 48


@pytest.mark.parametrize("loader", ["map", "folder"])
def test_new_loaders_raise_when_the_extractor_cannot_build(
        learnable_tree, tmp_path, monkeypatch, loader):
    """No silent fallback to the pixel decoder under either new loader."""
    from lance_distributed_training_tpu_torch.data import (
        create_synthetic_classification_dataset,
    )
    from lance_distributed_training_tpu_torch.native import coeffs

    def broken_build(src, target, flags, libs=()):
        raise OSError("g++ failed (exit 1): simulated")

    monkeypatch.setattr(coeffs, "_lib", None)
    monkeypatch.setattr(coeffs, "library_path",
                        lambda src, flags, stem: tmp_path / "none.so")
    monkeypatch.setattr(coeffs, "build_library", broken_build)
    monkeypatch.setenv("LDT_METRICS_PATH", os.devnull)
    if loader == "folder":
        args = _cli_args(learnable_tree, "--device_decode")
    else:
        path = str(tmp_path / "food")
        create_synthetic_classification_dataset(path, rows=24, num_classes=10,
                                                image_size=SIZE)
        args = ["train", "--dataset_path", path, "--device", "cpu",
                "--loader_style", "map", "--model_name", "resnet18",
                "--image_size", str(SIZE), "--num_classes", "10",
                "--batch_size", str(BATCH), "--max_steps", "2",
                "--device_decode"]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cli.main(args)
