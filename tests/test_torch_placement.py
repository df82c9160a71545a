"""The port's placement plane, producer threads and synchronous arm against
the JAX package's, on the CPU.

The JAX package's ``tests/test_placement.py`` cases less the mesh ones
(``place_batch`` against the synchronous primitive; the placed stream
against the synchronous stream; ``len``, ``set_epoch`` and the counters
delegated; decode errors raised on the consumer; leases back once the copy
is done; an abandoned iterator leaves no thread), then the port's placed
stream against the JAX ``PlacementPlane``'s on a one-device CPU mesh, as
numpy, bit for bit, for the iterable, map-style, folder and eval loaders
and a packed text batch (``_host_*`` and ragged keys); the resume cursor
while the ring runs ahead against the JAX ``PlacedLoader``'s tail; the
ordered fan-out of ``producers`` threads (``tests/test_pipeline.py``'s
order and error cases, for every loader, against ``producers=1`` and the
JAX loaders with 3 producers); and the trainer and CLI at the JAX defaults
against the synchronous control arm (bit-equal losses, no loader thread
left behind).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.data import PlacementPlane as JaxPlane
from lance_distributed_training_tpu.data import folder as jax_folder
from lance_distributed_training_tpu.data import format as jax_format
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_eval_pipeline as jax_make_eval_pipeline,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_map_style_pipeline as jax_make_map_style_pipeline,
)
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenDecoder as JaxTokenDecoder,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenPackConfig as JaxTokenPackConfig,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenPackPlanner as JaxTokenPackPlanner,
)
from lance_distributed_training_tpu.obs.registry import MetricsRegistry
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    BufferPool,
    Dataset,
    FolderDataPipeline,
    ImageClassificationDecoder,
    LoaderGraph,
    PlacementPlane,
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    create_synthetic_classification_dataset,
    create_synthetic_image_folder,
    create_variable_length_token_dataset,
    make_eval_pipeline,
    make_map_style_pipeline,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.parallel import make_global_batch
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE, ROWS = 32, 45


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("images") / "food")
    create_synthetic_classification_dataset(path, rows=ROWS, num_classes=7,
                                            image_size=SIZE, fragment_size=20,
                                            unique_images=12, seed=3)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "images")
    create_synthetic_image_folder(root, rows=30, num_classes=3,
                                  image_size=SIZE, unique_images=6, seed=2)
    return root


@pytest.fixture(scope="module")
def token_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "ragged")
    create_variable_length_token_dataset(path, rows=48, vocab_size=60,
                                         max_len=40, mean_len=10.0, seed=2,
                                         fragment_size=24)
    return path


def _jax_plane():
    return JaxPlane(get_mesh(jax.devices()[:1]), registry=MetricsRegistry())


def _numpy(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


def _assert_streams_equal(got, want, placed=True):
    """Equal keys, types and bits; ``placed``: ``got`` holds tensors but
    for its ``_host_*`` keys, which stay numpy."""
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            host = key.startswith("_host_") or not placed
            assert isinstance(g[key], np.ndarray if host else torch.Tensor), \
                key
            g_arr, w_arr = np.asarray(g[key]), np.asarray(w[key])
            assert g_arr.dtype == w_arr.dtype, key
            np.testing.assert_array_equal(g_arr, w_arr, err_msg=key)


def _image_decoders():
    return (ImageClassificationDecoder(SIZE, use_native=False),
            JaxImageDecoder(image_size=SIZE, use_native=False))


def _loaders(kind, image_path, tree, token_path, producers, device=None):
    """``(port loader, JAX loader)`` of one kind, the port's yielding host
    batches (``device=None``) or placing them itself, the JAX one host
    batches; both with ``producers`` threads."""
    got_dec, want_dec = _image_decoders()
    if kind == "iterable":
        return (make_train_pipeline(Dataset(image_path), "batch", 8, 0, 1,
                                    got_dec, device, producers=producers,
                                    shuffle=True, seed=2),
                jax_make_train_pipeline(jax_format.Dataset(image_path),
                                        "batch", 8, 0, 1, want_dec,
                                        producers=producers, shuffle=True,
                                        seed=2))
    if kind == "map":
        kw = dict(seed=5, epoch=1, producers=producers)
        return (make_map_style_pipeline(Dataset(image_path), 6, 0, 1,
                                        got_dec, device, **kw),
                jax_make_map_style_pipeline(jax_format.Dataset(image_path), 6,
                                            0, 1, want_dec, **kw))
    if kind == "folder":
        kw = dict(loader_style="map", seed=4, epoch=1, producers=producers)
        return (FolderDataPipeline(tree, 4, 0, 1, got_dec, device, **kw),
                jax_folder.FolderDataPipeline(tree, 4, 0, 1, want_dec, **kw))
    if kind == "eval":
        port_ds = Dataset(image_path)
        jax_ds = jax_format.Dataset(image_path)
        return (make_eval_pipeline(lambda idx: port_ds.take(idx), ROWS, 16, 0,
                                   1, got_dec, device, producers=producers),
                jax_make_eval_pipeline(lambda idx: jax_ds.take(idx), ROWS, 16,
                                       0, 1, want_dec, producers=producers))
    cfg = dict(pack_len=40, rows_multiple=2)
    got_tok = TokenDecoder(mode="pack", seq_len=40,
                           planner=TokenPackPlanner(TokenPackConfig(**cfg)))
    want_tok = JaxTokenDecoder(
        mode="pack", seq_len=40,
        planner=JaxTokenPackPlanner(JaxTokenPackConfig(**cfg)))
    return (make_train_pipeline(Dataset(token_path), "batch", 12, 0, 1,
                                got_tok, device, producers=producers),
            jax_make_train_pipeline(jax_format.Dataset(token_path), "batch",
                                    12, 0, 1, want_tok, producers=producers))


def _loader_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(("ldt-placement", "ldt-producer")))


KINDS = ["iterable", "map", "folder", "eval", "packed"]


# ---------------------------------------------- the JAX plane's own cases


def test_place_batch_matches_make_global_batch_bitwise():
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 255, (16, 8, 8, 3)).astype(np.uint8),
             "label": rng.integers(0, 10, 16).astype(np.int32),
             "_host_pack_meta": np.arange(4, dtype=np.int64)}
    placed = PlacementPlane("cpu").place_batch(batch)
    ref = make_global_batch(batch, "cpu")
    assert isinstance(placed["_host_pack_meta"], np.ndarray)
    for key in batch:
        np.testing.assert_array_equal(np.asarray(placed[key]),
                                      np.asarray(ref[key]))
        np.testing.assert_array_equal(np.asarray(placed[key]), batch[key])


def test_placed_stream_bit_identical_to_sync_path(image_path, tree,
                                                  token_path):
    for kind in KINDS:
        host, _ = _loaders(kind, image_path, tree, token_path, 1)
        sync, _ = _loaders(kind, image_path, tree, token_path, 1, "cpu")
        placed = list(PlacementPlane("cpu").wrap(host))
        assert len(placed) == len(host)
        _assert_streams_equal(placed, sync)


def test_placed_loader_delegates_len_set_epoch_and_counts(image_path):
    plane = PlacementPlane("cpu")
    inner = make_map_style_pipeline(Dataset(image_path), 8, 0, 1,
                                    _image_decoders()[0], None, seed=1)
    loader = plane.wrap(inner)
    assert len(loader) == len(inner) == ROWS // 8
    loader.set_epoch(3)
    assert inner.epoch == 3 and loader.state_dict() == {"epoch": 3,
                                                        "step": 0}
    n = sum(1 for _ in loader)
    assert n == len(inner)
    counts = loader.placement_counters.snapshot()
    assert counts["placement_batches_placed"] == n
    assert counts["placement_h2d_s"] > 0
    assert counts["placement_buffer_depth"] == 0
    assert len(plane.h2d_ms) == n and loader.counters is None
    # set_epoch on an inner loader without one is a no-op.
    plane.wrap(make_train_pipeline(Dataset(image_path), "batch", 8, 0, 1,
                                   _image_decoders()[0], None)).set_epoch(2)


@pytest.mark.parametrize("producers", [1, 3])
def test_placed_iterator_propagates_decode_error(image_path, producers):
    def bad_decode(table):
        raise RuntimeError("boom behind the plane")

    inner = make_train_pipeline(Dataset(image_path), "batch", 8, 0, 1,
                                bad_decode, None, producers=producers)
    with pytest.raises(RuntimeError, match="boom behind the plane"):
        list(PlacementPlane("cpu").wrap(inner))
    assert _loader_threads() == []


def test_leases_go_back_once_the_copy_is_done():
    pool = BufferPool()
    plane = PlacementPlane("cpu", buffer_pool=pool, depth=1)
    rng = np.random.default_rng(2)

    def leased_batches(n):
        for _ in range(n):
            batch = {"image": pool.lease((8, 4, 4, 3), np.uint8),
                     "label": pool.lease((8,), np.int32)}
            batch["image"][...] = rng.integers(0, 255, (8, 4, 4, 3))
            batch["label"][...] = rng.integers(0, 10, 8)
            yield batch

    seen = 0
    for batch in plane.iter_placed(leased_batches(6)):
        seen += 1
        # Upstream holds at most the batch being placed and the next.
        assert pool.stats()["outstanding"] <= 2 * 2
        del batch
    assert seen == 6
    pool.sweep()
    stats = pool.stats()
    assert stats["outstanding"] == 0 and stats["pending"] == 0
    assert stats["free"] > 0  # recycled, not dropped


def test_abandoned_iterator_mid_ring_leaves_nothing(image_path):
    """The consumer walks away after one batch with the ring full: teardown
    drains the ring, closes the loader behind it and joins every thread,
    and every lease goes back."""
    pool = BufferPool()
    decode = ImageClassificationDecoder(SIZE, use_native=False,
                                        buffer_pool=pool)
    inner = make_train_pipeline(Dataset(image_path), "batch", 4, 0, 1,
                                decode, None, producers=3, buffer_pool=pool)
    it = iter(PlacementPlane("cpu", buffer_pool=pool, depth=2).wrap(inner))
    first = next(it)
    assert isinstance(first["image"], torch.Tensor)
    assert "ldt-placement" in _loader_threads()
    it.close()
    assert _loader_threads() == []
    del first
    pool.sweep()
    assert pool.stats()["outstanding"] == 0 and pool.stats()["pending"] == 0


def test_placement_depth_below_one_raises_the_jax_message():
    with pytest.raises(ValueError) as got:
        trainer.train(trainer.TrainConfig(dataset_path="-", device="cpu",
                                          placement_depth=0))
    assert str(got.value) == "placement_depth must be >= 1, got 0"


# --------------------------------------------- the port's plane against JAX's


@pytest.mark.parametrize("kind", KINDS)
def test_placed_stream_equals_the_jax_plane(kind, image_path, tree,
                                            token_path):
    got, want = _loaders(kind, image_path, tree, token_path, 2)
    _assert_streams_equal(
        PlacementPlane("cpu", depth=2).wrap(got),
        [_numpy(b) for b in _jax_plane().wrap(want)])


def test_cursor_counts_consumed_batches_and_resumes_as_jax(image_path):
    got_dec, want_dec = _image_decoders()
    kw = dict(seed=3, epoch=1, producers=2)
    loader = PlacementPlane("cpu", depth=2).wrap(make_map_style_pipeline(
        Dataset(image_path), 4, 0, 1, got_dec, None, **kw))
    it = iter(loader)
    next(it), next(it)
    deadline = time.monotonic() + 10
    while (loader.inner.state_dict()["step"] < 4
           and time.monotonic() < deadline):
        time.sleep(0.01)
    # The ring runs ahead; the cursor counts what the consumer took.
    assert loader.inner.state_dict()["step"] >= 4
    assert loader.state_dict() == {"epoch": 1, "step": 2}
    it.close()
    assert loader.state_dict() == {"epoch": 1, "step": 2}
    cursor = loader.state_dict()
    resumed = PlacementPlane("cpu").wrap(make_map_style_pipeline(
        Dataset(image_path), 4, 0, 1, got_dec, None, **kw))
    resumed.load_state_dict(cursor)
    want = _jax_plane().wrap(jax_make_map_style_pipeline(
        jax_format.Dataset(image_path), 4, 0, 1, want_dec, **kw))
    want.load_state_dict(cursor)
    want = [_numpy(b) for b in want]
    assert len(want) == ROWS // 4 - 2
    _assert_streams_equal(resumed, want)
    assert resumed.state_dict() == {"epoch": 1, "step": ROWS // 4}


# ------------------------------------------------------------------ producers


@pytest.mark.parametrize("kind", KINDS)
def test_producers_keep_plan_order_and_equal_jax(kind, image_path, tree,
                                                 token_path):
    one, _ = _loaders(kind, image_path, tree, token_path, 1)
    three, want = _loaders(kind, image_path, tree, token_path, 3)
    synced, _ = _loaders(kind, image_path, tree, token_path, 3, "cpu")
    one = list(one)
    _assert_streams_equal(three, one, placed=False)
    _assert_streams_equal(synced, one)
    _assert_streams_equal(synced, want)
    assert _loader_threads() == []


@pytest.mark.parametrize("kind", ["iterable", "map", "folder", "eval"])
def test_producers_propagate_errors(kind, image_path, tree, token_path):
    loader, _ = _loaders(kind, image_path, tree, token_path, 2)

    def bad_decode(table):
        raise RuntimeError("decode exploded")

    # A factory's loader is a compiled LoaderGraph: the decode hook is the
    # engine's it compiled to.
    engine = loader.compile() if isinstance(loader, LoaderGraph) else loader
    engine.decode_fn = bad_decode
    with pytest.raises(RuntimeError, match="decode exploded"):
        list(loader)
    assert _loader_threads() == []


# ------------------------------------------------------- trainer and the CLI


def test_cli_placement_flags_take_the_jax_defaults():
    from lance_distributed_training_tpu import cli as jax_cli

    port, jax_parser = cli.build_parser(), jax_cli.build_parser()
    for flag in ("producer_threads", "placement_depth", "no_global_batch",
                 "no_buffer_pool", "pretrained"):
        assert port.get_default(flag) == jax_parser.get_default(flag), flag
        got = [a for a in port._actions if a.dest == flag][0]
        want = [a for a in jax_parser._actions if a.dest == flag][0]
        assert got.type == want.type and got.nargs == want.nargs, flag
    config = trainer.TrainConfig(dataset_path="-")
    assert (config.buffer_pool, config.producer_threads, config.global_batch,
            config.placement_depth, config.pretrained) == (True, 4, True, 2,
                                                           None)


def _run(tmp_path, argv, monkeypatch, name):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / f"{name}.jsonl"))
    result = cli.main(argv)
    assert _loader_threads() == []
    return result


CONTROL = ["--no_global_batch", "--producer_threads", "1", "--no_buffer_pool"]


def test_defaults_and_the_control_arm_train_alike_classification(
        tmp_path, monkeypatch, image_path):
    argv = ["train", "--dataset_path", image_path, "--device", "cpu",
            "--model_name", "resnet18", "--image_size", str(SIZE),
            "--num_classes", "10", "--batch_size", "8", "--max_steps", "2",
            "--log_every", "1"]
    plane = _run(tmp_path, argv, monkeypatch, "plane")
    control = _run(tmp_path, argv + CONTROL, monkeypatch, "control")
    assert plane["losses"] == control["losses"]
    assert plane["eval_accuracy"] == control["eval_accuracy"]
    assert plane["eval_rows"] == control["eval_rows"] == ROWS
    assert len(plane["placement_ms"]) >= 2 and plane["h2d_pct"] > 0
    assert "placement_ms" not in control and control["bufpool_misses"] == 0
    assert plane["bufpool_misses"] + plane["bufpool_hits"] > 0
    lines = (tmp_path / "plane.jsonl").read_text()
    assert '"h2d_pct"' in lines and '"placement_buffer_depth"' in lines
    assert '"h2d_pct"' not in (tmp_path / "control.jsonl").read_text()


def test_defaults_and_the_control_arm_train_alike_packed_causal_lm(
        tmp_path, monkeypatch, token_path):
    argv = ["train", "--dataset_path", token_path, "--device", "cpu",
            "--task_type", "causal_lm", "--model_name", "gpt_small",
            "--vocab_size", "60", "--seq_len", "40", "--batch_size", "12",
            "--max_steps", "2", "--optimizer", "adamw", "--lr", "1e-3",
            "--token_pack", "--pack_rows_multiple", "2", "--log_every", "1"]
    plane = _run(tmp_path, argv, monkeypatch, "plane")
    control = _run(tmp_path, argv + CONTROL, monkeypatch, "control")
    assert plane["losses"] == control["losses"]
    assert plane["grid_tokens"] == control["grid_tokens"]
    assert plane["eval_accuracy"] == control["eval_accuracy"]
    assert plane["bufpool_hits"] + plane["bufpool_misses"] > 0
