"""The port's CLIP contrastive path against the JAX package's.

``clip_tiny`` (a ResNet image tower of four BasicBlocks at 64 filters, a
two-block hidden-64 text tower) at 32 px and 16-token captions, f32 on both
sides, from one seeded set of Flax variables carried over by
``models/convert.py`` (the image tower's kernels, BatchNorm scales and
statistics drawn at random, so that no block is an identity):

* both embeddings and ``logit_scale``, in eval and in training (where the
  running statistics move too), within 1e-5 absolute on unit rows;
  ``clip_contrastive_loss`` and ``retrieval_top1`` within 1e-6 / exactly;
* ``ImageTextDecoder`` bit for bit in its pad, bucket and numeric arms, on
  fixed-size and on variable-length captions, and
  ``create_synthetic_image_text_dataset`` row for row;
* ``cli train --task_type contrastive --model_name clip_tiny`` on the CPU:
  three SGD steps on the JAX trainer's batches track the JAX step's losses
  within rtol 5e-5, and the eval covers every row. (The JAX step runs
  under ``jit``, where XLA on the CPU keeps the bf16 ``normalize_images``
  in f32 when an f32 model consumes it, 8e-3 away from the bf16 values the
  package computes eagerly and in bf16 models; the test rounds it to bf16
  with ``reduce_precision``, as K1 does.) With
  ``--token_pack`` on variable-length captions the bucketed batches give
  the padded run's losses bit for bit;
* two gloo processes, each with half of the batch: the loss is the global
  batch's and DDP's gradients are the JAX gradients of it, within 1e-5
  absolute (5e-5 relative to the largest for the image tower's).
"""

import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data import authoring as jax_authoring
from lance_distributed_training_tpu.data.decode import (
    ImageTextDecoder as JaxImageTextDecoder,
)
from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.data.token_pack import (
    TokenPackConfig as JaxTokenPackConfig,
)
from lance_distributed_training_tpu.models import clip as jax_clip
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.ops.image import normalize_images
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    ImageTextDecoder,
    TokenPackConfig,
    create_synthetic_image_text_dataset,
    decoder_for_task,
    write_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    clip,
    clip_state_dict_from_flax,
    contrastive_task,
    load_flax_clip,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
SIZE, SEQ, BATCH = 32, 16, 8
ATOL = 1e-5


def _jax_tiny():
    return functools.partial(jax_clip.clip_tiny, dtype=jnp.float32)


@functools.lru_cache(maxsize=1)
def _variables(seed=0):
    """Seeded clip_tiny variables: the Flax init, with the image tower's
    kernels, BatchNorm scales, biases and statistics drawn at random (made
    once: the Flax init runs op by op; the leaves are read-only)."""
    model = _jax_tiny()(max_len=SEQ)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(seed), jnp.zeros((2, SIZE, SIZE, 3)),
        jnp.zeros((2, SEQ), jnp.int32), jnp.ones((2, SEQ), jnp.int8))
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[1].key != "image_tower":
            return np.asarray(leaf)
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, variables)
    for leaf in jax.tree_util.tree_leaves(variables):
        leaf.flags.writeable = False
    return model, variables


def _port_model(variables):
    model = clip.clip_tiny(max_len=SEQ, dtype=torch.float32)
    load_flax_clip(model, variables)
    return model


def _batch(seed=0, rows=BATCH):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, SEQ + 1, rows)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int8)
    return {"image": rng.integers(0, 256, (rows, SIZE, SIZE, 3),
                                  dtype=np.uint8),
            "input_ids": (rng.integers(2, 1000, (rows, SEQ))
                          * mask).astype(np.int32),
            "attention_mask": mask}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_converted_state_dict_covers_the_model_exactly():
    _, variables = _variables()
    port = clip.clip_tiny(max_len=SEQ)
    state = clip_state_dict_from_flax(variables, (1, 1, 1, 1))
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert state[name].shape == tensor.shape, name
    assert float(port.logit_scale) == pytest.approx(np.log(1 / 0.07))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_embeddings_and_scale_match_jax(train):
    model, variables = _variables()
    batch = _batch()
    x = normalize_images(jnp.asarray(batch["image"])).astype(jnp.float32)
    args = (x, jnp.asarray(batch["input_ids"]),
            jnp.asarray(batch["attention_mask"]))
    if train:
        (img_j, txt_j, scale_j), state = model.apply(
            variables, *args, train=True, mutable=["batch_stats"])
    else:
        img_j, txt_j, scale_j = model.apply(variables, *args, train=False)
    port = _port_model(variables).train(train)
    t = _torch(batch)
    with torch.no_grad():
        img, txt, scale = port(
            torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2),
            t["input_ids"], t["attention_mask"])
    np.testing.assert_allclose(img.numpy(), img_j, atol=ATOL)
    np.testing.assert_allclose(txt.numpy(), txt_j, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(img.numpy(), axis=-1), 1.0,
                               atol=1e-6)
    assert float(scale) == pytest.approx(float(scale_j), rel=1e-7)
    assert float(scale) == pytest.approx(1 / 0.07, rel=1e-6)
    if train:
        want = np.asarray(state["batch_stats"]["image_tower"]["norm_init"][
            "var"])
        np.testing.assert_allclose(port.image_tower.bn1.running_var.numpy(),
                                   want, rtol=1e-5)


def test_loss_and_metric_match_jax():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((BATCH, 32)).astype(np.float32)
    txt = rng.standard_normal((BATCH, 32)).astype(np.float32)
    txt[:4] = img[:4] + 0.1 * txt[:4]  # half the pairs match
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale = np.float32(1 / 0.07)
    want = float(jax_clip.clip_contrastive_loss(jnp.asarray(img),
                                                jnp.asarray(txt), scale))
    got = float(clip.clip_contrastive_loss(
        torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale)))
    assert got == pytest.approx(want, abs=1e-6)
    jt = jax_tasks.get_task("contrastive", model_name="clip_tiny",
                            seq_len=SEQ)
    hits = np.asarray(jt.metric((jnp.asarray(img), jnp.asarray(txt), scale),
                                None))
    got_hits = clip.retrieval_top1(torch.from_numpy(img),
                                   torch.from_numpy(txt)).numpy()
    np.testing.assert_array_equal(got_hits, hits)
    assert 0 < hits.sum() < BATCH


# ------------------------------------------------------------- the data


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native decoder, built privately for this test."""
    from lance_distributed_training_tpu.native import jpeg as jax_jpeg

    monkeypatch.setattr(jax_jpeg, "_LIB_PATH", str(tmp_path / "jax_ldt.so"))
    monkeypatch.setattr(jax_jpeg, "_lib", None)
    monkeypatch.setattr(jax_jpeg, "_load_failed", False)
    monkeypatch.delenv("LDT_DISABLE_NATIVE", raising=False)
    return jax_jpeg


def _ragged_captions(path, rows=24, seed=3):
    """Images of the synthetic set beside variable-length ``list<int32>``
    captions of 1-20 tokens (no mask column)."""
    drawn = path + "_fixed"
    create_synthetic_image_text_dataset(drawn, rows=rows, seq_len=SEQ,
                                        image_size=SIZE, unique_images=7)
    images = Dataset(drawn).take(np.arange(rows)).column("image")
    rng = np.random.default_rng(seed)
    captions = [rng.integers(2, 1000, int(n), dtype=np.int32)
                for n in rng.integers(1, 21, rows)]
    table = pa.table({"image": images,
                      "input_ids": pa.array(captions, pa.list_(pa.int32()))})
    write_dataset(table, path, mode="create", max_rows_per_file=10)
    return path


def test_synthetic_image_text_dataset_matches_jax(tmp_path):
    kw = dict(rows=20, seq_len=SEQ, vocab_size=50, image_size=SIZE,
              fragment_size=8, unique_images=5, seed=2)
    jax_authoring.create_synthetic_image_text_dataset(str(tmp_path / "j"),
                                                      **kw)
    create_synthetic_image_text_dataset(str(tmp_path / "p"), **kw)
    want = JaxDataset(str(tmp_path / "j")).take(np.arange(20))
    got = Dataset(str(tmp_path / "p")).take(np.arange(20))
    assert got.schema == want.schema
    assert got.equals(want)
    assert Dataset(str(tmp_path / "p")).fragment_rows() == [8, 8, 4]


@pytest.mark.parametrize("captions", ["fixed", "ragged"])
@pytest.mark.parametrize("arm", ["pad", "bucket", "numeric"])
def test_image_text_decoder_matches_jax(tmp_path, jax_native, captions, arm):
    if captions == "fixed":
        path = str(tmp_path / "it")
        create_synthetic_image_text_dataset(path, rows=24, seq_len=SEQ,
                                            image_size=SIZE)
    else:
        path = _ragged_captions(str(tmp_path / "it"))
    pack = dict(pack_len=SEQ, rows_multiple=2) if arm == "bucket" else None
    kw = dict(image_size=SIZE, seq_len=None if arm == "numeric" else SEQ)
    want_dec = JaxImageTextDecoder(
        token_pack=JaxTokenPackConfig(**pack) if pack else None, **kw)
    got_dec = ImageTextDecoder(
        token_pack=TokenPackConfig(**pack) if pack else None, **kw)
    assert got_dec.cache_fingerprint() == want_dec.cache_fingerprint()
    assert [t.name for t in got_dec.tunables()] == \
        [t.name for t in want_dec.tunables()]
    table = Dataset(path).take(np.arange(5, 17))
    want, got = want_dec(table), got_dec(table)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if arm == "bucket" and captions == "ragged":
        assert "input_ids__values" in got  # a ragged page K3 finishes
    # Pickled for a worker: the same bytes from the copy.
    import pickle

    again = pickle.loads(pickle.dumps(got_dec))(table)
    for key in want:
        np.testing.assert_array_equal(again[key], want[key], err_msg=key)


def test_decoder_dispatch_and_refusals():
    dec = decoder_for_task("contrastive", seq_len=SEQ, image_size=SIZE,
                           token_pack=TokenPackConfig(pack_len=SEQ))
    assert isinstance(dec, ImageTextDecoder) and dec.arm in ("native", "pil")
    assert dec.cache_fingerprint().startswith("ImageTextDecoder/")
    with pytest.raises(ValueError) as got:
        decoder_for_task("contrastive", device_decode=True)
    from lance_distributed_training_tpu.data.decode import (
        decoder_for_task as jax_decoder_for_task,
    )

    with pytest.raises(ValueError) as want:
        jax_decoder_for_task("contrastive", device_decode=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="classification"):
        trainer.train(trainer.TrainConfig(
            dataset_path="-", task_type="contrastive", device_decode=True,
            device="cpu"))
    with pytest.raises(ValueError, match="requires a sequence model"):
        trainer.train(trainer.TrainConfig(
            dataset_path="-", task_type="contrastive", flash_attention=True,
            device="cpu"))


# ------------------------------------------------------------- the trainer


def _jit_like_eager(monkeypatch) -> None:
    """The JAX tasks at clip_tiny in f32, their normalised images rounded to
    bf16 inside ``jit`` too (the module's docstring)."""
    monkeypatch.setattr(jax_tasks, "clip_tiny", _jax_tiny())
    monkeypatch.setattr(jax_tasks, "normalize_images", lambda x: (
        jax.lax.reduce_precision(normalize_images(x), exponent_bits=8,
                                 mantissa_bits=7)))


def _jax_losses(monkeypatch, variables, path, steps, lr):
    """The JAX train step on the JAX loader's first ``steps`` batches of
    ``path`` (no flips), from ``variables``, its normalised images rounded
    to bf16 inside ``jit`` (the module's docstring)."""
    _jit_like_eager(monkeypatch)
    task = jax_tasks.get_task("contrastive", model_name="clip_tiny",
                              image_size=SIZE, seq_len=SEQ, augment=False)
    decode = JaxImageTextDecoder(image_size=SIZE, seq_len=SEQ)
    batches = [dict(b) for b in jax_make_train_pipeline(
        JaxDataset(path), "batch", BATCH, 0, 1, decode)][:steps]
    state = jax_trainer.TrainState.create(
        apply_fn=None, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_trainer.make_optimizer(jax_trainer.TrainConfig(
            dataset_path="-", optimizer="sgd", lr=lr, momentum=0.9)))
    step = jax_trainer.make_train_step(task, get_mesh(jax.devices()[:1]),
                                       donate=False)
    losses = []
    for batch in batches:
        state, loss = step(state, batch, jax.random.key(0))
        losses.append(float(loss))
    return losses


def _cli(path, *extra):
    return cli.main([
        "train", "--dataset_path", path, "--device", "cpu",
        "--task_type", "contrastive", "--model_name", "clip_tiny",
        "--image_size", str(SIZE), "--seq_len", str(SEQ),
        "--batch_size", str(BATCH), "--max_steps", "3", "--epochs", "1",
        "--lr", "0.05", "--no_augment", "--no_autotune", "--log_every", "1",
        *extra])


def test_cli_contrastive_tracks_the_jax_trainer(tmp_path, monkeypatch,
                                                jax_native):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    path = str(tmp_path / "it")
    create_synthetic_image_text_dataset(path, rows=28, seq_len=SEQ,
                                        image_size=SIZE, fragment_size=12)
    _, variables = _variables()
    task = contrastive_task(_port_model(variables), augment=False)
    monkeypatch.setattr(trainer, "get_task", lambda *a, **k: task)
    result = _cli(path)
    assert result["steps"] == 3
    assert result["eval_rows"] == 28 and 0 <= result["eval_accuracy"] <= 1
    assert result["images_per_sec"] > 0
    want = _jax_losses(monkeypatch, variables, path, 3, 0.05)
    assert want[0] != want[2]
    np.testing.assert_allclose(result["losses"], want, rtol=5e-5)


def test_cli_bucketed_captions_train_as_the_padded_ones(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    path = _ragged_captions(str(tmp_path / "it"), rows=24)
    # seq_len 32 is the bucket's floor: both arms give [8, 32] captions.
    runs = {arm: cli.main([
        "train", "--dataset_path", path, "--device", "cpu",
        "--task_type", "contrastive", "--model_name", "clip_tiny",
        "--image_size", str(SIZE), "--seq_len", "32",
        "--batch_size", str(BATCH), "--max_steps", "3", "--log_every", "0",
        "--no_autotune", *flags]) for arm, flags in
        (("padded", []), ("bucket", ["--token_pack"]))}
    assert runs["bucket"]["losses"] == runs["padded"]["losses"]
    assert runs["bucket"]["pack_new_shapes_total"] == 1
    assert runs["bucket"]["pack_sequences_total"] >= 24
    for run in runs.values():
        assert run["eval_rows"] == 24 and np.isfinite(run["losses"]).all()


# ------------------------------------------------- two processes over gloo

_CHILD = textwrap.dedent(r'''
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from torch.nn.parallel import DistributedDataParallel
    from lance_distributed_training_tpu_torch.models import clip, tasks
    from lance_distributed_training_tpu_torch.models.resnet import (
        set_sync_group)

    inp, out, rank, address = sys.argv[1:5]
    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=2, rank=rank)
    data = torch.load(inp)
    model = clip.clip_tiny(max_len=data["seq"], dtype=torch.float32)
    model.load_state_dict(data["state"])
    set_sync_group(model, dist.group.WORLD)
    task = tasks.contrastive_task(model, False, dist.group.WORLD)
    task = task.with_model(DistributedDataParallel(model))
    rows = data["batch"]["image"].shape[0] // 2
    batch = {k: v[rank * rows:(rank + 1) * rows]
             for k, v in data["batch"].items()}
    loss = task.loss(task.forward(batch, True), batch)
    loss.backward()
    torch.save({"loss": float(loss),
                "grads": {k: p.grad for k, p in model.named_parameters()}},
               out)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_train_on_the_global_batch(tmp_path,
                                                      monkeypatch):
    _jit_like_eager(monkeypatch)
    jt = jax_tasks.get_task("contrastive", model_name="clip_tiny",
                            image_size=SIZE, seq_len=SEQ, augment=False)
    _, variables = _variables()
    batch = _batch(9)

    def loss_fn(params):
        outputs, _ = jt.forward({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                batch, True, None)
        return jt.loss(outputs, batch)

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    grads = jax.tree_util.tree_map(np.asarray, grads)
    torch.save({"seq": SEQ, "batch": _torch(batch),
                "state": clip_state_dict_from_flax(variables, (1, 1, 1, 1))},
               tmp_path / "in.pt")
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path / "in.pt"),
         str(tmp_path / f"r{rank}.pt"), str(rank), address],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    runs = [torch.load(tmp_path / f"r{rank}.pt") for rank in range(2)]
    want_grads = clip_state_dict_from_flax(
        {"params": grads, "batch_stats": variables["batch_stats"]},
        (1, 1, 1, 1))
    for r in runs:
        assert r["loss"] == pytest.approx(float(want), abs=ATOL)
        for name, g in r["grads"].items():
            w = want_grads[name].numpy()
            tol = ATOL if not name.startswith("image_tower") else \
                5e-5 * max(np.abs(w).max(), 1e-3)
            np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
