"""The port's ViT against the JAX package's, on identical weights.

``vit_tiny`` (hidden 64, two blocks, patch 8) on 32 px images, f32 on both
sides, its Flax parameters carried over by ``models/convert.py``: logits in
eval agree within 1e-5 (absolute, on logits of order 1); one SGD step of the
classification task (K1's plain version normalises and flips, the same
flips on both sides) gives the same loss within rtol 1e-5 and the same
updated logits within 1e-5. The patch-size refusal carries the JAX message,
the classification registry the JAX names, and ``cli train --model_name
vit_tiny`` runs on the CPU with the eval over every row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models import vit as jax_vit
from lance_distributed_training_tpu.ops.image import (
    normalize_images,
    random_flip,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    create_synthetic_classification_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    classification_task,
    get_model_and_loss,
    get_task,
    load_flax_vit,
    vit,
    vit_state_dict_from_flax,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE, BATCH, CLASSES = 32, 6, 10
ATOL = 1e-5


def _params(seed=0):
    model = jax_vit.vit_tiny(num_classes=CLASSES, dtype=jnp.float32)
    params = model.init(jax.random.key(seed),
                        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32),
                        train=False)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params):
    model = vit.vit_tiny(num_classes=CLASSES, image_size=SIZE,
                         dtype=torch.float32)
    load_flax_vit(model, params)
    return model


def _images(seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)


def test_converted_state_dict_covers_the_model_exactly():
    _, params = _params()
    port = vit.vit_tiny(num_classes=CLASSES, image_size=SIZE)
    state = vit_state_dict_from_flax({"params": params})
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert state[name].shape == tensor.shape, name
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_vit_tiny_logits_match_jax():
    model, params = _params()
    images = _images()
    x = np.asarray(normalize_images(jnp.asarray(images)), np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  train=False))
    port = _port(params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (BATCH, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_one_classification_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_tasks, "_classifiers", lambda: {
        "vit_tiny": functools.partial(jax_vit.vit_tiny, dtype=jnp.float32)})
    jt = jax_tasks.get_task("classification", num_classes=CLASSES,
                            model_name="vit_tiny", image_size=SIZE)
    _, params = _params()
    batch = {"image": _images(1),
             "label": np.arange(BATCH, dtype=np.int32) % CLASSES}
    rng = jax.random.key(5)
    flips = np.asarray(jax.random.bernoulli(rng, 0.5, (BATCH, 1, 1, 1)))
    flips = flips.reshape(-1)
    assert 0 < flips.sum() < BATCH
    tx = jax_trainer.make_optimizer(jax_trainer.TrainConfig(
        dataset_path="-", optimizer="sgd", lr=0.1, momentum=0.9))

    def loss_fn(p):
        logits, _ = jt.forward({"params": p}, batch, True, rng)
        return jt.loss(logits, batch)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    moved = optax.apply_updates(params, updates)
    x = normalize_images(jnp.asarray(batch["image"]))
    want_after = np.asarray(jt.model.apply({"params": moved}, x,
                                           train=False))
    # The JAX forward flips with its own draw: the same bits here.
    np.testing.assert_array_equal(
        np.asarray(random_flip(rng, x)),
        np.asarray(jnp.where(flips[:, None, None, None], x[:, :, ::-1], x)))

    task = classification_task(_port(params))
    optimizer, lr = trainer.make_optimizer(trainer.TrainConfig(
        dataset_path="-", optimizer="sgd", lr=0.1, momentum=0.9),
        task.model.parameters())
    step = trainer.make_train_step(task, optimizer, lr)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = float(step(tbatch, flip_mask=torch.from_numpy(flips)))
    np.testing.assert_allclose(got, float(loss), rtol=1e-5)
    with torch.no_grad():
        after = task.forward(tbatch, False)
    np.testing.assert_allclose(after.numpy(), want_after, atol=ATOL)


@pytest.mark.parametrize("where", ["build", "forward"])
def test_patch_size_error_is_the_jax_message(where):
    model = jax_vit.vit_tiny(num_classes=CLASSES)
    with pytest.raises(ValueError) as want:
        model.init(jax.random.key(0), jnp.zeros((1, 30, 30, 3)), train=False)
    with pytest.raises(ValueError) as got:
        if where == "build":
            vit.vit_tiny(num_classes=CLASSES, image_size=30)
        else:
            vit.vit_tiny(num_classes=CLASSES, image_size=SIZE)(
                torch.zeros(1, 3, 30, 30))
    assert str(got.value) == str(want.value) == "image 30x30 not divisible " \
        "by patch 8"


def test_registry_names_and_refusals_are_the_jax_ones():
    with pytest.raises(ValueError) as want:
        jax_tasks.get_task("classification", model_name="vit_huge")
    with pytest.raises(ValueError) as got:
        get_task("classification", model_name="vit_huge")
    assert str(got.value) == str(want.value)
    with torch.device("meta"):
        model, _, _ = get_model_and_loss("classification", 101,
                                         model_name="vit_base")
    assert isinstance(model, vit.ViT) and model.head.out_features == 101
    assert model.pos_embed.shape == (196, 768)  # 224 px, patch 16
    assert model.patch_embed.weight.shape == (768, 3, 16, 16)


def test_cli_trains_vit_tiny_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=20, num_classes=10,
                                            image_size=SIZE, fragment_size=8)
    result = cli.main([
        "train", "--dataset_path", path, "--device", "cpu",
        "--model_name", "vit_tiny", "--image_size", str(SIZE),
        "--num_classes", "10", "--batch_size", "8", "--max_steps", "2",
        "--log_every", "1"])
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    assert isinstance(result["model"], vit.ViT)
    assert result["eval_rows"] == 20 and 0 <= result["eval_accuracy"] <= 1
    with pytest.raises(ValueError, match="requires a sequence model"):
        cli.main(["train", "--dataset_path", path, "--device", "cpu",
                  "--model_name", "vit_tiny", "--flash_attention"])
