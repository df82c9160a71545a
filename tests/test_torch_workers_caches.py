"""The slice as a whole on the CPU: the port's ``cli train`` with two decode
workers, the batch cache, the HBM replay tier and data echoing trains on
the batch sequence the JAX package's loaders and replay order give, and
its per-step losses are the JAX step function's on that sequence.

The port runs ``--num_workers 2 --batch_cache --device_cache --data_echo 2
--epochs 2 --no_autotune --no_augment --shuffle`` on a seeded JPEG
dataset; its step trace (``LDT_STEP_TRACE_PATH``) gives each step's batch
digest. The JAX side builds the sequence from its in-process loader's
first epoch, each batch twice, then its ``DeviceReplayCache``'s replay of
that epoch, each batch twice. Both sides start from identical seeded
ResNet-18 weights (``num_filters=8``, ``models/convert.py``) with a
float64 trunk, as ``tests/test_torch_classification.py`` does, and agree
within its ``rtol 1e-5``.

Sizes: four batches of 32 an epoch, so 16 steps, at the classification
tests' lr 0.05. Both sides start from one set of weights that f32 holds
exactly: the port's converter (``models/convert.py``) rounds every leaf to
f32, so float64 weights off the f32 grid would start the two trajectories
apart. Both heads compute in f32 (the JAX head's dtype is fixed), and
training amplifies rounding step by step where BatchNorm sees few values
a channel: at batches of 8, against the JAX steps with a float64 head,
the port's steps with its f32 head part by more than 1e-4 within 16
steps and with a float64 head agree within 1e-8
(``test_f64_heads_close_the_gap_at_batch_8``), so two f32 heads that
round differently can part as far. At batches of 32 the two packages' f32
heads stay near 1e-6 apart over 16 steps."""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data import cache as jax_cache
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.models import resnet as jax_resnet
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    create_synthetic_classification_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    classification_task,
    load_flax_resnet,
    resnet,
)
from lance_distributed_training_tpu_torch.native import native_available
from lance_distributed_training_tpu_torch.utils.chaos import batch_digest
from test_torch_threads import _one_torch_thread  # noqa: F401


SIZE, BATCH, BATCHES, ECHO, RTOL, LR = 32, 32, 4, 2, 1e-5, 0.05


def _variables(seed=0):
    """Seeded ResNet-18 variables (``num_filters=8``) with non-trivial
    BatchNorm parameters, in float64 on the f32 grid (the port's
    converter loads f32)."""
    model = jax_resnet.resnet18(dtype=jnp.float32, num_classes=10,
                                num_filters=8)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            leaf = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif key in ("scale", "var"):
            leaf = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            leaf = 0.1 * rng.standard_normal(leaf.shape)
        return np.float64(np.float32(leaf))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native decoder, built privately for this test
    (its own build shares one temp file between concurrent test
    workers)."""
    from lance_distributed_training_tpu.native import jpeg as jax_jpeg

    monkeypatch.setattr(jax_jpeg, "_LIB_PATH", str(tmp_path / "jax_ldt.so"))
    monkeypatch.setattr(jax_jpeg, "_lib", None)
    monkeypatch.setattr(jax_jpeg, "_load_failed", False)
    monkeypatch.delenv("LDT_DISABLE_NATIVE", raising=False)
    return jax_jpeg


def _jax_sequence(path, use_native):
    """The JAX loaders' batches in the order the port must train on them:
    epoch 0 from the in-process loader, epoch 1 from the replay tier, each
    batch ``ECHO`` times."""
    decode = JaxImageDecoder(image_size=SIZE, use_native=use_native)
    assert (decode._native is not None) == use_native
    first = [dict(b) for b in jax_make_train_pipeline(
        JaxDataset(path), "batch", BATCH, 0, 1, decode, shuffle=True,
        seed=0, epoch=0, columns=decode.required_columns)]
    replay = jax_cache.DeviceReplayCache(enabled=True, budget_gb=8.0, seed=0)
    assert replay.start_fill(False, 0)
    for batch in first:
        assert replay.admit(batch, len(first)) is None
    second = list(replay.replay_iter(1, 0, shuffled=True))
    return [b for epoch in (first, second) for b in epoch
            for _ in range(ECHO)]


class _HeadInF64:
    """``jax.numpy`` as the JAX ResNet module sees it, with ``float32``
    (its head's fixed dtype, the one use of the name there) meaning
    float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_losses(variables, sequence, monkeypatch, head_f64=False):
    if head_f64:
        monkeypatch.setattr(jax_resnet, "jnp", _HeadInF64())
    monkeypatch.setitem(jax_tasks._RESNETS, "resnet18", functools.partial(
        jax_resnet.resnet18, dtype=jnp.float64, param_dtype=jnp.float64,
        num_filters=8))
    with jax.enable_x64(True):
        task = jax_tasks.get_task("classification", num_classes=10,
                                  model_name="resnet18", image_size=SIZE,
                                  augment=False)
        config = jax_trainer.TrainConfig(dataset_path="-", optimizer="sgd",
                                         lr=LR, momentum=0.9)
        state = jax_trainer.TrainState.create(
            apply_fn=None, params=variables["params"],
            batch_stats=variables["batch_stats"],
            tx=jax_trainer.make_optimizer(config))
        step = jax_trainer.make_train_step(task, get_mesh(jax.devices()[:1]),
                                           donate=False)
        rng = jax.random.key(7)
        losses = []
        for batch in sequence:
            rng, step_rng = jax.random.split(rng)
            state, loss = step(state, batch, step_rng)
            losses.append(float(loss))
    return losses


def _port_model(variables):
    """The port's ResNet-18 with ``variables``, its trunk in float64."""
    model = resnet.resnet18(dtype=torch.float64, num_classes=10,
                            num_filters=8)
    load_flax_resnet(model, variables)
    return model.to(torch.float64)


def _port_losses(variables, sequence, head_f64):
    """The port's plain SGD steps on ``sequence`` from ``variables``, the
    head in f32 as the package computes it, or in float64."""
    model = _port_model(variables)
    task = classification_task(model, False)
    if head_f64:
        def forward(self, x):  # ResNet.forward without the head's f32 cast
            x = F.max_pool2d(F.relu_(self.bn1(self.conv1(x.to(self.dtype)))),
                             3, 2, 1)
            for layer in self.layers():
                x = layer(x)
            return self.fc(x.mean(dim=(2, 3)))

        model.forward = types.MethodType(forward, model)
        task = dataclasses.replace(task, loss=lambda logits, batch: (
            F.cross_entropy(logits, batch["label"].long())))
    else:
        model.fc.float()
    optimizer, lr = trainer.make_optimizer(trainer.TrainConfig(
        dataset_path="-", optimizer="sgd", lr=LR, momentum=0.9),
        model.parameters())
    step = trainer.make_train_step(task, optimizer, lr)
    return [float(step({k: torch.from_numpy(v) for k, v in b.items()}))
            for b in sequence]


def test_f64_heads_close_the_gap_at_batch_8(monkeypatch):
    """The witness for the sizes above: at batches of 8, with the JAX
    head in float64, the port's steps agree with a float64 head and part
    from it with the package's f32 head."""
    rng = np.random.default_rng(3)
    sequence = [{"image": rng.integers(0, 256, (8, SIZE, SIZE, 3),
                                       dtype=np.uint8),
                 "label": rng.integers(0, 10, 8).astype(np.int32)}
                for _ in range(2 * BATCHES * ECHO)]
    variables = _variables()
    want = np.array(_jax_losses(variables, sequence, monkeypatch,
                                head_f64=True))
    gaps = {head_f64: np.abs(np.array(_port_losses(
        variables, sequence, head_f64)) - want) / np.abs(want)
        for head_f64 in (False, True)}
    assert gaps[False].max() > 1e-4  # an f32 head alone moves the run
    assert gaps[True].max() < 1e-8, gaps[True]


def test_workers_caches_and_echo_train_the_jax_sequence(
        tmp_path, monkeypatch, jax_native):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=BATCH * BATCHES, num_classes=10,
                                            image_size=SIZE, fragment_size=24)
    variables = _variables()
    model = _port_model(variables)
    model.fc.float()  # the head stays f32, as Flax's
    task = classification_task(model, False)
    monkeypatch.setattr(trainer, "get_task", lambda *a, **k: task)
    monkeypatch.setenv("LDT_STEP_TRACE_PATH", str(tmp_path / "steps.jsonl"))
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main([
        "train", "--dataset_path", path, "--device", "cpu",
        "--model_name", "resnet18", "--image_size", str(SIZE),
        "--num_classes", "10", "--batch_size", str(BATCH),
        "--num_workers", "2", "--batch_cache",
        "--cache_dir", str(tmp_path / "bc"), "--device_cache",
        "--data_echo", str(ECHO), "--epochs", "2", "--no_autotune",
        "--no_augment", "--shuffle", "--log_every", "0",
        "--no_eval_at_end", "--lr", str(LR)])

    sequence = _jax_sequence(path, use_native=native_available())
    steps = [json.loads(line) for line in
             (tmp_path / "steps.jsonl").read_text().splitlines()]
    assert [s["batch_sha256"] for s in steps] \
        == [batch_digest(b) for b in sequence]
    assert result["steps"] == len(sequence) == 2 * BATCHES * ECHO
    assert [h["replay"] for h in result["history"]] == [False, True]
    assert result["history"][0]["worker_results"] == BATCHES
    assert result["history"][1]["worker_results"] == 0
    assert result["device_cache_batches"] == BATCHES
    assert result["worker_transport"] == "shm"
    assert result["shm_fallbacks"] == 0
    assert result["cache_misses"] == BATCHES and result["cache_hits"] == 0
    assert result["data_echo"] == ECHO and "autotune_ticks" not in result

    want = _jax_losses(variables, sequence, monkeypatch)
    assert want[0] != want[1]  # each echo is a real update
    np.testing.assert_allclose(result["losses"], want, rtol=RTOL)
