"""The port's classification trainer against the JAX trainer's pieces, the
CLI on a JPEG dataset, and data parallelism across two processes.

Both sides start from identical seeded ResNet-18 weights (``num_filters=8``,
32 px, 10 classes; ``models/convert.py``) and take the same flips: the JAX
step draws them inside ``random_flip`` from its step key, and the test
draws the same bits with ``jax.random.bernoulli`` and hands them to the
port. Three SGD steps (JAX: its ``make_train_step`` under ``enable_x64``)
run with a float64 trunk on both sides and agree within ``rtol 1e-5`` on
the losses and the running statistics; only the f32 head rounds. In f32,
BatchNorm over the 8 values a channel sees in the last stage amplifies the
two sides' different summation orders step by step (1e-3 by the third
step at lr 0.05; ``test_torch_resnet.py`` holds one f32 forward). The
two-process run computes in f32 on both arms, so the same code on the same
global batch agrees within 1e-5.
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
import optax
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data.pipeline import (
    make_eval_pipeline as jax_make_eval_pipeline,
)
from lance_distributed_training_tpu.models import resnet as jax_resnet
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    ImageClassificationDecoder,
    create_synthetic_classification_dataset,
    make_eval_pipeline,
)
from lance_distributed_training_tpu_torch.models import (
    classification_task,
    get_model_and_loss,
    get_task,
    load_flax_resnet,
    resnet,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import privatise_jax_native


ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(num_classes=10, num_filters=8)
SIZE, BATCH = 32, 8
RTOL = 1e-5


def _variables(seed=0):
    """Seeded ResNet-18 variables with non-trivial BatchNorm parameters."""
    model = jax_resnet.resnet18(dtype=jnp.float32, **SMALL)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3),
                                  dtype=np.uint8),
            "label": rng.integers(0, 10, BATCH).astype(np.int32)}


def _jax_task(monkeypatch, dtype=jnp.float32):
    """The JAX package's classification task over a ResNet-18 in ``dtype``
    with ``num_filters=8`` (its registry builds bf16 full width)."""
    monkeypatch.setitem(jax_tasks._RESNETS, "resnet18", functools.partial(
        jax_resnet.resnet18, dtype=dtype, param_dtype=dtype, num_filters=8))
    return jax_tasks.get_task("classification", num_classes=10,
                              model_name="resnet18", image_size=SIZE)


@pytest.fixture
def jax_task(monkeypatch):
    return _jax_task(monkeypatch)


def _port_task(variables, augment=True, dtype=torch.float32):
    model = resnet.resnet18(dtype=dtype, **SMALL)
    load_flax_resnet(model, variables)
    model.to(dtype).fc.float()  # the head stays f32, as Flax's does
    return classification_task(model, augment)


def _three_sgd_steps(monkeypatch, weight_decay, batches):
    """Three SGD steps on ``batches`` (numpy dicts) by the JAX step under
    x64 and by the port in float64, from the same weights and flips:
    ``(jax losses, port losses, jax running var, flips, port task)``."""
    kw = dict(optimizer="sgd", lr=0.05, momentum=0.9,
              weight_decay=weight_decay)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: np.float64(a),
                                           _variables())
        jax_task = _jax_task(monkeypatch, jnp.float64)
        config_j = jax_trainer.TrainConfig(dataset_path="-", **kw)
        state = jax_trainer.TrainState.create(
            apply_fn=None, params=variables["params"],
            batch_stats=variables["batch_stats"],
            tx=jax_trainer.make_optimizer(config_j))
        mesh = get_mesh(jax.devices()[:1])
        jax_step = jax_trainer.make_train_step(jax_task, mesh, donate=False)
        rng = jax.random.key(7)
        want, draws = [], []
        for s in range(3):
            rng, step_rng = jax.random.split(rng)
            draws.append(np.asarray(jax.random.bernoulli(
                step_rng, 0.5, (BATCH, 1, 1, 1))).reshape(-1).copy())
            state, loss = jax_step(state, batches[s], step_rng)
            want.append(float(loss))
        want_var = np.asarray(state.batch_stats["norm_init"]["var"])

    task = _port_task(variables, dtype=torch.float64)
    optimizer, lr = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", **kw),
        task.model.parameters())
    step = trainer.make_train_step(task, optimizer, lr)
    got = []
    for s in range(3):
        batch = {k: torch.from_numpy(v) for k, v in batches[s].items()}
        got.append(float(step(batch, flip_mask=torch.from_numpy(draws[s]))))
    return want, got, want_var, draws, task


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3], ids=["sgd", "sgd_l2"])
def test_three_sgd_steps_match_jax(monkeypatch, weight_decay):
    want, got, want_var, draws, task = _three_sgd_steps(
        monkeypatch, weight_decay, [_batch(s) for s in range(3)])
    assert want[0] != want[2] and 0 < sum(map(np.sum, draws)) < 3 * BATCH
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # The running statistics moved as the JAX step's did.
    np.testing.assert_allclose(task.model.bn1.running_var.numpy(), want_var,
                               rtol=RTOL)


def test_weighted_eval_matches_jax_on_a_padded_tail(jax_task, tmp_path):
    rows, global_batch = 20, 8  # 3 batches, the last with 4 wrapped pads
    create_synthetic_classification_dataset(
        str(tmp_path / "food"), rows=rows, num_classes=10, image_size=SIZE,
        fragment_size=7)
    dataset = Dataset(tmp_path / "food")
    decode = ImageClassificationDecoder(image_size=SIZE)
    variables = _variables(1)
    state = jax_trainer.TrainState.create(
        apply_fn=None, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.sgd(0.1))
    mesh = get_mesh(jax.devices()[:1])
    want = jax_trainer.evaluate(
        state,
        jax_make_eval_pipeline(lambda idx: dataset.take(idx), rows,
                               global_batch, 0, 1, decode),
        jax_trainer.make_eval_step(jax_task, mesh))
    task = _port_task(variables)
    loader = make_eval_pipeline(lambda idx: dataset.take(idx), rows,
                                global_batch, 0, 1, decode, "cpu")
    got, count = trainer.evaluate(loader, trainer.make_eval_step(task))
    assert count == rows
    assert got == pytest.approx(want, abs=1e-7)
    # Without the weights the pads would count: 24 examples, not 20.
    plain = [{k: v for k, v in b.items() if k != "_weight"} for b in loader]
    _, unweighted = trainer.evaluate(plain, trainer.make_eval_step(task))
    assert unweighted == 24


# ------------------------------------------- --device_decode: K2's batches


@pytest.fixture
def jax_coeff(tmp_path, monkeypatch):
    """The JAX package's coefficient decoder and K2 transform, over its
    native extractor built privately for this test (its own build links
    every process into one shared temp file)."""
    from lance_distributed_training_tpu.data import device_decode
    from lance_distributed_training_tpu.ops import jpeg_device

    privatise_jax_native(monkeypatch, tmp_path)
    return (device_decode.CoeffImageDecoder(image_size=SIZE),
            jpeg_device.make_batch_transform(SIZE))


def _port_coeff():
    from lance_distributed_training_tpu_torch.data import CoeffImageDecoder
    from lance_distributed_training_tpu_torch.ops.jpeg_device import (
        make_batch_transform,
    )

    return CoeffImageDecoder(image_size=SIZE), make_batch_transform(SIZE)


def test_three_sgd_steps_with_device_decode_match_jax(jax_coeff, monkeypatch,
                                                      tmp_path):
    """Both sides decode the same JPEG rows through their device-decode
    arm (coefficient pages, then K2), get the same pixels bit for bit, and
    take three SGD steps on them within ``RTOL``, as
    ``test_three_sgd_steps_match_jax`` does on random pixels."""
    dataset = Dataset(_image_dataset(tmp_path))
    jax_decode, jax_transform = jax_coeff
    port_decode, port_transform = _port_coeff()
    batches = []
    for s in range(3):
        table = dataset.take(np.arange(s * BATCH, (s + 1) * BATCH))
        want = {k: np.array(v) for k, v in
                jax_transform(jax_decode(table)).items()}
        got = port_transform({k: torch.from_numpy(v) for k, v in
                              port_decode(table).items()})
        assert sorted(got) == sorted(want) == ["image", "label"]
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        batches.append(want)
    want, got, want_var, _, task = _three_sgd_steps(monkeypatch, 0.0,
                                                     batches)
    assert want[0] != want[2]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(task.model.bn1.running_var.numpy(), want_var,
                               rtol=RTOL)


def test_weighted_eval_with_device_decode_matches_jax(jax_coeff, jax_task,
                                                      tmp_path):
    """The eval loaders carry coefficient pages and ``_weight``; each side
    decodes them with its K2 ahead of its eval step, as the trainers do."""
    rows, global_batch = 20, 8
    create_synthetic_classification_dataset(
        str(tmp_path / "food"), rows=rows, num_classes=10, image_size=SIZE,
        fragment_size=7)
    dataset = Dataset(tmp_path / "food")
    jax_decode, jax_transform = jax_coeff
    port_decode, port_transform = _port_coeff()
    variables = _variables(1)
    state = jax_trainer.TrainState.create(
        apply_fn=None, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.sgd(0.1))
    jax_eval = jax_trainer.make_eval_step(jax_task, get_mesh(
        jax.devices()[:1]))
    want = jax_trainer.evaluate(
        state,
        jax_make_eval_pipeline(lambda idx: dataset.take(idx), rows,
                               global_batch, 0, 1, jax_decode),
        lambda st, batch: jax_eval(st, jax_transform(batch)))
    port_eval = trainer.make_eval_step(_port_task(variables))
    loader = make_eval_pipeline(lambda idx: dataset.take(idx), rows,
                                global_batch, 0, 1, port_decode, "cpu")
    got, count = trainer.evaluate(
        loader, lambda batch: port_eval(port_transform(batch)))
    assert count == rows
    assert got == pytest.approx(want, abs=1e-7)


def test_get_model_and_loss_and_unported_tasks():
    with torch.device("meta"):
        model, loss_fn, eval_fn = get_model_and_loss("classification", 101)
    assert isinstance(model, resnet.ResNet) and model.fc.out_features == 101
    logits = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 0.0]])
    batch = {"label": torch.tensor([1, 2])}
    assert eval_fn(logits, batch).tolist() == [1.0, 0.0]
    assert float(loss_fn(logits, batch)) == pytest.approx(float(
        torch.nn.functional.cross_entropy(logits, batch["label"])))
    with pytest.raises(ValueError, match="Invalid task type: masked_lm"):
        get_model_and_loss("masked_lm", 10)
    # causal_lm and contrastive are ported (tests/test_torch_causal_lm.py,
    # tests/test_torch_contrastive.py), and so are the ViTs
    # (tests/test_torch_vit.py); unknown names raise.
    with pytest.raises(ValueError, match="Invalid model name"):
        get_task("contrastive", model_name="clip_vit_b16")
    with pytest.raises(ValueError, match="Invalid model name"):
        get_task("classification", model_name="vit_huge")


def _image_dataset(tmp_path, rows=24):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=rows, num_classes=10,
                                            image_size=SIZE, fragment_size=10)
    return path


def _cli_args(path, *extra):
    return ["train", "--dataset_path", path, "--task_type", "classification",
            "--model_name", "resnet18", "--image_size", str(SIZE),
            "--num_classes", "10", "--batch_size", str(BATCH),
            "--max_steps", "2", "--log_every", "1", *extra]


def test_cli_trains_classification_two_steps_on_cpu(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(_image_dataset(tmp_path), "--device", "cpu"))
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["decoder_arm"] in ("native", "pil")
    assert result["eval_rows"] == 24 and 0.0 <= result["eval_accuracy"] <= 1.0
    assert result["images_per_sec"] > 0 and result["world_size"] == 1
    assert result["images_per_sec_whole_run"] > 0
    out = capsys.readouterr().out
    assert "[metrics] decoder_arm=" in out and "images_per_sec=" in out
    assert "eval_accuracy=" in out
    # decoder arm, two steps, the epoch line and the eval line
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 5


def test_cli_trains_with_device_decode_two_steps_on_cpu(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(_image_dataset(tmp_path), "--device", "cpu",
                                "--device_decode"))
    assert result["steps"] == 2 and result["decoder_arm"] == "coeff"
    assert len(result["losses"]) == 2 and all(np.isfinite(result["losses"]))
    assert result["eval_rows"] == 24
    assert result["decode_entropy_ms"] > 0 and result["decode_threads"] >= 1
    assert result["decode_device_ms"] is None  # no card: nothing timed
    out = capsys.readouterr().out
    assert "[metrics] decoder_arm=coeff" in out
    assert "decode_entropy_ms=" in out
    # The control arm is the pixel decoder; the two flags exclude each other.
    plain = cli.main(_cli_args(_image_dataset(tmp_path / "b"), "--device",
                               "cpu", "--no_device_decode",
                               "--no_eval_at_end"))
    assert plain["decoder_arm"] in ("native", "pil")
    with pytest.raises(SystemExit):
        cli.main(_cli_args("-", "--device_decode", "--no_device_decode"))


def test_cli_device_decode_raises_when_the_extractor_cannot_build(
        tmp_path, monkeypatch):
    """No silent fallback to the pixel decoder: the build error surfaces."""
    from lance_distributed_training_tpu_torch.native import coeffs

    def broken_build(src, target, flags, libs=()):
        raise OSError("g++ failed (exit 1): simulated")

    monkeypatch.setattr(coeffs, "_lib", None)
    monkeypatch.setattr(coeffs, "library_path",
                        lambda src, flags, stem: tmp_path / "none.so")
    monkeypatch.setattr(coeffs, "build_library", broken_build)
    monkeypatch.setenv("LDT_METRICS_PATH", os.devnull)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cli.main(_cli_args(_image_dataset(tmp_path), "--device", "cpu",
                           "--device_decode"))
    with pytest.raises(ValueError, match="classification"):
        trainer.train(trainer.TrainConfig(
            dataset_path="-", task_type="masked_lm", device="cpu",
            device_decode=True))


def test_cli_classification_without_device_cpu_raises_without_a_card(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_cli_args(_image_dataset(tmp_path)))


def test_train_draws_flips_from_its_generator(tmp_path, monkeypatch):
    """The same seed gives the same run; augment off gives another."""
    monkeypatch.setenv("LDT_METRICS_PATH", os.devnull)
    path = _image_dataset(tmp_path)
    runs = [cli.main(_cli_args(path, "--device", "cpu", "--no_eval_at_end",
                               *extra))["losses"]
            for extra in ((), (), ("--no_augment",))]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


# ------------------------------------------------- two processes over gloo

_CHILD = textwrap.dedent(r'''
    import functools, os, sys
    import torch
    torch.set_num_threads(2)
    from lance_distributed_training_tpu_torch.models import resnet
    # f32 compute, so that the comparison can be tight.
    resnet.RESNETS["resnet18"] = functools.partial(resnet.resnet18,
                                                   dtype=torch.float32)
    from lance_distributed_training_tpu_torch.trainer import TrainConfig, train

    path, out, world, rank, address = sys.argv[1:6]
    kw = dict(dataset_path=path, model_name="resnet18", image_size=32,
              num_classes=10, batch_size=8, max_steps=3, epochs=1,
              log_every=0, eval_at_end=False, device="cpu")
    if int(world) > 1:
        kw.update(coordinator_address=address, num_processes=int(world),
                  process_id=int(rank))
    result = train(TrainConfig(**kw))
    torch.save({"losses": result["losses"], "world": result["world_size"],
                "state": result["model"].state_dict()}, out)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run_matches_one_process(tmp_path):
    path = _image_dataset(tmp_path, rows=32)
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, LDT_METRICS_PATH=os.devnull,
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    runs = [("2", "0"), ("2", "1"), ("1", "0")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, path,
         str(tmp_path / f"w{world}r{rank}.pt"), world, rank, address],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, rank in runs]
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
    one = torch.load(tmp_path / "w1r0.pt")
    assert one["world"] == 1
    for rank in ("0", "1"):
        two = torch.load(tmp_path / f"w2r{rank}.pt")
        assert two["world"] == 2
        np.testing.assert_allclose(two["losses"], one["losses"], rtol=0,
                                   atol=1e-5)
        assert sorted(two["state"]) == sorted(one["state"])
        for key, want in one["state"].items():
            np.testing.assert_allclose(two["state"][key].numpy(),
                                       want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=key)
