"""The port's torchvision checkpoint import against the JAX package's.

A seeded ResNet-18 (``num_filters=8`` for speed; the names and layouts are
torchvision's at any width) is written with ``torch.save`` in the forms a
torch user meets: bare, under ``state_dict`` or ``model``, with DDP's
``module.`` prefix and ``num_batches_tracked`` entries. The port's
imported model must equal ``resnet_state_dict_from_flax`` of the JAX
importer's variables bit for bit, and its eval-mode f32 logits the JAX
model's within ``tests/test_torch_resnet.py``'s ``RTOL, ATOL``. The head
rule, the coverage checks and their messages are the JAX importer's. The
trainer imports before the DDP wrap and before a restore; its first step's
loss (f32, no flips) equals the JAX task's on the imported variables within
``tests/test_torch_classification.py``'s ``RTOL``. The ResNet-50 parity is
``slow``, as the JAX package marks its own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.data.format import Dataset as JaxDataset
from lance_distributed_training_tpu.data.pipeline import (
    make_train_pipeline as jax_make_train_pipeline,
)
from lance_distributed_training_tpu.data.decode import (
    ImageClassificationDecoder as JaxImageDecoder,
)
from lance_distributed_training_tpu.models import resnet as jax_resnet
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.pretrained import (
    load_torch_state_dict as jax_load_torch_state_dict,
)
from lance_distributed_training_tpu.models.pretrained import (
    torchvision_resnet_to_flax,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    create_synthetic_classification_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    resnet,
    resnet_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.models.pretrained import (
    load_torch_state_dict,
    load_torchvision_resnet,
)
from test_torch_classification import RTOL as TRAIN_RTOL
from test_torch_resnet import ATOL, RTOL
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import privatise_jax_native


SIZE, BATCH, WIDTH = 32, 8, 8


def _torchvision_state(name="resnet18", classes=1000, seed=0):
    """A seeded torchvision-named state_dict, with non-trivial BatchNorm
    parameters and statistics (the default 1, 0, 0, 1 would hide a
    mapping bug) and torchvision's ``num_batches_tracked`` entries."""
    model = getattr(resnet, name)(
        num_classes=classes, num_filters=WIDTH, dtype=torch.float32,
        generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in model.state_dict().items():
        if value.dim() == 1:  # BatchNorm's four vectors and fc's bias
            if key.endswith(("running_var", ".weight")):
                draw = rng.uniform(0.5, 1.5, value.shape)
            else:
                draw = 0.1 * rng.standard_normal(value.shape)
            value = torch.from_numpy(draw.astype(np.float32))
        state[key] = value.clone()
        if key.endswith("running_var"):
            state[key.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7, dtype=torch.int64))
    return state


def _save(path, state, form="bare", prefix=""):
    state = {prefix + k: v for k, v in state.items()}
    obj = {"bare": state, "state_dict": {"state_dict": state, "epoch": 3},
           "model": {"model": state}}[form]
    torch.save(obj, path)
    return str(path)


def _port_model(name="resnet18", classes=1000, seed=0):
    return getattr(resnet, name)(
        num_classes=classes, num_filters=WIDTH, dtype=torch.float32,
        generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _flax_template(name, classes):
    """A Flax ResNet and a template of its variables for the importer:
    zeros of the abstract init's shapes (no Flax computation runs)."""
    model = getattr(jax_resnet, name)(num_classes=classes, num_filters=WIDTH,
                                      dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return model, jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)


def _eval_logits(flax_model, variables, x):
    apply = jax.jit(functools.partial(flax_model.apply, train=False))
    return np.asarray(apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("form,prefix", [("bare", ""), ("state_dict", ""),
                                         ("model", "module."),
                                         ("state_dict", "module.")])
def test_imported_backbone_equals_the_jax_importer_bit_for_bit(
        tmp_path, form, prefix):
    state = _torchvision_state()
    path = _save(tmp_path / "ckpt.pt", state, form, prefix)
    loaded = load_torch_state_dict(path)
    want_sd = jax_load_torch_state_dict(path)
    # The wrappers unwrap and the prefix goes, as in JAX (float32 values,
    # num_batches_tracked kept and skipped by the importer).
    assert sorted(loaded) == sorted(want_sd) == sorted(state)
    model = _port_model(seed=9)
    load_torchvision_resnet(model, loaded, "resnet18")
    flax_model, template = _flax_template("resnet18", 1000)
    imported = torchvision_resnet_to_flax(want_sd, template, "resnet18")
    want = resnet_state_dict_from_flax(imported, model.stage_sizes)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(got[key], state[key]), key
    if form != "bare":
        return
    # The same weights give the same eval-mode logits.
    x = np.random.default_rng(1).standard_normal(
        (4, SIZE, SIZE, 3)).astype(np.float32)
    want_logits = _eval_logits(flax_model, imported, x)
    model.eval()
    with torch.no_grad():
        got_logits = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, rtol=RTOL, atol=ATOL)


def test_head_rule_keeps_a_fresh_head_unless_its_shape_matches(tmp_path):
    state = _torchvision_state()
    path = _save(tmp_path / "ckpt.pt", state)
    model = _port_model(classes=10, seed=4)
    fresh = _port_model(classes=10, seed=4)
    load_torchvision_resnet(model, load_torch_state_dict(path), "resnet18")
    # The backbone from the file, the head the same-seed model's fresh one.
    assert torch.equal(model.conv1.weight, state["conv1.weight"])
    assert tuple(model.fc.weight.shape) == (10, 8 * WIDTH)
    assert torch.equal(model.fc.weight, fresh.fc.weight)
    assert torch.equal(model.fc.bias, fresh.fc.bias)
    # The JAX importer keeps its head for the same checkpoint.
    _, template = _flax_template("resnet18", 10)
    imported = torchvision_resnet_to_flax(jax_load_torch_state_dict(path),
                                          template, "resnet18")
    np.testing.assert_array_equal(imported["params"]["head"]["kernel"],
                                  template["params"]["head"]["kernel"])
    # Equal shapes import the head.
    same = _port_model(classes=1000, seed=4)
    load_torchvision_resnet(same, load_torch_state_dict(path), "resnet18")
    assert torch.equal(same.fc.weight, state["fc.weight"])
    assert torch.equal(same.fc.bias, state["fc.bias"])


def _jax_error(sd_path, name, classes, exc):
    _, template = _flax_template(name, classes)
    with pytest.raises(exc) as want:
        torchvision_resnet_to_flax(jax_load_torch_state_dict(sd_path),
                                   template, name)
    return str(want.value)


@pytest.mark.parametrize("name,exc", [("resnet34", KeyError),
                                      ("resnet50", ValueError)])
def test_wrong_architecture_raises_the_jax_message(tmp_path, name, exc):
    path = _save(tmp_path / "ckpt.pt", _torchvision_state())
    model = _port_model(name, classes=10)
    with pytest.raises(exc) as got:
        load_torchvision_resnet(model, load_torch_state_dict(path), name)
    assert str(got.value) == _jax_error(path, name, 10, exc)


def test_unmapped_keys_unknown_models_and_missing_files_raise_as_jax(
        tmp_path):
    state = _torchvision_state()
    state["extra.weight"] = torch.ones(3)
    path = _save(tmp_path / "ckpt.pt", state)
    with pytest.raises(ValueError) as got:
        load_torchvision_resnet(_port_model(), load_torch_state_dict(path),
                                "resnet18")
    assert str(got.value) == _jax_error(path, "resnet18", 1000, ValueError)
    assert "1 unmapped keys" in str(got.value)
    with pytest.raises(ValueError, match="pretrained import supports") as got:
        load_torchvision_resnet(_port_model(), {}, "vit_base")
    with pytest.raises(ValueError) as want:
        torchvision_resnet_to_flax({}, {}, "vit_base")
    assert str(got.value) == str(want.value)
    missing = str(tmp_path / "none.pt")
    with pytest.raises(FileNotFoundError) as got:
        load_torch_state_dict(missing)
    with pytest.raises(FileNotFoundError) as want:
        jax_load_torch_state_dict(missing)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- trainer


@pytest.fixture
def small_f32_resnet(monkeypatch):
    """The trainer's ResNet-18 at ``WIDTH`` filters in f32."""
    monkeypatch.setitem(resnet.RESNETS, "resnet18", functools.partial(
        resnet.resnet18, dtype=torch.float32, num_filters=WIDTH))
    monkeypatch.setenv("LDT_METRICS_PATH", "/dev/null")


def _dataset(tmp_path, rows=16):
    path = str(tmp_path / "food")
    create_synthetic_classification_dataset(path, rows=rows, num_classes=10,
                                            image_size=SIZE, fragment_size=8)
    return path


def _config(path, ckpt, **kw):
    kw = {"max_steps": 2, **kw}
    return trainer.TrainConfig(
        dataset_path=path, model_name="resnet18", image_size=SIZE,
        num_classes=1000, batch_size=BATCH, epochs=1, log_every=0,
        eval_at_end=False, augment=False, device="cpu", pretrained=ckpt,
        **kw)


def test_first_step_from_the_checkpoint_equals_the_jax_task(
        tmp_path, small_f32_resnet, monkeypatch):
    """Both sides compute the trunk in float64, as
    ``tests/test_torch_classification.py`` does for its ``RTOL``: in f32,
    BatchNorm over the 8 values a channel sees in the last stage amplifies
    the two sides' summation orders. Both decode with their native
    decoders: the JAX one is built privately for this test, since its own
    build links every process into one shared temp file, and a worker that
    loses that race decodes with PIL (8.0e-3 off the port's first loss)."""
    jax_jpeg = privatise_jax_native(monkeypatch, tmp_path)

    def resnet18_f64(**kw):
        model = resnet.resnet18(dtype=torch.float64, num_filters=WIDTH, **kw)
        model.to(torch.float64).fc.float()  # the head stays f32, as Flax's
        return model

    monkeypatch.setitem(resnet.RESNETS, "resnet18", resnet18_f64)
    path = _dataset(tmp_path)
    ckpt = _save(tmp_path / "ckpt.pt", _torchvision_state(), "state_dict",
                 "module.")
    result = trainer.train(_config(path, ckpt))
    assert result["decoder_arm"] == "native" and jax_jpeg.native_available()
    # The JAX task on the imported variables and the same first batch.
    batch = next(iter(jax_make_train_pipeline(
        JaxDataset(path), "batch", BATCH, 0, 1,
        JaxImageDecoder(image_size=SIZE))))
    _, template = _flax_template("resnet18", 1000)
    variables = torchvision_resnet_to_flax(
        jax_load_torch_state_dict(ckpt), template, "resnet18")
    with jax.enable_x64(True):
        monkeypatch.setitem(jax_tasks._RESNETS, "resnet18", functools.partial(
            jax_resnet.resnet18, dtype=jnp.float64, param_dtype=jnp.float64,
            num_filters=WIDTH))
        task = jax_tasks.get_task("classification", num_classes=1000,
                                  model_name="resnet18", image_size=SIZE)
        loss = jax.jit(lambda v, b: task.loss(
            task.forward(v, b, True, None)[0], b))
        want = float(loss(jax.tree_util.tree_map(np.float64, variables),
                          batch))
    np.testing.assert_allclose(result["losses"][0], want, rtol=TRAIN_RTOL)


def test_a_resumed_run_takes_the_checkpoints_weights(tmp_path,
                                                     small_f32_resnet):
    path = _dataset(tmp_path)  # one epoch of two steps
    ckpt = _save(tmp_path / "ckpt.pt", _torchvision_state())
    first = trainer.train(_config(path, ckpt, max_steps=0,
                                  checkpoint_dir=str(tmp_path / "ck")))
    assert first["steps"] == 2 and first["ckpt_last_success_step"] == 2
    # The same command again resumes past the file's weights: nothing is
    # left to train, and the model is the checkpoint's.
    again = trainer.train(_config(path, ckpt, max_steps=0,
                                  checkpoint_dir=str(tmp_path / "ck")))
    assert again["steps"] == 0
    want = first["model"].state_dict()
    for key, value in again["model"].state_dict().items():
        assert torch.equal(value, want[key]), key
    assert not torch.equal(again["model"].conv1.weight,
                           load_torch_state_dict(ckpt)["conv1.weight"])


def test_pretrained_on_a_text_task_raises_the_jax_message(tmp_path):
    with pytest.raises(ValueError, match="has no importer") as got:
        trainer.train(trainer.TrainConfig(
            dataset_path=_dataset(tmp_path), task_type="masked_lm",
            device="cpu", pretrained=str(tmp_path / "ckpt.pt")))
    assert str(got.value) == (
        "--pretrained imports torchvision ResNet checkpoints; task "
        "'masked_lm' has no importer")


def test_cli_pretrained_takes_the_jax_flag(tmp_path, small_f32_resnet):
    path = _dataset(tmp_path)
    ckpt = _save(tmp_path / "ckpt.pt", _torchvision_state(classes=1000))
    result = cli.main(["train", "--dataset_path", path, "--device", "cpu",
                       "--model_name", "resnet18", "--image_size", str(SIZE),
                       "--num_classes", "10", "--batch_size", str(BATCH),
                       "--max_steps", "1", "--no_eval_at_end",
                       "--pretrained", ckpt])
    assert result["steps"] == 1 and np.isfinite(result["losses"][0])
    assert "pretrained" in cli.build_parser().parse_args(
        ["--dataset_path", "-", "--pretrained", ckpt]).__dict__


@pytest.mark.slow
def test_resnet50_import_matches_the_jax_importer(tmp_path):
    """JAX marks its own ResNet-50 parity slow (``tests/test_pretrained.py``)."""
    state = _torchvision_state("resnet50")
    path = _save(tmp_path / "ckpt.pt", state)
    model = _port_model("resnet50", seed=5)
    load_torchvision_resnet(model, load_torch_state_dict(path), "resnet50")
    flax_model, template = _flax_template("resnet50", 1000)
    imported = torchvision_resnet_to_flax(jax_load_torch_state_dict(path),
                                          template, "resnet50")
    want = resnet_state_dict_from_flax(imported, model.stage_sizes)
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    x = np.random.default_rng(2).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    want_logits = _eval_logits(flax_model, imported, x)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)).numpy()
    np.testing.assert_allclose(got, want_logits, rtol=RTOL, atol=ATOL)
