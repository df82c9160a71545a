"""The port's ResNet family against the JAX package's Flax ResNet.

Small models (``num_filters=8``, 32 px, 10 classes) get the same seeded
weights on both sides through ``models/convert.py``, with the BatchNorm
scales, biases and running statistics away from their initial values so
that every branch counts. In f32 eval-mode logits agree within ``rtol 1e-5, atol
2e-5``: the two sides sum in other orders, nothing more. Train-mode logits
and the updated running statistics (biased batch variance, Flax momentum
0.9) are held in float64, where they agree to the f32 head's rounding, and
in f32 within the tolerance that small-batch BatchNorm's conditioning
leaves (``TRAIN_TOL``).
In bf16 compute the eval-mode logits agree within ``atol 0.05`` of logits
of size about 1: a one-ulp bf16 difference in an activation moves a logit
by about 1e-2 (in train mode small-batch BatchNorm amplifies such
differences past any useful bound; the float64 and f32 tests hold it). The converter is held as the inverse of the JAX package's
``torchvision_resnet_to_flax`` in both directions, and the parameter
counts at full width equal Flax's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.models import resnet as jax_resnet
from lance_distributed_training_tpu.models.pretrained import (
    torchvision_resnet_to_flax,
)
from lance_distributed_training_tpu_torch.models import resnet
from lance_distributed_training_tpu_torch.models.convert import (
    load_flax_resnet,
    resnet_state_dict_from_flax,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


SMALL = dict(num_classes=10, num_filters=8)
SIZE, BATCH = 32, 4
NAMES = ["resnet18", "resnet50"]
RTOL, ATOL = 1e-5, 2e-5
BF16_ATOL = 0.05


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _flax_shapes(name):
    """The tree of a small Flax ResNet's variables, as shapes (abstract
    init: no Flax computation runs)."""
    model = getattr(jax_resnet, name)(**SMALL)
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))


@functools.lru_cache(maxsize=None)
def _flax(name, dtype=jnp.float32, seed=0):
    """A small Flax ResNet and seeded variables for it (shared between
    tests, read only): kernels N(0, 1/fan_in), BatchNorm scales and
    running variances in [0.5, 1.5), biases and running means N(0, 0.01),
    so that every branch and statistic counts."""
    model = getattr(jax_resnet, name)(dtype=dtype, **SMALL)
    rng = np.random.default_rng(seed + 100)

    def fill(path, leaf):
        key = path[-1].key
        if key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, _flax_shapes(name))


def _port(name, variables, dtype=torch.float32):
    model = getattr(resnet, name)(dtype=dtype, **SMALL)
    load_flax_resnet(model, variables)
    return model


@pytest.mark.parametrize("name,stages", [("resnet18", (2, 2, 2, 2)),
                                         ("resnet50", (3, 4, 6, 3))])
def test_parameter_counts_equal_flax_at_full_width(name, stages):
    flax_model = getattr(jax_resnet, name)(num_classes=101)
    shapes = jax.eval_shape(
        lambda: flax_model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                train=False))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        model = getattr(resnet, name)(num_classes=101)
    assert model.stage_sizes == stages
    assert sum(p.numel() for p in model.parameters()) == want
    stats = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert sum(b.numel() for b in model.buffers()) == stats


@pytest.mark.parametrize("name", NAMES)
def test_converter_is_the_inverse_of_torchvision_resnet_to_flax(name):
    _, variables = _flax(name)
    state = resnet_state_dict_from_flax(variables, getattr(
        resnet, name)(**SMALL).stage_sizes)
    # Flax → port → (torchvision names) → Flax gives the variables back.
    # A zero template: a leaf the import missed would stay zero.
    fresh = jax.tree_util.tree_map(np.zeros_like, variables)
    back = torchvision_resnet_to_flax(
        {k: v.numpy() for k, v in state.items()}, fresh, name)
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(variables),
            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    # Port → Flax → port gives the state_dict back.
    model = getattr(resnet, name)(generator=torch.Generator().manual_seed(3),
                                  **SMALL)
    ported = model.state_dict()
    flax_vars = torchvision_resnet_to_flax(
        {k: v.numpy() for k, v in ported.items()}, fresh, name)
    again = resnet_state_dict_from_flax(flax_vars, model.stage_sizes)
    assert sorted(again) == sorted(ported)
    for key in ported:
        assert torch.equal(again[key], ported[key].contiguous()), key


@pytest.mark.parametrize("name", NAMES)
def test_eval_logits_match_flax(name):
    flax_model, variables = _flax(name)
    x = _images()
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    model = _port(name, variables).eval()
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# Train-mode tolerance by trunk dtype (the head is f32 on both sides). In
# float64 only the head's f32 rounding is left (and the f32 the Flax side
# stores its running statistics in). In f32, BatchNorm over the 4 to 64
# values a channel sees at 32 px divides by small batch deviations, so f32
# rounding differences grow block by block: measured 1e-5 to 1e-4 on
# ResNet-18's logits, and up to 4e-2 on ResNet-50's (16 blocks), which
# therefore is held in float64 only.
TRAIN_TOL = {"float64": dict(rtol=1e-5, atol=2e-5, stats=1e-6),
             "float32": dict(rtol=0, atol=1e-3, stats=1e-3)}


@pytest.mark.parametrize("name,dtype", [("resnet18", "float64"),
                                        ("resnet50", "float64"),
                                        ("resnet18", "float32")])
def test_train_forward_matches_flax_logits_and_running_stats(name, dtype):
    _, variables = _flax(name)
    x = _images(1)
    tol = TRAIN_TOL[dtype]
    with jax.enable_x64(dtype == "float64"):
        jdt = getattr(jnp, dtype)
        flax_model = getattr(jax_resnet, name)(dtype=jdt, param_dtype=jdt,
                                               **SMALL)
        cast = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                      variables)
        want, updated = flax_model.apply(cast, jnp.asarray(x, jdt),
                                         train=True, mutable=["batch_stats"])
        want = np.asarray(want)
        updated = jax.tree_util.tree_map(np.asarray, updated["batch_stats"])
    model = _port(name, variables, dtype=getattr(torch, dtype))
    model.to(getattr(torch, dtype)).fc.float()
    model.train()
    with torch.no_grad():
        got = model(_nchw(x).to(getattr(torch, dtype)))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"])
    want_state = resnet_state_dict_from_flax(
        {"params": variables["params"], "batch_stats": updated},
        model.stage_sizes)
    state = model.state_dict()
    running = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * sum(
        1 for m in model.modules() if isinstance(m, resnet.BatchNorm2d))
    for key in running:
        np.testing.assert_allclose(state[key].double().numpy(),
                                   want_state[key].double().numpy(),
                                   rtol=tol["stats"], atol=tol["stats"],
                                   err_msg=key)
    if dtype != "float64":
        return
    # The biased variance: at 1 x 1 pixels this layer sees n = BATCH values
    # a channel, and torch's own running_var (unbiased, n / (n - 1) larger)
    # would differ by a third of the batch term, far outside the tolerance.
    key, n = "layer4.1.bn1.running_var", BATCH
    old = np.float64(variables["batch_stats"][
        "BasicBlock_7" if name == "resnet18" else "BottleneckBlock_14"][
        "BatchNorm_0"]["var"])
    batch_var = (want_state[key].double().numpy() - 0.9 * old) / 0.1
    unbiased = 0.9 * old + 0.1 * batch_var * n / (n - 1)
    assert np.abs(state[key].double().numpy() - unbiased).max() > 1e3 * tol[
        "stats"]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_compute_matches_flax_bf16_in_eval(name):
    flax_model, variables = _flax(name, dtype=jnp.bfloat16)
    x = _images(2)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    model = _port(name, variables, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("name,last", [("resnet18", "bn2"),
                                       ("resnet50", "bn3")])
def test_last_bn_scale_of_each_block_starts_at_zero(name, last):
    model = getattr(resnet, name)(generator=torch.Generator().manual_seed(0),
                                  **SMALL)
    state = model.state_dict()
    zero = [k for k in state if k.endswith(f".{last}.weight")]
    assert len(zero) == sum(model.stage_sizes)
    # In Flax terms (through the JAX package's importer): the last
    # BatchNorm of each block (scale_init=zeros_init) is zero, every other
    # scale one, every bias zero.
    shapes = _flax_shapes(name)
    flax_vars = torchvision_resnet_to_flax(
        {k: v.numpy() for k, v in state.items()},
        jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes),
        name)
    last_flax = "BatchNorm_1" if name == "resnet18" else "BatchNorm_2"
    scales = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(flax_vars["params"]):
        names = [p.key for p in path]
        if names[-1] == "scale":
            scales += 1
            want = 0.0 if names[-2] == last_flax else 1.0
            assert np.all(leaf == want), names
        elif names[-1] == "bias" and names[0] != "head":
            assert np.all(leaf == 0.0), names
    assert scales == sum(1 for m in model.modules()
                         if isinstance(m, resnet.BatchNorm2d))
    # Conv kernels: Flax's LeCun normal (truncated at two deviations).
    w = state["layer1.0.conv1.weight"]
    fan_in = w[0].numel()
    bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
    assert 0 < w.abs().max() <= bound + 1e-6
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.2
