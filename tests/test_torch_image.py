"""K1 (image normalisation + flip) in the PyTorch port against the JAX side.

The plain PyTorch version (what ``normalize_flip`` runs for CPU tensors) is
held against the JAX package's jitted ``normalize_images`` and
``random_flip``, with the flip draw made by ``jax.random.bernoulli`` exactly
as ``random_flip`` makes it and handed to the port. The bound is 0 bf16
ulps: the largest gap measured is 0 over every uint8 value in every
channel, because both sides round to bf16 after each operation (XLA on the
CPU keeps each bf16 op's rounding; computing the chain in f32 and rounding
once instead would differ by up to 17842 ulps near zero). Tests marked
``cuda`` hold the kernel against the plain version on the card, bit for
bit, at the classification path's shapes, and skip without a card.
"""

import types

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch import ops
from lance_distributed_training_tpu_torch.ops import image

MAX_ULPS = 0  # bf16 ulps allowed between the port and the JAX function


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy and the JAX package's image ops."""
    jax = pytest.importorskip("jax")
    from lance_distributed_training_tpu.ops import image as package_image

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, image=package_image)


def _bf16_bits(x) -> np.ndarray:
    """bf16 values (a torch tensor or a JAX/numpy bf16 array) → int32 bit
    patterns, ordered so that adjacent floats differ by 1."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)
    bits = x.view(torch.int16).to(torch.int32).numpy()
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulps(a, b) -> int:
    return int(np.abs(_bf16_bits(a) - _bf16_bits(b)).max())


def test_constants_are_the_jax_functions_bf16_constants(jx):
    mean, std = image.bf16_constants()
    want_mean = np.asarray(jx.jnp.asarray(jx.image.IMAGENET_MEAN,
                                          jx.jnp.bfloat16)).astype(np.float32)
    want_std = np.asarray(jx.jnp.asarray(jx.image.IMAGENET_STD,
                                         jx.jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(np.float32(mean), want_mean)
    np.testing.assert_array_equal(np.float32(std), want_std)
    assert mean[0] == 0.484375
    assert image.IMAGENET_MEAN == jx.image.IMAGENET_MEAN
    assert image.IMAGENET_STD == jx.image.IMAGENET_STD


def test_every_uint8_value_matches_jax_normalize(jx):
    every = np.repeat(np.arange(256, dtype=np.uint8), 3).reshape(1, 16, 16, 3)
    want = jx.jax.jit(jx.image.normalize_images)(every)
    got = image.normalize_images_reference(torch.from_numpy(every))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 16, 16, 3)
    assert _ulps(got, want) <= MAX_ULPS


@pytest.mark.parametrize("shape,seed", [((4, 32, 32, 3), 0),
                                        ((1, 33, 17, 3), 1),
                                        ((6, 16, 48, 3), 2)])
def test_normalize_and_flip_match_jax(jx, shape, seed):
    x = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    key = jx.jax.random.key(seed)
    # random_flip's own draw, made outside it so the port can be given it.
    draw = np.asarray(jx.jax.random.bernoulli(key, 0.5, (shape[0], 1, 1, 1)))

    @jx.jax.jit
    def jax_prep(images, k):
        return jx.image.random_flip(k, jx.image.normalize_images(images))

    want = jax_prep(x, key)
    got = image.normalize_flip(torch.from_numpy(x),
                               torch.from_numpy(draw.reshape(-1).copy()))
    assert _ulps(got, want) <= MAX_ULPS
    assert 0 < draw.sum() < shape[0] or shape[0] == 1


def test_cpu_route_is_the_plain_version_and_counts_no_launch():
    x = torch.randint(0, 256, (3, 5, 7, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    mask = torch.tensor([True, False, True])
    before = dict(ops.LAUNCHES)
    got = image.normalize_flip(x, mask)
    want = image.random_flip_reference(image.normalize_images_reference(x),
                                       mask)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got[1], image.normalize_images_reference(x)[1])
    assert torch.equal(got[0], image.normalize_images_reference(x)[0].flip(1))
    assert dict(ops.LAUNCHES) == before
    # The model's view of the NHWC output is channels_last NCHW, no copy.
    view = got.permute(0, 3, 1, 2)
    assert view.is_contiguous(memory_format=torch.channels_last)
    assert view.data_ptr() == got.data_ptr()


def test_launch_counter_is_part_of_ops_launches():
    assert "image_normalize" in ops.LAUNCHES
    assert {"fwd", "bwd_dq", "bwd_dkv"} <= set(ops.LAUNCHES)


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 224, 224, 3), (1, 224, 224, 3),
                                   (1, 33, 17, 3), (3, 33, 17, 3),
                                   (2, 7, 48, 3)])
@pytest.mark.parametrize("mask", ["none", "random", "all"])
def test_kernel_matches_plain_on_card(cuda_device, shape, mask):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] + shape[2])
    x = torch.randint(0, 256, shape, generator=gen, device=cuda_device,
                      dtype=torch.uint8)
    flip = {"none": None,
            "random": torch.rand(shape[0], generator=gen,
                                 device=cuda_device) < 0.5,
            "all": torch.ones(shape[0], dtype=torch.bool,
                              device=cuda_device)}[mask]
    before = ops.LAUNCHES["image_normalize"]
    got = image.normalize_flip(x, flip)
    want = image.normalize_images_reference(x)
    if flip is not None:
        want = image.random_flip_reference(want, flip)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert ops.LAUNCHES["image_normalize"] == before + 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        image.normalize_flip(x.float())
    with pytest.raises(ValueError):
        image.normalize_flip(torch.zeros((2, 4, 4, 4), dtype=torch.uint8,
                                         device=cuda_device))
    with pytest.raises(ValueError):
        image.normalize_flip(x, torch.ones(3, dtype=torch.bool,
                                           device=cuda_device))
