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

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch import ops
from lance_distributed_training_tpu_torch.ops import image
from test_torch_threads import _one_torch_thread  # noqa: F401


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


# ------------------------------------------------- the kernel's table and routes


def _k1_config() -> dict:
    """The rows route's threads and rows a chunk, read from ``image.cu``."""
    source = (Path(image.__file__).parent / "csrc" / "image.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                source).group(1))
            for name in ("kThreads", "kRows")}


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 → bf16 bits (uint16), round to nearest even; no NaN here."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _kernel_table() -> np.ndarray:
    """The 3 x 256 table each CTA builds: bf16 bits of f_c(x), each step an
    f32 operation on bf16 values (true divisions) rounded to bf16."""
    mean, std = (np.float32(v) for v in image.bf16_constants())
    x = np.arange(256, dtype=np.float32)
    t1 = _bf16_value(_round_bf16(x / np.float32(255.0)))
    rows = []
    for c in range(3):
        t2 = _bf16_value(_round_bf16(t1 - mean[c]))
        rows.append(_round_bf16(t2 / std[c]))
    return np.stack(rows)


def _rows_route(x: np.ndarray, flip: np.ndarray, table: np.ndarray):
    """The rows route's walk: chunks of kRows rows, thread `tid` of
    kThreads taking units tid, tid + kThreads, ... (8 elements each),
    stepped as the kernel steps them, source bytes and channels as it
    indexes them. Returns the output bits and how often each unit was
    written."""
    cfg = _k1_config()
    threads, chunk = cfg["kThreads"], cfg["kRows"]
    b_, h_, w_, _ = x.shape
    flat = x.reshape(b_ * h_, 3 * w_)
    upr = 3 * w_ // 8
    out = np.zeros((b_ * h_, 3 * w_), np.uint16)
    writes = np.zeros((b_ * h_, upr), np.int64)
    d_rows, d_units = threads // upr, threads % upr
    for row0 in range(0, b_ * h_, chunk):
        n = min(chunk, b_ * h_ - row0)
        for tid in range(threads):
            rl, uu = tid // upr, tid % upr
            b, h = divmod(row0 + rl, h_)
            while rl < n:
                m = uu % 3
                c0 = 0 if m == 0 else 3 - m
                ch = [c0, 0 if c0 == 2 else c0 + 1, 2 if c0 == 0 else c0 - 1]
                j = np.arange(8)
                chans = np.array([ch[i % 3] for i in j])
                src = (3 * w_ - 3 - 8 * uu - j + 2 * chans) if flip[b] \
                    else 8 * uu + j
                out[row0 + rl, 8 * uu + j] = table[chans,
                                                   flat[row0 + rl, src]]
                writes[row0 + rl, uu] += 1
                uu += d_units
                rl += d_rows
                dh = d_rows
                if uu >= upr:
                    uu, rl, dh = uu - upr, rl + 1, dh + 1
                h += dh
                while h >= h_:
                    h, b = h - h_, b + 1
    return out.reshape(x.shape), writes


def _bytes_route(x: np.ndarray, flip: np.ndarray, table: np.ndarray):
    """The groups route with byte loads: pixel w of image b reads pixel
    W - 1 - w where flip[b] is set, each channel through its table row."""
    src = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    return table[np.arange(3), src]


def _vector_groups_route(x: np.ndarray, flip: np.ndarray,
                         table: np.ndarray) -> np.ndarray:
    """The groups route with 16-byte vectors (W % 16 == 0): group g of a
    row loads the 48 bytes of pixels [src0, src0 + 16), src0 = W - 16g - 16
    where mirrored, and output element j of the group reads byte
    ``(15 - j // 3 if mirrored else j // 3) * 3 + j % 3`` of them."""
    b_, h_, w_, _ = x.shape
    j = np.arange(48)
    out = np.zeros((b_, h_, 3 * w_), np.uint16)
    for b in range(b_):
        pixel = 15 - j // 3 if flip[b] else j // 3
        for g in range(w_ // 16):
            src0 = w_ - 16 * g - 16 if flip[b] else 16 * g
            span = x[b, :, src0:src0 + 16, :].reshape(h_, 48)
            out[b][:, 48 * g + j] = table[j % 3, span[:, pixel * 3 + j % 3]]
    return out.reshape(x.shape)


def test_kernel_table_matches_jax_on_every_value(jx):
    every = np.repeat(np.arange(256, dtype=np.uint8), 3).reshape(1, 16, 16, 3)
    want = np.asarray(jx.jax.jit(jx.image.normalize_images)(every))
    want_bits = _round_bf16(want.astype(np.float32)).reshape(256, 3)
    table = _kernel_table()
    for c in range(3):
        np.testing.assert_array_equal(table[c], want_bits[:, c])


@pytest.mark.parametrize("shape,seed", [((3, 5, 16, 3), 0), ((2, 7, 48, 3), 1),
                                        ((1, 33, 17, 3), 2), ((3, 4, 20, 3), 3),
                                        ((2, 9, 224, 3), 4), ((1, 3, 8, 3), 5)])
def test_kernel_routes_match_jax_normalize_and_flip(jx, shape, seed):
    """Each route the shape can take (rows and 16-byte groups only where
    W % 16 == 0, byte groups always: an unaligned batch takes them at any
    W) equals JAX's normalise + flip bit for bit, and the rows route writes
    every unit once."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    flip = rng.random(shape[0]) < 0.5
    flip[0] = True
    want = np.asarray(jx.jax.jit(
        lambda im: jnp_where_flip(jx, jx.image.normalize_images(im), flip))(x))
    want_bits = _round_bf16(want.astype(np.float32))
    table = _kernel_table()
    np.testing.assert_array_equal(_bytes_route(x, flip, table), want_bits)
    if shape[2] % 16 == 0:
        got, writes = _rows_route(x, flip, table)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want_bits)
        np.testing.assert_array_equal(_vector_groups_route(x, flip, table),
                                      want_bits)


def jnp_where_flip(jx, images, flip):
    """``random_flip``'s select with the draw given."""
    keep = jx.jnp.asarray(flip)[:, None, None, None]
    return jx.jnp.where(keep, jx.jnp.flip(images, axis=2), images)


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
                                   (3, 5, 16, 3), (1, 33, 17, 3),
                                   (3, 33, 17, 3), (2, 7, 48, 3),
                                   (2, 3, 2048, 3), (1, 2, 8192, 3)])
@pytest.mark.parametrize("mask", ["none", "random", "all"])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_matches_plain_on_card(cuda_device, shape, mask, offset):
    """Both routes, bit for bit: W % 16 == 0 at offset 0 takes the rows
    route; W = 8192 (too wide a row for its chunk) the groups route with
    16-byte vectors; W = 17 and a batch 1 byte into a larger buffer (not
    16-byte aligned) the groups route with byte loads."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] + shape[2])
    flat = torch.randint(0, 256, (offset + int(np.prod(shape)),),
                         generator=gen, device=cuda_device, dtype=torch.uint8)
    x = flat[offset:].view(shape)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
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
