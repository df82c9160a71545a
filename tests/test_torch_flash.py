"""Flash attention in the PyTorch port against the JAX side.

The plain PyTorch versions (what the kernel wrappers run for CPU tensors)
are held against upstream's ``mha_reference_no_custom_vjp`` and its
``jax.grad`` in f32, and the port's ``make_flash_attention`` against the JAX
package's own (its dense fallback off the TPU) at valid query positions,
where the Pallas kernel and the fallback agree by design. Tests marked
``cuda`` hold the CUDA kernels against the plain versions and skip without
a card. The JAX side is imported by a fixture, so that on a machine with a
card and no JAX the ``cuda`` tests still run (``-m cuda --noconftest``).
"""

import types

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch.ops import flash
from test_torch_threads import _one_torch_thread  # noqa: F401


B, H, S, D = 2, 3, 24, 16
SCALE = 1.0 / np.sqrt(D)
LENGTHS = np.array([S, 13])
VALID = (np.arange(S)[None, :] < LENGTHS[:, None]).astype(np.int32)
PACKED = np.array([[1] * 10 + [2] * 9 + [3] * 5,
                   [1] * 6 + [2] * 7 + [0] * 11], np.int32)

# (name, segment ids or None, causal)
CASES = [
    ("padded", VALID, False),
    ("causal", None, True),
    ("padded_causal", VALID, True),
    ("packed", PACKED, False),
    ("packed_causal", PACKED, True),
]


def _inputs(seed=0, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy, upstream's Pallas module and the JAX
    package's flash module."""
    jax = pytest.importorskip("jax")
    from jax.experimental.pallas.ops.tpu import flash_attention as upstream

    from lance_distributed_training_tpu.ops import flash as package_flash

    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, upstream=upstream,
                                 flash=package_flash)


def _upstream(jx, q, k, v, seg, causal, **kw):
    ids = None if seg is None else jx.upstream.SegmentIds(
        q=jx.jnp.asarray(seg), kv=jx.jnp.asarray(seg))
    return jx.upstream.mha_reference_no_custom_vjp(
        q, k, v, segment_ids=ids, causal=causal, sm_scale=SCALE, **kw)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name,seg,causal", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_matches_upstream_reference(jx, name, seg, causal):
    q, k, v, _ = _inputs()
    out, l, m = _upstream(jx, q, k, v, seg, causal, save_residuals=True)
    o_t, lse_t = flash.flash_attention_reference(_t(q), _t(k), _t(v), _t(seg),
                                                 causal, SCALE)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(m + jx.jnp.log(l)),
                               atol=1e-5)


@pytest.mark.parametrize("name,seg,causal", CASES, ids=[c[0] for c in CASES])
def test_plain_grads_match_jax_grad(jx, name, seg, causal):
    q, k, v, do = _inputs(1)

    def loss(q_, k_, v_):
        return jx.jnp.sum(_upstream(jx, q_, k_, v_, seg, causal) * do)

    want = jx.jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, segment_ids=_t(seg),
                                causal=causal, sm_scale=SCALE)
    (out * _t(do)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("kind", ["mask", "segment_ids"])
def test_matches_jax_package_at_valid_queries(jx, kind):
    q, k, v, _ = _inputs(2)
    jnp = jx.jnp
    jax_attn = jx.flash.make_flash_attention()
    port_attn = flash.make_flash_attention()
    if kind == "mask":
        ids = VALID
        mask = VALID[:, None, None, :].astype(bool)
        want = jax_attn(q, k, v, mask=jnp.asarray(mask))
        got = port_attn(_t(q), _t(k), _t(v), mask=_t(mask))
    else:
        ids = PACKED
        want = jax_attn(q, k, v, segment_ids=jnp.asarray(ids))
        got = port_attn(_t(q), _t(k), _t(v), segment_ids=_t(ids))
    live = ids > 0  # [B, S] query positions whose outputs are used
    got = got.detach().numpy().transpose(0, 2, 1, 3)[live]
    want = np.asarray(want).transpose(0, 2, 1, 3)[live]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_segment_attention_mask_matches_jax(jx):
    got = flash.segment_attention_mask(_t(PACKED)).numpy()
    want = np.asarray(jx.flash.segment_attention_mask(jx.jnp.asarray(PACKED)))
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, do = (_t(x) for x in _inputs(3))
    before = dict(flash.LAUNCHES)
    o, lse = flash.flash_attention_fwd(q, k, v, _t(VALID), False, SCALE)
    di = (o * do).sum(-1)
    dq = flash.flash_attention_bwd_dq(q, k, v, _t(VALID), lse, do, di,
                                      False, SCALE)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, _t(VALID), lse, do, di,
                                           False, SCALE)
    assert flash.LAUNCHES == before
    assert o.shape == dq.shape == dk.shape == dv.shape == q.shape
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32


def test_device_without_kernel_raises():
    q = torch.empty((B, H, S, D), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash.flash_attention_fwd(q, q, q)


def _launch_args(**bad):
    """Arguments of a valid bwd launch at [1, 2, 64, 64], with ``bad``
    replacing some of them."""
    bf16 = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    args = dict(q=bf16, k=bf16.clone(), v=bf16.clone(),
                segment_ids=torch.ones((1, 64), dtype=torch.int32),
                extra_bf16=[("do", bf16.clone())],
                extra_f32=[("lse", torch.zeros((1, 2, 64))),
                           ("di", torch.zeros((1, 2, 64)))])
    args.update(bad)
    return args


@pytest.mark.parametrize("bad,error", [
    ({"q": torch.zeros((1, 2, 64, 64))}, TypeError),
    ({"q": torch.zeros((1, 2, 64, 32), dtype=torch.bfloat16)}, ValueError),
    ({"k": torch.zeros((1, 2, 64, 64),
                       dtype=torch.bfloat16).transpose(2, 3)}, ValueError),
    ({"segment_ids": torch.ones((1, 63), dtype=torch.int32)}, ValueError),
    ({"segment_ids": torch.ones((1, 64), dtype=torch.int64)}, TypeError),
    ({"extra_f32": [("lse", torch.zeros((1, 2, 63)))]}, ValueError),
    ({"extra_bf16": [("do", torch.zeros((1, 2, 64, 64)))]}, TypeError),
], ids=["dtype", "head_dim", "contiguity", "seg_shape", "seg_dtype",
        "lse_shape", "do_dtype"])
def test_kernel_input_checks_raise(bad, error):
    flash._check("bwd_dq", **_launch_args())  # the valid launch passes
    with pytest.raises(error):
        flash._check("bwd_dq", **_launch_args(**bad))


@pytest.mark.parametrize("block_q,block_k", [(512, 512), (64, 64), (128, 32)])
def test_other_block_sizes_raise(block_q, block_k):
    with pytest.raises(ValueError, match="tiles"):
        flash.make_flash_attention(block_q=block_q, block_k=block_k)


@pytest.mark.parametrize("d", flash.HEAD_DIMS)
def test_forward_tile_block_sizes_follow_the_head_dim(d):
    q, k, v, _ = (_t(x) for x in _inputs(6, (B, H, S, d)))
    want = flash.make_flash_attention()(q, k, v)
    tile = flash.TILES["fwd"][d]
    got = flash.make_flash_attention(*tile)(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    other = next(t for t in flash.TILES["fwd"].values() if t != tile)
    with pytest.raises(ValueError, match="head dim"):
        flash.make_flash_attention(*other)(q, k, v)


def _source_tiles(d):
    """``(query rows, key rows)`` of each kernel's tile at head dim ``d``,
    read from the constants of ``csrc/flash_attn.cu``."""
    import re
    from pathlib import Path

    src = (Path(flash.__file__).parent / "csrc" / "flash_attn.cu").read_text()

    def const(name, scope=src):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", scope).group(1)
        expr = re.sub(r"(.+?) \? (\S+) : (\S+)", r"(\2 if \1 else \3)", expr)
        return eval(expr, {"D": d})

    def struct(name):
        return re.search(rf"struct {name} {{(.*?)\n}};", src, re.S).group(1)

    fwd, dq, dkv = struct("FwdCfg"), struct("DqCfg"), struct("DkvCfg")
    return {"fwd": (const("BM", fwd), const("BN", fwd)),
            "bwd_dq": (const("BM", dq), const("BN", dq)),
            "bwd_dkv": (const("BM", dkv), const("BN", dkv))}


@pytest.mark.parametrize("d", flash.HEAD_DIMS)
def test_tiles_match_the_kernel_source(d):
    assert set(flash.TILES) == set(flash.LAUNCHES)
    assert {n: tiles[d] for n, tiles in flash.TILES.items()} == _source_tiles(d)


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(device, shape, seed, seg):
    """bf16 q, k, v, dO on the card, and ``seg`` stretched to the sequence
    (its last column repeated) or None."""
    q, k, v, do = (torch.from_numpy(x).to(device, torch.bfloat16)
                   for x in _inputs(seed, shape))
    if seg is not None:
        reps = -(-shape[0] // seg.shape[0])
        seg = np.tile(seg, (reps, 1))[:shape[0]]
        if shape[2] >= seg.shape[1]:
            seg = np.concatenate(
                [seg, np.repeat(seg[:, -1:], shape[2] - seg.shape[1], 1)], 1)
        seg = torch.from_numpy(np.ascontiguousarray(seg[:, :shape[2]]))
        seg = seg.to(device)
    return q, k, v, do, seg


def _check_kernels_against_plain(q, k, v, do, seg, causal):
    """Run the three kernels and hold them against the plain versions in
    f32: |dO| within 2e-2, |dlse| within 1e-3, each gradient within 2% of
    the reference's largest entry. Returns the kernels' outputs."""
    scale = 1.0 / q.shape[-1] ** 0.5
    before = dict(flash.LAUNCHES)
    o, lse = flash.flash_attention_fwd(q, k, v, seg, causal, scale)
    f32 = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = flash.flash_attention_reference(*f32[:3], seg, causal,
                                                     scale)
    di = (o_ref * f32[3]).sum(-1)
    dq = flash.flash_attention_bwd_dq(q, k, v, seg, lse_ref, do, di, causal,
                                      scale)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, seg, lse_ref, do, di,
                                           causal, scale)
    dq_ref = flash.flash_attention_bwd_dq_reference(
        *f32[:3], seg, lse_ref, f32[3], di, causal, scale)
    dk_ref, dv_ref = flash.flash_attention_bwd_dkv_reference(
        *f32[:3], seg, lse_ref, f32[3], di, causal, scale)
    torch.cuda.synchronize()
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        err = (got.float() - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item()
    assert {n: flash.LAUNCHES[n] - before[n] for n in before} == {
        "fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    return o, lse, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 48, 130, 300])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,seg,causal", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain_on_card(cuda_device, d, s, name, seg, causal):
    # S = 48 lies below one tile; 130, 200 and 300 are not multiples of the
    # 64- and 128-row tiles, so the ragged edge is hit.
    q, k, v, do, seg = _card_inputs(cuda_device, (2, 3, s, d), 4, seg)
    _check_kernels_against_plain(q, k, v, do, seg, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [40, 190])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,seg,causal", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain_with_a_warpgroup_past_s_on_card(cuda_device, d, s,
                                                             name, seg,
                                                             causal):
    # The last 128-row query block of the forward and dQ ends past S, and its
    # second warpgroup (block rows 64-127) lies wholly past S: those rows get
    # lse = +inf in dQ and their TMA store is skipped.
    assert s % 128 and s % 128 <= 64
    q, k, v, do, seg = _card_inputs(cuda_device, (2, 3, s, d), 9, seg)
    _check_kernels_against_plain(q, k, v, do, seg, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name,seg,causal", CASES[:2],
                         ids=[c[0] for c in CASES[:2]])
def test_kernels_match_plain_over_many_waves_on_card(cuda_device, d, name,
                                                     seg, causal):
    # 16 x 24 heads x 3 tiles of 128 rows: several waves of blocks per SM.
    q, k, v, do, seg = _card_inputs(cuda_device, (16, 24, 320, d), 7, seg)
    _check_kernels_against_plain(q, k, v, do, seg, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_repeat_launch_is_bit_identical_on_card(cuda_device, d):
    q, k, v, do, seg = _card_inputs(cuda_device, (4, 6, 300, d), 8, PACKED)
    first = _check_kernels_against_plain(q, k, v, do, seg, False)
    second = _check_kernels_against_plain(q, k, v, do, seg, False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_through_kernels_matches_plain_on_card(cuda_device):
    shape = (2, 4, 130, 64)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                   for x in _inputs(5, shape))
    seg = torch.ones((2, 130), dtype=torch.int32, device=cuda_device)
    seg[1, 70:] = 0
    grads = []
    for inputs in ((q, k, v), (q.float(), k.float(), v.float())):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        if leaves[0].dtype == torch.float32:  # the plain version, in f32
            o, _ = flash.flash_attention_reference(*leaves, seg, False, 0.125)
        else:
            o = flash.flash_attention(*leaves, segment_ids=seg)
        (o.float() * do.float()).sum().backward()
        grads.append([t.grad.float() for t in leaves])
    for got, ref in zip(*grads):
        assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 64, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash.flash_attention_fwd(q.float(), q.float(), q.float())
    odd = torch.zeros((1, 2, 64, 32), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_fwd(odd, odd, odd)
    strided = q.transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention_fwd(strided, strided, strided)
