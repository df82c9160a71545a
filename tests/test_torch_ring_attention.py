"""Ring attention (K5) in the PyTorch port against the JAX side.

The plain fold (what the kernel wrappers run for CPU tensors) is held
against JAX's ``_block_attn``; the port's ring (one process holding every
position) against JAX's ``make_ring_attention`` on a ``('data', 'seq')``
mesh of the 8 virtual CPU devices and its ``jax.grad``; both rings against
dense attention; the port's backward against autograd through its plain
folds; and the process ring (2 and 4 gloo processes) against the
in-process ring, bit for bit; a fold over several ring steps against
one-step folds, bit for bit, and the launches each transport makes. Tests
marked ``cuda`` hold the kernels against the plain versions, and a fused
launch against one-step launches, and skip without a card. The JAX side is
imported by a fixture, so that on a machine with a card and no JAX the
``cuda`` tests still run (``-m cuda --noconftest``).
"""

import importlib
import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch.models.transformer import (
    dot_product_attention,
)
from lance_distributed_training_tpu_torch.ops import ring_attention as ra
from lance_distributed_training_tpu_torch.parallel.ring_attention import (
    InProcessRing,
    ProcessRing,
    make_ring_attention,
    ring_attention,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
ring_module = importlib.import_module(
    "lance_distributed_training_tpu_torch.parallel.ring_attention")
B, H, S, D = 4, 2, 32, 64
# Row 0 has no valid key; row 1 a fully masked last quarter and more.
LENGTHS = np.array([0, 19, 32, 27])
KEY_VALID = np.arange(S)[None, :] < LENGTHS[:, None]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lance_distributed_training_tpu.models.transformer import (
        dot_product_attention as dense,
    )

    ring = importlib.import_module(
        "lance_distributed_training_tpu.parallel.ring_attention")
    return types.SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh, ring=ring,
                                 dense=dense)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, shape=(B, H, S, D)):
    rng = np.random.default_rng(seed)
    return tuple(_normal(rng, shape) for _ in range(4))


# ------------------------------------------------------------ the plain fold

FOLD_CASES = ["first_no_mask", "first_padding", "fully_masked_block",
              "first_fully_masked"]


def _fold_inputs(case):
    """q [2,3,8,64], a K/V block of 16 keys, the carries and the mask."""
    rng = np.random.default_rng(FOLD_CASES.index(case))
    q = _normal(rng, (2, 3, 8, D))
    k, v = _normal(rng, (2, 3, 16, D)), _normal(rng, (2, 3, 16, D))
    if case.startswith("first"):  # the ring's first fold: m = -inf
        m = np.full((2, 3, 8), -np.inf, np.float32)
        l = np.zeros((2, 3, 8), np.float32)
        acc = np.zeros((2, 3, 8, D), np.float32)
    else:  # a later fold: finite carries
        m = _normal(rng, (2, 3, 8))
        l = rng.uniform(0.5, 3.0, (2, 3, 8)).astype(np.float32)
        acc = _normal(rng, (2, 3, 8, D))
    mask = None
    if case != "first_no_mask":
        mask = (np.arange(16)[None, :] < np.array([[11], [5]]))[:, None, None]
    if case in ("fully_masked_block", "first_fully_masked"):
        mask = mask.copy()
        mask[0] = False  # batch row 0: every key of the block masked
    return q, k, v, m, l, acc, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FOLD_CASES)
def test_plain_fold_matches_jax_block_attn(jx, case, dtype):
    q, k, v, m, l, acc, mask = _fold_inputs(case)
    jdt = getattr(jx.jnp, dtype)
    want = jx.ring._block_attn(
        *(jx.jnp.asarray(x, jdt) for x in (q, k, v)),
        *(jx.jnp.asarray(x) for x in (m, l, acc)),
        None if mask is None else jx.jnp.asarray(mask))
    tdt = getattr(torch, dtype)
    got = ra.block_attn_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        *(torch.from_numpy(x) for x in (m, l, acc)),
        None if mask is None else torch.from_numpy(mask))
    # atol 1e-5 in f32 and in bf16 alike. The carries are f32 in both, and
    # l and acc differ only by the order of f32 sums (at most 1e-6 here).
    # A bf16 score or PV product rounded at another point would move a
    # value by a bf16 ulp (2^-8 relative), far above 1e-5.
    for name, w, g in zip(("m", "l", "acc"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    if case == "first_fully_masked":
        # A fully masked first block: m is the fill value, nothing added.
        assert (got[0][0] == ra.MASK_FILL).all()
        assert (got[1][0] == 0).all() and (got[2][0] == 0).all()


# ------------------------------------------------------------ the ring


def _plain_ring(q, k, v, mask, sp):
    """The ring as JAX's loop runs it, through the plain fold: autograd
    through this is the plain backward."""
    sb = q.shape[2] // sp
    outs = []
    for i in range(sp):
        q_i = q[:, :, i * sb:(i + 1) * sb]
        m = torch.full(q_i.shape[:3], float("-inf"))
        l = torch.zeros(q_i.shape[:3])
        acc = torch.zeros(q_i.shape)
        for t in range(sp):
            j = (i - t) % sp
            m, l, acc = ra.block_attn_reference(
                q_i, k[:, :, j * sb:(j + 1) * sb], v[:, :, j * sb:(j + 1) * sb],
                m, l, acc, mask[..., j * sb:(j + 1) * sb])
        outs.append(ra.finalize(acc, l, q.dtype))
    return torch.cat(outs, 2)


def _with_grads(fn, q, k, v, w):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring_and_dense(jx, sp):
    """Forward and gradients against JAX's ring on a (data, seq) mesh of
    the 8 CPU devices, f32, at the JAX tests' tolerance (2e-4); both rings
    against dense attention at the rows with a valid key."""
    jax, jnp = jx.jax, jx.jnp
    q, k, v, w = _qkv(sp)
    mesh = jx.Mesh(np.array(jax.devices()[:8]).reshape(8 // sp, sp),
                   ("data", "seq"))
    jring = jx.ring.make_ring_attention(mesh)
    jmask = jnp.asarray(KEY_VALID[:, None, None, :])

    def loss(a, b, c):
        out = jring(a, b, c, jmask)
        return (out * jnp.asarray(w)).sum(), out

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    mask = torch.from_numpy(KEY_VALID[:, None, None, :])
    got, grads = _with_grads(
        lambda a, b, c: ring_attention(a, b, c, mask, InProcessRing(sp)),
        q, k, v, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for name, g, jg in zip("qkv", grads, jgrads):
        assert np.isfinite(np.asarray(jg)).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    # Row 0 has no valid key: both rings give 0 and zero gradients.
    assert (got[0] == 0).all() and (grads[0][0] == 0).all()
    assert not np.asarray(jgrads[0][0]).any()
    live = LENGTHS > 0
    dense = dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  mask=mask, dtype=torch.float32)
    np.testing.assert_allclose(got[live].numpy(), dense[live].numpy(),
                               rtol=2e-4, atol=2e-4)
    jdense = jx.dense(q, k, v, mask=jmask, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(want)[live],
                               np.asarray(jdense)[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_backward_is_autograd_through_the_plain_folds(sp):
    q, k, v, w = _qkv(10 + sp)
    mask = torch.from_numpy(KEY_VALID[:, None, None, :])
    got, grads = _with_grads(
        lambda a, b, c: ring_attention(a, b, c, mask, InProcessRing(sp)),
        q, k, v, w)
    want, want_grads = _with_grads(
        lambda a, b, c: _plain_ring(a, b, c, mask, sp), q, k, v, w)
    # The forward is the same plain fold, bit for bit; the backward is
    # flash's derivation written out against autodiff's chain through the
    # loop, f32 sums in other orders (atol 1e-5).
    assert torch.equal(got, want)
    for name, g, wg in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), wg.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_ring_attention_fn_takes_dense_attention_when_blocks_do_not_tile():
    q, k, v, _ = _qkv(20, (2, 2, 30, 16))
    mask = torch.from_numpy(np.arange(30)[None, None, None, :] < 21)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = make_ring_attention(4)(*args, mask=mask)
    want = dot_product_attention(*args, mask=mask, dtype=torch.float32)
    assert torch.equal(got, want)
    # 32 positions do tile: the ring, equal to dense within f32 sums.
    q, k, v, _ = _qkv(21, (2, 2, 32, 16))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    ring = make_ring_attention(4)(*args)
    np.testing.assert_allclose(ring.numpy(),
                               dot_product_attention(*args,
                                                     dtype=torch.float32),
                               rtol=1e-5, atol=1e-5)


def test_ring_attention_fn_refuses_untiled_blocks_off_the_cpu():
    # Off the CPU the only attention of the ring path is K5: a sequence
    # that does not tile raises instead of taking dense attention. A meta
    # tensor stands for a card's here.
    q = torch.zeros((2, 2, 30, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="30 does not split into 4"):
        make_ring_attention(4)(q, q, q)


@pytest.mark.parametrize("bad,error,match", [
    ("head_dim", ValueError, "head dim 32"),
    ("dtype", TypeError, "must be torch.bfloat16"),
    ("mask_shape", ValueError, "mask must be"),
    ("strided", ValueError, "contiguous"),
    ("shift", ValueError, "shift 4 outside"),
])
def test_kernel_wrappers_check_their_inputs(bad, error, match):
    q = torch.zeros((2, 3, 128, 64), dtype=torch.bfloat16)
    k, v = torch.zeros_like(q), torch.zeros_like(q)
    mask = torch.ones((2, 128), dtype=torch.uint8)
    shift = 1
    if bad == "head_dim":
        q = k = v = torch.zeros((2, 3, 128, 32), dtype=torch.bfloat16)
    elif bad == "dtype":
        k = k.float()
    elif bad == "mask_shape":
        mask = mask[:, :64]
    elif bad == "strided":
        v = torch.zeros((2, 3, 128, 128), dtype=torch.bfloat16)[..., :64]
    else:
        shift = 4
    with pytest.raises(error, match=match):
        ra._check("ring_fwd", q, k, v, mask, 4, shift)


def _bf16_case(seed, sp, sb=8):
    """bf16 q, k, v, dO of ``sp`` blocks of ``sb`` and a key mask with a
    row that has no valid key and a fully masked first block."""
    shape = (2, 3, sp * sb, D)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _qkv(seed, shape))
    keep = np.random.default_rng(seed).random((shape[0], shape[2])) < 0.6
    keep[0] = False
    keep[1, :sb] = False
    return q, k, v, do, torch.from_numpy(keep.astype(np.uint8))


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_plain_fold_over_steps_equals_one_step_folds(sp):
    """A fold of ``steps = sp`` ring steps gives the bits of ``sp``
    one-step folds, from fresh carries (forward with ``out``; dQ and dK/dV
    into ``out`` from zero totals) and from carries in memory."""
    q, k, v, do, mask = _bf16_case(40 + sp, sp)
    b, h, s, d = q.shape

    def carries():
        return (torch.full((b, h, s), float("-inf")), torch.zeros((b, h, s)),
                torch.zeros((b, h, s, d)))

    m1, l1, acc1 = carries()
    out1 = torch.empty_like(q)
    for t in range(sp):
        ra.ring_fold_fwd(q, k, v, mask, m1, l1, acc1, sp, t,
                         out=out1 if t == sp - 1 else None)
    m2, l2 = torch.empty((b, h, s)), torch.empty((b, h, s))
    out2 = torch.empty_like(q)
    ra.ring_fold_fwd(q, k, v, mask, m2, l2, None, sp, 0, out=out2, steps=sp)
    assert torch.equal(out1, out2) and torch.equal(m1, m2)
    assert torch.equal(l1, l2)
    m3, l3, acc3 = carries()
    ra.ring_fold_fwd(q, k, v, mask, m3, l3, acc3, sp, 0, steps=sp)
    for one, fused in ((m1, m3), (l1, l3), (acc1, acc3)):
        assert torch.equal(one, fused)

    lse = ra.row_lse(m1, l1)
    delta = (do.float() * out1.float()).sum(-1)
    dk1, dv1 = torch.zeros((b, h, s, d)), torch.zeros((b, h, s, d))
    for t in range(sp):
        ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, dk1, dv1, sp, t)
    grads = (torch.empty_like(k), torch.empty_like(v))
    ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, None, None, sp, 0,
                         steps=sp, out=grads)
    assert torch.equal(grads[0], dk1.to(k.dtype))
    assert torch.equal(grads[1], dv1.to(v.dtype))
    dk3, dv3 = torch.zeros((b, h, s, d)), torch.zeros((b, h, s, d))
    ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, dk3, dv3, sp, 0,
                         steps=sp)
    assert torch.equal(dk1, dk3) and torch.equal(dv1, dv3)

    dq1 = torch.zeros((b, h, s, d))
    for t in range(sp):
        ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq1, sp, t)
    dq_out = torch.empty_like(q)
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, None, sp, 0,
                        steps=sp, out=dq_out)
    assert torch.equal(dq_out, dq1.to(q.dtype))
    dq3 = torch.zeros((b, h, s, d))
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq3, sp, 0, steps=sp)
    assert torch.equal(dq1, dq3)


class _LoopbackRing(ProcessRing):
    """A process ring of ``size`` hops that never leave this process (the
    block a step folds is the one it holds): the transport's calls without
    a process group."""

    def __init__(self, size):
        self.size = size
        self.positions = 1
        self.fold_steps = 1

    def pass_on(self, tensors):
        return None

    def receive(self, tensors, pending):
        return tensors


def _count_folds(monkeypatch):
    calls = {"ring_fwd": [], "ring_bwd_dq": [], "ring_bwd_dkv": []}
    for name, fn in (("ring_fwd", "ring_fold_fwd"),
                     ("ring_bwd_dq", "ring_fold_bwd_dq"),
                     ("ring_bwd_dkv", "ring_fold_bwd_dkv")):
        wrapped = getattr(ring_module, fn)

        def counted(*args, _name=name, _fn=wrapped, **kwargs):
            calls[_name].append(kwargs.get("steps", 1))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ring_module, fn, counted)
    return calls


@pytest.mark.parametrize("transport", ["in_process", "process"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_each_transport_launches_its_folds(
        monkeypatch, transport, sp):
    """The in-process ring calls each of the forward, dQ and dK/dV wrappers
    once an attention call with ``steps = sp``; a process ring calls each
    ``sp`` times with ``steps = 1``."""
    calls = _count_folds(monkeypatch)
    ring = InProcessRing(sp) if transport == "in_process" else \
        _LoopbackRing(sp)
    q, k, v, do, mask = _bf16_case(50 + sp, sp)
    s = q.shape[2] if transport == "in_process" else q.shape[2] // sp
    ts = [t[:, :, :s].float().clone().requires_grad_() for t in (q, k, v)]
    key_mask = mask[:, :s].bool()[:, None, None, :]
    ring_attention(*ts, key_mask, ring).backward(do[:, :, :s].float())
    fused = transport == "in_process"
    assert calls["ring_fwd"] == ([sp] if fused else [1] * sp)
    assert calls["ring_bwd_dkv"] == ([sp] if fused else [1] * sp)
    assert calls["ring_bwd_dq"] == ([sp] if fused else [1] * sp)
    assert all(torch.isfinite(t.grad).all() for t in ts)


@pytest.mark.parametrize("steps,shift,match", [
    (0, 0, "steps 0 from shift 0 outside"),
    (-1, 1, "steps -1 from shift 1 outside"),
    (4, 1, "steps 4 from shift 1 outside"),
    (2, 3, "steps 2 from shift 3 outside"),
])
def test_kernel_wrappers_reject_steps_outside_the_ring(steps, shift, match):
    q, k, v, do, mask = _bf16_case(60, 4)
    b, h, s, d = q.shape
    m, l = torch.zeros((b, h, s)), torch.zeros((b, h, s))
    with pytest.raises(ValueError, match=match):
        ra._check("ring_fwd", q, k, v, mask, 4, shift, steps)
    with pytest.raises(ValueError, match=match):
        ra.ring_fold_fwd(q, k, v, mask, m, l, None, 4, shift,
                         out=torch.empty_like(q), steps=steps)
    with pytest.raises(ValueError, match=match):
        ra.ring_fold_bwd_dkv(q, k, v, mask, m, l, do, None, None, 4, shift,
                             steps=steps,
                             out=(torch.empty_like(k), torch.empty_like(v)))
    with pytest.raises(ValueError, match=match):
        ra.ring_fold_bwd_dq(q, k, v, mask, m, l, do, None, 4, shift,
                            steps=steps, out=torch.empty_like(q))


@pytest.mark.parametrize("kernel", ["ring_bwd_dq", "ring_bwd_dkv"])
def test_kernel_wrappers_reject_no_totals_and_no_out(kernel):
    """A backward launch writes its totals somewhere: f32 totals in memory,
    ``out``, or both; given neither, the wrapper raises."""
    q, k, v, do, mask = _bf16_case(61, 2)
    b, h, s, d = q.shape
    lse, delta = torch.zeros((b, h, s)), torch.zeros((b, h, s))
    with pytest.raises(ValueError, match=f"{kernel}: give"):
        if kernel == "ring_bwd_dq":
            ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, None, 2, 0)
        else:
            ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, None, None,
                                 2, 0)


# ------------------------------------------------ the process ring over gloo

_CHILD = textwrap.dedent(r'''
    import sys
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.models import (
        TransformerEncoder, masked_lm_task)
    from lance_distributed_training_tpu_torch.parallel.mesh import (
        new_seq_groups)
    from lance_distributed_training_tpu_torch.parallel.ring_attention import (
        ProcessRing, make_ring_attention, ring_attention)

    world, rank, address, inputs, out = sys.argv[1:6]
    world, rank = int(world), int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    data = torch.load(inputs)
    ring = ProcessRing(*new_seq_groups(world))
    s = data["q"].shape[2]
    lo, hi = rank * s // world, (rank + 1) * s // world
    q, k, v = (data[n][:, :, lo:hi].clone().requires_grad_()
               for n in ("q", "k", "v"))
    o = ring_attention(q, k, v, data["mask"][..., lo:hi], ring)
    o.backward(data["do"][:, :, lo:hi])
    # A small masked-LM encoder on this rank's sequence block, with its
    # slice of the MLM mask, as the trainer runs it.
    model = TransformerEncoder(64, hidden_size=128, num_layers=2,
                               num_heads=2, mlp_dim=256, max_len=s,
                               dtype=torch.float32,
                               attention_fn=make_ring_attention(world, ring))
    task = masked_lm_task(model)
    block, mlm = trainer._sequence_block(
        {"input_ids": data["ids"], "attention_mask": data["amask"]},
        data["mlm"], rank, world)
    with torch.no_grad():
        logits, _ = task.forward(block, False, mlm_mask=mlm)
    torch.save({"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                "logits": logits}, out)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(tmp_path, world, inputs):
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(world), str(rank), address,
         str(inputs), str(tmp_path / f"r{rank}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
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
    return [torch.load(tmp_path / f"r{rank}.pt") for rank in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_process_ring_equals_in_process_ring_bit_for_bit(tmp_path, world):
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(30 + world))
    mask = torch.from_numpy(KEY_VALID[:, None, None, :])
    rng = np.random.default_rng(world)
    ids = torch.from_numpy(rng.integers(2, 64, (B, S)))
    amask = torch.from_numpy(KEY_VALID.astype(np.int8))
    mlm = torch.from_numpy((rng.random((B, S)) < 0.15) & KEY_VALID)
    torch.save({"q": q, "k": k, "v": v, "do": do, "mask": mask, "ids": ids,
                "amask": amask, "mlm": mlm}, tmp_path / "inputs.pt")
    ranks = _run_children(tmp_path, world, tmp_path / "inputs.pt")
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ring_attention(qg, kg, vg, mask, InProcessRing(world))
    out.backward(do)
    from lance_distributed_training_tpu_torch.models import (
        TransformerEncoder,
        masked_lm_task,
    )

    model = TransformerEncoder(64, hidden_size=128, num_layers=2,
                               num_heads=2, mlp_dim=256, max_len=S,
                               dtype=torch.float32,
                               attention_fn=make_ring_attention(world))
    task = masked_lm_task(model)
    batch = {"input_ids": ids, "attention_mask": amask}
    with torch.no_grad():
        logits, _ = task.forward(batch, False, mlm_mask=mlm)
    sb = S // world
    for rank, got in enumerate(ranks):
        rows = slice(rank * sb, (rank + 1) * sb)
        for name, want in (("out", out.detach()), ("dq", qg.grad),
                           ("dk", kg.grad), ("dv", vg.grad)):
            assert torch.equal(got[name], want[:, :, rows]), (rank, name)
        # The encoder on a block: its logits are the whole sequence's
        # (other GEMM shapes: f32 sums in other orders).
        np.testing.assert_allclose(got["logits"].numpy(),
                                   logits[:, rows].numpy(), rtol=0,
                                   atol=1e-5)


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(device, shape, seed):
    """bf16 q, k, v, dO on the card and a uint8 key mask with a row that
    has no valid key and a row whose first block is fully masked."""
    q, k, v, do = (torch.from_numpy(x).to(device, torch.bfloat16)
                   for x in _qkv(seed, shape))
    keep = np.random.default_rng(seed).random((shape[0], shape[2])) < 0.6
    keep[0] = False
    keep[-1, :shape[2] // 4] = False
    return q, k, v, do, torch.from_numpy(keep.astype(np.uint8)).to(device)


def _ring_steps(q, k, v, do, mask, sp, fwd, dq_fold, dkv_fold):
    b, h, s, d = q.shape
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    out = torch.empty_like(q)
    for t in range(sp):
        fwd(q, k, v, mask, m, l, acc, sp, t, out=out if t == sp - 1 else None)
    lse = ra.row_lse(m, l)
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.zeros(q.shape, device=q.device) for _ in range(3))
    for t in range(sp):
        dq_fold(q, k, v, mask, lse, delta, do, dq, sp, t)
        dkv_fold(q, k, v, mask, lse, delta, do, dk, dv, sp, t)
    return out, lse, dq, dk, dv


KERNELS = (ra.ring_fold_fwd, ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv)
PLAIN = (ra.ring_fold_fwd_reference, ra.ring_fold_bwd_dq_reference,
         ra.ring_fold_bwd_dkv_reference)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sp", [((2, 3, 256, 64), 4),
                                      ((3, 2, 200, 64), 4),
                                      ((2, 2, 96, 64), 1),
                                      ((4, 12, 512, 64), 2)])
def test_kernels_match_plain_on_card(cuda_device, shape, sp):
    case = _card_case(cuda_device, shape, sum(shape) + sp)
    got = _ring_steps(*case, sp, *KERNELS)
    want = _ring_steps(*case, sp, *PLAIN)
    torch.cuda.synchronize()
    # flash's tolerances: out 0.02, lse 1e-3, gradients 2% of the largest;
    # and out within 4e-3 (a bf16 ulp or two), since the kernel rounds
    # where the plain fold does.
    assert (got[0].float() - want[0].float()).abs().max() <= 2e-2
    assert (got[0].float() - want[0].float()).abs().max() <= 4e-3
    assert (got[1] - want[1]).abs().max() <= 1e-3
    for g, w in zip(got[2:], want[2:]):
        assert (g - w).abs().max() <= 2e-2 * w.abs().max()
    empty = ~case[4].bool().any(1)
    assert (got[0][empty] == 0).all() and (got[2][empty] == 0).all()


@pytest.mark.cuda
def test_repeat_launch_is_bit_identical_on_card(cuda_device):
    case = _card_case(cuda_device, (4, 6, 384, 64), 5)
    first = _ring_steps(*case, 3, *KERNELS)
    again = _ring_steps(*case, 3, *KERNELS)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_through_kernels_matches_plain_on_card(cuda_device):
    q, k, v, do, mask = _card_case(cuda_device, (2, 4, 256, 64), 6)
    key_mask = mask.bool()[:, None, None, :]
    results = []
    for device in (cuda_device, torch.device("cpu")):
        ts = [t.to(device).clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*ts, key_mask.to(device), InProcessRing(4))
        out.backward(do.to(device))
        results.append([out.detach().float().cpu()]
                       + [t.grad.float().cpu() for t in ts])
    (got, *grads), (want, *want_grads) = results
    assert (got - want).abs().max() <= 2e-2
    for g, w in zip(grads, want_grads):
        assert (g - w).abs().max() <= 2e-2 * w.abs().max()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 64, 32), device=cuda_device, dtype=torch.bfloat16)
    m = torch.zeros((1, 2, 64), device=cuda_device)
    acc = torch.zeros((1, 2, 64, 32), device=cuda_device)
    mask = torch.ones((1, 64), device=cuda_device, dtype=torch.uint8)
    with pytest.raises(ValueError, match="head dim"):
        ra.ring_fold_fwd(q, q, q, mask, m, m.clone(), acc)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sp", [((2, 3, 256, 64), 4),
                                      ((3, 2, 200, 64), 4),
                                      ((2, 2, 96, 64), 1),
                                      ((4, 12, 512, 64), 2)])
def test_fused_launch_equals_one_step_launches_on_card(cuda_device, shape,
                                                       sp):
    """One launch over ``sp`` ring steps gives the bits of ``sp`` one-step
    launches of the same kernel: the forward from fresh carries and from
    carries in memory, dQ and dK/dV into bf16 from zero totals and into f32
    totals; rows with no valid key come out 0 with zero dQ, dK and dV."""
    q, k, v, do, mask = _card_case(cuda_device, shape, sum(shape) + sp)
    b, h, s, d = q.shape
    kw = dict(device=cuda_device)

    def carries():
        return (torch.full((b, h, s), float("-inf"), **kw),
                torch.zeros((b, h, s), **kw), torch.zeros((b, h, s, d), **kw))

    m1, l1, acc1 = carries()
    out1 = torch.empty_like(q)
    for t in range(sp):
        ra.ring_fold_fwd(q, k, v, mask, m1, l1, acc1, sp, t,
                         out=out1 if t == sp - 1 else None)
    m2, l2 = torch.empty((b, h, s), **kw), torch.empty((b, h, s), **kw)
    out2 = torch.empty_like(q)
    ra.ring_fold_fwd(q, k, v, mask, m2, l2, None, sp, 0, out=out2, steps=sp)
    m3, l3, acc3 = carries()
    ra.ring_fold_fwd(q, k, v, mask, m3, l3, acc3, sp, 0, steps=sp)
    lse = ra.row_lse(m1, l1)
    delta = (do.float() * out1.float()).sum(-1)
    dk1, dv1 = torch.zeros((b, h, s, d), **kw), torch.zeros((b, h, s, d), **kw)
    for t in range(sp):
        ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, dk1, dv1, sp, t)
    grads = (torch.empty_like(k), torch.empty_like(v))
    ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, None, None, sp, 0,
                         steps=sp, out=grads)
    dk3, dv3 = torch.zeros((b, h, s, d), **kw), torch.zeros((b, h, s, d), **kw)
    ra.ring_fold_bwd_dkv(q, k, v, mask, lse, delta, do, dk3, dv3, sp, 0,
                         steps=sp)
    dq1 = torch.zeros((b, h, s, d), **kw)
    for t in range(sp):
        ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq1, sp, t)
    dq_out = torch.empty_like(q)
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, None, sp, 0,
                        steps=sp, out=dq_out)
    dq3 = torch.zeros((b, h, s, d), **kw)
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq3, sp, 0, steps=sp)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and torch.equal(m1, m2)
    assert torch.equal(l1, l2)
    for one, fused in ((m1, m3), (l1, l3), (acc1, acc3), (dk1, dk3),
                       (dv1, dv3), (dq1, dq3)):
        assert torch.equal(one, fused)
    assert torch.equal(grads[0], dk1.to(k.dtype))
    assert torch.equal(grads[1], dv1.to(v.dtype))
    assert torch.equal(dq_out, dq1.to(q.dtype))
    empty = ~mask.bool().any(1)
    assert (out2[empty] == 0).all() and (dq_out[empty] == 0).all()
    assert (grads[0][empty] == 0).all() and (grads[1][empty] == 0).all()
