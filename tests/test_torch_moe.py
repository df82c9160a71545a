"""The port's switch-MoE against the JAX package's, on identical weights.

``MoEMLP`` alone (f32 on both sides): outputs, the load-balance term and the
gradients of both with respect to the input and every parameter agree within
1e-5 (absolute, on values of order 1), with no overflow, with some and with
most tokens past capacity (whose outputs must be exactly 0 on both sides).
Then bert_small's and gpt_small's tasks at narrow widths (hidden 64, two
blocks, the second one MoE with four experts, f32): the task loss with its
0.01-weighted term, and three AdamW steps, within rtol 1e-4. Last, two gloo
processes, each with half of the batch, against the JAX task on the whole
batch: the mean of their losses and of their terms, and DDP's gradients,
within 1e-5 — routing by per-process counts would place other tokens past
capacity and fail.
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
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.moe import MoEMLP as JaxMoE
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.models import (
    MoEMLP,
    TransformerEncoder,
    causal_lm_task,
    load_flax_params,
    masked_lm_task,
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.models.moe import moe_aux_loss
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
H, E, M = 16, 4, 32
VOCAB, SEQ, BATCH = 97, 16, 4
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ, num_experts=4, moe_every=2)
ATOL = 1e-5


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _moe_state(params) -> dict:
    return {"router.weight": torch.from_numpy(params["router"]["kernel"].T),
            "router.bias": torch.from_numpy(params["router"]["bias"]),
            **{k: torch.from_numpy(params[k])
               for k in ("w_in", "b_in", "w_out", "b_out")}}


@pytest.mark.parametrize("factor,overflow", [(8.0, False), (1.25, True),
                                             (0.25, True)],
                         ids=["no_overflow", "default", "most_overflow"])
def test_moe_mlp_matches_jax(factor, overflow):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, H)).astype(np.float32)
    cot = rng.standard_normal((2, 8, H)).astype(np.float32)
    jax_moe = JaxMoE(E, M, capacity_factor=factor, dtype=jnp.float32)
    params = _tree(jax_moe.init(jax.random.key(1), jnp.asarray(x))["params"])
    # A router that prefers expert 0, so that queues overflow.
    params["router"]["bias"] = np.array([1.0, 0.0, 0.0, -0.5], np.float32)

    def jax_fn(p, x):
        y, sown = jax_moe.apply({"params": p}, x, mutable=["aux_loss"])
        aux = sum(jax.tree_util.tree_leaves(sown["aux_loss"]))
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y_j, aux_j)), (gp, gx) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    moe = MoEMLP(H, E, M, capacity_factor=factor, dtype=torch.float32)
    moe.load_state_dict(_moe_state(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = moe(xt)
    (torch.sum(y * torch.from_numpy(cot)) + moe.aux).backward()

    dead_j = np.all(np.asarray(y_j) == 0, axis=-1)
    dead = (y == 0).all(-1).numpy()
    np.testing.assert_array_equal(dead, dead_j)
    assert dead.any() == overflow
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=ATOL)
    np.testing.assert_allclose(float(moe.aux), float(aux_j), atol=ATOL)
    assert float(moe.aux) > 1.0  # unbalanced routing costs more than 1
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=ATOL)
    grads = {k: v.grad.numpy() for k, v in moe.named_parameters()}
    for name, want in _moe_state(_tree(gp)).items():
        np.testing.assert_allclose(grads[name], want.numpy(), atol=ATOL,
                                   err_msg=name)


def test_moe_blocks_follow_moe_every_and_convert_exactly():
    model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, num_layers=4,
                       **{k: v for k, v in DIMS.items() if k != "num_layers"})
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = _tree(model.init(jax.random.key(0), ids, jnp.ones_like(ids),
                              train=False)["params"])
    assert ["moe" in params[f"layer_{i}"] for i in range(4)] \
        == [False, True, False, True]
    port = TransformerEncoder(VOCAB, dtype=torch.float32, num_layers=4,
                              **{k: v for k, v in DIMS.items()
                                 if k != "num_layers"})
    assert [layer.moe is not None for layer in port.layers] \
        == [False, True, False, True]
    state = torch_state_dict_from_flax(params)
    assert set(state) == set(port.state_dict())
    for name, tensor in port.state_dict().items():
        assert state[name].shape == tensor.shape, name


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
    lengths = np.array([SEQ, 12, 7, 10])
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int8)
    return {"input_ids": ids, "attention_mask": mask}


def _jax_task(monkeypatch, task_type):
    """The JAX package's text task over a narrow f32 preset with MoE."""
    name = "bert_small" if task_type == "masked_lm" else "gpt_small"
    preset = functools.partial(JaxEncoder, dtype=jnp.float32,
                               causal=task_type == "causal_lm",
                               **{k: v for k, v in DIMS.items()
                                  if k not in ("num_experts", "moe_every",
                                               "max_len")})
    monkeypatch.setattr(jax_tasks, name, preset)
    build = (jax_tasks._masked_lm_task if task_type == "masked_lm"
             else jax_tasks._causal_lm_task)
    task = build(VOCAB, name, SEQ, num_experts=4, moe_every=2)
    params = _tree(task.init_variables(jax.random.key(0))["params"])
    assert "moe" in params["layer_1"]
    return task, params


def _port_task(task_type, params):
    model = TransformerEncoder(VOCAB, dtype=torch.float32,
                               causal=task_type == "causal_lm", **DIMS)
    load_flax_params(model, params)
    return (masked_lm_task if task_type == "masked_lm"
            else causal_lm_task)(model)


@pytest.mark.parametrize("task_type", ["masked_lm", "causal_lm"])
def test_text_tasks_with_moe_match_jax(monkeypatch, task_type):
    jt, params = _jax_task(monkeypatch, task_type)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(optimizer="adamw", lr=1e-2, weight_decay=0.01)
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainConfig(dataset_path="-", task_type=task_type, **kw))
    rng = jax.random.key(3)

    def loss_fn(p):
        outputs, _ = jt.forward({"params": p}, jbatch, True, rng)
        return jt.loss(outputs, jbatch), outputs

    @jax.jit
    def jax_step(p, state):
        (loss, outputs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss, outputs[-1]

    port = _port_task(task_type, params)
    optimizer, lr = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", task_type=task_type, **kw),
        port.model.parameters())
    step = trainer.make_train_step(port, optimizer, lr)
    draw = {}
    if task_type == "masked_lm":
        # The JAX forward's own mask draw, handed to the port.
        draw["mlm_mask"] = torch.from_numpy(np.asarray(
            jax.random.bernoulli(rng, 0.15, (BATCH, SEQ))
            & (batch["attention_mask"] > 0)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    outputs = port.forward(tbatch, True, **draw)
    first = float(port.loss(outputs, tbatch))

    state = tx.init(params)
    want, got, aux = [], [], []
    for _ in range(3):
        params, state, loss, aux_j = jax_step(params, state)
        want.append(float(loss))
        aux.append(float(aux_j))
        got.append(float(step(tbatch, **draw)))
    assert all(a > 0.9 for a in aux)  # one MoE layer's term, near 1
    assert want[0] != want[2]
    np.testing.assert_allclose(first, want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_moe_eval_adds_no_term(monkeypatch):
    _, params = _jax_task(monkeypatch, "masked_lm")
    task = _port_task("masked_lm", params)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    mlm = {"mlm_mask": torch.from_numpy(
        np.arange(SEQ)[None, :] % 3 == 0).expand(BATCH, SEQ)}
    evaluated = task.loss(task.forward(batch, False, **mlm), batch)
    trained = task.loss(task.forward(batch, True, **mlm), batch)
    aux = moe_aux_loss(task.model)
    assert float(aux) > 0.9
    # The same weights and mask: training adds exactly the weighted term.
    np.testing.assert_allclose(float(trained),
                               float(evaluated) + 0.01 * float(aux),
                               rtol=1e-6)


# ------------------------------------------------- two processes over gloo

_CHILD = textwrap.dedent(r'''
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    from torch.nn.parallel import DistributedDataParallel
    from lance_distributed_training_tpu_torch.models import (
        TransformerEncoder, masked_lm_task)
    from lance_distributed_training_tpu_torch.models.moe import moe_aux_loss

    inp, out, rank, address = sys.argv[1:5]
    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=2, rank=rank)
    data = torch.load(inp)
    model = TransformerEncoder(data["vocab"], dtype=torch.float32,
                               **data["dims"])
    model.load_state_dict(data["state"])
    task = masked_lm_task(model, dist.group.WORLD)
    task = task.with_model(DistributedDataParallel(model))
    rows = data["ids"].shape[0] // 2
    half = slice(rank * rows, (rank + 1) * rows)
    batch = {"input_ids": data["ids"][half], "attention_mask": data["mask"][half]}
    outputs = task.forward(batch, True, mlm_mask=data["mlm"][half])
    loss = task.loss(outputs, batch)
    loss.backward()
    torch.save({"loss": float(loss), "aux": float(moe_aux_loss(model)),
                "grads": {k: p.grad for k, p in model.named_parameters()}},
               out)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_route_the_global_batch(monkeypatch, tmp_path):
    jt, params = _jax_task(monkeypatch, "masked_lm")
    batch = _batch(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(11)
    mlm = np.asarray(jax.random.bernoulli(rng, 0.15, (BATCH, SEQ))
                     & (batch["attention_mask"] > 0))

    def loss_fn(p):
        outputs, _ = jt.forward({"params": p}, jbatch, True, rng)
        return jt.loss(outputs, jbatch), outputs[-1]

    (want, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    # Routing each half alone (its own counts and capacity) gives another
    # loss: the test can tell global routing from per-process routing.
    alone = _port_task("masked_lm", params)
    halves = []
    for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        half = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        alone.forward(half, True, mlm_mask=torch.from_numpy(mlm[rows]))
        halves.append(float(moe_aux_loss(alone.model)))
    assert abs(np.mean(halves) - float(aux)) > 1e-3
    torch.save({"vocab": VOCAB, "dims": DIMS,
                "state": torch_state_dict_from_flax(params),
                "ids": torch.from_numpy(batch["input_ids"]),
                "mask": torch.from_numpy(batch["attention_mask"]),
                "mlm": torch.from_numpy(mlm)}, tmp_path / "in.pt")
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
    np.testing.assert_allclose(np.mean([r["loss"] for r in runs]),
                               float(want), atol=ATOL)
    np.testing.assert_allclose(np.mean([r["aux"] for r in runs]),
                               float(aux), atol=ATOL)
    for name, g in torch_state_dict_from_flax(_tree(grads)).items():
        for r in runs:
            np.testing.assert_allclose(r["grads"][name].numpy(), g.numpy(),
                                       atol=ATOL, err_msg=name)
