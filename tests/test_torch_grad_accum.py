"""Gradient accumulation in the port against the JAX trainer's
``optax.MultiSteps`` chain.

Both sides start from identical weights (``models/convert.py``) and take
the same micro-batches with the same explicit MLM masks (or flips). The
schedules count updates; inside a window the parameters do not move; on
the k-th micro-step one update lands on the mean gradient; a partial window
at the end is never applied. Losses agree within ``rtol 1e-4`` (f32
masked-LM) or ``1e-5`` (the f64 ResNet trunk, as
``test_torch_classification.py``), the final parameters within ``rtol
1e-4, atol 1e-6``, the micro-batch gradient norms within ``rtol 1e-4``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_classification import (
    BATCH as IMAGE_BATCH,
    SIZE,
    _jax_task,
    _port_task,
    _variables,
)

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    load_flax_params,
    masked_lm_task,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


VOCAB, SEQ, BATCH = 97, 16, 4
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ)
# Two windows and a partial third: a warmup schedule's first update has
# rate 0 (optax's warmup starts at 0), so the second one must move.
ACCUM, MICRO_STEPS = 4, 10


@pytest.mark.parametrize("accum", [1, 2, 4])
@pytest.mark.parametrize("sched,warmup", [("constant", 0), ("constant", 3),
                                          ("cosine", 0), ("cosine", 5)])
def test_lr_schedule_counts_updates_as_jax(sched, warmup, accum):
    kw = dict(dataset_path="-", lr=0.1, lr_schedule=sched,
              warmup_steps=warmup, total_steps=10, grad_accum=accum)
    want = jax_trainer.lr_schedule_fn(jax_trainer.TrainConfig(**kw))
    got = trainer.lr_schedule_fn(trainer.TrainConfig(**kw))
    assert callable(want) == callable(got)
    for count in range(12):
        w = float(want(count)) if callable(want) else want
        g = got(count) if callable(got) else got
        assert math.isclose(g, w, rel_tol=1e-6, abs_tol=1e-9), count


def _micro_batches(n):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
        lengths = rng.integers(4, SEQ + 1, BATCH)
        mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int8)
        mlm = (rng.random((BATCH, SEQ)) < 0.3) & (mask > 0)
        out.append((ids, mask, mlm))
    return out


# (optimizer, lr, weight_decay, grad_clip, lr_schedule, warmup_steps)
OPTIMIZERS = {
    "sgd": ("sgd", 0.5, 0.0, 0.0, "constant", 0),
    "sgd_l2_clip": ("sgd", 0.5, 1e-3, 0.05, "constant", 0),
    "adamw_cosine_warmup": ("adamw", 1e-2, 0.01, 0.0, "cosine", 3),
}


@functools.lru_cache(maxsize=None)  # the grad-norm test reuses a run
def _run_masked_lm(name, accum, steps):
    """``steps`` micro-steps of both sides from the same weights: per step
    (jax loss, port loss, jax grad norm, port grad norm, jax params, port
    params), params as flat numpy lists in the port's order; then the
    port's step, its optimizer and its initial params."""
    opt, lr, wd, clip, sched, warmup = OPTIMIZERS[name]
    kw = dict(optimizer=opt, lr=lr, momentum=0.9, weight_decay=wd,
              grad_clip=clip, lr_schedule=sched, warmup_steps=warmup,
              total_steps=12, grad_accum=accum)
    batches = _micro_batches(steps)
    ids0, mask0, _ = batches[0]
    model_j = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, **DIMS)
    params = model_j.init(jax.random.key(0), jnp.asarray(ids0),
                          jnp.asarray(mask0), train=False)["params"]
    jax_loss = jax_tasks._masked_lm_task(VOCAB, "bert_small", SEQ).loss
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainConfig(dataset_path="-", task_type="masked_lm", **kw))

    @jax.jit
    def jax_step(p, state, ids, mask, mlm):
        batch = {"input_ids": ids, "attention_mask": mask}

        def loss_fn(p):
            logits = model_j.apply({"params": p}, jnp.where(mlm, 1, ids),
                                   mask, train=True)
            return jax_loss((logits, mlm, 0.0), batch)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = tx.update(grads, state, p)
        return (optax.apply_updates(p, updates), state, loss,
                optax.global_norm(grads))

    model_t = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
    load_flax_params(model_t, jax.tree_util.tree_map(np.asarray, params))
    optimizer, sched_fn = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", task_type="masked_lm", **kw),
        model_t.parameters())
    step = trainer.make_train_step(masked_lm_task(model_t), optimizer,
                                   sched_fn, clip, grad_accum=accum,
                                   grad_norm=True)
    # The port's parameters in Flax's layout, to hold them against JAX's.
    names = [n for n, _ in model_t.named_parameters()]
    initial = [p.detach().numpy().copy() for p in model_t.parameters()]
    state = tx.init(params)
    out = []
    for ids, mask, mlm in batches:
        params, state, loss_j, norm_j = jax_step(
            params, state, jnp.asarray(ids), jnp.asarray(mask),
            jnp.asarray(mlm))
        loss_t = step({"input_ids": torch.from_numpy(ids),
                       "attention_mask": torch.from_numpy(mask)},
                      mlm_mask=torch.from_numpy(mlm))
        ported = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
        load_flax_params(ported, jax.tree_util.tree_map(np.asarray, params))
        want = dict(ported.named_parameters())
        got = dict(model_t.named_parameters())
        out.append((float(loss_j), float(loss_t), float(norm_j),
                    float(step.last_grad_norm),
                    [want[n].detach().numpy().copy() for n in names],
                    [got[n].detach().numpy().copy() for n in names]))
    return out, step, optimizer, initial


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_micro_steps_match_multisteps(name):
    out, step, optimizer, initial = _run_masked_lm(name, ACCUM, MICRO_STEPS)
    want = [o[0] for o in out]
    got = [o[1] for o in out]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    port = [initial] + [o[5] for o in out]
    for s in range(1, MICRO_STEPS + 1):
        if s % ACCUM:
            # Inside a window the parameters stay bit for bit; the last
            # micro-steps' partial window is never applied.
            for a, b in zip(port[s], port[s - 1]):
                np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in
               zip(port[2 * ACCUM], port[2 * ACCUM - 1]))
    assert want[0] != want[2 * ACCUM]  # the updates moved the weights
    names = [n for n, _ in step.task.model.named_parameters()]
    lr = OPTIMIZERS[name][1]
    for n, a, b in zip(names, out[-1][5], out[-1][4]):
        if n.endswith("attn.key.bias") and name.startswith("adamw"):
            # Attention is invariant to the key bias: its gradient is
            # rounding noise, which AdamW normalises to a step of ±lr.
            assert np.abs(a - b).max() <= 2 * lr * (MICRO_STEPS // ACCUM)
            continue
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=n)
    assert step.updates == MICRO_STEPS // ACCUM
    assert step.micro_step == MICRO_STEPS % ACCUM
    if name.startswith("adamw"):
        # AdamW's count advances once an update, not a micro-step.
        states = optimizer.state_dict()["state"].values()
        assert {float(s["step"]) for s in states} == {MICRO_STEPS // ACCUM}


@pytest.mark.parametrize("accum", [1, ACCUM])
def test_micro_batch_grad_norm_matches_optax_global_norm(accum):
    """``--log_grad_norm`` reads each micro-batch's own gradient (before
    clipping and accumulation), as ``optax.global_norm(grads)`` in the JAX
    step."""
    out = _run_masked_lm("sgd_l2_clip", accum, MICRO_STEPS)[0]
    want = [o[2] for o in out]
    got = [o[3] for o in out]
    assert len(set(want)) == MICRO_STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_resnet_accumulation_matches_jax_batch_stats(monkeypatch):
    """ResNet-18 with ``grad_accum 2``, four micro-steps: losses and
    BatchNorm's running statistics (updated on every micro-step, as the JAX
    step replaces them every step) against the JAX step under x64."""
    rng = np.random.default_rng(11)
    batches = [{"image": rng.integers(0, 256, (IMAGE_BATCH, SIZE, SIZE, 3),
                                      dtype=np.uint8),
                "label": rng.integers(0, 10, IMAGE_BATCH).astype(np.int32)}
               for _ in range(4)]
    kw = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3,
              grad_accum=2)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: np.float64(a),
                                           _variables())
        jax_task = _jax_task(monkeypatch, jnp.float64)
        state = jax_trainer.TrainState.create(
            apply_fn=None, params=variables["params"],
            batch_stats=variables["batch_stats"],
            tx=jax_trainer.make_optimizer(
                jax_trainer.TrainConfig(dataset_path="-", **kw)))
        jax_step = jax_trainer.make_train_step(
            jax_task, get_mesh(jax.devices()[:1]), donate=False)
        key = jax.random.key(5)
        want, draws, want_var = [], [], []
        for batch in batches:
            key, step_key = jax.random.split(key)
            draws.append(np.asarray(jax.random.bernoulli(
                step_key, 0.5, (IMAGE_BATCH, 1, 1, 1))).reshape(-1).copy())
            state, loss = jax_step(state, batch, step_key)
            want.append(float(loss))
            want_var.append(np.asarray(
                state.batch_stats["norm_init"]["var"]).copy())

    task = _port_task(variables, dtype=torch.float64)
    optimizer, lr = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", **kw), task.model.parameters())
    step = trainer.make_train_step(task, optimizer, lr, grad_accum=2)
    got, got_var = [], []
    for batch, draw in zip(batches, draws):
        got.append(float(step({k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              flip_mask=torch.from_numpy(draw))))
        got_var.append(task.model.bn1.running_var.numpy().copy())
    assert want[0] != want[2] and step.updates == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(got_var, want_var):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert not np.array_equal(got_var[0], got_var[1])


def test_accumulator_round_trips_through_state_dict():
    """A step restored mid-window from :meth:`TrainStep.state_dict` ends the
    window as the uninterrupted step does, bit for bit."""
    def fresh():
        torch.manual_seed(0)
        model = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
        optimizer, lr = trainer.make_optimizer(
            trainer.TrainConfig(dataset_path="-", optimizer="adamw", lr=1e-2,
                                grad_accum=3), model.parameters())
        return model, optimizer, trainer.make_train_step(
            masked_lm_task(model), optimizer, lr, grad_accum=3)

    batches = [({"input_ids": torch.from_numpy(ids),
                 "attention_mask": torch.from_numpy(mask)},
                torch.from_numpy(mlm)) for ids, mask, mlm in
               _micro_batches(5)]
    model_a, _, step_a = fresh()
    for batch, mlm in batches:
        step_a(batch, mlm_mask=mlm)
    model_b, opt_b, step_b = fresh()
    for batch, mlm in batches[:4]:  # one update and one micro-step in
        step_b(batch, mlm_mask=mlm)
    saved = {"model": {k: v.clone() for k, v in
                       model_b.state_dict().items()},
             "optimizer": opt_b.state_dict(),
             "step": {k: ([t.clone() for t in v] if isinstance(v, list)
                          else v) for k, v in step_b.state_dict().items()}}
    model_c, opt_c, step_c = fresh()
    model_c.load_state_dict(saved["model"])
    opt_c.load_state_dict(saved["optimizer"])
    step_c.load_state_dict(saved["step"])
    assert step_c.micro_step == 1 and step_c.updates == 1
    step_c(*batches[4][:1], mlm_mask=batches[4][1])
    for a, b in zip(model_a.parameters(), model_c.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="grad_accum"):
        trainer.make_train_step(masked_lm_task(model_c), opt_c,
                                grad_accum=2).load_state_dict(saved["step"])
