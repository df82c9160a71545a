"""Sequence-parallel masked-LM training in the PyTorch port, and the text
loss across processes, against the JAX trainer.

* Three AdamW steps of an f32 encoder whose attention is the port's ring
  (``seq_parallelism`` 2 and 4, every position in one process) track the
  JAX step through ``make_ring_attention`` on the matching ``('data',
  'seq')`` mesh, from the same converted weights and the same MLM mask.
* Two gloo processes equal one: masked-LM data parallel with unequal
  masked counts per process (the loss is the global batch's weighted mean,
  as the JAX loss over the global batch is), and a two-process sequence
  ring with the one-process ring, the eval on both ranks included.
* The refusals carry the JAX trainer's messages.
"""

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
from jax.sharding import Mesh

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu.parallel.ring_attention import (
    make_ring_attention as jax_make_ring_attention,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    load_flax_params,
    masked_lm_task,
)
from lance_distributed_training_tpu_torch.parallel.mesh import seq_topology
from lance_distributed_training_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
VOCAB, SEQ, BATCH = 97, 64, 4
# Head dim 64, as bert_base and bert_small have.
DIMS = dict(hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256,
            max_len=SEQ)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
    # Row 2's last 40 keys are masked: the last block at sp 2, the last two
    # and a half at sp 4.
    lengths = np.array([SEQ, 50, 24, 37])
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int8)
    mlm = (rng.random((BATCH, SEQ)) < 0.3) & (mask > 0)
    return ids, mask, mlm


@pytest.mark.parametrize("sp", [2, 4])
def test_seq_parallel_steps_match_jax(sp):
    ids, mask, mlm = _batch(sp)
    kw = dict(optimizer="adamw", lr=1e-2, weight_decay=0.01, total_steps=3,
              task_type="masked_lm", seq_len=SEQ, seq_parallelism=sp)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // sp, sp),
                ("data", "seq"))
    model_j = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32,
                         attention_fn=jax_make_ring_attention(mesh), **DIMS)
    params = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, **DIMS).init(
        jax.random.key(0), jnp.asarray(ids), jnp.asarray(mask),
        train=False)["params"]
    jax_loss = jax_tasks._masked_lm_task(VOCAB, "bert_small", SEQ).loss
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainConfig(dataset_path="-", **kw))
    batch_j = {"input_ids": jnp.asarray(ids),
               "attention_mask": jnp.asarray(mask)}

    @jax.jit
    def jax_step(p, state):
        def loss_fn(p):
            corrupted = jnp.where(mlm, 1, batch_j["input_ids"])
            logits = model_j.apply({"params": p}, corrupted,
                                   batch_j["attention_mask"], train=True)
            return jax_loss((logits, jnp.asarray(mlm), 0.0), batch_j)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    # The port: the trainer's ring attention_fn, optimizer and step.
    model_t = TransformerEncoder(VOCAB, dtype=torch.float32,
                                 attention_fn=make_ring_attention(sp), **DIMS)
    load_flax_params(model_t, jax.tree_util.tree_map(np.asarray, params))
    config = trainer.TrainConfig(dataset_path="-", device="cpu", **kw)
    optimizer, lr = trainer.make_optimizer(config, model_t.parameters())
    step = trainer.make_train_step(masked_lm_task(model_t), optimizer, lr)
    batch_t = {"input_ids": torch.from_numpy(ids),
               "attention_mask": torch.from_numpy(mask)}
    opt_state = tx.init(params)
    want, got = [], []
    for _ in range(3):
        params, opt_state, loss = jax_step(params, opt_state)
        want.append(float(loss))
        got.append(float(step(batch_t, mlm_mask=torch.from_numpy(mlm))))
    assert want[0] != want[2]  # the steps moved the weights
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ------------------------------------------------------------ the refusals


@pytest.mark.parametrize("kw", [
    dict(task_type="masked_lm", flash_attention=True, seq_parallelism=2),
    dict(task_type="causal_lm", seq_parallelism=2),
    dict(task_type="masked_lm", seq_len=30, seq_parallelism=4),
], ids=["flash", "task", "seq_len"])
def test_seq_parallel_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        trainer.train(trainer.TrainConfig(dataset_path="-", device="cpu",
                                          **kw))
    with pytest.raises(ValueError) as want:
        jax_trainer._task_from_config(
            jax_trainer.TrainConfig(dataset_path="-", **kw), None)
    assert str(got.value) == str(want.value)


def test_seq_parallel_token_pack_refusal_matches_jax():
    kw = dict(dataset_path="-", task_type="masked_lm", token_pack=True,
              seq_parallelism=2)
    with pytest.raises(ValueError) as got:
        trainer.train(trainer.TrainConfig(device="cpu", **kw))
    with pytest.raises(ValueError) as want:
        jax_trainer.train(jax_trainer.TrainConfig(**kw))
    assert str(got.value) == str(want.value)


def test_world_that_does_not_divide_refusal_matches_jax():
    with pytest.raises(ValueError) as got:
        seq_topology(0, 3, 2)
    with pytest.raises(ValueError) as want:
        get_mesh(jax.devices()[:3], seq_parallelism=2)
    assert str(got.value) == str(want.value)
    # Data outermost, as the JAX mesh lays out its devices.
    assert [seq_topology(r, 6, 2) for r in range(6)] == [
        (0, 3, 0), (0, 3, 1), (1, 3, 0), (1, 3, 1), (2, 3, 0), (2, 3, 1)]


# ------------------------------------------------------------ the loop


def _token_dataset(tmp_path, rows=24, seq=32):
    """Long rows first, short rows last: the processes of a two-process
    run hold unequal numbers of masked tokens."""
    rng = np.random.default_rng(0)
    lengths = np.where(np.arange(rows) % 8 < 4, rng.integers(24, seq + 1, rows),
                       rng.integers(3, 9, rows))
    docs = [rng.integers(2, 128, int(n)).tolist() for n in lengths]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=seq, pack=False)
    return path


def test_cli_seq_parallel_trains_and_evaluates_on_cpu(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main([
        "train", "--dataset_path", _token_dataset(tmp_path), "--task_type",
        "masked_lm", "--model_name", "bert_small", "--vocab_size", "128",
        "--seq_len", "32", "--batch_size", "8", "--max_steps", "2",
        "--seq_parallelism", "4", "--optimizer", "adamw", "--lr", "1e-3",
        "--log_every", "1", "--device", "cpu"])
    assert result["steps"] == 2 and all(np.isfinite(result["losses"]))
    assert result["eval_rows"] == 24 and 0 <= result["eval_accuracy"] <= 1
    assert "[metrics] step=2" in capsys.readouterr().out


def test_data_shares_take_disjoint_rows_of_one_draw():
    """Each data share, from the run's one generator at the same state,
    takes its rows of the one draw over the global batch: the shares'
    masks stacked in order are the global batch's mask, and two shares'
    masks differ."""
    from lance_distributed_training_tpu_torch.models.tasks import (
        draw_mlm_mask,
    )

    lengths = torch.tensor([64, 40, 64, 17, 64, 64, 33, 64])
    valid = (torch.arange(64)[None, :] < lengths[:, None]).to(torch.int8)
    whole = {"input_ids": torch.zeros((8, 64), dtype=torch.int32),
             "attention_mask": valid}
    want = draw_mlm_mask(whole, torch.Generator().manual_seed(8))
    for count in (2, 4):
        rows = 8 // count
        masks = [draw_mlm_mask(
            {k: v[d * rows:(d + 1) * rows] for k, v in whole.items()},
            torch.Generator().manual_seed(8), (d, count))
            for d in range(count)]
        assert torch.equal(torch.cat(masks), want)
        assert not torch.equal(masks[0], masks[1])


def test_sequence_block_keeps_global_positions():
    ids = torch.arange(24).reshape(2, 12)
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    mlm = ids % 5 == 0
    block, drawn = trainer._sequence_block(batch, mlm, 2, 3)
    assert torch.equal(block["input_ids"], ids[:, 8:])
    assert torch.equal(block["position_ids"],
                       torch.arange(8, 12).expand(2, 4))
    assert torch.equal(drawn, mlm[:, 8:])


_CHILD = textwrap.dedent(r'''
    import functools, sys
    import torch
    torch.set_num_threads(2)
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.models import tasks, transformer
    # f32 compute, so that the comparison can be tight.
    tasks.bert_small = functools.partial(transformer.bert_small,
                                         dtype=torch.float32)
    path, out, world, rank, address, sp, inject = sys.argv[1:8]
    counts = []
    if inject == "1":
        # A mask that follows the tokens, the same in every layout; the
        # count of each process's share is recorded.
        make_step = trainer.make_train_step

        def make_train_step(*args, **kwargs):
            inner = make_step(*args, **kwargs)

            def step(batch, generator=None, mlm_mask=None, flip_mask=None):
                mlm = ((batch["input_ids"] % 3) == 0) & (
                    batch["attention_mask"] > 0)
                counts.append(int(mlm.sum()))
                return inner(batch, mlm_mask=mlm)
            return step
        trainer.make_train_step = make_train_step
    kw = dict(dataset_path=path, task_type="masked_lm",
              model_name="bert_small", vocab_size=128, seq_len=32,
              batch_size=8, max_steps=3, epochs=1, log_every=0,
              optimizer="sgd", lr=0.5, seq_parallelism=int(sp),
              eval_at_end=inject != "1", device="cpu")
    if int(world) > 1:
        kw.update(coordinator_address=address, num_processes=int(world),
                  process_id=int(rank))
    result = trainer.train(trainer.TrainConfig(**kw))
    torch.save({"losses": result["losses"], "world": result["world_size"],
                "counts": counts, "eval": (result.get("eval_accuracy"),
                                           result.get("eval_rows")),
                "state": result["model"].state_dict()}, out)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_against_one(tmp_path, sp: int, inject: bool):
    path = _token_dataset(tmp_path)
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, LDT_METRICS_PATH=os.devnull,
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    runs = [("2", "0"), ("2", "1"), ("1", "0")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, path,
         str(tmp_path / f"w{world}r{rank}.pt"), world, rank, address,
         str(sp), "1" if inject else "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, rank in runs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    one = torch.load(tmp_path / "w1r0.pt")
    two = [torch.load(tmp_path / f"w2r{rank}.pt") for rank in ("0", "1")]
    assert one["world"] == 1 and all(t["world"] == 2 for t in two)
    for t in two:
        np.testing.assert_allclose(t["losses"], one["losses"], rtol=0,
                                   atol=1e-5)
        for key, want in one["state"].items():
            np.testing.assert_allclose(t["state"][key].numpy(), want.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)
    return one, two


def test_two_process_masked_lm_loss_is_the_global_weighted_mean(tmp_path):
    """Data parallel, masked-LM: the two processes hold unequal numbers of
    masked tokens every step, and still train as one process does on the
    whole batch (losses to atol 1e-5)."""
    one, two = _two_against_one(tmp_path, sp=1, inject=True)
    assert all(a != b for a, b in zip(two[0]["counts"], two[1]["counts"]))
    assert [a + b for a, b in zip(two[0]["counts"], two[1]["counts"])] == \
        one["counts"]


def test_two_process_sequence_ring_matches_one_process(tmp_path):
    """Two gloo processes, one ring of two, against one process holding
    both ring positions: the same rows, the same mask draw, the same
    losses (atol 1e-5) and weights; the eval runs on the ring too, and
    both ranks return the one process's eval over every row."""
    one, two = _two_against_one(tmp_path, sp=2, inject=False)
    assert two[0]["eval"] == two[1]["eval"]
    assert two[0]["eval"][1] == one["eval"][1] == 24
    np.testing.assert_allclose(two[0]["eval"][0], one["eval"][0], rtol=0,
                               atol=1e-6)
