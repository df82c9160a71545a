"""Packed text training in the port against the JAX package.

From one set of Flax weights (``models/convert.py``) the port's
``causal_lm`` task (gpt_small's trunk at narrow widths) and packed
``masked_lm`` (bert_small's) are held against the JAX tasks on one packed
batch made by the port's FFD decoder and K3's plain version: logits at live
positions (the flash kernels' plain version treats dead cells as a segment
of their own, the dense path masks them out: the losses weight them out in
both packages), loss and metric within 1e-4; then three AdamW steps whose
losses agree within rtol 1e-4 (f32 throughout). Also the trainer's
token-pack rejections and a packed causal-LM CLI run on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu.ops.flash import (
    make_flash_attention as jax_make_flash_attention,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    create_variable_length_token_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    causal_lm_task,
    get_task,
    load_flax_params,
    masked_lm_task,
)
from lance_distributed_training_tpu_torch.ops.flash import (
    make_flash_attention,
)
from lance_distributed_training_tpu_torch.ops.token_device import (
    make_pack_transform,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


VOCAB, SEQ = 97, 32
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ)


def _packed_batch(seed=0, n=11):
    """A packed batch: FFD plan of n sequences of 1-20 tokens into
    [rows, 32] grids (several sequences a row, dead cells at row ends)."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(2, VOCAB, int(m), dtype=np.int32)
            for m in rng.integers(1, 21, n)]
    table = pa.table({"input_ids": pa.array(docs, pa.list_(pa.int32()))})
    planner = TokenPackPlanner(TokenPackConfig(pack_len=SEQ, rows_multiple=2))
    host = TokenDecoder(mode="pack", seq_len=SEQ, planner=planner)(table)
    staged = {k: (v if k.startswith("_host_") else torch.from_numpy(v))
              for k, v in host.items()}
    batch = make_pack_transform()(staged)
    assert int(batch["segment_ids"].max()) == n
    return {k: v.numpy() for k, v in batch.items()}


def _flax_params(causal):
    model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, causal=causal,
                       **DIMS)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = model.init(jax.random.key(1), ids, jnp.ones((1, SEQ), jnp.int8),
                        train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _models(task, arm):
    causal = task == "causal_lm"
    params = _flax_params(causal)
    jax_fn = jax_make_flash_attention(causal=causal) if arm == "flash" \
        else None
    port_fn = make_flash_attention(causal=causal) if arm == "flash" else None
    jax_model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, causal=causal,
                           attention_fn=jax_fn, **DIMS)
    port = TransformerEncoder(VOCAB, dtype=torch.float32, causal=causal,
                              attention_fn=port_fn, **DIMS)
    load_flax_params(port, params)
    return jax_model, port, params


def _mlm_mask(batch, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.random(batch["input_ids"].shape) < 0.3) & (
        batch["attention_mask"] > 0)


def _jax_outputs(task, jax_model, params, batch, mlm):
    ids = jnp.asarray(batch["input_ids"])
    if task == "masked_lm":
        ids = jnp.where(mlm, 1, ids)
    logits = jax_model.apply(
        {"params": params}, ids, jnp.asarray(batch["attention_mask"]),
        train=False, segment_ids=jnp.asarray(batch["segment_ids"]),
        position_ids=jnp.asarray(batch["position_ids"]))
    if task == "masked_lm":
        return logits, (logits, jnp.asarray(mlm), jnp.zeros(()))
    return logits, (logits, jnp.zeros(()))


def _jax_task(task):
    if task == "masked_lm":
        return jax_tasks._masked_lm_task(VOCAB, "bert_small", SEQ)
    return jax_tasks._causal_lm_task(VOCAB, "gpt_small", SEQ)


def _port_task(task, model):
    return masked_lm_task(model) if task == "masked_lm" \
        else causal_lm_task(model)


@pytest.mark.parametrize("task", ["causal_lm", "masked_lm"])
@pytest.mark.parametrize("arm", ["dense", "flash"])
def test_packed_forward_loss_and_metric_match_jax(task, arm):
    jax_model, port, params = _models(task, arm)
    batch = _packed_batch()
    mlm = _mlm_mask(batch)
    logits_j, outputs_j = _jax_outputs(task, jax_model, params, batch, mlm)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    draw = {"mlm_mask": torch.from_numpy(mlm)} if task == "masked_lm" else {}
    port_task = _port_task(task, port)
    with torch.no_grad():
        outputs_t = port_task.forward(batch_t, True, **draw)
    logits_t = outputs_t[0] if task == "masked_lm" else outputs_t
    live = batch["segment_ids"] > 0
    np.testing.assert_allclose(logits_t.numpy()[live],
                               np.asarray(logits_j)[live], atol=1e-4)
    jt = _jax_task(task)
    np.testing.assert_allclose(float(port_task.loss(outputs_t, batch_t)),
                               float(jt.loss(outputs_j, batch_j)), atol=1e-4)
    np.testing.assert_allclose(port_task.metric(outputs_t, batch_t).numpy(),
                               np.asarray(jt.metric(outputs_j, batch_j)),
                               atol=1e-6)


def test_causal_loss_weights_out_junctions_and_dead_cells():
    batch = {k: torch.from_numpy(v) for k, v in _packed_batch(2).items()}
    model = TransformerEncoder(VOCAB, dtype=torch.float32, causal=True,
                               **DIMS)
    task = causal_lm_task(model)
    with torch.no_grad():
        logits = task.forward(batch, True)
    seg = batch["segment_ids"]
    # Predictions whose target lies in the same live sequence.
    keep = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
    raw = torch.nn.functional.cross_entropy(
        logits[:, :-1][keep], batch["input_ids"][:, 1:][keep].long())
    np.testing.assert_allclose(float(task.loss(logits, batch)), float(raw),
                               rtol=1e-6)


@pytest.mark.parametrize("task", ["causal_lm", "masked_lm"])
def test_three_packed_adamw_steps_match_jax(task):
    jax_model, port, params = _models(task, "flash")
    batch = _packed_batch(1)
    mlm = _mlm_mask(batch, 7)
    kw = dict(optimizer="adamw", lr=1e-2, weight_decay=0.01, momentum=0.9)
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainConfig(dataset_path="-", task_type=task, **kw))
    jt = _jax_task(task)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        _, outputs = _jax_outputs(task, jax_model, p, batch, mlm)
        return jt.loss(outputs, batch_j)

    @jax.jit
    def jax_step(p, state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    optimizer, sched = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", task_type=task, **kw),
        port.parameters())
    step = trainer.make_train_step(_port_task(task, port), optimizer, sched)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    draw = {"mlm_mask": torch.from_numpy(mlm)} if task == "masked_lm" else {}
    opt_state = tx.init(params)
    want, got = [], []
    for _ in range(3):
        params, opt_state, loss = jax_step(params, opt_state)
        want.append(float(loss))
        got.append(float(step(batch_t, **draw)))
    assert want[0] != want[2]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_get_task_builds_gpt_presets():
    with torch.device("meta"):
        task = get_task("causal_lm", model_name="gpt_small", seq_len=64)
    assert task.name == "causal_lm"
    assert task.metric_name == "next_token_accuracy"
    assert task.model.vocab_size == 50257 and task.model.max_len == 64
    assert task.model.causal and task.model.hidden_size == 256
    with torch.device("meta"):
        base = get_task("causal_lm", seq_len=1024)
    assert base.model.hidden_size == 768 and len(base.model.layers) == 12
    with pytest.raises(ValueError, match="Invalid model name"):
        get_task("causal_lm", model_name="bert_small")


# ------------------------------------------------------------- the trainer


def _ragged_dataset(tmp_path, rows=48):
    path = str(tmp_path / "ragged")
    create_variable_length_token_dataset(path, rows=rows, vocab_size=120,
                                         max_len=40, mean_len=9.0, seed=3)
    return path


def _cli_args(path, *extra):
    return ["train", "--dataset_path", path, "--task_type", "causal_lm",
            "--model_name", "gpt_small", "--vocab_size", "120",
            "--seq_len", "64", "--batch_size", "12", "--max_steps", "3",
            "--optimizer", "adamw", "--lr", "1e-3", "--flash_attention",
            "--log_every", "1", "--device", "cpu", *extra]


def test_cli_trains_packed_causal_lm_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    path = _ragged_dataset(tmp_path)
    packed = cli.main(_cli_args(path, "--token_pack",
                                "--pack_rows_multiple", "2"))
    out = capsys.readouterr().out
    assert packed["steps"] == 3 and all(np.isfinite(packed["losses"]))
    assert "valid_tokens_per_sec=" in out and "pad_waste_pct=" in out
    assert packed["pack_batches_total"] >= 3
    assert packed["pack_new_shapes_total"] >= 1
    assert all(g % 2 == 0 and g % 64 == 0 for g in packed["grid_tokens"])
    assert packed["eval_rows"] == 48 and 0 <= packed["eval_accuracy"] <= 1
    padded = cli.main(_cli_args(path, "--no_token_pack"))
    assert padded["grid_tokens"] == [12 * 64] * 3
    assert padded["eval_rows"] == 48
    # The two arms train on the same sequences: the same first loss (to
    # bf16 compute, whose roundings differ with the grid's shape), and the
    # packed grid pads less.
    np.testing.assert_allclose(packed["losses"][0], padded["losses"][0],
                               rtol=1e-3)
    assert packed["pad_waste_pct"] < padded["pad_waste_pct"]
    # Nothing is truncated at 64: each step's payload is the same in both
    # arms (the plan's in one, the attention mask's count in the other).
    assert padded["payload_tokens"] == packed["payload_tokens"]
    # Each arm's waste is its timed window's own (steps 2-3).
    for arm in (packed, padded):
        want = 100 * (1 - sum(arm["payload_tokens"][1:])
                      / sum(arm["grid_tokens"][1:]))
        np.testing.assert_allclose(arm["pad_waste_pct"], want, rtol=1e-12)


def test_pack_len_below_seq_len_matches_the_jax_plan(tmp_path, monkeypatch):
    """``--pack_len 32`` under ``--seq_len 64``: the trainer's decoders are
    the JAX trainer's, and each step's grid and payload are those of the
    JAX loader's batches, in order, with the over-long sequences cut."""
    from lance_distributed_training_tpu.data.format import (
        Dataset as JaxDataset,
    )
    from lance_distributed_training_tpu.data.pipeline import (
        make_train_pipeline as jax_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.data import Dataset

    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    path = _ragged_dataset(tmp_path)
    kw = dict(dataset_path=path, task_type="causal_lm", seq_len=64,
              pack_len=32, pack_rows_multiple=2, token_pack=True)
    jax_config = jax_trainer.TrainConfig(buffer_pool=False, **kw)
    for for_eval in (False, True):
        got = trainer._decoder_for(trainer.TrainConfig(device="cpu", **kw),
                                   for_eval=for_eval)
        want = jax_trainer._decoder_for(jax_config, for_eval=for_eval)
        assert got.cache_fingerprint() == want.cache_fingerprint()
    batches = list(jax_train_pipeline(
        JaxDataset(path), "batch", 12, 0, 1,
        jax_trainer._decoder_for(jax_config), shuffle=False, seed=0,
        epoch=0))
    result = cli.main(_cli_args(path, "--token_pack", "--pack_len", "32",
                                "--pack_rows_multiple", "2",
                                "--max_steps", "4"))
    assert result["steps"] == len(batches) == 4
    metas = [np.asarray(b["_host_pack_meta"]) for b in batches]
    assert all(m[1] == 32 for m in metas)
    assert result["grid_tokens"] == [int(m[0] * m[1]) for m in metas]
    assert result["payload_tokens"] == [int(m[2]) for m in metas]
    lengths = np.diff(Dataset(path).take(list(range(48)))
                      .column("input_ids").combine_chunks().offsets)
    assert result["pack_truncated_tokens_total"] == int(
        np.maximum(lengths - 32, 0).sum()) > 0
    assert all(np.isfinite(result["losses"]))
    assert result["eval_rows"] == 48


@pytest.mark.parametrize("kw,match", [
    (dict(task_type="classification"), "needs a text task"),
    (dict(task_type="masked_lm", num_processes=2), "single-process"),
])
def test_trainer_token_pack_rejections_match_jax(kw, match):
    config = trainer.TrainConfig(dataset_path="-", token_pack=True,
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match=match) as got:
        trainer.train(config)
    jax_config = jax_trainer.TrainConfig(dataset_path="-", token_pack=True,
                                         **kw)
    with pytest.raises(ValueError) as want:
        jax_trainer.train(jax_config)
    assert str(got.value) == str(want.value)


def test_cli_token_pack_flags_are_exclusive(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(_cli_args(str(tmp_path), "--token_pack", "--no_token_pack"))
