"""The port's masked-LM trainer against the JAX trainer's pieces, the CLI,
and the rule that the port imports nothing of JAX or the JAX package.

Both sides start from identical weights (through ``models/convert.py``) and
the same explicit MLM mask (``jax.random`` and ``torch.Generator`` give
different bits), then take three optimizer steps; losses must agree within
``rtol 1e-4``.
"""

import ast
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    load_flax_params,
    masked_lm_task,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


VOCAB, SEQ, BATCH = 97, 16, 4
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ)
ROOT = Path(__file__).resolve().parents[1]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
    lengths = np.array([SEQ, 12, 7, 10])
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int8)
    mlm = (rng.random((BATCH, SEQ)) < 0.3) & (mask > 0)
    return ids, mask, mlm


# (optimizer, lr, weight_decay, grad_clip, lr_schedule, warmup_steps)
OPTIMIZERS = [
    ("sgd", 0.5, 0.0, 0.0, "constant", 0),
    ("sgd", 0.5, 1e-3, 0.05, "constant", 0),
    ("adamw", 1e-2, 0.01, 0.0, "constant", 0),
    ("adamw", 1e-2, 0.01, 0.0, "cosine", 1),
]


@pytest.mark.parametrize("opt,lr,wd,clip,sched,warmup", OPTIMIZERS,
                         ids=["sgd", "sgd_l2_clip", "adamw", "adamw_cosine"])
def test_three_steps_match_jax(opt, lr, wd, clip, sched, warmup):
    ids, mask, mlm = _batch()
    kw = dict(optimizer=opt, lr=lr, momentum=0.9, weight_decay=wd,
              grad_clip=clip, lr_schedule=sched, warmup_steps=warmup,
              total_steps=3)
    # JAX: the package's model, masked-LM loss and optax chain.
    model_j = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, **DIMS)
    params = model_j.init(jax.random.key(0), jnp.asarray(ids),
                          jnp.asarray(mask), train=False)["params"]
    jax_loss = jax_tasks._masked_lm_task(VOCAB, "bert_small", SEQ).loss
    tx = jax_trainer.make_optimizer(
        jax_trainer.TrainConfig(dataset_path="-", task_type="masked_lm", **kw))
    batch_j = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask)}

    def loss_fn(p):
        corrupted = jnp.where(mlm, 1, batch_j["input_ids"])
        logits = model_j.apply({"params": p}, corrupted,
                               batch_j["attention_mask"], train=True)
        return jax_loss((logits, jnp.asarray(mlm), 0.0), batch_j)

    # The port, from the same weights.
    model_t = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
    load_flax_params(model_t, jax.tree_util.tree_map(np.asarray, params))
    optimizer, sched_fn = trainer.make_optimizer(
        trainer.TrainConfig(dataset_path="-", task_type="masked_lm", **kw),
        model_t.parameters())
    step = trainer.make_train_step(masked_lm_task(model_t), optimizer,
                                   sched_fn, clip)
    batch_t = {"input_ids": torch.from_numpy(ids),
               "attention_mask": torch.from_numpy(mask)}

    @jax.jit
    def jax_step(p, state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, state = tx.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    opt_state = tx.init(params)
    want, got = [], []
    for _ in range(3):
        params, opt_state, loss = jax_step(params, opt_state)
        want.append(float(loss))
        got.append(float(step(batch_t, mlm_mask=torch.from_numpy(mlm))))
    assert want[0] != want[2]  # the steps moved the weights
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("sched,warmup", [("constant", 0), ("constant", 3),
                                          ("cosine", 0), ("cosine", 4)])
def test_lr_schedules_match_optax(sched, warmup):
    kw = dict(dataset_path="-", lr=0.1, lr_schedule=sched,
              warmup_steps=warmup, total_steps=10)
    want = jax_trainer.lr_schedule_fn(jax_trainer.TrainConfig(**kw))
    got = trainer.lr_schedule_fn(trainer.TrainConfig(**kw))
    for count in range(12):
        w = float(want(count)) if callable(want) else want
        g = got(count) if callable(got) else got
        assert math.isclose(g, w, rel_tol=1e-6, abs_tol=1e-9), count


def test_masked_lm_draws_its_mask_from_the_generator():
    ids, mask, _ = _batch()
    task = masked_lm_task(TransformerEncoder(VOCAB, dtype=torch.float32,
                                             **DIMS))
    batch = {"input_ids": torch.from_numpy(ids),
             "attention_mask": torch.from_numpy(mask)}
    masks = [task.forward(batch, True, torch.Generator().manual_seed(s))[1]
             for s in (7, 7, 8)]
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert not (masks[0] & ~torch.from_numpy(mask > 0)).any()


def _token_dataset(tmp_path, rows=16):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, 128, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, rows)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    return path


def _cli_args(path, *extra):
    return ["train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", "128",
            "--seq_len", str(SEQ), "--batch_size", "4", "--max_steps", "2",
            "--optimizer", "adamw", "--lr", "1e-3", "--flash_attention",
            "--log_every", "1", *extra]


def test_cli_trains_two_steps_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    result = cli.main(_cli_args(_token_dataset(tmp_path), "--device", "cpu"))
    assert result["steps"] == 2 and result["device"] == "cpu"
    assert len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    out = capsys.readouterr().out
    assert "[metrics] step=1" in out and "tokens_per_sec=" in out
    # Two step lines, the epoch line and the eval over every row.
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 4
    assert result["eval_rows"] == 16 and 0 <= result["eval_accuracy"] <= 1


def test_cli_without_device_cpu_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(_cli_args(_token_dataset(tmp_path)))


@pytest.mark.parametrize("argv", [
    ["check"],
    ["graph"],
])
def test_cli_unported_surface_raises(tmp_path, argv, capsys):
    """``check`` and ``graph`` are ported: over a tree they return an exit
    status (0: clean, a graph drawn). No subcommand is left unported: a
    name neither CLI knows is a usage error of the train parser in both
    (exit 2), as in JAX."""
    from lance_distributed_training_tpu import cli as jax_cli

    (tmp_path / "m.py").write_text(
        "import threading\n\nLOCK = threading.Lock()\n")
    assert cli.main(argv + ["--root", str(tmp_path), "m.py"]) == 0
    out = capsys.readouterr().out
    assert ("ldt check: clean [1 files]" if argv[0] == "check"
            else "concurrency model over 1 files") in out
    errors = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as got:
            main([f"{argv[0]}-all", "--root", str(tmp_path)])
        assert got.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "error:" in errors[0]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "lance_distributed_training_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_slice_profile.py"]
    assert len(files) > 10
    banned = ("jax", "flax", "optax", "lance_distributed_training_tpu")
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in banned, f"{path.relative_to(ROOT)} imports {module}"


def test_entry_points_default_to_cuda():
    assert trainer.TrainConfig(dataset_path="-").device == "cuda"
    assert cli.build_parser().get_default("device") == "cuda"
    assert os.path.basename(trainer.__file__) == "trainer.py"
