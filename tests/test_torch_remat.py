"""``--remat``: each transformer block rematerialized in the backward.

The port checkpoints each block's call (``torch.utils.checkpoint``,
non-reentrant) where the JAX encoder wraps ``EncoderBlock`` in
``nn.remat``. Against JAX: ``get_task("masked_lm", remat=True)`` at
bert_small's widths (256/4/4/1024, f32, sequence 32) on identical weights,
the logits within the transformer tests' 1e-4 and the parameter gradients
within 1e-4 of their largest magnitude. Against the port without remat:
forward and gradients bit for bit on the CPU for dense, MoE and causal
blocks, the flash ``attention_fn`` and the in-process ring (the plain K5),
and ViT's blocks; the recomputed forward runs the attention's forward
twice a layer. ``cli train --remat`` takes the losses of the run without it,
bit for bit, and the ``state_dict`` keys do not change; so do two gloo
processes, a ring of two and MoE over their global batch.
"""

import functools
import importlib
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu import cli as jax_cli
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    create_text_token_dataset,
)
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    load_flax_params,
    masked_lm_task,
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.vit import ViT
from lance_distributed_training_tpu_torch.ops import flash
from lance_distributed_training_tpu_torch.ops.flash import (
    make_flash_attention,
)
from lance_distributed_training_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
VOCAB, SEQ, BATCH = 97, 32, 4
BERT_SMALL = dict(hidden_size=256, num_layers=4, num_heads=4, mlp_dim=1024)
NARROW = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _batch(seed=0, batch=BATCH, seq=SEQ, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (batch, seq)).astype(np.int32)
    lengths = rng.integers(seq // 2, seq + 1, batch)
    lengths[0] = seq
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int8)
    return {"input_ids": ids, "attention_mask": mask}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_masked_lm_remat_matches_jax_get_task(monkeypatch):
    """JAX's ``get_task(..., remat=True)`` against the port's, on bert_small's
    widths in f32: logits and every parameter's gradient."""
    preset = functools.partial(JaxEncoder, dtype=jnp.float32, **BERT_SMALL)
    monkeypatch.setattr(jax_tasks, "bert_small", preset)
    jt = jax_tasks.get_task("masked_lm", model_name="bert_small",
                            seq_len=SEQ, vocab_size=VOCAB, remat=True)
    params = _tree(jt.init_variables(jax.random.key(0))["params"])
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.key(3)

    def loss_fn(p):
        outputs, _ = jt.forward({"params": p}, jbatch, True, rng)
        return jt.loss(outputs, jbatch), outputs

    (_, (logits_j, mask_j, _)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)

    monkeypatch.setattr(tasks, "bert_small", functools.partial(
        TransformerEncoder, dtype=torch.float32, **BERT_SMALL))
    port = tasks.get_task("masked_lm", model_name="bert_small", seq_len=SEQ,
                          vocab_size=VOCAB, remat=True)
    assert port.model.remat is True
    load_flax_params(port.model, params)
    tbatch = _tensors(batch)
    outputs = port.forward(tbatch, True,
                           mlm_mask=torch.from_numpy(np.array(mask_j)))
    port.loss(outputs, tbatch).backward()
    live = batch["attention_mask"] > 0
    np.testing.assert_allclose(outputs[0].detach().numpy()[live],
                               np.asarray(logits_j)[live], atol=1e-4)
    want = torch_state_dict_from_flax(_tree(grads))
    got = {k: p.grad for k, p in port.model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


def _encoder(arm: str, remat: bool):
    kw = dict(NARROW, max_len=SEQ, dtype=torch.float32, remat=remat,
              generator=torch.Generator().manual_seed(5))
    if arm == "moe":
        kw.update(num_experts=4, moe_every=2)
    if arm == "causal":
        kw.update(causal=True)
    if arm == "flash":
        kw.update(attention_fn=make_flash_attention())
    if arm == "ring":
        kw.update(attention_fn=make_ring_attention(4))
    return TransformerEncoder(VOCAB, **kw)


def _forward_backward(model, batch):
    tbatch = _tensors(batch)
    task = masked_lm_task(model)
    mlm = torch.from_numpy(np.random.default_rng(7).random(
        batch["input_ids"].shape) < 0.3) & (tbatch["attention_mask"] > 0)
    outputs = task.forward(tbatch, True, mlm_mask=mlm)
    loss = task.loss(outputs, tbatch)
    loss.backward()
    return outputs[0].detach(), loss.detach(), {
        k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("arm", ["dense", "moe", "causal", "flash", "ring"])
def test_remat_is_bit_identical_to_the_run_without(arm):
    batch = _batch(1)
    plain = _forward_backward(_encoder(arm, False), batch)
    remat = _forward_backward(_encoder(arm, True), batch)
    assert torch.equal(remat[0], plain[0])
    assert torch.equal(remat[1], plain[1])
    assert set(remat[2]) == set(plain[2])
    for name, g in plain[2].items():
        assert g is not None, name
        assert torch.equal(remat[2][name], g), name


def _counting(monkeypatch, module, name):
    calls = [0]
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arm", ["flash", "ring"])
def test_remat_runs_each_attention_forward_twice(monkeypatch, arm):
    """FA-fwd (or the K5 fold) runs twice a layer under remat and once
    without; the backward kernels once a layer either way."""
    pra = importlib.import_module(
        "lance_distributed_training_tpu_torch.parallel.ring_attention")
    if arm == "flash":
        fwd = _counting(monkeypatch, flash, "flash_attention_fwd")
        bwd = _counting(monkeypatch, flash, "flash_attention_bwd_dq")
    else:
        fwd = _counting(monkeypatch, pra, "ring_fold_fwd")
        bwd = _counting(monkeypatch, pra, "ring_fold_bwd_dq")
    layers = NARROW["num_layers"]
    for remat, want in ((False, layers), (True, 2 * layers)):
        fwd[0] = bwd[0] = 0
        _forward_backward(_encoder(arm, remat), _batch(2))
        assert (fwd[0], bwd[0]) == (want, layers), remat


def test_vit_remat_field_and_the_classification_task_leaves_it_off():
    def run(remat):
        model = ViT(10, image_size=32, patch_size=8, hidden_size=64,
                    num_layers=2, num_heads=2, mlp_dim=128,
                    dtype=torch.float32, remat=remat,
                    generator=torch.Generator().manual_seed(1))
        x = torch.from_numpy(np.random.default_rng(0).random(
            (3, 3, 32, 32)).astype(np.float32))
        out = model(x)
        out.square().sum().backward()
        return out.detach(), {k: p.grad for k, p in model.named_parameters()}

    plain, remat = run(False), run(True)
    assert torch.equal(plain[0], remat[0])
    for name, g in plain[1].items():
        assert torch.equal(remat[1][name], g), name
    # As in JAX (models/tasks.py), the classification task does not pass
    # remat to a ViT.
    task = tasks.get_task("classification", model_name="vit_tiny",
                          image_size=32, num_classes=10, remat=True)
    assert task.model.remat is False


def test_state_dict_keys_do_not_change_and_cover_jax_remat_params():
    plain = _encoder("moe", False).state_dict()
    remat = _encoder("moe", True).state_dict()
    assert list(plain) == list(remat)
    for name, tensor in plain.items():
        assert torch.equal(remat[name], tensor), name
    model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, remat=True,
                       max_len=SEQ, num_experts=4, moe_every=2, **NARROW)
    ids = jnp.zeros((1, SEQ), jnp.int32)
    params = _tree(model.init(jax.random.key(0), ids, jnp.ones_like(ids),
                              train=False)["params"])
    assert set(torch_state_dict_from_flax(params)) == set(plain)


def test_cli_flag_matches_jax():
    port, jax_parser = cli.build_parser(), jax_cli.build_parser()
    assert port.get_default("remat") is jax_parser.get_default("remat") \
        is False
    got = [a for a in port._actions if a.dest == "remat"][0]
    want = [a for a in jax_parser._actions if a.dest == "remat"][0]
    assert got.help == want.help and got.option_strings == \
        want.option_strings
    assert trainer.TrainConfig(dataset_path="-").remat is False


def test_cli_train_remat_on_cpu_takes_the_losses_without_it(tmp_path,
                                                            monkeypatch):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, VOCAB, rng.integers(8, SEQ + 1)).tolist()
            for _ in range(48)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)

    def run(*extra):
        monkeypatch.setenv("LDT_METRICS_PATH",
                           str(tmp_path / f"m{len(extra)}.jsonl"))
        return cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", str(VOCAB),
            "--seq_len", str(SEQ), "--batch_size", "8", "--max_steps", "3",
            "--flash_attention", "--optimizer", "adamw", "--lr", "1e-3",
            "--device", "cpu", "--no_eval_at_end", "--no_autotune",
            "--log_every", "1", *extra])

    with torch.random.fork_rng():
        torch.set_num_threads(2)
        plain = run()
        remat = run("--remat")
    assert remat["model"].remat is True and plain["model"].remat is False
    assert len(remat["losses"]) == 3 and np.isfinite(remat["losses"]).all()
    assert remat["losses"] == plain["losses"]


# -------------------------------------------- two gloo processes, with remat

_CHILD = textwrap.dedent(r'''
    import functools, sys
    import torch
    torch.set_num_threads(1)
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.models import tasks, transformer
    tasks.bert_small = functools.partial(transformer.bert_small,
                                         dtype=torch.float32)
    path, out, rank, address, arm, remat = sys.argv[1:7]
    kw = dict(dataset_path=path, task_type="masked_lm",
              model_name="bert_small", vocab_size=128, seq_len=32,
              batch_size=8, max_steps=3, epochs=1, log_every=0,
              optimizer="sgd", lr=0.5, eval_at_end=False, device="cpu",
              remat=remat == "1", coordinator_address=address,
              num_processes=2, process_id=int(rank))
    if arm == "ring":
        kw.update(seq_parallelism=2)
    else:
        kw.update(num_experts=4, moe_every=2)
    result = trainer.train(trainer.TrainConfig(**kw))
    torch.save({"losses": result["losses"],
                "state": result["model"].state_dict()}, out)
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arm", ["ring", "moe"])
def test_two_gloo_processes_train_alike_with_remat(tmp_path, arm):
    """A ring of two processes (the recomputed forward passes its blocks
    around the ring again) and MoE over two processes' global batch (the
    recompute all-gathers the expert counts again on both ranks): losses
    and weights with ``--remat`` equal those without, bit for bit."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, 128, rng.integers(8, SEQ + 1)).tolist()
            for _ in range(24)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    env = dict(os.environ, LDT_METRICS_PATH=os.devnull,
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    addresses = {r: f"127.0.0.1:{_free_port()}" for r in ("0", "1")}
    procs = {(remat, rank): subprocess.Popen(
        [sys.executable, "-c", _CHILD, path,
         str(tmp_path / f"remat{remat}r{rank}.pt"), rank, addresses[remat],
         arm, remat],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for remat in ("0", "1") for rank in ("0", "1")}
    outs = {}
    try:
        for key, p in procs.items():
            outs[key] = p.communicate(timeout=180)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for key, p in procs.items():
        assert p.returncode == 0, (key, outs[key][-3000:])
    for rank in ("0", "1"):
        plain = torch.load(tmp_path / f"remat0r{rank}.pt")
        remat = torch.load(tmp_path / f"remat1r{rank}.pt")
        assert len(plain["losses"]) == 3
        assert remat["losses"] == plain["losses"]
        for name, value in plain["state"].items():
            assert torch.equal(remat["state"][name], value), (rank, name)
