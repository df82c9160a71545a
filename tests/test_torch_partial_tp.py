"""``--model_parallelism`` degrees whose plan splits only part of a layer.

JAX's rules pass through ``_fit_spec``, which drops an axis that does not
divide a dimension: where the degree divides the width but not the heads
(BERT-base, MoE BERT-base and ViT-B/16 at 8 and 16, ViT-S/16 at 4,
BERT-small, ViT-tiny and CLIP-tiny at 8), ``query``, ``key`` and
``value`` stay whole, ``attn/out/kernel`` still splits on its input, the
MLP splits as usual and the vocabulary and the experts split where they
divide. The port runs that plan: every attention computes its heads whole
and alike on every model rank and ``out`` is row-parallel over this
rank's block of its input features (``comm.scatter_to``).

* Plan parity (shapes only): every parameter's, moment's and
  accumulator's spec is what JAX ``partition_specs`` gives the same leaf
  of the ``TrainState``, for the rules and the rules with ``--fsdp`` (the
  data axis 2), on JAX's 8 CPU devices where the mesh fits them and on a
  ``jax.sharding.AbstractMesh`` of the same axes (no devices behind it:
  ``partition_specs`` reads only the mesh's shape) where it does not.
* ``shard_model_`` raises nothing at those degrees, every local shape is
  the plan's block, and the attentions take the ``out``-only mode; a
  partial plan that no rule of JAX's produces still raises, naming the
  leaves.
* ``comm.scatter_to`` and the ``out``-only attention over four gloo
  processes: the blocks and the gathered gradient exactly, the attention's
  output and gradients against the whole module within f32 rounding (the
  row-parallel ``out`` sums four partial products).
* One step of BERT-small at ``--model_parallelism 8`` over eight gloo
  processes, with ``tests/torch_layout_steps.py``'s tolerances of ``tp``:
  against JAX's step on its 8-device CPU mesh, against the port's DP run,
  and the bytes held against the plan.
* A checkpoint of ViT-tiny (two heads) at ``--model_parallelism 4``
  resumes bit for bit, and a DP run of four processes restores it (its
  losses within the 2e-3 relative of ``tp``: its GEMMs split by rows,
  not by the model).
* ``--fsdp`` with the partial plan (ViT-S/16 at degree 4, data 2: the
  whole ``query``/``key``/``value`` take a data block) tracks the DP run
  within the same 2e-3, each rank holding its plan's bytes.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.parallel import sharding as jax_sharding
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes,
)
from lance_distributed_training_tpu_torch.models.moe import MoEMLP
from lance_distributed_training_tpu_torch.models.transformer import (
    EncoderBlock,
    SelfAttention,
    TransformerEncoder,
)
from lance_distributed_training_tpu_torch.parallel import comm, sharding
from lance_distributed_training_tpu_torch.parallel.layout import shard_model_
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_cli, run_gloo
from torch_layout_steps import (
    check_against_dp,
    check_against_jax,
    check_held_bytes,
    layout_steps,
)

# name: (task, port/JAX model name, extra task fields, sizes)
SMALL = dict(seq_len=32, vocab_size=128, image_size=32, num_classes=10)
FULL = dict(seq_len=512, vocab_size=30522, image_size=224, num_classes=1000)
MODELS = {
    "bert_small": ("masked_lm", "bert_small", {}, SMALL),
    "moe_bert_small": ("masked_lm", "bert_small", {"num_experts": 8},
                       SMALL),
    "vit_tiny": ("classification", "vit_tiny", {}, SMALL),
    "clip_tiny": ("contrastive", "clip_tiny", {}, dict(SMALL, seq_len=16)),
    "bert_base": ("masked_lm", "bert_base", {}, FULL),
    "moe_bert_base": ("masked_lm", "bert_base", {"num_experts": 8}, FULL),
    "vit_base": ("classification", "vit_base", {}, FULL),
    "vit_small": ("classification", "vit_small", {}, FULL),
}
# (model, degree): each model at the degrees that split its width but not
# its heads.
DEGREES = [("bert_small", 8), ("moe_bert_small", 8), ("vit_tiny", 8),
           ("clip_tiny", 8), ("bert_base", 8), ("bert_base", 16),
           ("moe_bert_base", 8), ("moe_bert_base", 16), ("vit_base", 8),
           ("vit_base", 16), ("vit_small", 4)]


def _spec(spec) -> tuple:
    out = list(tuple(spec))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _jax_abstract(model: str):
    """JAX's abstract TrainState of ``model`` (AdamW, two micro-steps an
    update, so that the accumulator is a leaf)."""
    task_type, name, extra, sizes = MODELS[model]
    config = jax_trainer.TrainConfig(
        dataset_path="unused", task_type=task_type, model_name=name,
        optimizer="adamw", grad_accum=2, **sizes, **extra)
    task = jax_trainer._task_from_config(config, get_mesh(jax.devices()[:1]))
    tx = jax_trainer.make_optimizer(config, 10)

    def create(rng):
        variables = task.init_variables(rng)
        return jax_trainer.TrainState.create(
            apply_fn=None, params=variables["params"],
            batch_stats=variables.get("batch_stats"), tx=tx)

    return task.name, jax.eval_shape(create, jax.random.key(0))


def _port_model(model: str):
    """The port's task of ``model``, built on the meta device (shapes
    only)."""
    task_type, name, extra, sizes = MODELS[model]
    with torch.device("meta"):
        return tasks.get_task(
            task_type, model_name=name, num_classes=sizes["num_classes"],
            image_size=sizes["image_size"], seq_len=sizes["seq_len"],
            vocab_size=(sizes["vocab_size"]
                        if task_type != "classification" else None),
            **extra)


def _mesh(degree: int, data: int):
    """JAX's mesh of ``data x degree``: the CPU devices where they suffice,
    else an abstract mesh of the same axes."""
    if data * degree <= len(jax.devices()):
        return get_mesh(jax.devices()[:data * degree],
                        model_parallelism=degree)
    return AbstractMesh((data, degree), ("data", "model"))


@pytest.mark.parametrize("strategy", ["rules", "rules_fsdp"])
@pytest.mark.parametrize("model,degree", DEGREES)
def test_plan_matches_jax_partition_specs(model, degree, strategy):
    fsdp = strategy == "rules_fsdp"
    data = 2 if fsdp else 1
    mesh = _mesh(degree, data)
    task_name, abstract = _jax_abstract(model)
    rules = jax_sharding.rules_for_task(task_name, MODELS[model][1])
    specs = jax_sharding.partition_specs(
        abstract, rules, mesh, fsdp_axis="data" if fsdp else None)
    flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    leaves = {jax_sharding._path_str(p): (tuple(leaf.shape), _spec(s))
              for (p, leaf), s in zip(
                  jax.tree_util.tree_flatten_with_path(abstract)[0],
                  flat_specs)}
    task = _port_model(model)
    assert task.name == task_name
    plan = sharding.plan_model(
        flax_named_shapes(task.model),
        sharding.rules_for_task(task.name, MODELS[model][1]),
        comm.mesh_shape(data * degree, degree), fsdp=fsdp)
    params = {p[len("params/"):] for p in leaves if p.startswith("params/")}
    assert {leaf.flax_path for leaf in plan.values()} == params
    for leaf in plan.values():
        path = leaf.flax_path
        shape, want = leaves[f"params/{path}"]
        assert shape == leaf.flax_shape, leaf.name
        assert _spec(leaf.specs[0]) == want, leaf.name
        moments = [s for p, (_, s) in leaves.items()
                   if p.startswith("opt_state/") and "acc_grads" not in
                   p.split("/") and p.endswith("/" + path)]
        assert moments and all(s == _spec(leaf.specs[1]) for s in moments)
        assert leaves[f"opt_state/acc_grads/{path}"][1] == \
            _spec(leaf.specs[2]), leaf.name
        # The partial plan itself: the heads whole over 'model' (a data
        # block under fsdp where the leaf is large), out split on its
        # input.
        if "/attn/" in path and path.endswith("/kernel"):
            if "/attn/out/" in path:
                assert leaf.param == ("model", 1), leaf.name
            else:
                assert leaf.param is None or leaf.param[0] == "data", \
                    leaf.name
                assert fsdp or leaf.param is None
    kernels = [leaf for leaf in plan.values()
               if leaf.flax_path.endswith("attn/query/kernel")]
    assert kernels
    if fsdp and min(np.prod(k.flax_shape) for k in kernels) >= 16384:
        assert all(k.param and k.param[0] == "data" for k in kernels)


class _Group:
    """A stand-in for the model group: ``shard_model_`` only hands it on."""


def _expected(model: str, degree: int, plan: dict) -> dict:
    """Whether the experts and the vocabulary split: each as its own
    dimension divides by the degree, whatever the heads do."""
    experts = MODELS[model][2].get("num_experts", 0)
    return {"experts": experts > 0 and experts % degree == 0,
            "vocab": any(leaf.param == ("model", 0) for name, leaf in
                         plan.items() if name.endswith("tok_embed.weight"))}


@pytest.mark.parametrize("model,degree", DEGREES)
def test_shard_model_keeps_the_plans_blocks(model, degree):
    """The plans the parent's port refused (``NotImplementedError``: "the
    plan splits only some of [... query, key, value, out]")."""
    mesh = comm.mesh_shape(degree, degree)
    for rank in (0, degree - 1):
        task = _port_model(model)
        plan = sharding.plan_model(
            flax_named_shapes(task.model),
            sharding.rules_for_task(task.name, MODELS[model][1]), mesh)
        heads = {name: m.num_heads for name, m in task.model.named_modules()
                 if isinstance(m, SelfAttention)}
        topo = comm.Topology(rank, degree, degree, create_groups=False)
        group = topo.group["model"] = _Group()
        shard_model_(task.model, plan, topo)
        for name, p in task.model.named_parameters():
            assert tuple(p.shape) == plan[name].local_shape("param", mesh), \
                name
        want = _expected(model, degree, plan)
        seen = {"attention": 0, "mlp": 0, "experts": 0, "vocab": 0}
        for name, m in task.model.named_modules():
            if isinstance(m, SelfAttention):
                assert m.tp_group is None and m.out_group is group
                assert m.num_heads == heads[name]
                seen["attention"] += 1
            elif isinstance(m, EncoderBlock) and m.moe is None:
                assert m.tp_group is group
                seen["mlp"] += 1
            elif isinstance(m, MoEMLP):
                assert (m.expert_group is group) == want["experts"]
                seen["experts"] += m.expert_group is group
            if isinstance(m, TransformerEncoder):
                assert (m.vocab_group is group) == want["vocab"]
                seen["vocab"] += m.vocab_group is group
        assert seen["attention"] and seen["mlp"]
        assert bool(seen["experts"]) == want["experts"]
        assert bool(seen["vocab"]) == want["vocab"]


@pytest.mark.parametrize("leaves", [("query",), ("query", "out"),
                                    ("key", "value", "out")])
def test_a_partial_plan_no_rule_gives_still_raises(leaves):
    task = _port_model("bert_small")
    plan = sharding.plan_model(flax_named_shapes(task.model), (),
                               comm.mesh_shape(2, 2))
    for leaf in leaves:
        name = f"layers.0.attn.{leaf}.weight"
        plan[name] = dataclasses.replace(plan[name], param=("model", 0))
    topo = comm.Topology(0, 2, 2, create_groups=False)
    with pytest.raises(NotImplementedError) as err:
        shard_model_(task.model, plan, topo)
    for leaf in leaves:
        assert f"layers.0.attn.{leaf}.weight" in str(err.value)


# ----------------------------------- scatter_to and the out-only attention

_ATTENTION_CHILD = r'''
import json
import torch
import torch.distributed as dist
from lance_distributed_training_tpu_torch.models.transformer import (
    SelfAttention)
from lance_distributed_training_tpu_torch.parallel import comm

out = {}
group = dist.group.WORLD
for dt in (torch.float32, torch.bfloat16):
    x = torch.arange(2 * 3 * 8, dtype=dt).reshape(2, 3, 8).requires_grad_()
    y = comm.scatter_to(x, group)
    (y.float() * (RANK + 1)).sum().backward()
    out[str(dt)] = {"block": y.float().tolist(),
                    "grad": x.grad.float().tolist()}
assert comm.scatter_to(x, None) is x

torch.manual_seed(0)
whole = SelfAttention(16, 2, dtype=torch.float32)
part = SelfAttention(16, 2, dtype=torch.float32)
part.load_state_dict(whole.state_dict())
n = 16 // WORLD
part.out.weight = torch.nn.Parameter(
    whole.out.weight.detach()[:, RANK * n:(RANK + 1) * n].clone())
part.out_group = group
x = torch.randn(2, 5, 16)
ys = [m(x.clone().requires_grad_()) for m in (whole, part)]
dy = torch.randn(2, 5, 16)
for y in ys:
    (y * dy).sum().backward()
out["attention"] = {
    "y": (ys[1] - ys[0]).abs().max().item(),
    "query": (part.query.weight.grad - whole.query.weight.grad
              ).abs().max().item(),
    "out": (part.out.weight.grad - whole.out.weight.grad[
        :, RANK * n:(RANK + 1) * n]).abs().max().item(),
    "out_bias": (part.out.bias.grad - whole.out.bias.grad).abs().max().item(),
    "scale": ys[0].abs().max().item()}
print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def attention_ranks():
    outs = run_gloo(_ATTENTION_CHILD, 4)
    return [json.loads([line for line in out.splitlines()
                        if line.startswith("RESULT ")][-1][len("RESULT "):])
            for out in outs]


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_scatter_to_keeps_a_block_and_gathers_the_gradient(attention_ranks,
                                                           dtype):
    whole = np.arange(2 * 3 * 8).reshape(2, 3, 8)
    grad = np.repeat(np.arange(1, 5), 2)[None, None, :].repeat(3, 1)
    for rank, got in enumerate(attention_ranks):
        assert got[dtype]["block"] == whole[..., 2 * rank:2 * rank + 2
                                            ].tolist()
        # The gradient of each block is (its rank + 1): all-gathered, the
        # whole tensor's on every rank.
        assert got[dtype]["grad"] == grad.repeat(2, 0).tolist()


def test_out_only_attention_equals_the_whole_module(attention_ranks):
    for got in attention_ranks:
        att = got["attention"]
        for key in ("y", "query", "out", "out_bias"):
            assert att[key] <= 1e-5 * max(att["scale"], 1.0), (key, att)


# ------------------------------------- BERT-small at degree 8, one step

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return layout_steps(["tp8"], tmp_path_factory.mktemp("tp8"))


def test_tp8_step_matches_jax(steps):
    check_against_jax(steps, "tp8")


def test_tp8_step_matches_the_port_dp_run(steps):
    check_against_dp(steps, "tp8")


def test_tp8_holds_what_its_plan_computes(steps):
    task = _port_model("bert_small")
    check_held_bytes(steps, "tp8", flax_named_shapes(task.model))


# -------------------------- a partial-plan checkpoint: ViT-tiny at 4

def _vit_argv(path, *extra):
    return ["train", "--dataset_path", path, "--model_name", "vit_tiny",
            "--image_size", "32", "--num_classes", "10", "--batch_size", "16",
            "--optimizer", "adamw", "--lr", "1e-3", "--log_every", "1",
            "--device", "cpu", "--no_autotune", "--no_eval_at_end", *extra]


def test_partial_plan_checkpoint_resumes_bit_for_bit_and_dp_restores_it(
        tmp_path, image_dataset):
    path = image_dataset.uri
    ckpt = str(tmp_path / "ckpt")
    tp = ["--model_parallelism", "4"]
    whole = run_cli(4, _vit_argv(path, *tp, "--max_steps", "4"))
    first = run_cli(4, _vit_argv(path, *tp, "--max_steps", "2",
                                 "--checkpoint_dir", ckpt,
                                 "--checkpoint_every_steps", "2"))
    dp_ckpt = str(tmp_path / "ckpt_dp")
    shutil.copytree(ckpt, dp_ckpt)
    rest = run_cli(4, _vit_argv(path, *tp, "--max_steps", "2",
                                "--checkpoint_dir", ckpt))
    # Four DP processes (a checkpoint names its world): the same global
    # batches, split by rows rather than by the model.
    dp = run_cli(4, _vit_argv(path, "--max_steps", "2", "--checkpoint_dir",
                              dp_ckpt))
    assert whole[0]["parallel"]["mesh"]["model"] == 4
    assert first[0]["losses"] + rest[0]["losses"] == whole[0]["losses"]
    assert all(r["losses"] == whole[0]["losses"] for r in whole)
    assert dp[0]["global_step"] == 4
    np.testing.assert_allclose(dp[0]["losses"], whole[0]["losses"][2:],
                               rtol=2e-3)


# ------------------- fsdp with the partial plan: ViT-S/16 at 4, data 2

def test_fsdp_with_a_partial_plan_tracks_the_dp_run(image_dataset):
    """``--fsdp`` under the rules at a degree that keeps the heads whole:
    the whole ``query``/``key``/``value`` (147,456 elements each) take a
    data block, as JAX's ``rules_fsdp`` plan gives them; eight ranks (data
    2 x model 4) track two DDP ranks on the same global batches, and each
    holds its plan's bytes."""
    argv = ["train", "--dataset_path", image_dataset.uri, "--model_name",
            "vit_small", "--image_size", "32", "--num_classes", "10",
            "--batch_size", "8", "--optimizer", "adamw", "--lr", "1e-3",
            "--log_every", "1", "--device", "cpu", "--no_autotune",
            "--no_eval_at_end", "--max_steps", "2"]
    layout = run_cli(8, argv + ["--model_parallelism", "4", "--fsdp"])
    dp = run_cli(2, argv)
    assert layout[0]["parallel"]["mesh"] == {"data": 2, "model": 4,
                                             "seq": 1, "pipe": 1}
    for rank in layout:
        assert rank["losses"] == layout[0]["losses"]
        assert rank["parallel"]["held_bytes"] == \
            rank["parallel"]["plan_bytes"]
    np.testing.assert_allclose(layout[0]["losses"], dp[0]["losses"],
                               rtol=2e-3)
