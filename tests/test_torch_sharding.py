"""The port's layouts beyond data parallelism against the JAX package's.

Layout parity (shapes only): for every parameter of BERT-small, MoE
BERT-small, ViT-tiny, CLIP-tiny (ResNet image tower, encoder text tower)
and ResNet-18, and for its optimizer moments and gradient accumulator, the
port's plan (``parallel/sharding.plan_model`` through
``models/convert.flax_leaf_view``) names the Flax leaf, shape and spec that
JAX ``partition_specs`` gives the same leaf of the ``TrainState`` under
the rules (``--model_parallelism 2``), ``--fsdp``, ``--zero 1``, ``--zero
2`` with ``--grad_accum 2``, the rules with fsdp on a 2x2 mesh, and the
pipeline (the stacked blocks over ``'pipe'``) — the clamps, the
16384-element floor and the zero level-1/level-2 difference on the
accumulator included — and a port dimension that holds the sharded Flax
one whole, so that its contiguous blocks are the Flax dimension's.

One train step of each layout (TP, FSDP, ZeRO-1, ZeRO-2 over two
micro-steps, EP, PP) on BERT-small (vocabulary 128, sequence 32, batch 8,
SGD with momentum, bf16 compute), over two gloo processes, from the JAX
package's initial weights carried over by ``convert`` and JAX's own MLM
mask draw:

* against JAX's same layout (its ``state_shardings`` on a 2-device
  sub-mesh of the 8 virtual CPU devices): the loss within 2e-3 relative,
  the logged gradient norm within 5e-3 relative, and two probe
  parameters' updates within 3% of the JAX update's largest element (the
  packages' bf16 backward passes part by about 1% of it);
* against the port's own data-parallel run of the same weights and batch:
  FSDP, ZeRO-1 and ZeRO-2 bit for bit (the same reduction order: each
  leaf's two halves summed once, then halved; the gathered parameters are
  the same bits) and PP bit for bit against the one-process pipelined
  model (the same per-microbatch products, activations shipped exactly);
  TP and EP within 2e-3 relative on the loss and the norm and 3% of the
  update on the probes (the row-parallel projections sum two
  bf16-rounded partial products in f32, where one process rounds the
  whole product once);
* the logged gradient norm is the global norm of the whole gradient:
  within 1e-5 relative where the step is bit for bit (each split leaf's
  squared block norms are summed over its group, where one process takes
  the whole leaf's norm).

A sharded run's checkpoint holds the whole state in the data-parallel
format: an FSDP run preempted and resumed matches the uninterrupted run
bit for bit, and a data-parallel run resumed from it continues it bit for
bit. Every JAX refusal of these layouts is kept with JAX's message, and
the CLI's five flags are JAX's.
"""

import functools
import re

import jax
import numpy as np
import pytest

from lance_distributed_training_tpu import cli as jax_cli
from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.models import tasks as jax_tasks
from lance_distributed_training_tpu.parallel import sharding as jax_sharding
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes,
)
from lance_distributed_training_tpu_torch.parallel import comm, sharding
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_cli
from torch_layout_steps import (
    check_against_dp,
    check_against_jax,
    check_held_bytes,
    layout_steps,
)

VOCAB, SEQ, BATCH, IMAGE = 128, 32, 8, 32

# (task, model name, extra task arguments) of each layout-parity model.
MODELS = {
    "bert_small": ("masked_lm", "bert_small", {}),
    "moe_bert_small": ("masked_lm", "bert_small", {"num_experts": 4}),
    "vit_tiny": ("classification", "vit_tiny", {}),
    "clip_tiny": ("contrastive", "clip_tiny", {}),
    "resnet18": ("classification", "resnet18", {}),
}
# (model, seq, pipe) degrees, fsdp, zero level, grad_accum of each strategy
# over 2 (rules_fsdp: 4) devices.
STRATEGIES = {
    "rules": ((2, 1, 1), False, 0, 1),
    "fsdp": ((1, 1, 1), True, 0, 1),
    "zero1": ((1, 1, 1), False, 1, 2),
    "zero2": ((1, 1, 1), False, 2, 2),
    "rules_fsdp": ((2, 1, 1), True, 0, 2),
}


def _spec(spec) -> tuple:
    out = list(tuple(spec))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _path(path) -> str:
    return jax_sharding._path_str(path)


@functools.lru_cache(maxsize=None)
def _jax_abstract(model: str, accum: int, pipe: int):
    """JAX's abstract TrainState of ``model`` (AdamW, ``grad_accum``)."""
    task_type, name, extra = MODELS[model]
    mesh = get_mesh(jax.devices()[:pipe], pipe_parallelism=pipe)
    config = jax_trainer.TrainConfig(
        dataset_path="unused", task_type=task_type, model_name=name,
        seq_len=SEQ if task_type != "contrastive" else 16, vocab_size=VOCAB,
        image_size=IMAGE, num_classes=10, optimizer="adamw",
        grad_accum=accum, pipeline_parallelism=pipe, **extra)
    task = jax_trainer._task_from_config(config, mesh)
    tx = jax_trainer.make_optimizer(config, 10)

    def create(rng):
        variables = task.init_variables(rng)
        return jax_trainer.TrainState.create(
            apply_fn=None, params=variables["params"],
            batch_stats=variables.get("batch_stats"), tx=tx)

    return task.name, jax.eval_shape(create, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_model(model: str, pipe: int):
    task_type, name, extra = MODELS[model]
    task = tasks.get_task(
        task_type, model_name=name, num_classes=10, image_size=IMAGE,
        seq_len=SEQ if task_type != "contrastive" else 16,
        vocab_size=VOCAB if task_type != "classification" else None,
        pipeline_parallelism=pipe, **extra)
    return task.name, flax_named_shapes(task.model)


def _cases():
    for model in MODELS:
        for strategy in STRATEGIES:
            yield model, strategy
    yield "bert_small", "pipe"


@pytest.mark.parametrize("model,strategy", list(_cases()))
def test_plan_matches_jax_partition_specs(model, strategy):
    if strategy == "pipe":
        (mp, sp, pp), fsdp, zero, accum = (1, 1, 2), False, 0, 1
    else:
        (mp, sp, pp), fsdp, zero, accum = STRATEGIES[strategy]
    data = 4 // (mp * pp) if strategy == "rules_fsdp" else 2 // (mp * pp)
    devices = jax.devices()[:data * mp * pp]
    mesh = get_mesh(devices, model_parallelism=mp, pipe_parallelism=pp)
    task_name, abstract = _jax_abstract(model, accum, pp)
    rules = (jax_sharding.rules_for_task(task_name, MODELS[model][1])
             if mp > 1 or pp > 1 else ())
    specs = jax_sharding.partition_specs(
        abstract, rules, mesh, fsdp_axis="data" if fsdp else None,
        zero_axis="data" if zero else None, zero_level=zero or 1)
    leaves = {_path(p): (tuple(leaf.shape), _spec(s)) for (p, leaf), s in zip(
        jax.tree_util.tree_flatten_with_path(abstract)[0],
        jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)))}
    port_name, named = _port_model(model, pp)
    assert port_name == task_name
    port_rules = (sharding.rules_for_task(port_name, MODELS[model][1])
                  if mp > 1 or pp > 1 else ())
    assert [(p, tuple(s)) for p, s in port_rules] == [
        (p, tuple(s)) for p, s in rules]
    plan = sharding.plan_model(named, port_rules, comm.mesh_shape(
        len(devices), mp, sp, pp), fsdp=fsdp, zero_level=zero)
    params = {p[len("params/"):] for p in leaves if p.startswith("params/")}
    assert {leaf.flax_path for leaf in plan.values()} == params
    split = 0
    for leaf in plan.values():
        shape, want = leaves[f"params/{leaf.flax_path}"]
        assert shape == leaf.flax_shape, leaf.name
        assert _spec(leaf.specs[0]) == want, leaf.name
        moments = [s for p, (_, s) in leaves.items()
                   if p.startswith("opt_state/") and "acc_grads" not in
                   p.split("/") and p.endswith("/" + leaf.flax_path)]
        assert moments and all(s == _spec(leaf.specs[1]) for s in moments), \
            leaf.name
        if accum > 1:
            _, acc = leaves[f"opt_state/acc_grads/{leaf.flax_path}"]
            assert acc == _spec(leaf.specs[2]), leaf.name
        for spec, layout in zip(leaf.specs, (leaf.param, leaf.moment,
                                             leaf.accum)):
            sharded = [(d, a) for d, a in enumerate(spec) if a is not None]
            assert (layout is None) == (not sharded), leaf.name
            if sharded:
                (d, axis), = sharded
                assert layout[0] == axis
                # The port dimension holds the Flax one whole (heads x
                # head_dim rows for the attention's heads), so its
                # contiguous blocks are the Flax dimension's blocks.
                assert leaf.shape[layout[1]] % leaf.flax_shape[d] == 0, \
                    leaf.name
                split += 1
    big = any(np.prod(leaf.flax_shape) >= 16384 for leaf in plan.values())
    if (strategy != "rules" and big) or (strategy == "rules"
                                         and model != "resnet18"):
        assert split, "the strategy split nothing"


def test_zero_levels_differ_on_the_accumulator_only():
    _, named = _port_model("bert_small", 1)
    mesh = comm.mesh_shape(2)
    one = sharding.plan_model(named, (), mesh, zero_level=1)
    two = sharding.plan_model(named, (), mesh, zero_level=2)
    big = [n for n, leaf in one.items() if leaf.moment is not None]
    assert big
    for name in one:
        assert one[name].param is None and two[name].param is None
        assert one[name].moment == two[name].moment
        assert one[name].accum is None
        assert two[name].accum == two[name].moment
    # The floor: a leaf under 16384 elements stays whole.
    small = [n for n, leaf in one.items()
             if np.prod(leaf.shape) < 16384]
    assert small and all(one[n].moment is None for n in small)


def test_grad_and_batch_specs_match_jax():
    """ZeRO-2's in-flight gradient layout and the batch spec are JAX's."""
    _, abstract = _jax_abstract("bert_small", 1, 1)
    mesh = get_mesh(jax.devices()[:2])
    want = jax_sharding.grad_partition_specs(abstract.params, mesh)
    leaves = {_path(p): tuple(leaf.shape) for p, leaf in
              jax.tree_util.tree_flatten_with_path(abstract.params)[0]}
    got = sharding.grad_partition_specs(leaves, comm.mesh_shape(2))
    flat = {_path(p): _spec(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    assert {k: _spec(v) for k, v in got.items()} == flat
    for ndim in (1, 2, 4):
        for seq in (None, "seq"):
            assert tuple(sharding.batch_partition_spec(
                ndim, seq_axis=seq)) == tuple(
                jax_sharding.batch_partition_spec(ndim, seq_axis=seq))


# ------------------------------------------------- one step of each layout

SHARDING_LAYOUTS = ["tp", "fsdp", "zero1", "zero2"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return layout_steps(SHARDING_LAYOUTS, tmp_path_factory.mktemp("steps"))


@pytest.mark.parametrize("layout", SHARDING_LAYOUTS)
def test_one_step_of_each_layout_matches_jax(steps, layout):
    check_against_jax(steps, layout)


@pytest.mark.parametrize("layout", SHARDING_LAYOUTS)
def test_one_step_of_each_layout_matches_the_port_dp_run(steps, layout):
    check_against_dp(steps, layout)


@pytest.mark.parametrize("layout", SHARDING_LAYOUTS)
def test_each_layout_holds_what_its_plan_computes(steps, layout):
    check_held_bytes(steps, layout, _port_model("bert_small", 1)[1])


# ------------------------------------------------------- checkpoint, CLI


def _dataset(tmp_path, rows=16):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, rows)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    return path


def _argv(path, *extra):
    return ["train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", str(VOCAB),
            "--seq_len", str(SEQ), "--batch_size", "4", "--optimizer",
            "adamw", "--lr", "1e-3", "--log_every", "1", "--device", "cpu",
            "--no_autotune", "--no_eval_at_end", *extra]


def test_sharded_checkpoint_resumes_bit_for_bit_and_dp_restores_it(tmp_path):
    path = _dataset(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    whole = run_cli(2, _argv(path, "--fsdp", "--max_steps", "4"))
    first = run_cli(2, _argv(path, "--fsdp", "--max_steps", "2",
                             "--checkpoint_dir", ckpt,
                             "--checkpoint_every_steps", "2"))
    import shutil

    dp_ckpt = str(tmp_path / "ckpt_dp")
    shutil.copytree(ckpt, dp_ckpt)
    rest = run_cli(2, _argv(path, "--fsdp", "--max_steps", "2",
                            "--checkpoint_dir", ckpt))
    dp = run_cli(2, _argv(path, "--max_steps", "2", "--checkpoint_dir",
                          dp_ckpt))
    assert first[0]["losses"] + rest[0]["losses"] == whole[0]["losses"]
    assert dp[0]["global_step"] == 4
    assert dp[0]["losses"] == whole[0]["losses"][2:]


# ------------------------------------------------------------ refusals

_JAX_MESSAGES = {
    "fsdp_zero": "fsdp and zero_opt are mutually exclusive: fsdp (ZeRO-3) "
                 "already shards the optimizer state along with the params",
    "zero3": "zero_opt must be 0, 1 (shard optimizer state) or 2 (also "
             "shard gradient accumulation), got 3",
    "flash_pp": "flash_attention cannot combine with seq_parallelism or "
                "pipeline_parallelism (they select their own attention "
                "path)",
    "pp_causal": "pipeline_parallelism>1 requires a sequence model "
                 "(masked_lm)",
    "pack_pp": "token_pack is incompatible with seq_parallelism/"
               "pipeline_parallelism: packed batches re-enter the data "
               "layout inside the pack transform and carry no static "
               "sequence split",
}


@pytest.mark.parametrize("case,fields", [
    ("fsdp_zero", {"fsdp": True, "zero_opt": 1}),
    ("zero3", {"zero_opt": 3}),
    ("flash_pp", {"flash_attention": True, "pipeline_parallelism": 2}),
    ("pp_causal", {"task_type": "causal_lm", "pipeline_parallelism": 2}),
    ("pack_pp", {"token_pack": True, "pipeline_parallelism": 2}),
])
def test_trainer_refusals_keep_the_jax_messages(tmp_path, case, fields):
    message = _JAX_MESSAGES[case]
    # The message is the JAX trainer's, its f-string value aside.
    src = re.sub(r'"\s*\n\s*f?"', "", open(jax_trainer.__file__).read())
    assert message.rsplit("got ", 1)[0] in src, case
    config = dict(dataset_path=_dataset(tmp_path), task_type="masked_lm",
                  model_name="bert_small", device="cpu")
    config.update(fields)
    with pytest.raises(ValueError) as err:
        trainer.train(trainer.TrainConfig(**config))
    assert str(err.value) == message


@pytest.mark.parametrize("case", ["pp_moe", "pp_flash", "pp_causal",
                                  "layers", "model_name"])
def test_get_task_refusals_keep_the_jax_messages(case):
    kwargs = {"pp_moe": dict(num_experts=4),
              "pp_flash": dict(attention_fn=lambda *a, **k: None),
              "pp_causal": {}, "layers": {}, "model_name": {}}[case]
    task_type = "causal_lm" if case == "pp_causal" else "masked_lm"
    pipe = 3 if case == "layers" else 2
    name = "bert_large" if case == "model_name" else "bert_small"
    mesh = get_mesh(jax.devices()[:pipe], pipe_parallelism=pipe)
    with pytest.raises(ValueError) as jax_err:
        jax_tasks.get_task(task_type, model_name=name, seq_len=SEQ,
                           pipeline_parallelism=pipe, mesh=mesh, **kwargs)
    with pytest.raises(ValueError) as port_err:
        tasks.get_task(task_type, model_name=name, seq_len=SEQ,
                       pipeline_parallelism=pipe, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("world,degrees", [(2, (3, 1, 1)), (4, (2, 1, 3)),
                                           (2, (0, 1, 1)), (2, (1, 1, 0))])
def test_mesh_refusals_keep_the_jax_messages(world, degrees):
    mp, sp, pp = degrees
    with pytest.raises(ValueError) as jax_err:
        get_mesh(jax.devices()[:world], model_parallelism=mp,
                 seq_parallelism=sp, pipe_parallelism=pp)
    with pytest.raises(ValueError) as port_err:
        comm.mesh_shape(world, mp, sp, pp)
    assert str(port_err.value) == str(jax_err.value)


def test_one_process_cannot_split_the_model(tmp_path):
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "model\\*seq\\*pipe parallelism=2"):
        cli.main(_argv(_dataset(tmp_path), "--model_parallelism", "2",
                       "--max_steps", "1"))


@pytest.mark.parametrize("flag", ["model_parallelism", "pipeline_parallelism",
                                  "pp_microbatches", "fsdp", "zero"])
def test_cli_flags_are_the_jax_flags(flag):
    want = next(a for a in jax_cli.build_parser()._actions
                if a.dest == flag)
    got = next(a for a in cli.build_parser()._actions if a.dest == flag)
    for attr in ("type", "default", "choices", "const", "nargs", "help",
                 "metavar"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got).__name__ == type(want).__name__


def test_cli_passes_the_layout_flags_through(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(cli, "train", lambda config: seen.setdefault(
        "config", config))
    cli.main(_argv(_dataset(tmp_path), "--model_parallelism", "2",
                   "--pipeline_parallelism", "2", "--pp_microbatches", "8",
                   "--zero", "2"))
    config = seen["config"]
    assert (config.model_parallelism, config.pipeline_parallelism,
            config.pp_microbatches, config.zero_opt, config.fsdp) == (
        2, 2, 8, 2, False)
    seen.clear()
    cli.main(_argv(_dataset(tmp_path / "b"), "--fsdp", "--zero"))
    assert (seen["config"].fsdp, seen["config"].zero_opt) == (True, 1)
