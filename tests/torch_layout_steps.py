"""One train step of each layout beyond data parallelism, in the port over
the layout's gloo processes (two; eight for ``tp8``) and in the JAX
package on a sub-mesh of as many devices, for
``tests/test_torch_sharding.py`` (TP, FSDP, ZeRO-1, ZeRO-2),
``tests/test_torch_expert_parallel.py`` (EP),
``tests/test_torch_pipeline_parallel.py`` (PP) and
``tests/test_torch_partial_tp.py`` (TP at degree 8, which splits the
width but not BERT-small's four heads); the tolerances and why are in
``tests/test_torch_sharding.py``'s docstring.

BERT-small (vocabulary 128, sequence 32, batch 8, SGD with momentum, bf16
compute) from the JAX package's initial weights carried over by
``convert`` and JAX's own MLM mask draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.parallel import sharding as jax_sharding
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch.models.convert import (
    pipelined_state_dict_from_flax,
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.parallel import comm, sharding
from torch_gloo_jobs import start_gloo

VOCAB, SEQ, BATCH = 128, 32, 8

LAYOUTS = {  # name: (model degree, pipe degree, fsdp, zero, accum, experts,
    #                world)
    "tp": (2, 1, False, 0, 1, 0, 2),
    "fsdp": (1, 1, True, 0, 1, 0, 2),
    "zero1": (1, 1, False, 1, 1, 0, 2),
    "zero2": (1, 1, False, 2, 2, 0, 2),
    "ep": (2, 1, False, 0, 1, 4, 2),
    "pp": (1, 2, False, 0, 1, 0, 2),
    "tp8": (8, 1, False, 0, 1, 0, 8),
}
PROBES = ("layers.1.attn.query.weight", "tok_embed.weight")
PP_PROBES = ("blocks.attn.query.weight", "tok_embed")
LR = 0.05


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.int32)
    lengths = rng.integers(SEQ // 2, SEQ + 1, BATCH)
    mask[np.arange(SEQ)[None, :] >= lengths[:, None]] = 0
    ids[mask == 0] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _jax_config(layout: str):
    mp, pp, fsdp, zero, accum, experts, _ = LAYOUTS[layout]
    return jax_trainer.TrainConfig(
        dataset_path="unused", task_type="masked_lm",
        model_name="bert_small", seq_len=SEQ, vocab_size=VOCAB,
        batch_size=BATCH, optimizer="sgd", lr=LR, momentum=0.9,
        grad_accum=accum, model_parallelism=mp, pipeline_parallelism=pp,
        fsdp=fsdp, zero_opt=zero, num_experts=experts, moe_every=2)


def _jax_setup(layout: str):
    """JAX's task, mesh, rules and config of ``layout`` on a sub-mesh of
    the layout's world."""
    config = _jax_config(layout)
    mp, pp = config.model_parallelism, config.pipeline_parallelism
    mesh = get_mesh(jax.devices()[:LAYOUTS[layout][6]],
                    model_parallelism=mp, pipe_parallelism=pp)
    task = jax_trainer._task_from_config(config, mesh)
    rules = (jax_sharding.rules_for_task(task.name, config.model_name)
             if mp > 1 or pp > 1 else ())
    return config, mesh, task, rules


def _jax_step(layout: str, batches, rngs):
    """JAX's own layout: ``(initial params, losses, norms, params after
    the steps)``."""
    config, mesh, task, rules = _jax_setup(layout)
    state, state_sharding = jax_trainer.create_sharded_train_state(
        jax.random.key(0), task, config, mesh, rules,
        fsdp_axis="data" if config.fsdp else None,
        zero_axis="data" if config.zero_opt else None,
        zero_level=int(config.zero_opt) or 1, total_steps=10)
    init = jax.tree_util.tree_map(np.asarray, state.params)
    grad_sharding = None
    if int(config.zero_opt) >= 2:
        grad_sharding = jax.tree_util.tree_map(
            lambda s: jax.sharding.NamedSharding(mesh, s),
            jax_sharding.grad_partition_specs(state.params, mesh))
    step = jax_trainer.make_train_step(
        task, mesh, state_sharding=state_sharding, donate=False,
        grad_norm=True, grad_sharding=grad_sharding)
    losses, norms = [], []
    for batch, rng in zip(batches, rngs):
        state, loss, norm = step(state, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, rng)
        losses.append(float(loss))
        norms.append(float(norm))
    after = jax.tree_util.tree_map(np.asarray, state.params)
    return init, losses, norms, after


_STEP_CHILD = r'''
import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes)
from lance_distributed_training_tpu_torch.parallel import comm
from lance_distributed_training_tpu_torch.parallel.layout import (
    ShardedState, shard_model_)
from lance_distributed_training_tpu_torch.parallel.sharding import (
    plan_model, rules_for_task)


def one(data):
    mp, pp, fsdp, zero, accum, experts, _ = data["degrees"]
    config = trainer.TrainConfig(
        dataset_path="unused", task_type="masked_lm",
        model_name="bert_small", seq_len=data["seq"],
        vocab_size=data["vocab"], optimizer="sgd", lr=data["lr"],
        momentum=0.9, grad_accum=accum, log_grad_norm=True)

    def build(group, pipe=1):
        task = tasks.get_task("masked_lm", model_name="bert_small",
                              seq_len=data["seq"], vocab_size=data["vocab"],
                              num_experts=experts, pipeline_parallelism=pipe,
                              pp_microbatches=4, loss_group=group)
        task.model.load_state_dict(data["state"])
        return task

    def run(step, rows, full_state, world=WORLD):
        losses, norms = [], []
        for batch, mask in zip(data["batches"], data["masks"]):
            local = {k: v[rows] for k, v in batch.items()}
            loss = step(local, mlm_mask=mask[rows])
            if world > 1:
                loss = comm.all_reduce(loss, None) / world
            losses.append(float(loss))
            norms.append(float(step.last_grad_norm))
        state = full_state()
        return {"losses": losses, "norms": norms,
                "probes": {k: state[k] for k in data["probes"]}}

    out = {}
    # The layout, as the trainer lays it out.
    topo = comm.Topology(RANK, WORLD, mp, 1, pp)
    d, n = topo.index["data"], topo.size["data"]
    per = data["batch"] // n
    rows = slice(d * per, (d + 1) * per)
    task = build(topo.batch_group, pp)
    rules = (rules_for_task(task.name, "bert_small") if mp > 1 or pp > 1
             else ())
    plan = plan_model(flax_named_shapes(task.model), rules, topo.size,
                      fsdp=fsdp, zero_level=zero)
    shard_model_(task.model, plan, topo)
    sharded = ShardedState(task.model, plan, topo, accum)
    opt, lr = trainer.make_optimizer(config, sharded.masters)
    step = trainer.make_train_step(task, opt, lr, grad_accum=accum,
                                   grad_norm=True, sharded=sharded)
    out["layout"] = run(step, rows,
                        lambda: sharded.full_state(opt, step.accum)[0])
    out["held"] = sharded.held_bytes(opt, step.accum)
    # The data-parallel run of the same weights and batch: DDP over the
    # data groups (FSDP, ZeRO), or one process holding the whole batch
    # (TP, EP, PP; PP's model applies every stage in turn).
    if n > 1:
        task = build(dist.group.WORLD)
        ddp = DistributedDataParallel(task.model)
        opt, lr = trainer.make_optimizer(config, task.model.parameters())
        step = trainer.make_train_step(task.with_model(ddp), opt, lr,
                                       grad_accum=accum, grad_norm=True)
    else:
        task = build(None, pp)
        opt, lr = trainer.make_optimizer(config, task.model.parameters())
        step = trainer.make_train_step(task, opt, lr, grad_accum=accum,
                                       grad_norm=True)
        rows = slice(0, data["batch"])
    out["dp"] = run(step, rows, task.model.state_dict, WORLD if n > 1 else 1)
    return out


for source, target in zip(ARGS[::2], ARGS[1::2]):
    result = one(torch.load(source))
    if RANK == 0:
        torch.save(result, target)
'''


def _jax_init(layout: str):
    """The initial parameters JAX's layout starts from (its task's init
    from key 0, as ``create_sharded_train_state`` draws them)."""
    _, _, task, _ = _jax_setup(layout)
    return jax.tree_util.tree_map(np.asarray, jax.jit(task.init_variables)(
        jax.random.key(0))["params"])


def layout_steps(layouts, tmp) -> dict:
    """Each of ``layouts``' port run (and its DP reference) and JAX's: the
    port's ranks run every layout of a world in one gloo job while JAX
    steps its own."""
    plans, files = {}, {}
    for layout in layouts:
        degrees = LAYOUTS[layout]
        accum = degrees[4]
        batches = [_batch(i) for i in range(accum)]
        rngs = [jax.random.key(100 + i) for i in range(accum)]
        masks = [np.asarray(jax.random.bernoulli(r, 0.15, (BATCH, SEQ))
                            & (b["attention_mask"] > 0))
                 for r, b in zip(rngs, batches)]
        init = _jax_init(layout)
        convert = (pipelined_state_dict_from_flax if degrees[1] > 1
                   else torch_state_dict_from_flax)
        probes = PP_PROBES if degrees[1] > 1 else PROBES
        torch.save({
            "degrees": degrees, "state": convert(init), "seq": SEQ,
            "vocab": VOCAB, "lr": LR, "batch": BATCH, "probes": probes,
            "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                        for b in batches],
            "masks": [torch.from_numpy(m) for m in masks]},
            tmp / f"{layout}.pt")
        files.setdefault(degrees[6], []).extend(
            [tmp / f"{layout}.pt", tmp / f"{layout}.out"])
        plans[layout] = (batches, rngs, init, convert, probes)
    jobs = [start_gloo(_STEP_CHILD, world, *paths)
            for world, paths in files.items()]
    out = {}
    for layout, (batches, rngs, init, convert, probes) in plans.items():
        start, losses, norms, after = _jax_step(layout, batches, rngs)
        for a, b in zip(jax.tree_util.tree_leaves(start),
                        jax.tree_util.tree_leaves(init)):
            assert np.array_equal(a, b)
        before, after = convert(init), convert(after)
        out[layout] = {"jax_losses": losses, "jax_norms": norms,
                       "init": {k: before[k] for k in probes},
                       "jax_probes": {k: after[k] for k in probes}}
    for job in jobs:
        job.wait(600)
    for layout in layouts:
        out[layout]["port"] = torch.load(tmp / f"{layout}.out")
    return out


def _close_updates(got: dict, want: dict, init: dict, share: float = 0.03):
    """Each probe's update within ``share`` of the reference update's
    largest element (bf16 backward passes part by about 1% of it)."""
    for name, value in got.items():
        update = (want[name] - init[name]).abs().max()
        diff = (value - want[name]).abs().max()
        assert diff <= share * update, (name, float(diff), float(update))


def check_against_jax(steps, layout):
    """The layout's step against JAX's same layout (the module's
    docstring)."""
    got = steps[layout]
    port = got["port"]["layout"]
    np.testing.assert_allclose(port["losses"], got["jax_losses"], rtol=2e-3)
    np.testing.assert_allclose(port["norms"], got["jax_norms"], rtol=5e-3)
    _close_updates(port["probes"], got["jax_probes"], got["init"])


def check_against_dp(steps, layout):
    """The layout's step against the port's data-parallel run."""
    port = steps[layout]["port"]
    got, dp = port["layout"], port["dp"]
    if layout in ("fsdp", "zero1", "zero2", "pp"):
        assert got["losses"] == dp["losses"]
        for name, value in got["probes"].items():
            assert torch.equal(value, dp["probes"][name]), name
        # The norm sums each split leaf's squared block norms over its
        # group, where one process takes the whole leaf's norm.
        np.testing.assert_allclose(got["norms"], dp["norms"], rtol=5e-5)
    else:
        np.testing.assert_allclose(got["losses"], dp["losses"], rtol=2e-3)
        np.testing.assert_allclose(got["norms"], dp["norms"], rtol=2e-3)
        _close_updates(got["probes"], dp["probes"],
                       steps[layout]["init"])


def check_held_bytes(steps, layout, named):
    """The bytes a rank holds are the plan's, and fewer than replicated
    (``named``: the full model's ``flax_named_shapes``)."""
    held = steps[layout]["port"]["held"]
    mp, pp, fsdp, zero, accum, experts, world = LAYOUTS[layout]
    rules = ((sharding.TRANSFORMER_RULES if pp == 1 else
              sharding.PIPELINE_RULES) if mp > 1 or pp > 1 else ())
    mesh = comm.mesh_shape(world, mp, 1, pp)
    plan = sharding.plan_model(named, rules, mesh, fsdp=fsdp,
                               zero_level=zero)
    want = sharding.plan_bytes(plan, mesh, moments=1, accum=accum > 1)
    assert held == want
    whole = sharding.plan_bytes(sharding.plan_model(named, (), mesh), mesh,
                                moments=1, accum=accum > 1)
    assert held["total"] < whole["total"]
