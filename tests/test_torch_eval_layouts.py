"""The eval on every rank under the run's layout, against JAX's eval.

Each layout's ``train`` runs as two gloo ranks on the CPU (eight for
``tp8``, whose degree splits BERT-small's width but not its four heads:
the heads stay whole and only ``out`` is row-parallel; BERT-small,
vocabulary 16, sequence 32, global batch 4) from the JAX package's
initial weights (carried over by ``models/convert``; the trainer's
``get_task`` is wrapped to load them) with a learning rate of 0, so that
the eval at the end reads those weights. Thirteen eval rows of 22 to 32
tokens: the global eval batches are four, the last padded with three
wrap-around rows of weight 0, and every row has at least four masked
positions (every seventh column). The small vocabulary gives the initial
weights an accuracy above 0 to compare.

* Every rank evaluates: its data share reads its slice of each global
  eval batch (the plan's rows, split by the data index, not the rank: the
  ranks of a model group, a pipeline or a ring read the same rows).
* Every rank returns the same ``(accuracy, rows)``, and the rows are the
  dataset's, exactly.
* The accuracy is JAX's ``make_eval_step`` on two CPU devices over the same
  rows and weights (the dense model, the MoE model for ``ep``, the
  pipelined model for ``pp``), within ``EVAL_ABS``: the mean over rows of
  each row's share of correctly predicted masked positions. The packages'
  bf16 forward passes part by rounding (the layout tests hold their losses
  within 2e-3 relative), which can flip the argmax of a masked position
  whose two largest logits lie that close; one such flip moves the
  accuracy by at most ``1 / (4 rows)`` (a row with four masked
  positions), and the limit allows that one flip.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.data.pipeline import (
    make_eval_pipeline as jax_make_eval_pipeline,
)
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    create_text_token_dataset,
)
from lance_distributed_training_tpu_torch.data.samplers import (
    padded_eval_index_batches,
)
from lance_distributed_training_tpu_torch.models.convert import (
    pipelined_state_dict_from_flax,
    torch_state_dict_from_flax,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import free_port, start_gloo

VOCAB, SEQ, BATCH, ROWS = 16, 32, 4, 13
MIN_LEN, MIN_MASKED = 22, 4  # columns 0, 7, 14 and 21 of every row
EVAL_ABS = 1.0 / (MIN_MASKED * ROWS)

# name: (the layout's train fields, the JAX model it is held against)
LAYOUTS = {
    "dp": ({}, "dense"),
    "tp": ({"model_parallelism": 2}, "dense"),
    "fsdp": ({"fsdp": True}, "dense"),
    "zero2": ({"zero_opt": 2, "grad_accum": 2}, "dense"),
    "ep": ({"model_parallelism": 2, "num_experts": 4, "moe_every": 2},
           "moe"),
    "pp": ({"pipeline_parallelism": 2, "pp_microbatches": 2}, "pp"),
    "ring": ({"seq_parallelism": 2}, "dense"),
    "tp8": ({"model_parallelism": 8}, "dense"),
}
WORLDS = {"tp8": 8}  # the ranks of a layout (else two)

_EVAL_CHILD = r'''
import json
import torch
from lance_distributed_training_tpu_torch import trainer

path, runs, common = ARGS[0], json.loads(ARGS[1]), json.loads(ARGS[2])
get_task, build = trainer.get_task, trainer._build_eval_loader
seen = {}


def loaded(*args, **kwargs):
    task = get_task(*args, **kwargs)
    task.model.load_state_dict(torch.load(seen["weights"]))
    return task


def eval_loader(*args, data_index=0, data_world=1, **kwargs):
    seen["share"] = [data_index, data_world]
    return build(*args, data_index=data_index, data_world=data_world,
                 **kwargs)


trainer.get_task, trainer._build_eval_loader = loaded, eval_loader
for name, weights, port, fields in runs:
    seen.clear()
    seen["weights"] = weights
    result = trainer.train(trainer.TrainConfig(
        dataset_path=path, coordinator_address=f"127.0.0.1:{port}",
        num_processes=WORLD, process_id=RANK, **common, **fields))
    print("RESULT " + json.dumps({
        "layout": name, "accuracy": result["eval_accuracy"],
        "rows": result["eval_rows"], "share": seen["share"]}), flush=True)
'''
# The runs' shared fields: a learning rate of 0 and one step leave the
# weights as loaded.
COMMON = dict(task_type="masked_lm", model_name="bert_small",
              vocab_size=VOCAB, seq_len=SEQ, batch_size=BATCH,
              optimizer="sgd", lr=0.0, max_steps=1, epochs=1, log_every=0,
              eval_at_end=True, autotune=False, device="cpu")


def _docs():
    rng = np.random.default_rng(5)
    return [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(MIN_LEN, SEQ + 1, ROWS)]


def _jax_setup(model: str):
    """JAX's task and mesh of ``model`` on two CPU devices, and its initial
    weights (key 0) carried over to the port."""
    fields = {"dense": {}, "moe": {"num_experts": 4, "moe_every": 2},
              "pp": {"pipeline_parallelism": 2, "pp_microbatches": 2}}[model]
    config = jax_trainer.TrainConfig(
        dataset_path="unused", task_type="masked_lm",
        model_name="bert_small", seq_len=SEQ, vocab_size=VOCAB,
        batch_size=BATCH, **fields)
    mesh = get_mesh(jax.devices()[:2],
                    pipe_parallelism=config.pipeline_parallelism)
    task = jax_trainer._task_from_config(config, mesh)
    params = jax.jit(task.init_variables)(jax.random.key(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    convert = (pipelined_state_dict_from_flax if model == "pp"
               else torch_state_dict_from_flax)
    return config, mesh, task, params, convert(params)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """Each layout's ranks' results (one gloo job a world runs them all
    while JAX evaluates) and JAX's accuracy of each model."""
    tmp = tmp_path_factory.mktemp("eval_layouts")
    path = str(tmp / "tokens")
    create_text_token_dataset(path, _docs(), seq_len=SEQ, pack=False,
                              fragment_size=5)
    setups = {}
    for model in ("dense", "moe", "pp"):
        setups[model] = _jax_setup(model)
        torch.save(setups[model][4], tmp / f"{model}.pt")
    runs: dict = {}
    for name, (fields, model) in LAYOUTS.items():
        runs.setdefault(WORLDS.get(name, 2), []).append(
            [name, str(tmp / f"{model}.pt"), free_port(), fields])
    jobs = [start_gloo(_EVAL_CHILD, world, path, json.dumps(mine),
                       json.dumps(COMMON), init=False)
            for world, mine in runs.items()]
    dataset = Dataset(path)
    jax_acc = {}
    for model, (config, mesh, task, params, _) in setups.items():
        state = jax_trainer.TrainState.create(apply_fn=None, params=params,
                                              tx=optax.sgd(0.1))
        loader = jax_make_eval_pipeline(
            lambda idx: dataset.take(idx), ROWS, BATCH, 0, 1,
            jax_trainer._decoder_for(config, for_eval=True))
        jax_acc[model] = jax_trainer.evaluate(
            state, loader, jax_trainer.make_eval_step(task, mesh))
    results = {name: [] for name in LAYOUTS}
    for out in [out for job in jobs for out in job.wait(600)]:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                got = json.loads(line[len("RESULT "):])
                results[got["layout"]].append(got)
    return results, jax_acc


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_evaluates_every_row_once(evals, layout):
    ranks = evals[0][layout]
    assert len(ranks) == WORLDS.get(layout, 2)
    assert all(r["rows"] == ROWS for r in ranks)
    assert all(r["accuracy"] == ranks[0]["accuracy"] for r in ranks)
    # The rows split by data index: the shares' weighted rows are every
    # row once, and ranks of one share read the same rows.
    world = ranks[0]["share"][1]
    want = {"dp": 2, "fsdp": 2, "zero2": 2}.get(layout, 1)
    assert world == want
    plans = {tuple(r["share"]): padded_eval_index_batches(
        ROWS, BATCH, *r["share"]) for r in ranks}
    assert len(plans) == world
    rows = [int(i) for plan in plans.values() for idx, w in plan
            for i, weight in zip(idx, w) if weight > 0]
    assert sorted(rows) == list(range(ROWS))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_matches_jax_on_the_same_weights(evals, layout):
    results, jax_acc = evals
    want = jax_acc[LAYOUTS[layout][1]]
    got = results[layout][0]["accuracy"]
    assert 0 < want < 1
    assert abs(got - want) <= EVAL_ABS, (got, want)
