"""The port's GPipe pipeline (``parallel/pipeline_parallel.py``) against
sequential application and against the JAX package's ``pipeline_apply``,
over four gloo processes on the CPU laid out as JAX's ``(data, pipe)`` mesh
(two data groups of a two-stage pipeline, two layers a stage), as
``tests/test_pipeline_parallel.py`` holds the JAX one: the forward, the
gradients of the stacked parameters and of the input, and the
microbatching error. Then the pipelined masked-LM (``masked_lm_pp``): its
weights converted from JAX's tree, and one train step of the PP layout
against JAX's and bit for bit against the one-process pipelined model
(``tests/torch_layout_steps.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lance_distributed_training_tpu.parallel import (
    pipeline_parallel as jax_pp,
)
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes,
    pipelined_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.parallel.pipeline_parallel import (
    pipeline_apply,
    stack_stage_params,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_gloo
from torch_layout_steps import SEQ as steps_seq
from torch_layout_steps import VOCAB as steps_vocab
from torch_layout_steps import (
    check_against_dp,
    check_against_jax,
    check_held_bytes,
    layout_steps,
)

HID, LAYERS, BATCH, MICRO = 16, 4, 24, 3


def _layers(seed=0):
    gen = np.random.default_rng(seed)
    return [{"w": (gen.standard_normal((HID, HID)) * 0.3).astype(np.float32),
             "b": (gen.standard_normal(HID) * 0.1).astype(np.float32)}
            for _ in range(LAYERS)]


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, HID)).astype(np.float32)


def _jax_stage_fn(params, x):
    return jax.lax.scan(lambda h, p: (jnp.tanh(h @ p["w"] + p["b"]), None),
                        x, params)[0]


def _jax_sequential(layers, x):
    for p in layers:
        x = jnp.tanh(x @ p["w"] + p["b"])
    return x


_CHILD = r'''
import json
import numpy as np
import torch
from lance_distributed_training_tpu_torch.parallel.comm import Topology
from lance_distributed_training_tpu_torch.parallel.pipeline_parallel import (
    pipeline_apply)

data = np.load(ARGS[0])
micro = int(ARGS[1])
topo = Topology(RANK, WORLD, pipe=2)
d, p = topo.index["data"], topo.index["pipe"]
per = data["x"].shape[0] // topo.size["data"]
layers = data["w"].shape[0] // 2
x = torch.tensor(data["x"][d * per:(d + 1) * per], requires_grad=True)
params = {k: torch.tensor(data[k][p * layers:(p + 1) * layers],
                          requires_grad=True) for k in ("w", "b")}


def stage_fn(params, h):
    for i in range(params["w"].shape[0]):
        h = torch.tanh(h @ params["w"][i] + params["b"][i])
    return h


out = pipeline_apply(stage_fn, params, x, micro, pipe_group=topo.group["pipe"],
                     pipe_ranks=topo.ranks["pipe"], stage=p,
                     data=topo.size["data"])
(out ** 2).sum().backward()
np.savez(ARGS[2] + f".{RANK}.npz", d=d, p=p, out=out.detach().numpy(),
         gx=x.grad.numpy(), gw=params["w"].grad.numpy(),
         gb=params["b"].grad.numpy())
'''


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' outputs and gradients: ``{(data, pipe): arrays}``."""
    tmp = tmp_path_factory.mktemp("pp")
    layers = _layers()
    np.savez(tmp / "in.npz", x=_x(),
             w=np.stack([p["w"] for p in layers]),
             b=np.stack([p["b"] for p in layers]))
    run_gloo(_CHILD, 4, tmp / "in.npz", MICRO, tmp / "out")
    ranks = {}
    for rank in range(4):
        got = np.load(tmp / f"out.{rank}.npz")
        ranks[(int(got["d"]), int(got["p"]))] = got
    return ranks


def test_dp_x_pp_forward_matches_sequential_and_jax(four_ranks):
    layers = _layers()
    x = _x()
    want = np.asarray(_jax_sequential(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers],
        jnp.asarray(x)))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "pipe"))
    stacked = jax_pp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    jax_out = np.asarray(jax_pp.pipeline_apply(
        _jax_stage_fn, stacked, jnp.asarray(x), mesh, MICRO))
    for d in range(2):
        rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
        for p in range(2):  # the result is every stage's
            got = four_ranks[(d, p)]["out"]
            np.testing.assert_allclose(got, want[rows], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, jax_out[rows], rtol=1e-5,
                                       atol=1e-5)


def test_dp_x_pp_gradients_match_sequential(four_ranks):
    layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in _layers()]
    x = jnp.asarray(_x())
    g_layers, g_x = jax.grad(
        lambda ls, x: (_jax_sequential(ls, x) ** 2).sum(),
        argnums=(0, 1))(layers, x)
    for p in range(2):
        # Each stage's gradients of its layers, summed over the data
        # groups (the loss is the sum over the whole batch).
        gw = sum(four_ranks[(d, p)]["gw"] for d in range(2))
        gb = sum(four_ranks[(d, p)]["gb"] for d in range(2))
        for i in range(2):
            np.testing.assert_allclose(gw[i], np.asarray(
                g_layers[2 * p + i]["w"]), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(gb[i], np.asarray(
                g_layers[2 * p + i]["b"]), rtol=1e-4, atol=1e-5)
    for d in range(2):
        rows = slice(d * BATCH // 2, (d + 1) * BATCH // 2)
        for p in range(2):  # the input's gradient reaches every stage
            np.testing.assert_allclose(four_ranks[(d, p)]["gx"],
                                       np.asarray(g_x)[rows], rtol=1e-4,
                                       atol=1e-5)


def test_one_stage_is_sequential_application():
    layers = _layers(3)
    stacked = stack_stage_params(
        [{k: torch.tensor(v) for k, v in p.items()} for p in layers])
    x = torch.tensor(_x(4))

    def stage_fn(params, h):
        for i in range(params["w"].shape[0]):
            h = torch.tanh(h @ params["w"][i] + params["b"][i])
        return h

    got = pipeline_apply(stage_fn, stacked, x, 4)
    want = _jax_sequential(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers],
        jnp.asarray(_x(4)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("batch,micro,data", [(6, 4, 1), (12, 4, 2)])
def test_bad_microbatching_raises_the_jax_message(batch, micro, data):
    layers = _layers()
    stacked_j = jax_pp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in layers])
    if data > 1:
        mesh = Mesh(np.array(jax.devices()[:2 * data]).reshape(data, 2),
                    ("data", "pipe"))
    else:
        mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))
    x = np.zeros((batch, HID), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_pp.pipeline_apply(_jax_stage_fn, stacked_j, jnp.asarray(x), mesh,
                              micro)
    # The port gets this data group's share of the batch.
    local = torch.zeros(batch // data, HID)
    with pytest.raises(ValueError) as port_err:
        pipeline_apply(lambda p, h: h, {}, local, micro, data=data)
    assert str(port_err.value) == str(jax_err.value)
    assert json.dumps(str(jax_err.value)).startswith('"batch ')


# ------------------------------------------------ the PP layout, one step

@pytest.fixture(scope="module")
def pp_steps(tmp_path_factory):
    """The pipelined masked-LM (``--pipeline_parallelism 2
    --pp_microbatches 4``) over two gloo processes and in the JAX package
    (``tests/torch_layout_steps.py``): its loss and its stacked blocks and
    tied embedding after the update against JAX's, bit for bit against the
    one-process pipelined model."""
    return layout_steps(["pp"], tmp_path_factory.mktemp("pp_step"))


def test_pp_step_matches_jax(pp_steps):
    check_against_jax(pp_steps, "pp")


def test_pp_step_matches_the_one_process_model(pp_steps):
    check_against_dp(pp_steps, "pp")


def test_pp_holds_what_its_plan_computes(pp_steps):
    task = tasks.get_task("masked_lm", model_name="bert_small",
                          seq_len=steps_seq, vocab_size=steps_vocab,
                          pipeline_parallelism=2)
    check_held_bytes(pp_steps, "pp", flax_named_shapes(task.model))


def test_pipelined_weights_convert_from_jax():
    """``pipelined_state_dict_from_flax`` maps JAX's pipelined tree (the
    stacked blocks, the top-level leaves) onto the port's module, whose
    one-stage forward is the JAX task's within 1e-5 in f32 (the stage
    applies each block unmasked, as JAX's)."""
    from lance_distributed_training_tpu.models import tasks as jax_tasks
    from jax.sharding import Mesh as _Mesh

    mesh = _Mesh(np.array(jax.devices()[:1]), ("pipe",))
    jt = jax_tasks._pipelined_masked_lm_task(64, "bert_small", 16, mesh, 2,
                                             dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jt.init_variables(jax.random.key(0))["params"])
    model = tasks.PipelinedMaskedLM(64, 256, 4, 4, 1024, 16, 2,
                                    dtype=torch.float32)
    model.load_state_dict(pipelined_state_dict_from_flax(params))
    ids = np.random.default_rng(0).integers(2, 64, (4, 16))
    batch = {"input_ids": jnp.asarray(ids), "attention_mask":
             jnp.ones((4, 16), jnp.int32)}
    (logits, _, _), _ = jt.forward({"params": params}, batch, False, None)
    eval_mask = (np.arange(16) % 7 == 0)[None, :]
    corrupted = np.where(eval_mask, 1, ids)
    got = model(torch.from_numpy(corrupted))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=1e-5)
