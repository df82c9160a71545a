"""Expert parallelism and MoE on a ring of processes, on the CPU over gloo.

Expert parallelism: two processes of a ``'model'`` group, each holding two
of an f32 MoE encoder's four experts (laid out by the plan and
``parallel/layout.shard_model_``, only the MoE rules applied, so that the
rest of the model stays whole): the logits and the gradients of every
parameter are those of the one-process module bit for bit (each token's
row is summed from one expert's output and zeros), and the logits agree
with the JAX encoder on the same weights within 1e-5.

MoE on a ring: four processes laid out as JAX's ``('data', 'seq')`` mesh,
each holding one sequence block of its data share's rows, route the JAX
way — a token's place in its expert's queue counted over the global
``[B, S]`` batch in row-major order. The outputs, the tokens past capacity
(exactly zero on both sides), the load-balance term and the gradients
agree with the JAX ``MoEMLP`` on the whole batch within 1e-5; counting the
queues per process would drop other tokens and fail. Through the
trainer, ``--num_experts`` with ``--seq_parallelism 2`` over two processes
trains, on the one-process ring's losses.

The EP layout's train step (``--num_experts 4 --model_parallelism 2``)
against JAX's same layout and the port's data-parallel run:
``tests/torch_layout_steps.py``, with the tolerances stated in
``tests/test_torch_sharding.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lance_distributed_training_tpu.models.moe import MoEMLP as JaxMoE
from lance_distributed_training_tpu.models.transformer import (
    TransformerEncoder as JaxEncoder,
)
from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import (
    TransformerEncoder,
    tasks,
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_cli, run_gloo
from torch_layout_steps import SEQ as steps_seq
from torch_layout_steps import VOCAB as steps_vocab
from torch_layout_steps import (
    check_against_dp,
    check_against_jax,
    check_held_bytes,
    layout_steps,
)

H, E, M = 16, 4, 32
VOCAB, SEQ, BATCH = 97, 16, 4
DIMS = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
            max_len=SEQ, num_experts=4, moe_every=2)
ATOL = 1e-5


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


_EP_CHILD = r'''
import numpy as np
import torch
from lance_distributed_training_tpu_torch.models import TransformerEncoder
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes)
from lance_distributed_training_tpu_torch.parallel.comm import Topology
from lance_distributed_training_tpu_torch.parallel.layout import shard_model_
from lance_distributed_training_tpu_torch.parallel.sharding import (
    TRANSFORMER_RULES, plan_model)

data = torch.load(ARGS[0])
model = TransformerEncoder(data["vocab"], dtype=torch.float32, **data["dims"])
model.load_state_dict(data["state"])
topo = Topology(RANK, WORLD, model=2)
rules = [r for r in TRANSFORMER_RULES if r[0].startswith("moe/")]
plan = plan_model(flax_named_shapes(model), rules, topo.size)
shard_model_(model, plan, topo)
model.train()
logits = model(data["ids"])
(logits * data["cot"]).sum().backward()
torch.save({"logits": logits.detach(), "start": [
    m.expert_start for m in model.modules() if hasattr(m, "expert_start")],
    "grads": {k: p.grad for k, p in model.named_parameters()}},
    ARGS[1] + f".{RANK}.pt")
'''


def test_experts_split_over_the_model_group(tmp_path):
    rng = np.random.default_rng(0)
    ids = rng.integers(2, VOCAB, (BATCH, SEQ))
    jax_model = JaxEncoder(vocab_size=VOCAB, dtype=jnp.float32, **DIMS)
    params = _tree(jax_model.init(jax.random.key(0),
                                  jnp.asarray(ids, jnp.int32))["params"])
    want = np.asarray(jax_model.apply({"params": params},
                                      jnp.asarray(ids, jnp.int32)))
    state = torch_state_dict_from_flax(params)
    whole = TransformerEncoder(VOCAB, dtype=torch.float32, **DIMS)
    whole.load_state_dict(state)
    whole.train()
    cot = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    logits = whole(torch.from_numpy(ids))
    (logits * cot).sum().backward()
    torch.save({"vocab": VOCAB, "dims": DIMS, "state": state,
                "ids": torch.from_numpy(ids), "cot": cot}, tmp_path / "in.pt")
    run_gloo(_EP_CHILD, 2, tmp_path / "in.pt", tmp_path / "out")
    ranks = [torch.load(tmp_path / f"out.{r}.pt") for r in range(2)]
    assert [r["start"] for r in ranks] == [[0], [2]]
    for r in ranks:
        assert torch.equal(r["logits"], logits.detach())
    np.testing.assert_allclose(logits.detach().numpy(), want, atol=ATOL)
    for name, p in whole.named_parameters():
        if ".moe.w_" in name or ".moe.b_" in name:
            got = torch.cat([r["grads"][name] for r in ranks])
        else:
            got = ranks[0]["grads"][name]
            assert torch.equal(ranks[1]["grads"][name], got), name
        assert torch.equal(got, p.grad), name


_RING_CHILD = r'''
import numpy as np
import torch
from lance_distributed_training_tpu_torch.models import MoEMLP
from lance_distributed_training_tpu_torch.models.moe import set_moe_group
from lance_distributed_training_tpu_torch.parallel.comm import Topology

data = np.load(ARGS[0])
topo = Topology(RANK, WORLD, seq=2)
d, s = topo.index["data"], topo.index["seq"]
b, seq = data["x"].shape[:2]
rows = slice(d * b // 2, (d + 1) * b // 2)
block = slice(s * seq // 2, (s + 1) * seq // 2)
moe = MoEMLP(data["x"].shape[-1], 4, 32, float(data["factor"]),
             dtype=torch.float32)
moe.load_state_dict({k: torch.from_numpy(data[k]) for k in (
    "router.weight", "router.bias", "w_in", "b_in", "w_out", "b_out")})
set_moe_group(moe, topo.batch_group, 2)
moe.train()
x = torch.tensor(data["x"][rows, block], requires_grad=True)
y = moe(x)
((y * torch.from_numpy(data["cot"][rows, block])).sum()
 + moe.aux * 0.5 / WORLD).backward()
np.savez(ARGS[1] + f".{RANK}.npz", d=d, s=s, y=y.detach().numpy(),
         aux=moe.aux.detach().numpy(), gx=x.grad.numpy(),
         **{"g_" + k: p.grad.numpy() for k, p in moe.named_parameters()})
'''


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_on_a_ring_routes_the_global_batch(tmp_path, factor):
    rng = np.random.default_rng(3)
    b, seq = 4, 8
    x = rng.standard_normal((b, seq, H)).astype(np.float32)
    cot = rng.standard_normal((b, seq, H)).astype(np.float32)
    jax_moe = JaxMoE(E, M, capacity_factor=factor, dtype=jnp.float32)
    params = _tree(jax_moe.init(jax.random.key(1), jnp.asarray(x))["params"])
    # A router that prefers expert 0, so that its queue overflows.
    params["router"]["bias"] = np.array([1.0, 0.0, 0.0, -0.5], np.float32)

    def loss_fn(p, x):
        y, sown = jax_moe.apply({"params": p}, x, mutable=["aux_loss"])
        aux = sown["aux_loss"]["load_balance"][0]
        return (y * cot).sum() + aux * 0.5, (y, aux)

    (_, (want, aux)), (g_params, g_x) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    want, g_x = np.asarray(want), np.asarray(g_x)
    np.savez(tmp_path / "in.npz", x=x, cot=cot, factor=factor, **{
        "router.weight": params["router"]["kernel"].T,
        "router.bias": params["router"]["bias"],
        **{k: params[k] for k in ("w_in", "b_in", "w_out", "b_out")}})
    run_gloo(_RING_CHILD, 4, tmp_path / "in.npz", tmp_path / "out")
    got = np.zeros_like(want)
    got_gx = np.zeros_like(g_x)
    grads, terms = {}, []
    for rank in range(4):
        r = np.load(tmp_path / f"out.{rank}.npz")
        d, s = int(r["d"]), int(r["s"])
        rows = slice(d * b // 2, (d + 1) * b // 2)
        block = slice(s * seq // 2, (s + 1) * seq // 2)
        got[rows, block] = r["y"]
        got_gx[rows, block] = r["gx"]
        terms.append(float(r["aux"]))
        for k in r.files:
            if k.startswith("g_"):
                grads[k] = grads.get(k, 0) + r[k]
    dropped = np.all(want == 0, axis=-1)
    assert dropped.any()  # some tokens are past capacity
    np.testing.assert_array_equal(np.all(got == 0, axis=-1), dropped)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(np.mean(terms), float(aux), atol=ATOL)
    np.testing.assert_allclose(got_gx, g_x, atol=ATOL)
    # Each rank's loss is its share of the global one (its term divided
    # by the group's size, the term being scaled by it): the parameters'
    # gradients summed over the ranks are the JAX ones.
    g = _tree(g_params)
    for k in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_allclose(grads["g_" + k], g[k], atol=ATOL)
    np.testing.assert_allclose(grads["g_router.weight"],
                               g["router"]["kernel"].T, atol=ATOL)


# ------------------------------------------------ the EP layout, one step

@pytest.fixture(scope="module")
def ep_steps(tmp_path_factory):
    """``--num_experts 4 --model_parallelism 2`` (the experts and the dense
    blocks split over the model group) over two gloo processes and in the
    JAX package (``tests/torch_layout_steps.py``)."""
    return layout_steps(["ep"], tmp_path_factory.mktemp("ep"))


def test_ep_step_matches_jax(ep_steps):
    check_against_jax(ep_steps, "ep")


def test_ep_step_matches_the_port_dp_run(ep_steps):
    check_against_dp(ep_steps, "ep")


def test_ep_holds_what_its_plan_computes(ep_steps):
    task = tasks.get_task("masked_lm", model_name="bert_small",
                          seq_len=steps_seq, vocab_size=steps_vocab,
                          num_experts=4)
    check_held_bytes(ep_steps, "ep", flax_named_shapes(task.model))


# ------------------------------------- MoE on a ring through the trainer


def test_moe_trains_on_a_ring_of_processes(tmp_path):
    """``--num_experts`` with ``--seq_parallelism 2`` over two processes
    trains (it raised before). Its first loss is the one-process ring's
    (whose MoE layers see whole sequences: the same routing) within 2e-3
    relative, and the next ones track it within 2%: the two rings' bf16
    folds part from the first update on, by as much without MoE blocks."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, 16)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    argv = ["train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", str(VOCAB),
            "--seq_len", str(SEQ), "--batch_size", "4", "--optimizer",
            "sgd", "--lr", "0.01", "--log_every", "1", "--device", "cpu",
            "--no_autotune", "--num_experts", "4", "--seq_parallelism", "2",
            "--max_steps", "3"]
    ring = run_cli(2, argv)
    alone = run_cli(1, argv)
    assert ring[0]["losses"] == ring[1]["losses"]
    np.testing.assert_allclose(ring[0]["losses"][0], alone[0]["losses"][0],
                               rtol=2e-3)
    np.testing.assert_allclose(ring[0]["losses"], alone[0]["losses"],
                               rtol=2e-2)
    assert ring[0]["eval_rows"] == 16
