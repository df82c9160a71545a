"""``--fsdp`` gathered unit by unit, and the sharded checkpoint gathered
leaf by leaf to rank 0.

Two gloo ranks on the CPU take two updates under ``fsdp`` (SGD with
momentum) and, from the same weights and batches, a DDP run takes the
same two: BERT-small masked-LM (vocabulary 128, sequence 32, batch 8),
the same with ``--remat`` (each encoder block's forward runs again in the
backward, so its leaves are gathered a third time), and ResNet-18 (10
classes, 32 px, batch 8, BatchNorm over the global batch). As in
``tests/torch_layout_steps.check_against_dp``, the losses and the
parameters after the updates are the DP run's bit for bit (each leaf's
two halves summed once, then halved; the gathered parameters are the
same bits), and the logged gradient norm is within 5e-5 relative (the
norm sums each split leaf's squared block norms over the group).

The gathered-parameter and whole-gradient peaks that
``ShardedState.peaks`` counts stay within the root unit plus two units
(``UNITS``: the root is every fsdp leaf outside the blocks; a unit is one
encoder block or one ResNet block), below the whole model's fsdp leaves,
which a gather of every leaf before the forward would hold at once.

A sharded save under ``fsdp``, ``--model_parallelism 2`` and ``--zero 2``
holds at most one whole leaf at a time (the largest leaf of the
parameters and the AdamW moments), on rank 0 only, and writes the whole
state in the data-parallel format.
"""

import math
import os

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_cli, start_gloo

VOCAB, SEQ, BATCH, IMAGE = 128, 32, 8, 32

# The fsdp bytes of each case's model: the root unit, the largest unit and
# the whole model's fsdp leaves (f32).
UNITS = {
    # tok_embed [128, 256]; a block's query, key, value and out [256, 256],
    # mlp_in [1024, 256] and mlp_out [256, 1024]; four blocks.
    "bert_small": {"root": 131072, "largest": 3145728, "units": 4,
                   "whole": 131072 + 4 * 3145728},
    # No leaf outside the blocks reaches 16384 elements (the stem's 9408,
    # the head's 5120); layer4.1's two [512, 512, 3, 3] convolutions are
    # the largest unit.
    "resnet18": {"root": 0, "largest": 18874368, "units": 8,
                 "whole": 44597248},
}
CASES = {"bert_small": ("bert_small", False),
         "bert_small_remat": ("bert_small", True),
         "resnet18": ("resnet18", False)}

_FSDP_CHILD = r'''
import torch
from torch.nn.parallel import DistributedDataParallel
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes)
from lance_distributed_training_tpu_torch.models.resnet import set_sync_group
from lance_distributed_training_tpu_torch.parallel import comm
from lance_distributed_training_tpu_torch.parallel.layout import (
    ShardedState, shard_model_)
from lance_distributed_training_tpu_torch.parallel.sharding import plan_model


def one(data):
    text = data["model"] == "bert_small"
    config = trainer.TrainConfig(dataset_path="unused", optimizer="sgd",
                                 lr=0.05, momentum=0.9, log_grad_norm=True)

    def build(group):
        if text:
            task = tasks.get_task(
                "masked_lm", model_name="bert_small", seq_len=data["seq"],
                vocab_size=data["vocab"], remat=data["remat"],
                loss_group=group, generator=torch.Generator().manual_seed(0))
        else:
            task = tasks.get_task(
                "classification", model_name="resnet18", num_classes=10,
                image_size=data["image"],
                generator=torch.Generator().manual_seed(0))
            set_sync_group(task.model, group)
        return task

    per = data["batch"] // WORLD
    rows = slice(RANK * per, (RANK + 1) * per)

    def run(step, full_state):
        losses, norms = [], []
        for batch, draw in zip(data["batches"], data["draws"]):
            local = {k: v[rows] for k, v in batch.items()}
            kw = {"mlm_mask" if text else "flip_mask": draw[rows]}
            loss = comm.all_reduce(step(local, **kw), None) / WORLD
            losses.append(float(loss))
            norms.append(float(step.last_grad_norm))
        return {"losses": losses, "norms": norms, "state": full_state()}

    topo = comm.Topology(RANK, WORLD)
    task = build(topo.batch_group)
    plan = plan_model(flax_named_shapes(task.model), (), topo.size,
                      fsdp=True)
    shard_model_(task.model, plan, topo)
    sharded = ShardedState(task.model, plan, topo)
    opt, lr = trainer.make_optimizer(config, sharded.masters)
    step = trainer.make_train_step(task, opt, lr, grad_norm=True,
                                   sharded=sharded)
    out = {"fsdp": run(step, lambda: sharded.full_state(opt, None)[0]),
           "peaks": dict(sharded.peaks), "units": sharded.unit_bytes()}
    task = build(torch.distributed.group.WORLD)
    ddp = DistributedDataParallel(task.model, broadcast_buffers=False)
    opt, lr = trainer.make_optimizer(config, task.model.parameters())
    step = trainer.make_train_step(task.with_model(ddp), opt, lr,
                                   grad_norm=True)
    out["dp"] = run(step, task.model.state_dict)
    return out


for source, target in zip(ARGS[::2], ARGS[1::2]):
    result = one(torch.load(source))
    if RANK == 0:
        torch.save(result, target)
'''


def _case_data(model: str, remat: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batches, draws = [], []
    for _ in range(2):
        if model == "bert_small":
            ids = rng.integers(2, VOCAB, (BATCH, SEQ)).astype(np.int32)
            mask = np.ones((BATCH, SEQ), np.int32)
            lengths = rng.integers(SEQ // 2, SEQ + 1, BATCH)
            mask[np.arange(SEQ)[None, :] >= lengths[:, None]] = 0
            ids[mask == 0] = 0
            batches.append({"input_ids": torch.from_numpy(ids),
                            "attention_mask": torch.from_numpy(mask)})
            draws.append(torch.from_numpy(
                (rng.random((BATCH, SEQ)) < 0.15) & (mask > 0)))
        else:
            images = rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3),
                                  dtype=np.uint8)
            labels = rng.integers(0, 10, BATCH).astype(np.int32)
            batches.append({"image": torch.from_numpy(images),
                            "label": torch.from_numpy(labels)})
            draws.append(torch.from_numpy(rng.random(BATCH) < 0.5))
    return {"model": model, "remat": remat, "seq": SEQ, "vocab": VOCAB,
            "image": IMAGE, "batch": BATCH, "batches": batches,
            "draws": draws}


@pytest.fixture(scope="module")
def fsdp_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_units")
    files = []
    for name, (model, remat) in CASES.items():
        torch.save(_case_data(model, remat), tmp / f"{name}.pt")
        files += [tmp / f"{name}.pt", tmp / f"{name}.out"]
    start_gloo(_FSDP_CHILD, 2, *files).wait(600)
    return {name: torch.load(tmp / f"{name}.out") for name in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_by_units_matches_the_dp_run(fsdp_steps, case):
    got = fsdp_steps[case]
    fsdp, dp = got["fsdp"], got["dp"]
    assert fsdp["losses"] == dp["losses"]
    assert fsdp["losses"][0] != fsdp["losses"][1]
    np.testing.assert_allclose(fsdp["norms"], dp["norms"], rtol=5e-5)
    for name, value in dp["state"].items():
        assert torch.equal(fsdp["state"][name], value), name


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_peaks_hold_the_root_and_two_units(fsdp_steps, case):
    got = fsdp_steps[case]
    want = UNITS[CASES[case][0]]
    units = got["units"]
    assert {k: units[k] for k in ("root", "largest", "units")} == {
        k: want[k] for k in ("root", "largest", "units")}
    bound = want["root"] + 2 * want["largest"]
    peaks = got["peaks"]
    for key in ("gathered_params", "whole_grads"):
        assert want["largest"] <= peaks[key] <= bound, (key, peaks[key])
        assert peaks[key] < want["whole"]


def _dataset(tmp_path, rows=16):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, rows)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    return path


@pytest.mark.parametrize("flags", [["--fsdp"], ["--model_parallelism", "2"],
                                   ["--zero", "2", "--grad_accum", "2"]],
                         ids=["fsdp", "tp", "zero2"])
def test_sharded_save_holds_one_whole_leaf_at_a_time(tmp_path, flags):
    ckpt = str(tmp_path / "ckpt")
    results = run_cli(2, [
        "train", "--dataset_path", _dataset(tmp_path), "--task_type",
        "masked_lm", "--model_name", "bert_small", "--vocab_size",
        str(VOCAB), "--seq_len", str(SEQ), "--batch_size", "4",
        "--optimizer", "adamw", "--lr", "1e-3", "--log_every", "0",
        "--device", "cpu", "--no_autotune", "--no_eval_at_end",
        "--max_steps", "2", "--checkpoint_dir", ckpt,
        "--checkpoint_every_steps", "2", *flags])
    model = tasks.get_task("masked_lm", model_name="bert_small",
                           seq_len=SEQ, vocab_size=VOCAB).model
    whole = model.state_dict()
    largest = max(math.prod(v.shape) * 4 for v in whole.values())
    peaks = [r["parallel"]["peak_bytes"]["checkpoint_leaf"] for r in results]
    # Rank 0 gathered each split leaf whole, one at a time; rank 1 gathers
    # nothing.
    assert 0 < peaks[0] <= largest and peaks[1] == 0
    state = torch.load(CheckpointManager(ckpt).state_path(2),
                       map_location="cpu", weights_only=True)
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    moments = [s["exp_avg"] for s in state["optimizer"]["state"].values()]
    params = list(model.parameters())
    assert [tuple(m.shape) for m in moments] == [tuple(p.shape)
                                                 for p in params]
    assert os.path.getsize(CheckpointManager(ckpt).state_path(2)) > 0


def test_the_sharded_state_frees_the_model_with_it():
    """The units' hooks hold the state weakly: a parameter's hook lives in
    the tensor's C++ autograd metadata, and a strong reference from it back
    to the model would keep every run's model alive (a process that trains
    twice would hold the first run's whole parameters)."""
    import gc
    import weakref

    from lance_distributed_training_tpu_torch.models.convert import (
        flax_named_shapes,
    )
    from lance_distributed_training_tpu_torch.parallel import comm
    from lance_distributed_training_tpu_torch.parallel.layout import (
        ShardedState,
    )
    from lance_distributed_training_tpu_torch.parallel.sharding import (
        plan_model,
    )

    def build():
        model = tasks.get_task("masked_lm", model_name="bert_small",
                               seq_len=SEQ, vocab_size=VOCAB).model
        # Rank 0's place on a data axis of two, without a process group:
        # building the state cuts blocks and registers hooks, no
        # collective.
        topo = comm.Topology(0, 2, create_groups=False)
        plan = plan_model(flax_named_shapes(model), (), topo.size,
                          fsdp=True)
        state = ShardedState(model, plan, topo)
        assert state.unit_bytes()["units"] == UNITS["bert_small"]["units"]
        return weakref.ref(model), weakref.ref(state)

    model, state = build()
    gc.collect()
    assert model() is None and state() is None
