"""A checkpoint resumed under another process count, against the JAX
package's contract.

JAX draws the masked-LM mask with one key over the global batch
(``jax.random.bernoulli(rng, mask_prob, ids.shape)`` on the global array,
JAX ``models/tasks.py``), keeps that one key in the checkpoint cursor, and
restores the state with orbax onto whatever mesh the restarted job has. A
step saved by ``W`` processes therefore resumes under ``W'``: the plan the
new world size builds continues at the cursor's epoch and step, and the
masks continue the saved key's draws. The port draws from one generator,
seeded alike on every process, over the global batch, each data share
taking its rows; the cursor carries its one state, and the restore reads
each rank's blocks under the live layout whatever number of processes
wrote them. On the CPU, over gloo, BERT-small in f32 (so that the
comparisons across world sizes can be tight):

* Plans: the port's loader at the new world size serves, from the cursor,
  the rows of JAX's ``make_plan`` + ``slice_plan`` (batch sampler with and
  without shuffle, fragment sampler) and of JAX's map-style batches.
* The draw: a data share's mask is its rows of the global draw, the rows
  JAX's batch sharding gives the device of that data index.
* One process against two: the same masks bit for bit, the losses within
  ``tests/test_torch_seq_parallel.py``'s atol 1e-5.
* Resumes 2 -> 1, 1 -> 2 and 2 -> 4 under DP, fsdp -> tp (2 -> 4), zero2
  -> DP (2 -> 1) and tp -> fsdp (4 -> 2): the state restored, read back
  whole, is the saved step bit for bit; the resumed masks and batches are
  the uninterrupted saving run's next ones bit for bit, its losses within
  atol 1e-5; a sharded rank reads its held bytes, not the step.
* The earlier cursor format (every process's generator state), with one
  entry and with several; a world size that does not divide the batch,
  which raises as a fresh run does; the state-tree refusals.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from lance_distributed_training_tpu.data import samplers as jax_samplers
from lance_distributed_training_tpu.parallel.sharding import (
    batch_partition_spec,
)
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.data import (
    create_text_token_dataset,
    samplers,
)
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.tasks import (
    MASK_PROB,
    draw_mlm_mask,
)
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    CheckpointRefused,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_gloo

VOCAB, SEQ, BATCH, STEPS, SAVED = 128, 32, 4, 4, 2
LOSS_ATOL = 1e-5  # tests/test_torch_seq_parallel.py's two against one


def _docs(rows: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(6, SEQ + 1, rows)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Sixteen rows in fragments of five: four global batches of four."""
    path = str(tmp_path_factory.mktemp("elastic") / "tokens")
    create_text_token_dataset(path, _docs(16, 0), seq_len=SEQ, pack=False,
                              fragment_size=5)
    return path


def _argv(path, *extra, steps=STEPS):
    """``cli train`` for ``steps`` micro-steps of this run."""
    return ["train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", str(VOCAB),
            "--seq_len", str(SEQ), "--batch_size", str(BATCH),
            "--optimizer", "adamw", "--lr", "1e-3", "--log_every", "0",
            "--device", "cpu", "--no_autotune", "--no_eval_at_end",
            "--max_steps", str(steps), *extra]


# ------------------------------------------------------------- the plans

PLAN_ROWS, PLAN_BATCH = 40, 8
PLANS = {  # name: (loader_style, sampler_type, shuffle)
    "batch": ("iterable", "batch", False),
    "batch_shuffled": ("iterable", "batch", True),
    "fragment": ("iterable", "fragment", False),
    "map": ("map", "batch", False),
}


@pytest.fixture(scope="module")
def plan_corpus(tmp_path_factory):
    """Forty distinct rows in fragments of seven, and each row's id by its
    tokens."""
    docs = _docs(PLAN_ROWS, 1)
    path = str(tmp_path_factory.mktemp("plans") / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False,
                              fragment_size=7)
    ids = {tuple(d[:SEQ] + [0] * (SEQ - len(d))): i
           for i, d in enumerate(docs)}
    assert len(ids) == PLAN_ROWS
    return path, ids


def _jax_rows(style, sampler, shuffle, rank, world, epoch, step) -> list:
    """JAX's plan tail from the cursor, each batch as its global row
    ids."""
    per = PLAN_BATCH // world
    if style == "map":
        batches = jax_samplers.distributed_index_batches(
            PLAN_ROWS, per, rank, world, shuffle=True, seed=0, epoch=epoch)
        return [list(map(int, b)) for b in batches[step:]]
    fragment_rows = [7, 7, 7, 7, 7, 5]
    offsets = np.concatenate([[0], np.cumsum(fragment_rows)])
    plan = jax_samplers.slice_plan(jax_samplers.make_plan(
        sampler, fragment_rows, per, rank, world, shuffle=shuffle, seed=0,
        epoch=epoch), step)
    return [[int(offsets[r.fragment]) + i for r in ranges
             for i in range(r.start, r.stop)] for ranges in plan]


def _port_rows(path, ids, style, sampler, shuffle, rank, world, epoch,
               step) -> list:
    """The port's trainer loader of this rank at this world size, resumed
    at the cursor, each batch as its row ids."""
    config = trainer.TrainConfig(
        dataset_path=path, task_type="masked_lm", model_name="bert_small",
        vocab_size=VOCAB, seq_len=SEQ, batch_size=PLAN_BATCH,
        loader_style=style, sampler_type=sampler, shuffle=shuffle,
        device="cpu", autotune=False)
    loader = trainer._build_loader(
        config, trainer.Dataset(path), trainer._decoder_for(config),
        torch.device("cpu"), epoch, PLAN_BATCH // world, rank, world)
    loader.load_state_dict({"epoch": epoch, "step": step})
    return [[ids[tuple(row.tolist())] for row in batch["input_ids"]]
            for batch in loader]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("plan", list(PLANS))
def test_the_resumed_plan_at_a_new_world_size_is_jaxs(plan_corpus, plan,
                                                      world):
    """Every rank of the new world, from the cursor of epochs 0 and 1 at
    steps 0, 1 and the plan's last, serves exactly the rows of JAX's plan
    tail there; the port's sampler functions give JAX's plans."""
    path, ids = plan_corpus
    style, sampler, shuffle = PLANS[plan]
    per = PLAN_BATCH // world
    fragment_rows = [7, 7, 7, 7, 7, 5]
    for epoch in (0, 1):
        for rank in range(world):
            if style == "map":
                mine = samplers.distributed_index_batches(
                    PLAN_ROWS, per, rank, world, shuffle=True, seed=0,
                    epoch=epoch)
                theirs = jax_samplers.distributed_index_batches(
                    PLAN_ROWS, per, rank, world, shuffle=True, seed=0,
                    epoch=epoch)
                assert [b.tolist() for b in mine] == \
                    [b.tolist() for b in theirs]
            else:
                assert samplers.make_plan(
                    sampler, fragment_rows, per, rank, world,
                    shuffle=shuffle, seed=0, epoch=epoch) == \
                    [[tuple(r) for r in ranges] for ranges in
                     jax_samplers.make_plan(
                         sampler, fragment_rows, per, rank, world,
                         shuffle=shuffle, seed=0, epoch=epoch)]
            steps = len(_jax_rows(style, sampler, shuffle, rank, world,
                                  epoch, 0))
            assert steps > 1
            for step in (0, 1, steps - 1):
                assert _port_rows(path, ids, style, sampler, shuffle, rank,
                                  world, epoch, step) == _jax_rows(
                    style, sampler, shuffle, rank, world, epoch, step), (
                    epoch, rank, step)


def test_global_step_rows_do_not_depend_on_the_world_size():
    """Under the default plan (the batch sampler, no shuffle) global step
    ``s`` covers rows ``[s·B, (s+1)·B)`` whatever the world size: rank
    ``k`` of ``W`` takes plan batch ``k`` of each step, each of ``B/W``
    rows, so that a resume under another world size reads the saving run's
    next rows (JAX ``data/samplers.py``)."""
    fragment_rows = [7, 7, 7, 7, 7, 5]
    offsets = np.concatenate([[0], np.cumsum(fragment_rows)])
    for world in (1, 2, 4, 8):
        plans = [samplers.make_plan("batch", fragment_rows,
                                    PLAN_BATCH // world, k, world)
                 for k in range(world)]
        for s in range(len(plans[0])):
            rows = [int(offsets[r.fragment]) + i for k in range(world)
                    for r in plans[k][s] for i in range(r.start, r.stop)]
            assert rows == list(range(s * PLAN_BATCH, (s + 1) * PLAN_BATCH))


# -------------------------------------------------------------- the draw

@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_a_share_takes_the_rows_jax_gives_its_data_index(count):
    """JAX draws over the global array's shape and shards it over the data
    axis (``batch_partition_spec``): device ``d`` holds a block of the
    rows. The port's share ``d`` of ``count`` draws over the same global
    shape and takes the same block. (The values differ: the generators
    are another family.)"""
    rows, seq = 16, 24
    lengths = np.random.default_rng(count).integers(1, seq + 1, rows)
    valid = torch.from_numpy(
        (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int8))
    whole = {"input_ids": torch.ones((rows, seq), dtype=torch.int32),
             "attention_mask": valid}
    drawn = jax.eval_shape(
        lambda key: jax.random.bernoulli(key, MASK_PROB, (rows, seq)),
        jax.random.PRNGKey(0))
    assert drawn.shape == (rows, seq)
    mesh = Mesh(np.array(jax.devices()[:count]), ("data",))
    blocks = NamedSharding(mesh, batch_partition_spec(2)).devices_indices_map(
        (rows, seq))
    want = draw_mlm_mask(whole, torch.Generator().manual_seed(5))
    assert want.shape == (rows, seq) and want.any()
    assert not (want & (valid == 0)).any()
    for d, device in enumerate(mesh.devices.flat):
        block = blocks[device][0]
        share = {k: v[block] for k, v in whole.items()}
        got = draw_mlm_mask(share, torch.Generator().manual_seed(5),
                            (d, count))
        assert torch.equal(got, want[block])


# ---------------------------------------------------------- the gloo runs

# ``cli train`` in each rank (argv, dump prefix): bert_small in f32; each
# micro-step's share rows and mask, and the state right after a restore,
# read back whole (a collective under a sharded layout), and any warning.
_RUN = r'''
import functools
import json
import warnings
import torch
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.models import tasks, transformer

tasks.bert_small = functools.partial(transformer.bert_small,
                                     dtype=torch.float32)
argv, dump = json.loads(ARGS[0]), ARGS[1]
record = {"masks": [], "batches": [], "restored": None}
_draw = trainer.draw_mlm_mask


def draw(batch, generator, share=(0, 1)):
    mask = _draw(batch, generator, share)
    record["masks"].append(mask.clone())
    record["batches"].append(batch["input_ids"].clone())
    return mask


def copy(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [copy(v) for v in tree]
    return tree


_restore = trainer._restore_checkpoint


def restore(ckpt, model, optimizer, train_step, sharded, *args):
    out = _restore(ckpt, model, optimizer, train_step, sharded, *args)
    if sharded is not None:
        state, opt, accum = sharded.full_state(optimizer, train_step.accum)
    else:
        state, opt, accum = (model.state_dict(), optimizer.state_dict(),
                             train_step.accum)
    record["restored"] = copy({"model": state, "optimizer": opt["state"],
                               "accum": accum})
    return out


trainer.draw_mlm_mask = draw
trainer._restore_checkpoint = restore
if WORLD > 1:
    argv += ["--coordinator_address", ADDRESS, "--num_processes",
             str(WORLD), "--process_id", str(RANK)]
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    result = cli.main(argv)
record.update(
    losses=result["losses"], world=result["world_size"],
    global_step=result["global_step"], parallel=result.get("parallel"),
    restore_bytes=result.get("ckpt_restore_bytes"),
    restore_scanned=result.get("ckpt_restore_scanned_bytes"),
    warnings=[str(w.message) for w in caught])
torch.save(record, f"{dump}.{RANK}.pt")
'''


def _gloo(world: int, argv: list, dump) -> list:
    """``argv`` in ``world`` ranks: each rank's record."""
    run_gloo(_RUN, world, json.dumps(argv), str(dump), init=False)
    return [torch.load(f"{dump}.{rank}.pt") for rank in range(world)]


def _global(records: list, key: str) -> list:
    """Each micro-step's global tensor of ``key``: one rank a data share
    (its data index under a layout, else its rank), stacked in order."""
    shares = {}
    for rank, r in enumerate(records):
        index = r["parallel"]["index"]["data"] if r["parallel"] else rank
        shares.setdefault(index, r)
    return [torch.cat([shares[d][key][i] for d in sorted(shares)])
            for i in range(len(records[0][key]))]


SAVES = {  # saved under: (ranks, flags)
    "dp1": (1, []),
    "dp2": (2, []),
    "fsdp2": (2, ["--fsdp"]),
    "zero2": (2, ["--zero", "2", "--grad_accum", "2"]),
    "tp4": (4, ["--model_parallelism", "2"]),
}
RESUMES = {  # case: (saved under, ranks, flags)
    "dp2_to_dp1": ("dp2", 1, []),
    "dp1_to_dp2": ("dp1", 2, []),
    "dp2_to_dp4": ("dp2", 4, []),
    "fsdp2_to_tp4": ("fsdp2", 4, ["--model_parallelism", "2"]),
    "zero2_to_dp1": ("zero2", 1, ["--grad_accum", "2"]),
    "tp4_to_fsdp2": ("tp4", 2, ["--fsdp"]),
}


@pytest.fixture(scope="module")
def saves(corpus, tmp_path_factory):
    """Each saving layout's uninterrupted run of STEPS micro-steps,
    checkpointing every SAVED, lazily: ``{name: (records, dir)}``."""
    root = tmp_path_factory.mktemp("saves")
    done = {}

    def get(name):
        if name not in done:
            world, flags = SAVES[name]
            ck = str(root / f"ck_{name}")
            records = _gloo(world, _argv(corpus, *flags, "--checkpoint_dir",
                                         ck, "--checkpoint_every_steps",
                                         str(SAVED)), root / name)
            done[name] = (records, ck)
        return done[name]

    return get


def _step_only(ck: str, dst: str, step: int = SAVED) -> str:
    """A copy of checkpoint ``ck`` holding its step ``step`` alone."""
    shutil.copytree(ck, dst)
    mgr = CheckpointManager(dst)
    for other in mgr.all_steps():
        if other != step:
            shutil.rmtree(mgr._step_dir(other))
            os.unlink(mgr._cursor_path(other))
    assert mgr.all_steps() == [step]
    return dst


@pytest.fixture(scope="module", params=list(RESUMES))
def resumed(request, saves, corpus, tmp_path_factory):
    """The saving run's step SAVED resumed under the case's world size and
    layout for the rest of the STEPS micro-steps."""
    source, world, flags = RESUMES[request.param]
    records, ck = saves(source)
    tmp = tmp_path_factory.mktemp(request.param)
    mine = _step_only(ck, str(tmp / "ck"))
    got = _gloo(world, _argv(corpus, *flags, "--checkpoint_dir", mine,
                             steps=STEPS - SAVED), tmp / "run")
    return {"case": request.param, "saved": records, "got": got,
            "state": CheckpointManager(mine).read_state(SAVED),
            "index": CheckpointManager(mine).index(SAVED)}


def _assert_equal_trees(got, want, where):
    if torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_trees(g, w, f"{where}/{i}")
    else:
        assert got == want, where


def test_the_restored_state_read_back_whole_is_the_saved_step(resumed):
    saved = resumed["state"]
    dump = resumed["got"][0]["restored"]
    _assert_equal_trees(dump["model"], saved["model"], "model")
    _assert_equal_trees(dump["optimizer"], saved["optimizer"]["state"],
                        "optimizer")
    _assert_equal_trees(dump["accum"], saved["train_step"]["accum"], "accum")
    assert saved["train_step"]["updates"] == \
        SAVED // (2 if resumed["case"].startswith("zero2") else 1)


def test_the_resumed_masks_and_batches_are_the_saving_runs_next(resumed):
    """The new world's shares, stacked, draw the masks and read the rows
    that the saving run drew and read at the same micro-steps; the ranks
    of one share alike."""
    got, saved = resumed["got"], resumed["saved"]
    for key in ("masks", "batches"):
        mine, theirs = _global(got, key), _global(saved, key)[SAVED:]
        assert len(mine) == len(theirs) == STEPS - SAVED
        for a, b in zip(mine, theirs):
            assert torch.equal(a, b), key
    for r in got:
        index = r["parallel"]["index"]["data"] if r["parallel"] else None
        same = [o for o in got if o["parallel"]
                and o["parallel"]["index"]["data"] == index]
        for o in same:
            assert all(torch.equal(a, b)
                       for a, b in zip(o["masks"], r["masks"]))


def test_the_resumed_losses_continue_the_saving_run(resumed):
    got, saved = resumed["got"], resumed["saved"]
    for r in got:
        assert r["global_step"] == STEPS and r["world"] == len(got)
        np.testing.assert_allclose(r["losses"], saved[0]["losses"][SAVED:],
                                   rtol=0, atol=LOSS_ATOL)


def _leaf_bytes(leaf: dict) -> int:
    return int(np.prod(leaf["shape"])) * torch.empty(
        (), dtype=getattr(torch, leaf["dtype"])).element_size()


def test_a_rank_of_the_new_world_reads_what_it_holds(resumed):
    """Each rank assembles its held bytes (parameters, moments,
    accumulator) plus the whole leaves that ``held_bytes`` leaves out
    (0-d step counters, the model's buffers): under a sharded layout its
    blocks only, from fewer bytes of the shards than the step holds; under
    DP, where every rank holds the state whole, the whole step."""
    index = resumed["index"]
    params = {n for n, _ in tasks.get_task(
        "masked_lm", model_name="bert_small", seq_len=SEQ,
        vocab_size=VOCAB).model.named_parameters()}
    leaves = index["leaves"]
    whole = sum(_leaf_bytes(leaf) for leaf in leaves.values())
    extra = sum(_leaf_bytes(leaf) for name, leaf in leaves.items()
                if not leaf["shape"] or (name.startswith("model/") and
                                         name[len("model/"):] not in params))
    step = sum(f["bytes"] for f in index["files"].values())
    for r in resumed["got"]:
        if r["parallel"] is None:
            assert r["restore_bytes"] == whole
            continue
        held = r["parallel"]["held_bytes"]["total"]
        assert r["restore_bytes"] == held + extra
        assert held + extra <= r["restore_scanned"] < step


def test_one_process_and_two_draw_the_same_masks(saves):
    one, _ = saves("dp1")
    two, _ = saves("dp2")
    for key in ("masks", "batches"):
        for a, b in zip(_global(one, key), _global(two, key)):
            assert torch.equal(a, b), key
    assert not torch.equal(two[0]["masks"][0], two[1]["masks"][0])


def test_one_process_and_two_train_alike(saves):
    one, _ = saves("dp1")
    two, _ = saves("dp2")
    for r in two:
        np.testing.assert_allclose(r["losses"], one[0]["losses"], rtol=0,
                                   atol=LOSS_ATOL)


# ------------------------------------------------ the earlier cursor form

def _legacy(saves, tmp_path, rngs, shares) -> str:
    """DP2's step SAVED re-saved as step SAVED + 1 with its cursor in the
    earlier form: ``rng`` a list of states, ``rng_data_index`` their
    shares."""
    _, ck = saves("dp2")
    mine = _step_only(ck, str(tmp_path / "ck"))
    mgr = CheckpointManager(mine)
    state, cursor, step = mgr.restore_latest()
    one = cursor["rng"]
    cursor.update(rng=[one if s is None else s for s in rngs],
                  rng_data_index=shares)
    mgr.save(step + 1, state, cursor=cursor, wait=True)
    mgr.close()
    return mine


def test_an_earlier_cursor_of_one_entry_continues_bit_for_bit(
        saves, corpus, tmp_path):
    records, _ = saves("dp2")
    mine = _legacy(saves, tmp_path, [None], [0])
    got = _gloo(1, _argv(corpus, "--checkpoint_dir", mine,
                         steps=STEPS - SAVED), tmp_path / "r")
    assert not any("earlier format" in w for w in got[0]["warnings"])
    for a, b in zip(_global(got, "masks"),
                    _global(records, "masks")[SAVED:]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got[0]["losses"],
                               records[0]["losses"][SAVED:], rtol=0,
                               atol=LOSS_ATOL)


def test_an_earlier_cursor_of_several_continues_from_share_0(
        saves, corpus, tmp_path):
    """Two per-share states, share 0's listed second: share 0's becomes the
    run's one generator (so the masks here continue the saving run's), and
    a warning says that the per-share draws do not continue."""
    records, _ = saves("dp2")
    other = torch.Generator().manual_seed(99).get_state().tolist()
    mine = _legacy(saves, tmp_path, [other, None], [1, 0])
    got = _gloo(2, _argv(corpus, "--checkpoint_dir", mine,
                         steps=STEPS - SAVED), tmp_path / "r")
    assert any("earlier format" in w for w in got[0]["warnings"])
    for a, b in zip(_global(got, "masks"),
                    _global(records, "masks")[SAVED:]):
        assert torch.equal(a, b)


def test_a_world_size_that_does_not_divide_the_batch_raises_alike(
        saves, corpus):
    """Three processes on a global batch of four: a resume raises what a
    fresh run raises, before any restore."""
    _, ck = saves("dp2")
    with pytest.raises(AssertionError,
                       match="global batch 4 not divisible by 3 processes"):
        _gloo(3, _argv(corpus, "--checkpoint_dir", ck), ck + "_three")
    with pytest.raises(AssertionError,
                       match="global batch 4 not divisible by 3 processes"):
        _gloo(3, _argv(corpus), ck + "_fresh")


@pytest.mark.parametrize("change,match", [
    ({"optimizer": "sgd"}, "its optimizer is not this run's"),
    ({"num_experts": 4}, "its model is not this run's"),
], ids=["another_optimizer", "another_model"])
def test_a_step_of_another_state_tree_is_still_refused(saves, corpus,
                                                      tmp_path, change,
                                                      match):
    """The step two fsdp processes saved, resumed by one process under
    another state tree: refused, as at the same world size."""
    _, ck = saves("fsdp2")
    mine = _step_only(ck, str(tmp_path / "ck"))
    config = dict(dataset_path=corpus, task_type="masked_lm",
                  model_name="bert_small", vocab_size=VOCAB, seq_len=SEQ,
                  batch_size=BATCH, optimizer="adamw", lr=1e-3,
                  log_every=0, device="cpu", autotune=False,
                  eval_at_end=False, max_steps=STEPS - SAVED,
                  checkpoint_dir=mine)
    with pytest.raises(CheckpointRefused, match=match):
        trainer.train(trainer.TrainConfig(**dict(config, **change)))
