"""The port's sharded checkpoint against the JAX package's orbax contract.

JAX ``utils/checkpoint.py`` saves model and optimizer state with orbax:
sharded writes from every process, restored onto the live mesh's
shardings. The port's step (``utils/checkpoint.py``) is a shard file a
writing rank and an index that rank 0 commits once every shard is in
place; ``ShardedState.local_state`` and ``read_sharded_state``
(``parallel/layout.py``) write and read a rank's blocks. On the CPU,
over gloo where there are ranks, BERT-small:

* The reader: a block of a leaf is cut from the pieces that overlap it,
  whatever dimension split them, reading only the block's bytes; the
  tree's plain values keep their types; a torn piece raises; a step of
  the earlier one-file format restores.
* JAX's ``CheckpointManager`` cases (``tests/test_checkpoint.py``) on the
  sharded format over two processes: each rank writes only its pieces; a
  shard torn for one rank, or missing, makes both fall back to the same
  step; a stale step is overwritten; a duplicate returns False on both;
  orphan sidecars are collected; a failed write on one rank raises on
  both; a rank SIGKILLed mid-write leaves the step not intact.
* Bytes: under fsdp, zero2, tp at 2, the partial plan at 8 and ep, each
  rank's shard holds exactly its blocks (rank 0 also the whole leaves),
  every leaf once, and no rank copies a whole split leaf to its host.
* Another layout at the same world size: the restored whole state equals
  the saved one bit for bit, each rank reading only what it holds, and
  the continuation equals, bit for bit, the same layout's restored
  through the parent's whole-state path (the whole state on every host,
  each rank's blocks cut from it there).
* Against JAX: an fsdp run preempted after two steps and resumed under
  tp tracks JAX's fsdp run on its 8 CPU devices restored by orbax onto
  the tp mesh, within ``tests/test_torch_sharding.py``'s tolerances.
* Emergency saves: an exception on every rank saves each rank's share
  of the last completed step, awaited, equal to a SIGTERM drain's; an
  exception on one rank, whose peer waits in a training collective,
  commits nothing and ends both.
* Refusals. JAX's orbax restore takes a change of layout (fsdp to tp or
  to DP) and no change of the state tree: for another optimizer, another
  accumulation, the pipeline's stacked blocks or MoE layers JAX's
  ``restore_latest`` finds every step unrestorable and returns None (a
  fresh start). The port refuses such a step with
  ``CheckpointRefused``, naming what differs.
"""

import json
import math
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lance_distributed_training_tpu import trainer as jax_trainer
from lance_distributed_training_tpu.parallel.mesh import get_mesh
from lance_distributed_training_tpu.utils.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.data import create_text_token_dataset
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    torch_state_dict_from_flax,
)
from lance_distributed_training_tpu_torch.utils import checkpoint
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    CheckpointRefused,
    LeafRef,
    StepReader,
    atomic_write_json,
)
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_gloo_jobs import run_cli, run_gloo, start_gloo
from torch_layout_steps import LR, PROBES, _batch, _close_updates

VOCAB, SEQ = 128, 32


# ------------------------------------------------------------ the reader

def _pieces(directory, whole, dim, parts) -> dict:
    """``whole`` saved as ``parts`` blocks along ``dim`` (or whole), one
    shard file a block behind 8 bytes of another leaf, and the index
    document that names them."""
    pieces = []
    blocks = [whole] if dim is None else list(whole.chunk(parts, dim))
    for r, block in enumerate(blocks):
        file = f"shard-{r:05d}.bin"
        with open(os.path.join(directory, file), "wb") as f:
            f.write(b"8 bytes.")
            f.write(block.contiguous().numpy().tobytes())
        pieces.append({
            "file": file, "rank": r, "dim": dim, "at": 8,
            "offset": 0 if dim is None else r * block.shape[dim],
            "length": None if dim is None else block.shape[dim],
            "axis": None if dim is None else "data"})
    return {"format": 1, "tree": {"leaf": "w"}, "files": {}, "leaves": {
        "w": {"shape": list(whole.shape), "dtype": "float32",
              "pieces": pieces}}}


SPLITS = {"whole": (None, 1), "dim0_of_2": (0, 2), "dim1_of_3": (1, 3),
          "dim0_of_4": (0, 4)}
READS = [(None, 0, 1), (0, 1, 2), (1, 0, 2), (1, 2, 3), (0, 3, 4)]


@pytest.mark.parametrize("saved", list(SPLITS))
def test_a_block_is_cut_from_the_pieces_that_overlap_it(tmp_path, saved,
                                                        monkeypatch):
    """Each piece's bytes from the overlap's first element to its last, in
    reads of at most ``_SPAN_BYTES`` or one row: exactly the block's where
    the block is whole rows, the rows it crosses where it is not."""
    monkeypatch.setattr(checkpoint, "_SPAN_BYTES", 2 * 6 * 4)
    whole = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    index = _pieces(str(tmp_path), whole, *SPLITS[saved])
    for dim, i, parts in READS:
        want = whole if dim is None else whole.chunk(parts, dim)[i]
        with StepReader(str(tmp_path), index) as reader:
            got = reader.read("w", dim, i, parts)
            assert torch.equal(got, want), (dim, i, parts)
            assert reader.bytes_read == reader.largest_read == \
                want.numel() * 4
            if dim in (None, 0):  # whole rows of every piece it overlaps
                assert reader.bytes_scanned == want.numel() * 4
            else:
                assert want.numel() * 4 <= reader.bytes_scanned \
                    <= whole.numel() * 4


def test_a_short_or_missing_piece_raises(tmp_path):
    whole = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    index = _pieces(str(tmp_path), whole, 0, 2)
    with open(tmp_path / "shard-00001.bin", "r+b") as f:
        f.truncate(8 + 12)  # half of its block
    with StepReader(str(tmp_path), index) as reader:
        assert torch.equal(reader.read("w", 0, 0, 2), whole[:2])
        with pytest.raises(RuntimeError, match="ends before"):
            reader.read("w")
    index["leaves"]["w"]["pieces"].pop()
    with StepReader(str(tmp_path), index) as reader:
        with pytest.raises(RuntimeError, match="cover 6 of 12"):
            reader.read("w")


def test_the_tree_keeps_its_plain_values_and_their_types(tmp_path):
    state = {"t": torch.arange(3), 7: {"tuple": (1, 2.5, None),
                                       "list": [True, "x", float("inf")]},
             "empty": {}, "half": torch.ones(2, dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(1, state, cursor={"epoch": 0, "step": 1}, wait=True)
    tree = mgr.reader(1).tree()  # no tensor is read
    assert tree["t"] == LeafRef("t") and tree["half"] == LeafRef("half")
    got, _, _ = mgr.restore_latest()
    assert got[7] == {"tuple": (1, 2.5, None),
                      "list": [True, "x", float("inf")]}
    assert isinstance(got[7]["tuple"], tuple) and got["empty"] == {}
    assert torch.equal(got["t"], state["t"])
    assert got["half"].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="cannot checkpoint a object"):
        mgr.save(2, {"x": object()}, cursor={"epoch": 0, "step": 2})
    mgr.close()


def test_a_parent_format_step_restores_beside_new_ones(tmp_path):
    """A step directory holding the earlier format's one ``state.pt``
    restores, as JAX's trainer keeps restoring its legacy steps."""
    directory = tmp_path / "ck"
    (directory / "5").mkdir(parents=True)
    state = {"model": {"w": torch.rand(4, 3)}, "train_step": {"updates": 3}}
    torch.save(state, directory / "5" / "state.pt")
    atomic_write_json(str(directory / "cursors" / "5.json"),
                      {"epoch": 0, "step": 5})
    mgr = CheckpointManager(str(directory), max_to_keep=2)
    assert mgr.all_steps() == [5] and mgr.step_intact(5)
    assert mgr.shard_paths(5) == [str(directory / "5" / "state.pt")]
    got, cursor, step = mgr.restore_latest()
    assert step == 5 and cursor["step"] == 5
    assert torch.equal(got["model"]["w"], state["model"]["w"])
    assert got["train_step"] == {"updates": 3}
    for new in (6, 7):
        mgr.save(new, state, cursor={"epoch": 0, "step": new}, wait=True)
    assert mgr.all_steps() == [6, 7]  # the old step collected like any
    mgr.close()


# ------------------------------------- JAX's cases over two processes

_CASES = r'''
import json
import os
import torch
import torch.distributed as dist
from lance_distributed_training_tpu_torch.utils import checkpoint as C
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager, Piece, atomic_write_json)

BASE = ARGS[0]
out = {}


def whole(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((4, 6), generator=g), torch.rand(3, generator=g)


def tree(seed):
    """This rank's share: its two rows of w (a piece), b whole."""
    w, b = whole(seed)
    return {"w": Piece(w[2 * RANK:2 * RANK + 2].clone(), (4, 6), 0,
                       2 * RANK, "data", True), "b": b, "seed": seed}


def expect(seed):
    w, b = whole(seed)
    return {"w": w[2 * RANK:2 * RANK + 2].tolist(), "b": b.tolist()}


def read(reader):
    return reader.read("w", 0, RANK, 2), reader.read("b")


def manager(name, keep=5):
    return CheckpointManager(os.path.join(BASE, name), max_to_keep=keep)


def save(mgr, step, seed, wait=True, share=None):
    return mgr.save(step, share or tree(seed),
                    cursor={"epoch": 0, "step": step}, wait=wait)


def restored(mgr):
    got = mgr.restore_latest(read)
    if got is None:
        return None
    (w, b), cursor, step = got
    return {"step": step, "cursor_step": cursor["step"], "w": w.tolist(),
            "b": b.tolist()}


def on_rank0(fn):
    dist.barrier()
    if RANK == 0:
        fn()
    dist.barrier()


mgr = manager("pieces")
save(mgr, 1, 1)
index = mgr.index(1)
out["pieces"] = {
    "files": index["files"], "bytes_written": mgr.bytes_written,
    "pieces": {k: v["pieces"] for k, v in index["leaves"].items()},
    "tree": index["tree"], "restored": restored(mgr), "expect": expect(1)}

mgr = manager("replicated")
w, b = whole(2)
save(mgr, 1, 2, share={"w": w, "b": b})
out["replicated"] = {"files": mgr.index(1)["files"],
                     "bytes_written": mgr.bytes_written,
                     "whole": mgr.read_state(1)["w"].tolist(),
                     "expect": w.tolist()}

mgr = manager("torn")
save(mgr, 3, 3)
save(mgr, 6, 6)
intact_before = mgr.step_intact(6)
real_read = C.StepReader.read


def failing(self, *args, **kwargs):
    # Step 6's shard reads fail on rank 1 alone (an I/O error its host
    # sees): every file is in place, so both ranks find the step intact.
    if RANK == 1 and self.directory.endswith(os.sep + "6"):
        raise OSError("read error")
    return real_read(self, *args, **kwargs)


C.StepReader.read = failing
out["torn"] = {"intact_before": intact_before, "restored": restored(mgr),
               "intact_after": mgr.step_intact(6), "expect": expect(3)}
C.StepReader.read = real_read
# The fallback poisoned step 6 on both ranks: a save there overwrites it.
out["stale"] = {"saved": save(mgr, 6, 9), "restored": restored(mgr),
                "expect": expect(9)}

mgr = manager("missing")
save(mgr, 3, 3)
save(mgr, 6, 6)
on_rank0(lambda: os.unlink(os.path.join(mgr.directory, "6",
                                        "shard-00001.bin")))
out["missing"] = {"intact": mgr.step_intact(6),
                  "latest_intact": mgr.latest_intact_step(),
                  "restored": restored(mgr), "expect": expect(3)}

mgr = manager("duplicate")
first = save(mgr, 5, 5)
out["duplicate"] = {"first": first, "again": save(mgr, 5, 1),
                    "restored": restored(mgr), "expect": expect(5)}

mgr = manager("orphans", keep=2)
on_rank0(lambda: atomic_write_json(
    os.path.join(mgr.directory, "cursors", "0.json"), {"epoch": 0, "step": 0}))
for step in (1, 2, 3):
    save(mgr, step, step)
out["orphans"] = {
    "steps": mgr.all_steps(), "last": mgr.last_success_step,
    "saves": len(mgr.save_ms),
    "cursors": sorted(os.listdir(os.path.join(mgr.directory, "cursors")))}

mgr = manager("failed")
real = C._write_tensors


def broken(f, tensors):
    raise OSError("disk full")


if RANK == 1:
    C._write_tensors = broken
save(mgr, 1, 1, wait=False)
try:
    mgr.close()
    error = None
except RuntimeError as exc:
    error = str(exc)
C._write_tensors = real
out["failed"] = {"error": error, "steps": mgr.all_steps(),
                 "index": os.path.exists(mgr.index_path(1))}

mgr = manager("legacy")


def legacy():
    w, b = whole(4)
    os.makedirs(os.path.join(mgr.directory, "4"))
    torch.save({"w": w, "b": b, "seed": 4},
               os.path.join(mgr.directory, "4", "state.pt"))
    atomic_write_json(os.path.join(mgr.directory, "cursors", "4.json"),
                      {"epoch": 0, "step": 4})


on_rank0(legacy)
out["legacy"] = {"restored": restored(mgr), "expect": expect(4)}
print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    base = tmp_path_factory.mktemp("cases")
    outs = run_gloo(_CASES, 2, str(base), timeout=300)
    return [json.loads([line for line in out.splitlines()
                        if line.startswith("RESULT ")][-1][len("RESULT "):])
            for out in outs]


def _restored_is(got, step, expect):
    assert got["step"] == got["cursor_step"] == step
    assert got["w"] == expect["w"] and got["b"] == expect["b"]


def _case_pieces(ranks):
    for rank, got in enumerate(ranks):
        files = got["pieces"]["files"]
        assert sorted(files) == ["shard-00000.bin", "shard-00001.bin"]
        # A shard is its tensors' bytes: rank 0 w's rows and b, rank 1 w's.
        assert [files[f"shard-0000{r}.bin"]["bytes"] for r in (0, 1)] == [
            (12 + 3) * 4, 12 * 4]
        assert got["pieces"]["bytes_written"] == [
            files[f"shard-{rank:05d}.bin"]["bytes"]]
        w, b = got["pieces"]["pieces"]["w"], got["pieces"]["pieces"]["b"]
        # w: one block a rank, each written by its holder; b: whole, once.
        assert [(p["rank"], p["dim"], p["offset"], p["length"])
                for p in w] == [(0, 0, 0, 2), (1, 0, 2, 2)]
        assert [(p["rank"], p["dim"]) for p in b] == [(0, None)]
        assert {"value": 1} in [v for _, v in got["pieces"]["tree"]["dict"]]
        _restored_is(got["pieces"]["restored"], 1, got["pieces"]["expect"])


def _case_replicated(ranks):
    """A replicated state (DP, a lone process): rank 0 writes it all."""
    for rank, got in enumerate(ranks):
        got = got["replicated"]
        assert list(got["files"]) == ["shard-00000.bin"]
        assert got["bytes_written"] == [got["files"]["shard-00000.bin"][
            "bytes"] if rank == 0 else 0]
        assert got["whole"] == got["expect"]


def _case_torn_shard_on_one_rank(ranks):
    for got in ranks:
        got = got["torn"]
        assert got["intact_before"] and not got["intact_after"]
        _restored_is(got["restored"], 3, got["expect"])


def _case_stale_step_overwritten(ranks):
    for got in ranks:
        got = got["stale"]
        assert got["saved"] is True
        _restored_is(got["restored"], 6, got["expect"])


def _case_missing_shard(ranks):
    for got in ranks:
        got = got["missing"]
        assert got["intact"] is False and got["latest_intact"] == 3
        _restored_is(got["restored"], 3, got["expect"])


def _case_duplicate_returns_false(ranks):
    for got in ranks:
        got = got["duplicate"]
        assert got["first"] is True and got["again"] is False
        _restored_is(got["restored"], 5, got["expect"])


def _case_orphans_collected(ranks):
    for got in ranks:
        got = got["orphans"]
        assert got["steps"] == [2, 3] and got["last"] == 3
        assert got["saves"] == 3
        assert got["cursors"] == ["2.json", "3.json"]


def _case_failed_write_raises_on_every_rank(ranks):
    for got in ranks:
        got = got["failed"]
        assert got["error"] == "checkpoint write failed: rank 1: disk full"
        assert got["steps"] == [] and got["index"] is False


def _case_parent_format_restores_blocks(ranks):
    for got in ranks:
        _restored_is(got["legacy"]["restored"], 4, got["legacy"]["expect"])


CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_pieces, _case_replicated, _case_torn_shard_on_one_rank,
    _case_stale_step_overwritten, _case_missing_shard,
    _case_duplicate_returns_false, _case_orphans_collected,
    _case_failed_write_raises_on_every_rank,
    _case_parent_format_restores_blocks)}


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_keep_jax_checkpoint_semantics(cases, case):
    CASES[case](cases)


def test_a_gloo_job_whose_port_was_taken_runs_again(monkeypatch):
    """The jobs of these tests rendezvous on a port that ``free_port``
    found free; another process may take it before rank 0 binds it. Such
    a job runs again on another port."""
    import socket

    import torch_gloo_jobs

    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    ports = [taken.getsockname()[1]]
    real = torch_gloo_jobs.free_port
    monkeypatch.setattr(torch_gloo_jobs, "free_port",
                        lambda: ports.pop() if ports else real())
    try:
        outs = run_gloo('print("RESULT", RANK, WORLD)', 2)
    finally:
        taken.close()
    assert not ports
    assert [out.split("RESULT ")[1].split() for out in outs] == [
        ["0", "2"], ["1", "2"]]


_KILLED = r'''
import os
import signal
import torch
from lance_distributed_training_tpu_torch.utils import checkpoint as C
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager, Piece)

mgr = CheckpointManager(ARGS[0])


def tree(seed):
    w = torch.full((4, 6), float(seed))
    return {"w": Piece(w[2 * RANK:2 * RANK + 2].clone(), (4, 6), 0,
                       2 * RANK, "data", True)}


mgr.save(3, tree(3), cursor={"epoch": 0, "step": 3}, wait=True)
if RANK == 1:
    def dying(f, tensors):
        f.write(b"half a shard")
        f.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    C._write_tensors = dying
mgr.save(6, tree(6), cursor={"epoch": 0, "step": 6})
try:
    mgr.close()
    print("RESULT committed", flush=True)
except Exception as exc:
    print(f"RESULT commit failed: {type(exc).__name__}", flush=True)
    os._exit(0)  # the group lost a member: nothing to shut down
'''


def test_a_rank_killed_mid_write_leaves_the_step_not_intact(tmp_path):
    ck = str(tmp_path / "ck")
    job = start_gloo(_KILLED, 2, ck)
    outs = []
    try:
        for proc in job.procs:
            outs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in job.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert job.procs[1].returncode == -signal.SIGKILL, outs[1][-3000:]
    assert "RESULT commit failed" in outs[0], outs[0][-3000:]
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3] and not mgr.step_intact(6)
    assert mgr.latest_intact_step() == 3
    state, cursor, step = mgr.restore_latest()
    assert step == 3 and torch.equal(state["w"], torch.full((4, 6), 3.0))


# ---------------------------------------- the layouts, through cli train

LAYOUTS = {
    "fsdp": (2, ["--fsdp"]),
    "zero2": (2, ["--zero", "2", "--grad_accum", "2"]),
    "tp": (2, ["--model_parallelism", "2"]),
    # BERT-small's four heads at degree 8: query/key/value whole, out split.
    "tp8": (8, ["--model_parallelism", "8"]),
    "ep": (2, ["--num_experts", "4", "--model_parallelism", "2"]),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, VOCAB, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, 16)]
    path = str(tmp_path_factory.mktemp("corpus") / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False)
    return path


def _argv(path, *extra):
    return ["train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_small", "--vocab_size", str(VOCAB),
            "--seq_len", str(SEQ), "--batch_size", "4", "--optimizer",
            "adamw", "--lr", "1e-3", "--log_every", "1", "--device", "cpu",
            "--no_autotune", "--no_eval_at_end", *extra]


def _save_argv(path, ck, flags):
    return _argv(path, *flags, "--max_steps", "2", "--checkpoint_dir", ck,
                 "--checkpoint_every_steps", "2")


def _leaf_bytes(leaf: dict, piece: dict) -> int:
    numel = math.prod(leaf["shape"])
    if piece["dim"] is not None:
        numel = numel // leaf["shape"][piece["dim"]] * piece["length"]
    return numel * torch.empty((), dtype=getattr(
        torch, leaf["dtype"])).element_size()


def _whole_kinds(index: dict, params: set) -> tuple:
    """``(whole leaves a rank holds, whole leaves outside held_bytes)``:
    the bytes of the index's whole leaves that ``ShardedState.held_bytes``
    counts (parameters, moments, accumulators) and of those it does not
    (0-d step counters, the model's buffers)."""
    held = extra = 0
    for name, leaf in index["leaves"].items():
        for p in leaf["pieces"]:
            if p["dim"] is not None:
                continue
            buffer = (name.startswith("model/")
                      and name[len("model/"):] not in params)
            if not leaf["shape"] or buffer:
                extra += _leaf_bytes(leaf, p)
            else:
                held += _leaf_bytes(leaf, p)
    return held, extra


def _params(flags) -> set:
    experts = int(flags[flags.index("--num_experts") + 1]) \
        if "--num_experts" in flags else 0
    model = tasks.get_task("masked_lm", model_name="bert_small",
                           seq_len=SEQ, vocab_size=VOCAB,
                           num_experts=experts).model
    return {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_rank_writes_exactly_its_blocks(tmp_path, corpus, layout):
    """Every leaf once: a split leaf's blocks each by the rank that holds
    it (the lowest of its holders; here every rank is), a whole leaf by
    rank 0. A rank's bytes are thus its held bytes, less the whole leaves
    it holds unless it is rank 0, plus on rank 0 the step counters; the
    largest tensor a rank copies to its host is the largest it writes,
    never a whole split leaf."""
    world, flags = LAYOUTS[layout]
    ck = str(tmp_path / "ck")
    results = run_cli(world, _save_argv(corpus, ck, flags))
    index = CheckpointManager(ck).index(2)
    written, largest = [0] * world, [0] * world
    for leaf in index["leaves"].values():
        ranks = sorted(p["rank"] for p in leaf["pieces"])
        assert ranks == sorted(set(ranks))  # no block written twice
        for p in leaf["pieces"]:
            n = _leaf_bytes(leaf, p)
            written[p["rank"]] += n
            largest[p["rank"]] = max(largest[p["rank"]], n)
            if p["dim"] is None:
                assert p["rank"] == 0
            else:
                assert p["length"] < leaf["shape"][p["dim"]]
    whole_held, extra = _whole_kinds(index, _params(flags))
    total = sum(_leaf_bytes(leaf, {"dim": None})
                for leaf in index["leaves"].values())
    assert sum(written) == total
    for rank, result in enumerate(results):
        held = result["parallel"]["held_bytes"]["total"]
        want = held + extra if rank == 0 else held - whole_held
        assert written[rank] == want, (rank, written[rank], held)
        shard = index["files"][f"shard-{rank:05d}.bin"]
        assert result["ckpt_bytes"] == shard["bytes"] == written[rank]
        assert shard["rank"] == rank
        assert result["ckpt_step_bytes"] == sum(
            f["bytes"] for f in index["files"].values())
        assert result["parallel"]["peak_bytes"]["checkpoint_leaf"] == \
            largest[rank]


PAIRS = {  # saved under, restored under (the state tree the same)
    "fsdp-tp": (["--fsdp"], ["--model_parallelism", "2"]),
    "tp-fsdp": (["--model_parallelism", "2"], ["--fsdp"]),
    "zero2-tp": (["--zero", "2", "--grad_accum", "2"],
                 ["--model_parallelism", "2", "--grad_accum", "2"]),
    "ep-zero1": (["--num_experts", "4", "--model_parallelism", "2"],
                 ["--num_experts", "4", "--zero", "1"]),
}

# A run resumed under the layout of argv through ``mode``'s restore, its
# whole state right after the restore on rank 0's host in ``dump``:
# "sharded" is the trainer's, "parent" the parent's path (every host reads
# the whole state, each rank's blocks cut from it there, the parent's
# ``ShardedState.load_full_state`` copied as it was).
_RESUME = r'''
import json
import torch
from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    unpack_rng_key)

mode, dump, argv = ARGS[0], ARGS[1], json.loads(ARGS[2])
masks = []
_draw = tasks.draw_mlm_mask


def draw(batch, generator, share=(0, 1)):
    mask = _draw(batch, generator, share)
    masks.append(mask.int().tolist())
    return mask


trainer.draw_mlm_mask = draw


def load_full_state(sharded, model_state, optimizer, opt_state, accum,
                    saved_accum):
    with torch.no_grad():
        for e in sharded.entries:
            full = model_state[e.name]
            leaf = sharded.plan[e.name].param
            if e.shard:
                e.master.data.copy_(sharded._block(full, e.master_layout))
            elif leaf is not None and leaf[0] in ("model", "pipe"):
                e.param.data.copy_(sharded._block(full, leaf))
            else:
                e.param.data.copy_(full)
        params = {e.name for e in sharded.entries}
        rest = {k: v for k, v in model_state.items() if k not in params}
        if rest:
            sharded.model.load_state_dict(rest, strict=False)
    local = {"param_groups": opt_state["param_groups"], "state": {}}
    for i, saved in opt_state["state"].items():
        e = sharded.entries[int(i)]
        local["state"][int(i)] = {
            k: (sharded._block(v, e.master_layout).clone()
                if torch.is_tensor(v) and v.dim() > 0
                and e.master_layout is not None else v)
            for k, v in saved.items()}
    optimizer.load_state_dict(local)
    if accum is not None and saved_accum is not None:
        with torch.no_grad():
            for e, acc, full in zip(sharded.entries, accum, saved_accum):
                layout = sharded._accum_held(e)
                acc.copy_(full if layout is None or sharded.topo.size[
                    layout[0]] == 1 else sharded._block(full, layout))


def parent_restore(ckpt, model, optimizer, train_step, sharded, mask_gen,
                   epochs):
    state, cursor, step = ckpt.restore_latest()
    load_full_state(sharded, state["model"], optimizer, state["optimizer"],
                    train_step.accum, state["train_step"].get("accum"))
    train_step.load_state_dict(dict(state["train_step"], accum=None))
    unpack_rng_key(cursor["rng"], mask_gen)
    start_epoch = min(int(cursor.get("epoch", 0)), epochs)
    epoch_step = int(cursor.get("step", 0)) if start_epoch < epochs else 0
    return start_epoch, epoch_step, int(cursor.get("global_step", step))


restore = (trainer._restore_checkpoint if mode == "sharded"
           else parent_restore)


def hooked(ckpt, model, optimizer, train_step, sharded, *args):
    out = restore(ckpt, model, optimizer, train_step, sharded, *args)
    model_state, opt_state, accum = sharded.full_state(optimizer,
                                                       train_step.accum)
    if RANK == 0:
        torch.save({"model": model_state, "optimizer": opt_state["state"],
                    "accum": accum}, dump)
    return out


trainer._restore_checkpoint = hooked
argv += ["--coordinator_address", ADDRESS, "--num_processes", str(WORLD),
         "--process_id", str(RANK)]
result = cli.main(argv)
print("RESULT " + json.dumps(dict({k: result.get(k) for k in (
    "losses", "global_step", "parallel", "ckpt_restore_bytes",
    "ckpt_restore_largest_bytes", "ckpt_restore_scanned_bytes")},
    masks=masks)), flush=True)
'''


def _resume(mode, dump, argv) -> list:
    outs = run_gloo(_RESUME, 2, mode, str(dump), json.dumps(argv),
                    init=False)
    return [json.loads([line for line in out.splitlines()
                        if line.startswith("RESULT ")][-1][len("RESULT "):])
            for out in outs]


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request, corpus, tmp_path_factory):
    """A two-rank run saved at step 2 under the first layout, resumed
    under the second through the trainer's restore and through the
    parent's path, each for two more steps."""
    saved_flags, flags = PAIRS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    ck, parent_ck = str(tmp / "ck"), str(tmp / "parent_ck")
    run_cli(2, _save_argv(corpus, ck, saved_flags))
    shutil.copytree(ck, parent_ck)
    argv = _argv(corpus, *flags, "--max_steps", "2")
    sharded = _resume("sharded", tmp / "sharded.pt",
                      argv + ["--checkpoint_dir", ck])
    parent = _resume("parent", tmp / "parent.pt",
                     argv + ["--checkpoint_dir", parent_ck])
    return {"saved": CheckpointManager(ck).read_state(2),
            "index": CheckpointManager(ck).index(2),
            "sharded": sharded, "parent": parent, "flags": flags,
            "dumps": {m: torch.load(tmp / f"{m}.pt")
                      for m in ("sharded", "parent")}}


def _assert_equal_trees(got, want, where):
    if torch.is_tensor(want):
        assert torch.equal(got, want), where
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


def test_the_state_restored_under_another_layout_is_the_saved_one(pair):
    saved, dump = pair["saved"], pair["dumps"]["sharded"]
    _assert_equal_trees(dump["model"], saved["model"], "model")
    _assert_equal_trees(dump["optimizer"], saved["optimizer"]["state"],
                        "optimizer")
    _assert_equal_trees(dump["accum"], saved["train_step"]["accum"],
                        "accum")


def test_the_continuation_equals_the_parent_paths_bit_for_bit(pair):
    _assert_equal_trees(pair["dumps"]["sharded"], pair["dumps"]["parent"],
                        "restored")
    for got, want in zip(pair["sharded"], pair["parent"]):
        assert got["global_step"] == want["global_step"] == 4
        assert got["losses"] == want["losses"]
        assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))


def test_the_ranks_of_a_data_share_draw_alike_after_the_resume(pair):
    """The run's one generator continues from the cursor's one state on
    every rank: the ranks that hold one share take the same rows of the
    global draw, so that they draw the same masks, and two shares take
    other rows of it; the parent's path from the same state draws the
    same."""
    by_share: dict = {}
    for got, parent in zip(pair["sharded"], pair["parent"]):
        assert got["masks"] == parent["masks"] and len(got["masks"]) == 2
        share = got["parallel"]["index"]["data"]
        by_share.setdefault(share, []).append(got["masks"])
    for draws in by_share.values():
        assert all(d == draws[0] for d in draws)
    if len(by_share) > 1:
        assert by_share[0][0] != by_share[1][0]


def test_a_rank_reads_only_what_it_holds(pair):
    """Every rank assembles its held bytes and the step counters (and the
    buffers), no leaf larger than it holds one, from fewer bytes of the
    shards than the step holds: a piece's span only where the block
    overlaps it."""
    index = pair["index"]
    _, extra = _whole_kinds(index, _params(pair["flags"]))
    whole = max(_leaf_bytes(leaf, {"dim": None})
                for leaf in index["leaves"].values())
    step = sum(f["bytes"] for f in index["files"].values())
    for result in pair["sharded"]:
        held = result["parallel"]["held_bytes"]["total"]
        assert result["ckpt_restore_bytes"] == held + extra
        assert result["ckpt_restore_largest_bytes"] <= whole
        assert held + extra <= result["ckpt_restore_scanned_bytes"] < step
    # The parent's path read the whole state on every host.
    for result in pair["parent"]:
        assert result["ckpt_restore_bytes"] == sum(
            _leaf_bytes(leaf, {"dim": None})
            for leaf in index["leaves"].values())


# ---------------------------------------------------------- against JAX

# fsdp for two steps from JAX's weights, the step saved by the trainer's
# save, then a tp state restored from it by the trainer's restore and two
# more steps: each step's loss and norm, the probes after.
_FSDP_THEN_TP = r'''
import torch
from lance_distributed_training_tpu_torch import trainer
from lance_distributed_training_tpu_torch.models import tasks
from lance_distributed_training_tpu_torch.models.convert import (
    flax_named_shapes)
from lance_distributed_training_tpu_torch.parallel import comm
from lance_distributed_training_tpu_torch.parallel.layout import (
    ShardedState, shard_model_)
from lance_distributed_training_tpu_torch.parallel.sharding import (
    plan_model, rules_for_task)
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager)

data = torch.load(ARGS[0])
ck, target = ARGS[1], ARGS[2]
config = trainer.TrainConfig(
    dataset_path="unused", task_type="masked_lm", model_name="bert_small",
    seq_len=data["seq"], vocab_size=data["vocab"], optimizer="sgd",
    lr=data["lr"], momentum=0.9, log_grad_norm=True)


def build(mp, fsdp):
    topo = comm.Topology(RANK, WORLD, mp)
    task = tasks.get_task("masked_lm", model_name="bert_small",
                          seq_len=data["seq"], vocab_size=data["vocab"],
                          loss_group=topo.batch_group)
    task.model.load_state_dict(data["state"])
    rules = rules_for_task(task.name, "bert_small") if mp > 1 else ()
    plan = plan_model(flax_named_shapes(task.model), rules, topo.size,
                      fsdp=fsdp)
    shard_model_(task.model, plan, topo)
    sharded = ShardedState(task.model, plan, topo)
    opt, lr = trainer.make_optimizer(config, sharded.masters)
    step = trainer.make_train_step(task, opt, lr, grad_norm=True,
                                   sharded=sharded)
    return topo, task, sharded, opt, step


def run(topo, step, steps):
    n = topo.size["data"]
    per = data["batch"] // n
    rows = slice(topo.index["data"] * per, (topo.index["data"] + 1) * per)
    losses, norms = [], []
    for i in steps:
        batch, mask = data["batches"][i], data["masks"][i]
        loss = step({k: v[rows] for k, v in batch.items()},
                    mlm_mask=mask[rows])
        if n > 1:
            loss = comm.all_reduce(loss, topo.batch_group) / n
        losses.append(float(loss))
        norms.append(float(step.last_grad_norm))
    return losses, norms


gen = torch.Generator().manual_seed(0)
topo, task, sharded, opt, step = build(1, True)
losses, norms = run(topo, step, [0, 1])
ckpt = CheckpointManager(ck)
journal = trainer._CkptJournal()
journal.abs_step, journal.cursor_base = 2, {"epoch": 0, "step": 2}
trainer._save_checkpoint(ckpt, journal, task.model, opt, step, gen,
                         wait=True, sharded=sharded)
ckpt.close()
topo, task, sharded, opt, step = build(2, False)
resumed = trainer._restore_checkpoint(CheckpointManager(ck), task.model,
                                      opt, step, sharded, gen, 1)
more = run(topo, step, [2, 3])
state = sharded.full_state(opt, step.accum)[0]
if RANK == 0:
    torch.save({"losses": losses + more[0], "norms": norms + more[1],
                "resumed": resumed, "mesh": dict(topo.size),
                "probes": {k: state[k] for k in data["probes"]}}, target)
'''


def _jax_run(layout_kw: dict, init_key: int):
    config = jax_trainer.TrainConfig(
        dataset_path="unused", task_type="masked_lm",
        model_name="bert_small", seq_len=SEQ, vocab_size=VOCAB,
        batch_size=8, optimizer="sgd", lr=LR, momentum=0.9, **layout_kw)
    mesh = get_mesh(jax.devices(),
                    model_parallelism=config.model_parallelism)
    task = jax_trainer._task_from_config(config, mesh)
    from lance_distributed_training_tpu.parallel import sharding as jax_sh

    rules = (jax_sh.rules_for_task(task.name, config.model_name)
             if config.model_parallelism > 1 else ())
    state, state_sharding = jax_trainer.create_sharded_train_state(
        jax.random.key(init_key), task, config, mesh, rules,
        fsdp_axis="data" if config.fsdp else None, total_steps=10)
    step = jax_trainer.make_train_step(task, mesh,
                                       state_sharding=state_sharding,
                                       donate=False, grad_norm=True)
    return state, step, dict(mesh.shape)


def test_an_fsdp_run_resumed_under_tp_tracks_jax_restored_by_orbax(
        tmp_path):
    """JAX: fsdp on its 8 CPU devices for two steps, an orbax save, the
    state restored onto a tp mesh (data 4, model 2) over a target of other
    weights, two more steps. The port: two gloo ranks, fsdp then tp, from
    JAX's initial weights and mask draws. Losses within 2e-3 relative,
    norms within 5e-3, the probes' updates within 3% of JAX's largest
    element (``tests/test_torch_sharding.py``'s tolerances of tp)."""
    batches = [_batch(i) for i in range(4)]
    rngs = [jax.random.key(100 + i) for i in range(4)]
    masks = [np.asarray(jax.random.bernoulli(r, 0.15, (8, SEQ))
                        & (b["attention_mask"] > 0))
             for r, b in zip(rngs, batches)]
    state, step, mesh = _jax_run({"fsdp": True}, 0)
    assert mesh["data"] == 8
    init = jax.tree_util.tree_map(np.asarray, state.params)
    source = tmp_path / "inputs.pt"
    torch.save({"state": torch_state_dict_from_flax(init), "seq": SEQ,
                "vocab": VOCAB, "lr": LR, "batch": 8, "probes": PROBES,
                "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                            for b in batches],
                "masks": [torch.from_numpy(np.array(m)) for m in masks]},
               source)
    job = start_gloo(_FSDP_THEN_TP, 2, source, tmp_path / "port_ck",
                     tmp_path / "port.pt")
    losses, norms = [], []
    for i in (0, 1):
        state, loss, norm = step(state, {k: jnp.asarray(v) for k, v in
                                         batches[i].items()}, rngs[i])
        losses.append(float(loss))
        norms.append(float(norm))
    mgr = JaxCheckpointManager(str(tmp_path / "jax_ck"))
    mgr.save(2, state, wait=True, cursor={"epoch": 0, "step": 2})
    mgr.close()
    target, step, mesh = _jax_run({"model_parallelism": 2}, 1)
    assert mesh["model"] == 2
    restored = JaxCheckpointManager(str(tmp_path / "jax_ck")).restore_latest(
        target)
    assert restored is not None and restored[2] == 2
    state = restored[0]
    for i in (2, 3):
        state, loss, norm = step(state, {k: jnp.asarray(v) for k, v in
                                         batches[i].items()}, rngs[i])
        losses.append(float(loss))
        norms.append(float(norm))
    after = torch_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params))
    before = torch_state_dict_from_flax(init)
    job.wait(600)
    port = torch.load(tmp_path / "port.pt")
    assert port["resumed"] == (0, 2, 2)
    assert port["mesh"]["model"] == 2
    np.testing.assert_allclose(port["losses"], losses, rtol=2e-3)
    np.testing.assert_allclose(port["norms"], norms, rtol=5e-3)
    _close_updates(port["probes"], {k: after[k] for k in PROBES},
                   {k: before[k] for k in PROBES})


# ------------------------------------------------------ emergency saves

# A two-rank ``cli train`` whose decode raises at the 6th batch on the
# ranks of ARGS[1] (the failing processes wait 5 s for their peers instead
# of the trainer's 60): each rank's error on a RESULT line.
_FAILING = r'''
import json
import os
from lance_distributed_training_tpu_torch import cli, trainer

argv, failing_ranks = json.loads(ARGS[0]), json.loads(ARGS[1])
trainer._PEER_WAIT_S = 5.0
decoder_for = trainer._decoder_for


def failing(config, for_eval=False):
    decode = decoder_for(config, for_eval)
    if for_eval or RANK not in failing_ranks:
        return decode
    calls = []

    def fn(table):
        calls.append(1)
        if len(calls) == 6:
            raise RuntimeError("decode failed at batch 6")
        return decode(table)
    return fn


trainer._decoder_for = failing
argv += ["--coordinator_address", ADDRESS, "--num_processes", str(WORLD),
         "--process_id", str(RANK)]
try:
    cli.main(argv)
    print("RESULT " + json.dumps("finished"), flush=True)
except Exception as exc:
    print("RESULT " + json.dumps(str(exc)), flush=True)
    os._exit(0)  # the group may have lost a member: nothing to shut down
'''


def _failing(ck, corpus, ranks) -> list:
    argv = _argv(corpus, "--fsdp", "--epochs", "2", "--checkpoint_dir", ck,
                 "--checkpoint_every_steps", "2")
    outs = run_gloo(_FAILING, 2, json.dumps(argv), json.dumps(ranks),
                    init=False, timeout=120)
    return [json.loads([line for line in out.splitlines()
                        if line.startswith("RESULT ")][-1][len("RESULT "):])
            for out in outs]


def test_an_exception_on_every_rank_saves_each_ranks_share(
        tmp_path, corpus, monkeypatch):
    """Both ranks raise at batch 6: each writes its fsdp blocks of step 5
    awaited, rank 0 commits it, and the step equals, bit for bit, the one
    that a SIGTERM drain after step 5 saves (the same cursor too)."""
    ck = str(tmp_path / "ck")
    errors = _failing(ck, corpus, [0, 1])
    assert errors == ["decode failed at batch 6"] * 2
    mgr = CheckpointManager(ck)
    assert mgr.latest_intact_step() == 5
    files = mgr.index(5)["files"]
    assert sorted(f["rank"] for f in files.values()) == [0, 1]
    monkeypatch.setenv("LDT_CHAOS", "drain@5")
    drained = str(tmp_path / "drained")
    run_cli(2, _argv(corpus, "--fsdp", "--epochs", "2", "--checkpoint_dir",
                     drained, "--checkpoint_every_steps", "2"))
    want = CheckpointManager(drained)
    assert want.latest_intact_step() == 5
    assert mgr.cursor(5) == want.cursor(5)
    assert (mgr.cursor(5)["epoch"], mgr.cursor(5)["step"]) == (1, 1)
    _assert_equal_trees(mgr.read_state(5), want.read_state(5), "step 5")


@pytest.mark.parametrize("rank", [0, 1])
def test_an_exception_on_one_rank_commits_nothing_and_ends(tmp_path, corpus,
                                                           rank):
    """One rank raises at batch 6 while its peer waits in step 6's
    collective: the failing rank's gate gives up after its timeout, it
    exits without saving, and its peer's collective then fails. Both end
    (no hang), and no step after the last committed one, 4, is written or
    committed."""
    ck = str(tmp_path / "ck")
    errors = _failing(ck, corpus, [rank])
    assert errors[rank] == "decode failed at batch 6"
    assert "Connection closed by peer" in errors[1 - rank], errors
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 4] and mgr.latest_intact_step() == 4
    assert sorted(os.listdir(ck)) == ["2", "4", "cursors"]


# ------------------------------------------------------------ refusals

def _run(tmp_path, **kw):
    cfg = dict(dataset_path=kw.pop("path"), task_type="masked_lm",
               model_name="bert_small", vocab_size=VOCAB, seq_len=SEQ,
               batch_size=4, optimizer="adamw", lr=1e-3, log_every=0,
               eval_at_end=False, device="cpu", autotune=False,
               checkpoint_dir=str(tmp_path / "ck"), max_steps=2,
               checkpoint_every_steps=2)
    cfg.update(kw)
    return trainer.train(trainer.TrainConfig(**cfg))


@pytest.mark.parametrize("change,match", [
    ({"optimizer": "sgd"}, "its optimizer is not this run's"),
    ({"num_experts": 4}, "its model is not this run's"),
], ids=["optimizer", "moe"])
def test_a_step_of_another_state_tree_is_refused(tmp_path, corpus,
                                                 monkeypatch, change,
                                                 match):
    monkeypatch.setenv("LDT_METRICS_PATH", os.devnull)
    _run(tmp_path, path=corpus)
    with pytest.raises(CheckpointRefused, match=match):
        _run(tmp_path, path=corpus, **change)


@pytest.mark.parametrize("saved,flags,match", [
    (["--pipeline_parallelism", "2"], [], "stacked blocks"),
    (["--zero", "2", "--grad_accum", "2"], ["--fsdp"],
     "taken with a gradient accumulator and this run has none"),
], ids=["pipeline", "accumulator"])
def test_a_layout_of_another_state_tree_is_refused(tmp_path, corpus, saved,
                                                   flags, match):
    ck = str(tmp_path / "ck")
    run_cli(2, _save_argv(corpus, ck, saved))
    with pytest.raises(AssertionError) as failed:
        run_cli(2, _argv(corpus, *flags, "--max_steps", "2",
                         "--checkpoint_dir", ck))
    assert "CheckpointRefused" in str(failed.value)
    assert match in str(failed.value)
