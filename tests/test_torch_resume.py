"""Resume fidelity of the port's trainer, and the rest of the trainer's
surface beyond the main path.

A run drained mid-epoch (``LDT_CHAOS=drain@N``, the in-process twin of
SIGTERM) with step checkpoints resumes from its awaited emergency
checkpoint and consumes the exact remaining batches, with losses equal to
an uninterrupted control run's, bit for bit, on the CPU: ResNet-18 (the
twin of ``tests/test_checkpoint.py``'s drain test), masked-LM with
``grad_accum 2`` drained mid-window, a fallback past a corrupted newest
step, and two gloo processes. Then the crash path, the ``max_steps`` stop,
the eval over a held-out dataset, the profiler and the CLI's flags.
"""

import glob
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu_torch import cli, trainer
from lance_distributed_training_tpu_torch.data import (
    create_synthetic_classification_dataset,
    create_text_token_dataset,
)
from lance_distributed_training_tpu_torch.utils import chaos as C
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
SEQ = 16


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("food") / "food")
    create_synthetic_classification_dataset(path, rows=96, num_classes=10,
                                            image_size=32, fragment_size=40)
    return path


def _token_docs(rows, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 128, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, rows)]


@pytest.fixture(scope="module")
def token_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tokens") / "tokens")
    create_text_token_dataset(path, _token_docs(48), seq_len=SEQ, pack=False,
                              fragment_size=20)
    return path


def _run(tmp_path, monkeypatch, trace, chaos=None, **kw):
    """``train`` with the step trace at ``trace`` (and ``LDT_CHAOS``):
    ``(result, trace records)``."""
    path = str(tmp_path / trace)
    monkeypatch.setenv(C.TRACE_ENV, path)
    monkeypatch.setenv("LDT_METRICS_PATH", str(tmp_path / "m.jsonl"))
    if chaos:
        monkeypatch.setenv(C.CHAOS_ENV, chaos)
    else:
        monkeypatch.delenv(C.CHAOS_ENV, raising=False)
    result = trainer.train(trainer.TrainConfig(device="cpu", **kw))
    return result, C.read_trace(path)


def _image_config(image_path, **kw):
    return dict(dataset_path=image_path, num_classes=10,
                model_name="resnet18", image_size=32, batch_size=16,
                epochs=2, lr=0.01, eval_at_end=False, log_every=0, seed=7,
                **kw)


def _text_config(token_path, **kw):
    return dict(dataset_path=token_path, task_type="masked_lm",
                model_name="bert_small", vocab_size=128, seq_len=SEQ,
                batch_size=4, epochs=2, optimizer="adamw", lr=1e-2,
                lr_schedule="cosine", warmup_steps=3, shuffle=True,
                eval_at_end=False, log_every=0, seed=3, **kw)


def _assert_resumed_equals(control, resumed, first):
    assert resumed[0]["step"] == first
    assert resumed[-1]["step"] == control[-1]["step"]
    by_step = {t["step"]: t for t in control}
    for t in resumed:
        ref = by_step[t["step"]]
        assert t["batch_sha256"] == ref["batch_sha256"], t["step"]
        assert t["loss"] == ref["loss"], (t["step"], t["loss"], ref["loss"])


def _assert_same_params(a, b):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def test_resnet_drain_resume_is_bit_identical(tmp_path, monkeypatch,
                                              image_path):
    """The twin of the JAX drain test: ResNet-18 at 32 px, batch 16, two
    epochs, ``drain@5`` with ``checkpoint_every_steps 2``, flips on (the
    flip generator's state rides the cursor)."""
    cfg = _image_config(image_path)
    control_result, control = _run(tmp_path, monkeypatch, "control.jsonl",
                                   **cfg)
    assert len(control) == 2 * (96 // 16)
    ck = str(tmp_path / "ck")
    r1, pre = _run(tmp_path, monkeypatch, "pre.jsonl", chaos="drain@5",
                   checkpoint_dir=ck, checkpoint_every_steps=2, **cfg)
    assert r1["preempted"] is True and r1["steps"] == 5
    assert r1["global_step"] == 5 and r1["ckpt_last_success_step"] == 5
    assert [t["step"] for t in pre] == [1, 2, 3, 4, 5]
    r2, resumed = _run(tmp_path, monkeypatch, "resume.jsonl",
                       checkpoint_dir=ck, checkpoint_every_steps=2, **cfg)
    assert "preempted" not in r2 and r2["start_epoch"] == 0
    assert r2["steps"] == 7 and r2["global_step"] == 12
    assert r2["ckpt_restore_ms"] is not None
    # No replayed batch, no skipped batch; BatchNorm's statistics too.
    _assert_resumed_equals(control, resumed, first=6)
    _assert_same_params(r2["model"], control_result["model"])


def test_masked_lm_drained_mid_window_resumes_bit_identical(
        tmp_path, monkeypatch, token_path):
    """``grad_accum 2`` drained at micro-step 5: the emergency checkpoint
    carries a half-full accumulator, the resumed run ends equal to the
    control, parameters and AdamW's moments bit for bit."""
    cfg = _text_config(token_path, grad_accum=2, log_grad_norm=True)
    control_result, control = _run(tmp_path, monkeypatch, "control.jsonl",
                                   **cfg)
    assert len(control) == 2 * (48 // 4)
    ck = str(tmp_path / "ck")
    r1, _ = _run(tmp_path, monkeypatch, "pre.jsonl", chaos="drain@5",
                 checkpoint_dir=ck, checkpoint_every_steps=2, **cfg)
    assert r1["preempted"] is True and r1["global_step"] == 5
    saved, cursor, step = CheckpointManager(ck).restore_latest()
    assert step == 5 and cursor["global_step"] == 5
    assert cursor["epoch"] == 0 and cursor["step"] == 5
    assert saved["train_step"]["micro_step"] == 1
    assert saved["train_step"]["updates"] == 2
    assert any(bool(a.abs().sum()) for a in saved["train_step"]["accum"])
    r2, resumed = _run(tmp_path, monkeypatch, "resume.jsonl",
                       checkpoint_dir=ck, checkpoint_every_steps=2, **cfg)
    _assert_resumed_equals(control, resumed, first=6)
    assert r2["losses"] == control_result["losses"][5:]
    _assert_same_params(r2["model"], control_result["model"])
    want = control_result["optimizer"].state_dict()["state"]
    got = r2["optimizer"].state_dict()["state"]
    for key in want:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[key][name], want[key][name]), (key, name)


def test_corrupt_newest_step_falls_back_and_still_matches(
        tmp_path, monkeypatch, token_path):
    """A torn newest state file: the resume falls back to the step before
    and replays from there, ending equal to the control."""
    cfg = _text_config(token_path, grad_accum=2)
    control_result, control = _run(tmp_path, monkeypatch, "control.jsonl",
                                   **cfg)
    ck = str(tmp_path / "ck")
    _run(tmp_path, monkeypatch, "pre.jsonl", chaos="drain@7",
         checkpoint_dir=ck, checkpoint_every_steps=3, **cfg)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3, 6, 7]
    shard, = mgr.shard_paths(7)
    with open(shard, "r+b") as f:
        f.truncate(100)
    r2, resumed = _run(tmp_path, monkeypatch, "resume.jsonl",
                       checkpoint_dir=ck, checkpoint_every_steps=3, **cfg)
    _assert_resumed_equals(control, resumed, first=7)
    _assert_same_params(r2["model"], control_result["model"])


def test_exception_mid_run_leaves_an_emergency_checkpoint(
        tmp_path, monkeypatch, token_path):
    """A decode that raises at the 6th batch: the run re-raises it after an
    awaited checkpoint of its last completed step, 5, whose cursor names
    batch 6."""
    decoder_for = trainer._decoder_for

    def failing(config, for_eval=False):
        decode = decoder_for(config, for_eval)
        if for_eval:
            return decode
        calls = []

        def fn(table):
            calls.append(1)
            if len(calls) == 6:
                raise RuntimeError("decode failed at batch 6")
            return decode(table)
        return fn

    monkeypatch.setattr(trainer, "_decoder_for", failing)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="decode failed at batch 6"):
        _run(tmp_path, monkeypatch, "t.jsonl", checkpoint_dir=ck,
             checkpoint_every_steps=2, **_text_config(token_path,
                                                      grad_accum=2))
    mgr = CheckpointManager(ck)
    assert mgr.latest_intact_step() == 5
    cursor = mgr.cursor(5)
    assert (cursor["epoch"], cursor["step"], cursor["global_step"]) == \
        (0, 5, 5)


def test_max_steps_stop_mid_epoch_takes_no_epoch_checkpoint(
        tmp_path, monkeypatch, token_path):
    ck = str(tmp_path / "ck")
    result, _ = _run(tmp_path, monkeypatch, "t.jsonl", checkpoint_dir=ck,
                     max_steps=3, **_text_config(token_path))
    assert result["steps"] == 3 and "preempted" not in result
    assert CheckpointManager(ck).all_steps() == []
    assert result["ckpt_save_ms"] == []
    # Without a stop the epoch checkpoints land at each epoch's end, with
    # a cursor naming the next epoch's first batch.
    ck2 = str(tmp_path / "ck2")
    _run(tmp_path, monkeypatch, "t2.jsonl", checkpoint_dir=ck2,
         **_text_config(token_path))
    mgr = CheckpointManager(ck2)
    assert mgr.all_steps() == [12, 24]
    assert mgr.cursor(12)["epoch"] == 1 and mgr.cursor(12)["step"] == 0


def test_resume_under_another_world_size_raises(tmp_path, monkeypatch,
                                                token_path):
    ck = str(tmp_path / "ck")
    _run(tmp_path, monkeypatch, "t.jsonl", chaos="drain@2",
         checkpoint_dir=ck, **_text_config(token_path))
    mgr = CheckpointManager(ck)
    state, cursor, step = mgr.restore_latest()
    cursor["rng"] = cursor["rng"] * 2  # as if two processes had saved it
    mgr.save(step + 1, state, cursor=cursor, wait=True)
    with pytest.raises(ValueError, match="taken by 2 processes"):
        _run(tmp_path, monkeypatch, "t2.jsonl", checkpoint_dir=ck,
             **_text_config(token_path))


# The children run torch on one intra-op thread, the bound every port
# test's ``_one_torch_thread`` sets (a spawned child does not inherit it).
# With two, the uninterrupted run's loss at micro-step 3 (the first after
# the first update) read 9.8593731 instead of 9.8598471 in about 4% of runs
# under load: the first AdamW step's ``exp_avg_sq.sqrt()`` of the first
# parameter (``pos_embed``, 4096 elements) runs as two MKL vector-math
# calls of 2048 elements, one on each thread (ATen's vectorised-math
# kernels split at a grain of 2048), and one half came back with relative
# errors up to 2.6e-4 while the same step rerun on copies of its inputs
# gave the expected bits. On one thread it never did (0 of 227 runs under
# load, against 3 of 82 on two at the same time; ROADMAP Queue 3). The
# trainer's CPU path now makes one vector-math call before any on two
# threads, after which two threads gave it in none of 198 runs.
_CHILD = textwrap.dedent(r'''
    import sys
    import torch
    torch.set_num_threads(1)
    from lance_distributed_training_tpu_torch import trainer
    path, out, ck, world, rank, address = sys.argv[1:7]
    kw = dict(dataset_path=path, task_type="masked_lm",
              model_name="bert_small", vocab_size=128, seq_len=16,
              batch_size=8, epochs=1, log_every=0, optimizer="adamw",
              lr=1e-2, grad_accum=2, eval_at_end=False, device="cpu",
              coordinator_address=address, num_processes=int(world),
              process_id=int(rank))
    if ck != "-":
        kw.update(checkpoint_dir=ck, checkpoint_every_steps=2)
    result = trainer.train(trainer.TrainConfig(**kw))
    torch.save({"losses": result["losses"],
                "preempted": result.get("preempted", False),
                "global_step": result["global_step"],
                "state": result["model"].state_dict(),
                "threads": torch.get_num_threads()}, out)
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, path, tag, ck="-", chaos=None):
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, LDT_METRICS_PATH=os.devnull,
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    env.pop(C.CHAOS_ENV, None)
    env.pop(C.TRACE_ENV, None)
    if chaos:
        env[C.CHAOS_ENV] = chaos
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, path,
         str(tmp_path / f"{tag}{rank}.pt"), ck, "2", str(rank), address],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp_path / f"{tag}{rank}.pt") for rank in (0, 1)]


def _name_the_first_difference(tmp_path, path, pre_update, first, want):
    """A micro-step 3 loss differs: rerun the uninterrupted two processes,
    this time saving at micro-step 2, write both runs' parameters after the
    first update to ``tmp_path`` and name the first tensor that differs.
    The control itself runs without saves, so that whatever a save does
    to a run cannot hide the difference."""
    diag_ck = str(tmp_path / "diag_ck")
    diag = _two_processes(tmp_path, path, "diag", diag_ck)
    updates = {"uninterrupted": CheckpointManager(diag_ck).read_state(2)[
        "model"], "preempted": pre_update}
    dump = tmp_path / "params_after_first_update.pt"
    torch.save(updates, dump)
    differ = next((name for name, value in updates["uninterrupted"].items()
                   if not torch.equal(updates["preempted"][name], value)),
                  None)
    raise AssertionError(
        f"micro-step 3 loss {first['losses'][2]!r} (preempted run) != "
        f"{want['losses'][2]!r} (uninterrupted; "
        f"{[d['losses'][2] for d in diag]!r} in a rerun that saves); after "
        f"the first update the first tensor that differs is {differ} (both "
        f"runs' parameters in {dump})")


def test_two_gloo_processes_preempted_and_resumed_match_the_uninterrupted(
        tmp_path, token_path):
    """Two processes, each with its own mask generator: preempted at
    micro-step 3 (mid-window) and resumed, their losses and weights equal
    the uninterrupted two-process run's, bit for bit. A micro-step 3 loss
    that differs comes with both runs' parameters after the first update
    and the name of the first tensor that differs."""
    control = _two_processes(tmp_path, token_path, "control")
    ck = str(tmp_path / "ck")
    pre = _two_processes(tmp_path, token_path, "pre", ck, chaos="drain@3")
    assert all(p["preempted"] and p["global_step"] == 3 for p in pre)
    cursor = CheckpointManager(ck).cursor(3)
    assert len(cursor["rng"]) == 2 and cursor["rng"][0] != cursor["rng"][1]
    # Micro-step 2 closes the first window: read the preempted run's
    # parameters there before the resumed run's saves rotate ``ck``.
    pre_update = CheckpointManager(ck).read_state(2)["model"]
    resumed = _two_processes(tmp_path, token_path, "resumed", ck)
    for got, want, first in zip(resumed, control, pre):
        assert got["global_step"] == want["global_step"] == 6
        if first["losses"][2] != want["losses"][2]:
            _name_the_first_difference(tmp_path, token_path, pre_update,
                                       first, want)
        assert first["losses"] + got["losses"] == want["losses"]
        for key, value in want["state"].items():
            assert torch.equal(got["state"][key], value), key


def test_the_resume_children_step_on_one_torch_thread(tmp_path, token_path):
    """The two-process runs train on one intra-op thread a process, so no
    elementwise kernel of the first optimizer step is split between
    threads (the cause of the micro-step 3 mismatch, above ``_CHILD``), and
    two uninterrupted runs give the same losses and weights, bit for
    bit."""
    first = _two_processes(tmp_path, token_path, "one")
    again = _two_processes(tmp_path, token_path, "two")
    assert [r["threads"] for r in first + again] == [1, 1, 1, 1]
    for a, b in zip(first, again):
        assert a["losses"] == b["losses"]
        for key, value in a["state"].items():
            assert torch.equal(b["state"][key], value), key


# The fault without the trainer: a fresh process on two intra-op threads
# runs BERT-small's forward and backward, then its first AdamW step, and
# reruns that step on copies of its inputs. Without the trainer's warm-up
# ``pos_embed``'s update differed from the rerun in 16 of 400 processes
# (one half of it, as in the trainer), with it in none of 100, and on one
# thread in none of 100 (my CPU runs).
_FIRST_ADAMW_STEP = textwrap.dedent(r'''
    import sys
    import torch
    torch.set_num_threads(2)
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.models import tasks
    if sys.argv[1] == "warm":
        trainer._warm_vector_math()
    task = tasks.get_task("masked_lm", model_name="bert_small", seq_len=16,
                          vocab_size=128,
                          generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"input_ids": torch.randint(2, 128, (8, 16), generator=gen),
             "attention_mask": torch.ones(8, 16, dtype=torch.int32)}
    mask = torch.rand(8, 16, generator=gen) < 0.15
    task.loss(task.forward(batch, True, mlm_mask=mask), batch).backward()
    params = list(task.model.parameters())
    again = [torch.nn.Parameter(p.detach().clone()) for p in params]
    for p, q in zip(params, again):
        q.grad = p.grad.clone()
    torch.optim.AdamW(params, lr=1e-2).step()
    torch.optim.AdamW(again, lr=1e-2).step()
    print(sum(not torch.equal(p, q) for p, q in zip(params, again)))
''')


def test_a_first_adamw_step_after_the_warm_up_equals_its_rerun():
    """The minimal form of the fault (above): after the trainer's
    ``_warm_vector_math``, a fresh process's first AdamW step on two
    threads equals its rerun, in each of eight processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FIRST_ADAMW_STEP, "warm"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(8)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert out.splitlines()[-1] == "0", out[-3000:]


def test_eval_every_over_the_val_dataset(tmp_path, monkeypatch, token_path):
    val = str(tmp_path / "val")
    create_text_token_dataset(val, _token_docs(10, seed=1), seq_len=SEQ,
                              pack=False)
    result, _ = _run(tmp_path, monkeypatch, "t.jsonl",
                     **{**_text_config(token_path), "eval_at_end": True,
                        "eval_every": 1, "val_dataset_path": val})
    assert len(result["history"]) == 2
    for entry in result["history"]:
        assert entry["val_rows"] == 10 and 0 <= entry["val_acc"] <= 1
    # The end eval reads the val split, every row once.
    assert result["eval_rows"] == 10
    assert result["eval_accuracy"] == result["history"][-1]["val_acc"]
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert sum("val_acc" in json.loads(line) for line in lines) == 2


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, token_path):
    prof = tmp_path / "trace"
    result, _ = _run(tmp_path, monkeypatch, "t.jsonl", profile_dir=str(prof),
                     **{**_text_config(token_path), "epochs": 1})
    files = glob.glob(str(prof / "*.json"))
    assert files == [result["profile_trace"]]
    events = json.loads(Path(files[0]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # The window covers epoch steps 2-11: the step's backward ran in it.
    assert any("backward" in n.lower() for n in names)


def test_progress_lines_carry_lr_and_grad_norm(tmp_path, monkeypatch,
                                               token_path, capsys):
    cfg = {**_text_config(token_path, grad_accum=2, log_grad_norm=True,
                          run_name="mine", no_wandb=True),
           "log_every": 1, "epochs": 1}
    result, _ = _run(tmp_path, monkeypatch, "t.jsonl", **cfg)
    records = [json.loads(line) for line in
               (tmp_path / "m.jsonl").read_text().splitlines()]
    assert records[0]["run_name"] == "mine" and records[0]["wandb"] is False
    assert records[0]["config"]["grad_accum"] == 2
    steps = [r for r in records if "loss" in r]
    assert len(steps) == 12
    schedule = trainer.lr_schedule_fn(trainer.TrainConfig(**cfg),
                                      total_steps=12)
    for r in steps:
        assert r["lr"] == pytest.approx(schedule(r["step"] // 2), abs=1e-12)
        assert np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
    assert "grad_norm=" in capsys.readouterr().out
    # The default run name is the JAX trainer's.
    cfg.pop("run_name")
    _run(tmp_path, monkeypatch, "t2.jsonl", **{**cfg, "max_steps": 1})
    last = (tmp_path / "m.jsonl").read_text().splitlines()
    header = [json.loads(line) for line in last if "run_name" in line][-1]
    assert header["run_name"] == "DP-iterable-batch-bert_small"


# ------------------------------------------------------------------- CLI

NEW_FLAGS = [
    (["--val_dataset_path", "/v"], "val_dataset_path", "/v"),
    (["--grad_accum", "4"], "grad_accum", 4),
    (["--no_wandb"], "no_wandb", True),
    (["--eval_every", "2"], "eval_every", 2),
    (["--run_name", "r"], "run_name", "r"),
    (["--log_grad_norm"], "log_grad_norm", True),
    (["--checkpoint_dir", "/c"], "checkpoint_dir", "/c"),
    (["--checkpoint_every", "3"], "checkpoint_every", 3),
    (["--checkpoint_every_steps", "5"], "checkpoint_every_steps", 5),
    (["--no_resume"], "resume", False),
    (["--profile_dir", "/p"], "profile_dir", "/p"),
]


@pytest.mark.parametrize("argv,field,value", NEW_FLAGS,
                         ids=[a[0].lstrip("-") for a, _, _ in NEW_FLAGS])
def test_cli_flag_reaches_train_config(monkeypatch, argv, field, value):
    seen = []
    monkeypatch.setattr(cli, "train", seen.append)
    cli.main(["train", "--dataset_path", "/d", *argv])
    (config,) = seen
    assert getattr(config, field) == value
    # JAX's default otherwise.
    seen.clear()
    cli.main(["train", "--dataset_path", "/d"])
    assert getattr(seen[0], field) == getattr(
        trainer.TrainConfig(dataset_path="/d"), field)


@pytest.mark.parametrize("argv", [["--backend", "cpu"],
                                  ["--num_cpu_devices", "8"],
                                  ["--no_compile_cache"],
                                  ["--compile_cache_dir", "/tmp/x"]])
def test_cli_jax_runtime_flags_raise_naming_device(monkeypatch, argv):
    monkeypatch.setattr(cli, "train", lambda config: pytest.fail("trained"))
    with pytest.raises(NotImplementedError,
                       match="--device .*no XLA compile cache"):
        cli.main(["train", "--dataset_path", "/d", *argv])

