"""The port's checkpoint plane against the JAX package's: the verified JSON
documents byte for byte, the ``CheckpointManager`` cases of
``tests/test_checkpoint.py`` on torch files, the generator state, the
``TrainLoader`` resume cursor, the SIGTERM handler, the chaos spec and the
batch digest.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from lance_distributed_training_tpu.utils import chaos as jax_chaos
from lance_distributed_training_tpu.utils import checkpoint as jax_ckpt
from lance_distributed_training_tpu_torch.data import (
    Dataset,
    create_text_token_dataset,
    decoder_for_task,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.utils import chaos, checkpoint
from lance_distributed_training_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    atomic_write_json,
    pack_rng_key,
    read_verified_json,
    unpack_rng_key,
)
from lance_distributed_training_tpu_torch.utils.signals import (
    PreemptionHandler,
)
from test_torch_threads import _one_torch_thread  # noqa: F401


PAYLOADS = [
    {"epoch": 2, "step": 7},
    {"epoch": 0, "step": 3, "global_step": 11, "rng": [[1, 2, 3], [255, 0]]},
    {"b": "ü", "a": [1.5, None, True], "nested": {"z": 1, "y": {}}},
]


@pytest.mark.parametrize("payload", PAYLOADS)
def test_manifest_bytes_equal_jax(tmp_path, payload):
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    atomic_write_json(ours, payload)
    jax_ckpt.atomic_write_json(theirs, payload)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # Each side reads the other's document.
    assert jax_ckpt.read_verified_json(ours) == payload
    assert read_verified_json(theirs) == payload
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.rand((4, 3), generator=gen),
            "b": torch.rand(3, generator=gen)}


def _corrupt_step_dir(directory, step):
    """Truncate every file under the step's directory — the torn write a
    SIGKILL mid-commit leaves behind."""
    for root, _, names in os.walk(os.path.join(directory, str(step))):
        for name in names:
            with open(os.path.join(root, name), "wb") as f:
                f.write(b"torn")


def _torn_write(tmp_path):
    path = str(tmp_path / "m.json")
    atomic_write_json(path, {"epoch": 2, "step": 7})
    assert read_verified_json(path) == {"epoch": 2, "step": 7}
    with open(path, "a", encoding="utf-8") as f:
        f.write("garbage")
    assert read_verified_json(path) is None
    assert read_verified_json(str(tmp_path / "missing.json")) is None


def _tampered_payload(tmp_path):
    path = str(tmp_path / "m.json")
    atomic_write_json(path, {"step": 7})
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    doc["payload"]["step"] = 8  # flip without re-hashing
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    assert read_verified_json(path) is None


def _empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    assert mgr.latest_intact_step() is None
    assert mgr.restore_latest() is None
    mgr.close()


def _numeric_step_order(tmp_path):
    """Step 10 beats step 2: numeric, not lexicographic."""
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
    mgr.save(2, _state(2), cursor={"epoch": 0, "step": 2}, wait=True)
    mgr.save(10, _state(10), cursor={"epoch": 0, "step": 10}, wait=True)
    assert mgr.latest_step() == 10 and mgr.latest_intact_step() == 10
    _, cursor, step = mgr.restore_latest()
    assert step == 10 and cursor["step"] == 10
    mgr.close()


def _intact_duplicate_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.save(5, _state(), cursor={"epoch": 0, "step": 5}, wait=True)
    # An emergency save racing the periodic one must not raise.
    assert mgr.save(5, _state(1), cursor={"epoch": 0, "step": 5},
                    wait=True) is False
    state, _, _ = mgr.restore_latest()
    assert torch.equal(state["w"], _state()["w"])
    mgr.close()


def _corrupt_step_falls_back(tmp_path):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, max_to_keep=5)
    mgr.save(3, _state(1), cursor={"epoch": 0, "step": 3}, wait=True)
    mgr.save(6, _state(2), cursor={"epoch": 0, "step": 6}, wait=True)
    _corrupt_step_dir(directory, 6)
    state, cursor, step = mgr.restore_latest()
    assert step == 3 and cursor["step"] == 3
    assert torch.equal(state["w"], _state(1)["w"])
    mgr.close()


def _corrupt_sidecar_skips_its_step(tmp_path):
    """A sidecar failing its content hash marks the WHOLE step corrupt."""
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, max_to_keep=5)
    mgr.save(3, _state(1), cursor={"epoch": 0, "step": 3}, wait=True)
    mgr.save(6, _state(2), cursor={"epoch": 0, "step": 6}, wait=True)
    with open(os.path.join(directory, "cursors", "6.json"), "a",
              encoding="utf-8") as f:
        f.write("x")
    assert not mgr.step_intact(6)
    assert mgr.latest_intact_step() == 3
    state, cursor, step = mgr.restore_latest()
    assert step == 3 and cursor["step"] == 3
    assert torch.equal(state["w"], _state(1)["w"])
    mgr.close()


def _stale_corrupt_step_overwritten(tmp_path):
    """After a fallback restore the rerun revisits the torn step's id; the
    save there replaces the stale occupant (the failed load poisoned it)."""
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, max_to_keep=5)
    mgr.save(3, _state(1), cursor={"epoch": 0, "step": 3}, wait=True)
    mgr.save(6, _state(2), cursor={"epoch": 0, "step": 6}, wait=True)
    _corrupt_step_dir(directory, 6)
    assert mgr.restore_latest()[2] == 3
    assert not mgr.step_intact(6)
    fresh = _state(9)
    assert mgr.save(6, fresh, cursor={"epoch": 0, "step": 6,
                                      "global_step": 6}, wait=True)
    state, cursor, step = mgr.restore_latest()
    assert step == 6 and cursor["global_step"] == 6
    assert torch.equal(state["w"], fresh["w"])
    mgr.close()


def _orphan_sidecars_collected(tmp_path):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, max_to_keep=2)
    # A sidecar whose state file never committed (a crash between them).
    atomic_write_json(os.path.join(directory, "cursors", "0.json"),
                      {"epoch": 0, "step": 0})
    for step in (1, 2, 3):
        mgr.save(step, _state(step), cursor={"epoch": 0, "step": step},
                 wait=True)
    assert mgr.all_steps() == [2, 3]
    names = sorted(os.listdir(os.path.join(directory, "cursors")))
    assert names == ["2.json", "3.json"], names
    assert mgr.last_success_step == 3 and len(mgr.save_ms) == 3
    mgr.close()


def _state_file_without_sidecar_is_not_intact(tmp_path):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory)
    mgr.save(4, _state(), cursor={"epoch": 0, "step": 4}, wait=True)
    os.unlink(os.path.join(directory, "cursors", "4.json"))
    assert mgr.all_steps() == [4] and not mgr.step_intact(4)
    assert mgr.restore_latest() is None
    mgr.close()


CASES = {f.__name__.lstrip("_"): f for f in (
    _torn_write, _tampered_payload, _empty_dir, _numeric_step_order,
    _intact_duplicate_skipped, _corrupt_step_falls_back,
    _corrupt_sidecar_skips_its_step, _stale_corrupt_step_overwritten,
    _orphan_sidecars_collected, _state_file_without_sidecar_is_not_intact)}


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_manager(tmp_path, case):
    CASES[case](tmp_path)


def test_save_copies_off_the_live_tensors_before_returning(tmp_path):
    """The file holds the state at the call, though training goes on
    mutating the tensors while the background thread writes."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    live = _state(3)
    want = {k: v.clone() for k, v in live.items()}
    mgr.save(1, {"model": live, "extra": [live["b"], 7]},
             cursor={"epoch": 0, "step": 1})
    live["w"].add_(1.0)
    live["b"].zero_()
    mgr.close()
    state, _, _ = mgr.restore_latest()
    assert torch.equal(state["model"]["w"], want["w"])
    assert torch.equal(state["extra"][0], want["b"]) and state["extra"][1] == 7
    assert mgr.write_ms and mgr.last_success_step == 1


def test_failed_background_write_raises_at_the_next_wait(tmp_path,
                                                         monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"))

    def broken(f, tensors):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write_tensors", broken)
    mgr.save(1, _state(), cursor={"epoch": 0, "step": 1})
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.close()
    assert mgr.all_steps() == []
    assert not [n for n in os.listdir(os.path.join(mgr.directory, "1"))]


def test_generator_state_round_trips():
    gen = torch.Generator().manual_seed(1234)
    torch.rand(17, generator=gen)
    packed = pack_rng_key(gen)
    assert json.loads(json.dumps(packed)) == packed
    want = torch.rand(64, generator=gen)
    restored = unpack_rng_key(packed, torch.Generator().manual_seed(0))
    assert torch.equal(torch.rand(64, generator=restored), want)


# ------------------------------------------------- the TrainLoader cursor

SEQ = 16


@pytest.fixture
def tokens(tmp_path):
    rng = np.random.default_rng(0)
    docs = [rng.integers(2, 128, int(n)).tolist()
            for n in rng.integers(4, SEQ + 1, 40)]
    path = str(tmp_path / "tokens")
    create_text_token_dataset(path, docs, seq_len=SEQ, pack=False,
                              fragment_size=7)
    return Dataset(path)


class _Counting:
    def __init__(self, decode):
        self.decode = decode
        self.calls = 0

    def __call__(self, table):
        self.calls += 1
        return self.decode(table)


def _loader(dataset, decode, epoch=1):
    return make_train_pipeline(dataset, "batch", 4, 0, 1, decode, "cpu",
                               prefetch=3, shuffle=True, seed=5, epoch=epoch)


@pytest.mark.parametrize("k", [0, 3, 9, 10])
def test_loader_cursor_resumes_at_batch_k_without_decoding_the_skipped(
        tokens, k):
    decode = decoder_for_task("masked_lm", seq_len=SEQ)
    full = list(_loader(tokens, decode))
    assert len(full) == 10
    counting = _Counting(decode)
    loader = _loader(tokens, counting)
    loader.load_state_dict({"epoch": 1, "step": k})
    assert loader.state_dict() == {"epoch": 1, "step": k}
    tail = list(loader)
    assert counting.calls == len(full) - k == len(tail)
    for got, want in zip(tail, full[k:]):
        assert sorted(got) == sorted(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert loader.state_dict() == {"epoch": 1, "step": len(full)}


def test_loader_cursor_counts_batches_handed_out_not_prefetched(tokens):
    loader = _loader(tokens, decoder_for_task("masked_lm", seq_len=SEQ))
    it = iter(loader)
    next(it)
    next(it)
    # The producer has decoded ahead (prefetch 3); the cursor names the
    # next batch the consumer will get.
    assert loader.state_dict() == {"epoch": 1, "step": 2}
    it.close()
    with pytest.raises(ValueError, match="negative resume cursor"):
        loader.load_state_dict({"epoch": 1, "step": -1})
    with pytest.raises(ValueError, match="epoch 0"):
        loader.load_state_dict({"epoch": 0, "step": 1})


# ------------------------------------------ signals, chaos, batch digest


def test_preemption_handler_request_and_sigterm_restore_disposition():
    before = signal.getsignal(signal.SIGTERM)
    handler = PreemptionHandler()
    handler.request()
    handler.request()
    assert handler.requested and handler.requests == 1
    real = PreemptionHandler().install()
    try:
        assert real.installed and not real.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert real.requested
    finally:
        real.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    real.uninstall()  # idempotent


@pytest.mark.parametrize("spec", ["drain@6", "sigkill@7", " SIGTERM @3",
                                  "drain@1", None, "", "sigkill", "drain@x",
                                  "explode@3", "drain@0", "drain@-2"])
def test_chaos_spec_parses_as_jax(spec):
    env = {} if spec is None else {chaos.CHAOS_ENV: spec}
    try:
        want = jax_chaos.TrainerChaos.from_env(env)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            chaos.TrainerChaos.from_env(env)
        assert str(got.value) == str(exc)
        return
    got = chaos.TrainerChaos.from_env(env)
    if want is None:
        assert got is None
        return
    assert (got.action, got.at_step) == (want.action, want.at_step)
    fired = []
    got.drain_cb = lambda: fired.append(True)
    if got.action == "drain":
        got.on_step(got.at_step - 1)
        assert not fired
        got.on_step(got.at_step)
        got.on_step(got.at_step + 1)  # one-shot
        assert fired == [True]


def test_batch_digest_equals_jax():
    rng = np.random.default_rng(2)
    batch = {"input_ids": rng.integers(0, 500, (4, 16)).astype(np.int32),
             "attention_mask": (rng.random((4, 16)) < 0.8).astype(np.int8),
             "image": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
             "_weight": np.array([1.0, 0.0], np.float32)}
    want = jax_chaos.batch_digest(batch)
    assert chaos.batch_digest(batch) == want
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert chaos.batch_digest(tensors) == want
    assert chaos.batch_digest(batch["image"]) == jax_chaos.batch_digest(
        batch["image"])
    tensors["input_ids"] = tensors["input_ids"].long()
    assert chaos.batch_digest(tensors) != want  # the dtype is hashed


def test_step_trace_records_and_reads_back(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    trace = chaos.StepTrace.from_env({chaos.TRACE_ENV: path})
    batch = {"x": torch.arange(4)}
    trace.record(3, 0, batch, torch.tensor(1.25))
    trace.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"step": 4, "ep')  # the torn line a SIGKILL leaves
    records = chaos.read_trace(path)
    assert records == jax_chaos.read_trace(path) == [{
        "step": 3, "epoch": 0, "batch_sha256": chaos.batch_digest(batch),
        "loss": 1.25}]
    assert chaos.StepTrace.from_env({}) is None
