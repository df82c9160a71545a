"""The port's runtime witnesses, written by the port itself.

Under ``LDT_LEAK_SANITIZER=1``, ``LDT_WIRE_SANITIZER=1``,
``LDT_LOCK_SANITIZER=1`` or ``LDT_COMPILE_SANITIZER=1`` a process of the
port dumps its own witness at exit (``*-witness-torch.json``, never the
JAX package's file names), and the JAX loaders read each. A short
sanitized CPU training run gives all three witnesses the port's
``check`` joins (the CPU form of ``chip_smoke.py``'s analysis phase).
Also the one fault of the port that its checker found in
``data/buffers.py`` (LDT1201), repaired.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lance_distributed_training_tpu.analysis.cli import (
    load_compile_witness,
    load_leak_witness,
    load_wire_witness,
)
from lance_distributed_training_tpu_torch.analysis import check_main
from lance_distributed_training_tpu_torch.data import (
    create_synthetic_classification_dataset,
)
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SANITIZERS = ("LDT_LOCK_SANITIZER", "LDT_LEAK_SANITIZER",
              "LDT_WIRE_SANITIZER", "LDT_COMPILE_SANITIZER")


def _env(**flags) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in SANITIZERS and not k.endswith("_WITNESS_PATH")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(flags)
    return env


_LEAK_AND_WIRE = """\
import socket
import numpy as np
from lance_distributed_training_tpu_torch.data.buffers import BufferPool
from lance_distributed_training_tpu_torch.service import protocol as P


def main():
    pool = BufferPool()
    kept = pool.lease((16,), np.uint8)
    pool.release(pool.lease((16,), np.uint8))
    a, b = socket.socketpair()
    P.send_msg(a, P.MSG_HELLO, {"version": P.PROTOCOL_VERSION})
    print(P.recv_msg(b)[0])
    a.close()
    b.close()
    return kept


kept = main()
"""


def test_leak_and_wire_witnesses_are_written_by_the_port(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _LEAK_AND_WIRE], cwd=tmp_path,
        env=_env(LDT_LEAK_SANITIZER="1", LDT_WIRE_SANITIZER="1"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "leak-witness-torch.json", "wire-witness-torch.json"]
    leak = load_leak_witness(str(tmp_path / "leak-witness-torch.json"),
                             str(ROOT))
    assert sum(v["acquired"] for v in leak["sites"].values()) == 2
    assert sum(v["released"] for v in leak["sites"].values()) == 1
    wire = load_wire_witness(str(tmp_path / "wire-witness-torch.json"))
    assert wire["frames"]["1"] >= 1 and "version" in wire["fields"]["1"]


def test_the_ragged_lease_releases_both_pages_when_counting_fails(
        monkeypatch):
    """LDT1201 on port data/buffers.py lease_ragged (JAX
    BufferPool.lease_ragged guards the same step): a failure after both
    pages are leased releases both."""
    from lance_distributed_training_tpu_torch.utils import leaktrack

    pool = BufferPool()

    def boom(*_a, **_k):
        raise RuntimeError("counter down")

    saved = leaktrack.snapshot()
    leaktrack.reset()
    leaktrack.enable()
    try:
        monkeypatch.setattr(pool._ragged_leases, "inc", boom)
        with pytest.raises(RuntimeError, match="counter down"):
            pool.lease_ragged(10, 3, np.int32)
        counts = list(leaktrack.sites().values())
    finally:
        leaktrack.restore(saved)
    assert sum(c["acquired"] for c in counts) == 2
    assert sum(c["released"] for c in counts) == 2
    assert len(pool._outstanding) == 0


def test_a_sanitized_cpu_training_run_gives_witnesses_the_check_joins(
        tmp_path):
    data = tmp_path / "food"
    create_synthetic_classification_dataset(
        str(data), rows=24, num_classes=10, image_size=32, fragment_size=12)
    run = tmp_path / "run"
    run.mkdir()
    argv = [sys.executable, "-m", "lance_distributed_training_tpu_torch.cli",
            "train", "--device", "cpu", "--dataset_path", str(data),
            "--model_name", "resnet18", "--image_size", "32",
            "--num_classes", "10", "--batch_size", "8", "--max_steps", "3",
            "--log_every", "1", "--no_autotune"]
    proc = subprocess.run(
        argv, cwd=run, capture_output=True, text=True, timeout=600,
        env=_env(LDT_COMPILE_SANITIZER="1", LDT_LOCK_SANITIZER="1",
                 LDT_LEAK_SANITIZER="1",
                 LDT_METRICS_PATH=str(tmp_path / "m.jsonl")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    witnesses = {p.name for p in run.iterdir()}
    assert {"compile-witness-torch.json", "lock-witness-torch.json",
            "leak-witness-torch.json"} <= witnesses
    compiles = load_compile_witness(
        str(run / "compile-witness-torch.json"), str(ROOT))
    by_file = {}
    for site, entry in compiles["compiles"].items():
        path, _, line = site.rpartition(":")
        by_file.setdefault(path, {})[line.partition("@")[2]] = entry
    k1 = by_file["lance_distributed_training_tpu_torch/ops/image.py"]
    forward = by_file["lance_distributed_training_tpu_torch/models/resnet.py"]
    # Three train steps, then three eval batches (no flip mask: a new
    # signature there, on the eval line only).
    assert {k: e["calls"] for k, e in k1.items()} == {"": 3, "eval": 3}
    assert k1[""]["post_warmup"] == 0
    assert {k: (e["calls"], e["post_warmup"]) for k, e in forward.items()} \
        == {"": (3, 0)}
    evals = by_file["lance_distributed_training_tpu_torch/trainer.py"]
    assert [e["calls"] for e in evals.values()] == [3]
    d2h = compiles["transfers"]["d2h"]
    assert d2h and all(s.startswith(
        "lance_distributed_training_tpu_torch/trainer.py:") for s in d2h)
    out = io.StringIO()
    rc = check_main([
        "--compile-witness", str(run / "compile-witness-torch.json"),
        "--lock-witness", str(run / "lock-witness-torch.json"),
        "--leak-witness", str(run / "leak-witness-torch.json")], out=out)
    text = out.getvalue()
    assert rc == 0, text
    assert "ldt check: clean" in text
    events = sum(e["count"] for e in d2h.values())
    assert (f"{events} D2H transfer events, {events} D2H at declared sync "
            "funnels") in text
