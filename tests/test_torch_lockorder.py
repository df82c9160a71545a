"""The port's lock-order sanitizer: JAX's witness schema, and a shim that
chains with the JAX package's.

Each test snapshots both recorders and restores them, so a sanitized run
(``LDT_LOCK_SANITIZER=1``) keeps its witness.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from lance_distributed_training_tpu.analysis.cli import load_lock_witness
from lance_distributed_training_tpu.utils import lockorder as jax_lockorder
from lance_distributed_training_tpu_torch.utils import lockorder
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_PKG = ROOT / "lance_distributed_training_tpu_torch"
JAX_PKG = ROOT / "lance_distributed_training_tpu"


@pytest.fixture()
def shims():
    """Both shims' state saved, threading's factories restored after."""
    saved = (jax_lockorder.snapshot(), lockorder.snapshot(),
             threading.Lock, threading.RLock)
    lockorder.uninstall()
    jax_lockorder.uninstall()
    lockorder.reset()
    jax_lockorder.reset()
    yield
    jax_state, port_state, lock, rlock = saved
    threading.Lock, threading.RLock = lock, rlock
    for mod, state in ((jax_lockorder, jax_state), (lockorder, port_state)):
        with mod._state_lock:
            mod._edges.clear()
            mod._edges.update(state["edges"])
            mod._acquired.clear()
            mod._acquired.update(state["acquired"])
        mod._scope = state["scope"]
        mod._installed = state["installed"]


def _make_locks_at(path: Path, line_count: int = 1) -> dict:
    """Create a Lock and an RLock from code whose filename is ``path``,
    as a module there would."""
    code = compile("a = threading.Lock()\nb = threading.RLock()\n",
                   str(path), "exec")
    scope = {"threading": threading}
    exec(code, scope)
    return scope


def test_the_witness_has_jax_schema_and_jax_loader_reads_it(shims, tmp_path):
    lockorder.install([str(tmp_path)])
    locks = _make_locks_at(tmp_path / "mod.py")
    with locks["a"]:
        with locks["b"]:
            pass
    path = lockorder.dump(str(tmp_path / "w.json"))
    data = json.loads(Path(path).read_text())
    assert set(data) == {"version", "edges", "acquired"}
    assert data["edges"] == [{"src": f"{tmp_path}/mod.py:1",
                              "dst": f"{tmp_path}/mod.py:2", "count": 1}]
    loaded = load_lock_witness(path, str(tmp_path))
    assert loaded == {"edges": {("mod.py:1", "mod.py:2")},
                      "acquired": {"mod.py:1": 1, "mod.py:2": 1}}
    assert lockorder.DEFAULT_WITNESS_PATH != jax_lockorder.DEFAULT_WITNESS_PATH


def test_the_port_shim_chains_with_the_installed_jax_shim(shims, tmp_path):
    jax_lockorder.install()  # JAX's scope: the JAX package
    lockorder.install()      # the port's: the port's package
    port_locks = _make_locks_at(PORT_PKG / "x_lockorder_probe.py")
    jax_locks = _make_locks_at(JAX_PKG / "x_lockorder_probe.py")
    other = _make_locks_at(tmp_path / "elsewhere.py")
    for name, reentrant in (("a", False), ("b", True)):
        mine, theirs = port_locks[name], jax_locks[name]
        assert isinstance(mine, lockorder.InstrumentedLock)
        assert mine.reentrant is reentrant
        # Not a raw lock: JAX's shim saw its own caller's site.
        assert isinstance(theirs, jax_lockorder.InstrumentedLock)
        assert theirs.site == f"{JAX_PKG}/x_lockorder_probe.py:" \
            f"{1 if name == 'a' else 2}"
        assert not isinstance(other[name], (lockorder.InstrumentedLock,
                                            jax_lockorder.InstrumentedLock))
    with jax_locks["a"]:
        with jax_locks["b"]:
            pass
    assert jax_lockorder.edges() and not lockorder.edges()
    # The port's uninstall hands the factories back to JAX's shim.
    lockorder.uninstall()
    assert threading.Lock is jax_lockorder._lock_factory
    assert threading.RLock is jax_lockorder._rlock_factory


def test_nesting_edges_and_rlock_reentry(shims, tmp_path):
    lockorder.install([str(tmp_path)])
    locks = _make_locks_at(tmp_path / "m.py")
    with locks["b"]:
        with locks["b"]:
            with locks["a"]:
                pass
    # An edge from each held occurrence of the RLock, none to itself
    # (JAX's recorder counts the same way).
    assert lockorder.edges() == {
        (f"{tmp_path}/m.py:2", f"{tmp_path}/m.py:1"): 2}


def test_a_sanitized_process_writes_the_port_witness(tmp_path):
    """Under LDT_LOCK_SANITIZER=1 the port installs its shim at import
    and its atexit hook writes lock-witness-torch.json with the port's
    own lock sites."""
    env = dict(os.environ, LDT_LOCK_SANITIZER="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("LDT_LOCK_WITNESS_PATH", None)
    child = (
        "from lance_distributed_training_tpu_torch.data.buffers import "
        "BufferPool\n"
        "import numpy as np\n"
        "pool = BufferPool()\n"
        "page = pool.lease((16,), np.uint8)\n"
        "pool.release(page)\n"
    )
    proc = subprocess.run([sys.executable, "-c", child], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[lockorder] witness written to" in proc.stderr
    data = json.loads((tmp_path / "lock-witness-torch.json").read_text())
    assert not (tmp_path / "lock-witness.json").exists()
    sites = load_lock_witness(str(tmp_path / "lock-witness-torch.json"),
                              str(ROOT))["acquired"]
    assert any(s.startswith(
        "lance_distributed_training_tpu_torch/data/buffers.py:")
        for s in sites), data
