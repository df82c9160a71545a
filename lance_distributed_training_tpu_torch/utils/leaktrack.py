"""Runtime resource-lease sanitizer — the witness half of LDT1201.

A copy of ``lance_distributed_training_tpu/utils/leaktrack.py`` for the
port (which imports nothing of the JAX package): the same hooks, keys and
witness format, called by the port's buffer pool, shm ring, workers and
batch cache. The analyzer the text below names is the port's copy
(``analysis/ownermodel.py``, ``python -m lance_distributed_training_tpu_torch.cli
check --leak-witness``). Under the flag this module dumps its own witness
at interpreter exit (``atexit``), to ``leak-witness-torch.json`` unless
``LDT_LEAK_WITNESS_PATH`` says otherwise, so that it never overwrites the
JAX package's ``leak-witness.json``.

The static ownership model (``analysis/ownermodel.py``) infers "this
acquire site has an exit path that never releases" from the AST. Like the
lock model it has two failure modes: paths it cannot see (a release
routed through a container, a C extension) and paths that never happen.
This module closes both with evidence: an opt-in (``LDT_LEAK_SANITIZER=1``)
recorder the buffer plane calls on every :class:`BufferPool` page lease /
release and every shm slot-token handoff, keyed by the *acquire call
site* (``abspath:lineno`` of the caller — the join key the static acquire
records map onto) with a creation-site traceback per outstanding handle.
At process exit the recorder dumps a witness JSON (its own ``atexit``
hook, mirroring the lock witness) that ``ldt check --leak-witness <path>``
cross-checks:

* a static LDT1201 leak whose acquire site shows leaked handles at exit
  is *reproduced* — the finding says so, with the count;
* one whose site was exercised and every acquisition released is marked
  ``witness_pruned`` (rendered, not failing, never baselined);
* sites the run never touched prove nothing and change nothing — the
  same strict-evidence discipline as ``utils/lockorder.py``.

The recorder is deliberately dumb and cheap: a dict update under one raw
lock per acquire/release, no I/O until :func:`dump`. Hooks are two-line
``if leaktrack.enabled():`` guards in ``data/buffers.py`` /
``data/workers.py`` — cold by default, measurable-but-harmless at
test-suite scale, which is exactly where the witness is collected
(``scripts/ci.sh`` runs tier-1 under the sanitizer, then feeds the
witness back into the gate).

Attribution quirk worth knowing (the lock witness has its twin): shm
slot tokens are acquired in WORKER processes (``ShmSlotWriter._acquire``
— the static model's acquire site) but the parent-side custody this
recorder sees starts where the descriptor lands (``WorkerPool._unwrap``).
Those runtime sites match no static acquire record and are simply inert
in the ``--leak-witness`` cross-check — they still document real token
custody (a site with ``leaked > 0`` is a genuinely lost slot), they just
never corroborate or prune a static finding. Pool-page and socket sites
join exactly.

Stdlib-only, no package imports: the analyzer side only ever READS the
JSON this writes, and must do so even when the training package cannot
import.

Knobs::

    LDT_LEAK_SANITIZER=1      # the data plane's hooks start recording
    LDT_LEAK_WITNESS_PATH=…   # dump target (default ./leak-witness-torch.json)
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import traceback
import _thread
from typing import Dict, List, Optional, Tuple

__all__ = [
    "enabled",
    "enable",
    "disable",
    "track_acquire",
    "track_release",
    "track_dropped",
    "outstanding",
    "sites",
    "reset",
    "snapshot",
    "restore",
    "dump",
    "ENV_FLAG",
    "ENV_PATH",
]

ENV_FLAG = "LDT_LEAK_SANITIZER"
ENV_PATH = "LDT_LEAK_WITNESS_PATH"
DEFAULT_WITNESS_PATH = "leak-witness-torch.json"

# Recorder state. A RAW lock (the sanitizer must never observe itself
# through the lock sanitizer's shim); critical sections are dict updates
# only, never I/O.
_state_lock = _thread.allocate_lock()
# (kind, key) -> (site, [traceback lines])
_outstanding: Dict[Tuple[str, object], Tuple[str, List[str]]] = {}
# site -> [acquired, released, leaked] (leaked = dropped without release;
# handles still outstanding at dump time are added on top, read-only).
_sites: Dict[str, List[int]] = {}
# Evaluated once per process: hooks are two attribute reads when off.
_enabled = os.environ.get(ENV_FLAG) == "1"


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the recorder on in-process (tests; production opts in via the
    env flag so spawned workers inherit it)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _caller_site(depth: int) -> str:
    frame = sys._getframe(depth)
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


def track_acquire(kind: str, key: object, depth: int = 2) -> None:
    """Record one acquisition. ``key`` must identify the handle until its
    release (``id(obj)`` for pool pages — the pool pops the entry before
    the id can be reused; ``(session, slot, gen)`` for shm tokens).
    ``depth`` names the frame whose line is the acquire site: 2 = the
    current line of the function invoking this hook, 3 = that function's
    caller (``BufferPool.lease`` passes 3 so the site is the ``.lease(``
    call line in user code — exactly the static model's acquire record)."""
    site = _caller_site(depth)
    tb = traceback.format_stack(sys._getframe(depth), limit=8)
    with _state_lock:
        _outstanding[(kind, key)] = (site, tb)
        _sites.setdefault(site, [0, 0, 0])[0] += 1


def track_release(kind: str, key: object) -> bool:
    """Record a matched release (attributed to the handle's ACQUIRE site —
    the leak verdict is per acquire site). Returns False for unknown
    handles: foreign objects blanket-released, or acquisitions made
    before the recorder was enabled — never an error."""
    with _state_lock:
        entry = _outstanding.pop((kind, key), None)
        if entry is None:
            return False
        _sites.setdefault(entry[0], [0, 0, 0])[1] += 1
    return True


def track_dropped(kind: str, key: object) -> bool:
    """Record a handle garbage-collected WITHOUT release — the leak event
    itself, caught live (the BufferPool's weakref callback routes here)."""
    with _state_lock:
        entry = _outstanding.pop((kind, key), None)
        if entry is None:
            return False
        _sites.setdefault(entry[0], [0, 0, 0])[2] += 1
    return True


def outstanding() -> int:
    with _state_lock:
        return len(_outstanding)


def sites() -> Dict[str, dict]:
    """Per-site counters as the witness schema reports them (handles still
    outstanding count as leaked: at dump time nothing will release them)."""
    with _state_lock:
        live: Dict[str, int] = {}
        for (kind, key), (site, _tb) in _outstanding.items():
            live[site] = live.get(site, 0) + 1
        return {
            site: {
                "acquired": acq,
                "released": rel,
                "leaked": leaked + live.get(site, 0),
            }
            for site, (acq, rel, leaked) in _sites.items()
        }


def reset() -> None:
    with _state_lock:
        _outstanding.clear()
        _sites.clear()


def snapshot() -> dict:
    """Recorder state, for tests that enable/reset without clobbering a
    session-level sanitizer (tier-1 under ``LDT_LEAK_SANITIZER=1``
    collects its witness ACROSS the suite — same discipline as
    ``lockorder.snapshot``)."""
    with _state_lock:
        return {
            "outstanding": dict(_outstanding),
            "sites": {k: list(v) for k, v in _sites.items()},
            "enabled": _enabled,
        }


def restore(state: dict) -> None:
    global _enabled
    with _state_lock:
        _outstanding.clear()
        _outstanding.update(state["outstanding"])
        _sites.clear()
        _sites.update({k: list(v) for k, v in state["sites"].items()})
    _enabled = state["enabled"]


def dump(path: Optional[str] = None) -> str:
    """Write the witness JSON (atomically — the CI stage feeds it straight
    into ``ldt check --leak-witness``, and a torn file must fail loudly as
    absent, not parse as an empty witness). Returns the path written."""
    path = path or os.environ.get(ENV_PATH) or DEFAULT_WITNESS_PATH
    with _state_lock:
        leaked = [
            {
                "kind": kind,
                "site": site,
                "traceback": [line.rstrip("\n") for line in tb],
            }
            for (kind, _key), (site, tb) in sorted(
                _outstanding.items(), key=lambda kv: kv[1][0]
            )
        ]
    payload = {
        "version": 1,
        "sites": dict(sorted(sites().items())),
        "leaked": leaked,
    }
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-leakwitness-")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _dump_at_exit() -> None:
    try:
        path = dump()
    except OSError as exc:
        sys.stderr.write(f"[leaktrack] witness not written: {exc}\n")
        return
    sys.stderr.write(f"[leaktrack] witness written to {path}\n")


if _enabled:
    atexit.register(_dump_at_exit)
