"""Runtime lock-order sanitizer — the witness half of LDT1001.

A copy of ``lance_distributed_training_tpu/utils/lockorder.py`` for the
port, with the same witness format. Three differences: its default scope
is the port's package; :func:`install` chains, so that a lock created
outside the port's scope goes to the factory installed before this one
(the JAX package's shim, when a test run installed it first) with its
caller's own site, not to a raw lock that would blind the other shim; and
:func:`install_from_env` (called at the top of the port's ``__init__``
under ``LDT_LOCK_SANITIZER=1``, before any port module makes a lock)
installs it and dumps the witness at interpreter exit, to
``lock-witness-torch.json`` unless ``LDT_LOCK_WITNESS_PATH`` says
otherwise.

The static lock model (``analysis/concmodel.py``) infers "lock B acquired
while lock A is held" from the AST. Static inference has two failure
modes: it can miss an ordering that only materialises through a code path
it cannot resolve, and it can report a cycle whose edges never co-occur at
runtime. This module closes both gaps with evidence: an opt-in
(``LDT_LOCK_SANITIZER=1``) shim that replaces ``threading.Lock``/``RLock``
with instrumented wrappers for locks *created inside this package*, records
every observed acquisition ordering (src held → dst acquired) keyed by the
locks' creation sites, and dumps a witness JSON the analyzer cross-checks
with ``ldt check --lock-witness <path>``:

* a static cycle whose every edge was observed is *reproduced*, not
  inferred — the finding says so;
* a static cycle with an edge that never happened, although both locks
  demonstrably were exercised, is marked ``witness_pruned`` (rendered,
  not failing).

Scope discipline: the factory inspects its caller's frame at construction
time (one stack hop — construction is rare, per-object) and hands back a
**raw** stdlib lock for any caller outside the configured scope, so jax /
orbax / stdlib internals pay nothing and see the exact objects they
expect. Acquire overhead inside the scope is a thread-local list append
plus a dict update under the recorder's own plain lock — measurable but
harmless at test-suite scale, which is exactly where the witness is
collected (``scripts/ci.sh`` runs tier-1 under the sanitizer, then feeds
the witness back into the gate).

Stdlib-only, no package imports: the analyzer may load the witness in an
environment where the training package itself cannot import.

Attribution quirk worth knowing: a C/Cython extension that creates a
Python-level lock (numpy's ``default_rng`` BitGenerator does) has no
Python frame of its own, so the creation attributes to the nearest
in-package Python caller — e.g. a ``samplers.py`` line "creating" numpy's
RNG lock. Such sites match no static lock identity and are simply inert
in the ``--lock-witness`` cross-check; they still document real
held-while-allocating behavior in the raw witness.

Knobs::

    LDT_LOCK_SANITIZER=1      # the port's __init__ installs the shim
    LDT_LOCK_WITNESS_PATH=…   # dump target (default ./lock-witness-torch.json)
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import _thread
from typing import Dict, List, Optional, Tuple

__all__ = [
    "InstrumentedLock",
    "install",
    "install_from_env",
    "uninstall",
    "installed",
    "reset",
    "snapshot",
    "restore",
    "edges",
    "dump",
    "ENV_FLAG",
    "ENV_PATH",
]

ENV_FLAG = "LDT_LOCK_SANITIZER"
ENV_PATH = "LDT_LOCK_WITNESS_PATH"
DEFAULT_WITNESS_PATH = "lock-witness-torch.json"

# The package root: locks created under it are instrumented by default.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REAL_LOCK = _thread.allocate_lock
# The stdlib's own RLock, even when another shim has replaced
# threading.RLock already.
_REAL_RLOCK = getattr(threading, "_CRLock", None) or threading._PyRLock

# Recorder state. The meta-lock is a RAW lock (never instrumented — the
# sanitizer must not observe, or deadlock on, itself); critical sections
# are dict updates only, never I/O.
_state_lock = _REAL_LOCK()
_edges: Dict[Tuple[str, str], int] = {}
_acquired: Dict[str, int] = {}
_tls = threading.local()


def _held_stack() -> List["InstrumentedLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = []
        _tls.stack = stack
    return stack


class InstrumentedLock:
    """A ``threading.Lock``/``RLock`` stand-in that records acquisition
    order. ``site`` is the creation point (``abspath:lineno``) — the join
    key the static model's lock identities map onto."""

    __slots__ = ("site", "reentrant", "_real")

    def __init__(self, site: str, reentrant: bool = False):
        self.site = site
        self.reentrant = reentrant
        self._real = _REAL_RLOCK() if reentrant else _REAL_LOCK()

    def _record_acquire(self) -> None:
        stack = _held_stack()
        new_edges = []
        for held in stack:
            if held is self and self.reentrant:
                continue  # legal re-entry: not an ordering event
            new_edges.append((held.site, self.site))
        with _state_lock:
            _acquired[self.site] = _acquired.get(self.site, 0) + 1
            for edge in new_edges:
                _edges[edge] = _edges.get(edge, 0) + 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Record BEFORE blocking: the ordering attempt is the event —
        # a deadlock would otherwise suppress its own evidence.
        self._record_acquire()
        got = self._real.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        stack = _held_stack()
        # Remove the most recent occurrence (locks may release out of
        # acquisition order; list.remove from the tail keeps it cheap).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"<InstrumentedLock {kind} {self.site}>"


def _caller_site(depth: int = 2) -> Tuple[str, int]:
    frame = sys._getframe(depth)
    return frame.f_code.co_filename, frame.f_lineno


_scope: Tuple[str, ...] = ()
_installed = False
# The factories threading.Lock/RLock held when install() ran: the next
# link of the chain for callers outside this shim's scope.
_prev_lock = _REAL_LOCK
_prev_rlock = _REAL_RLOCK
_atexit_registered = False


def _in_scope(filename: str) -> bool:
    return any(filename.startswith(prefix) for prefix in _scope)


def _chained(factory, reentrant: bool, filename: str, lineno: int):
    """A lock from ``factory`` on behalf of the caller at
    ``filename:lineno``. A lockorder-shaped shim (its module has
    ``_in_scope`` and ``InstrumentedLock``: the JAX package's, or this
    module) judges the caller's own site, since calling its factory from
    here would make this frame the caller; anything else is called."""
    g = getattr(factory, "__globals__", None) or {}
    in_scope, cls = g.get("_in_scope"), g.get("InstrumentedLock")
    if not (callable(in_scope) and cls is not None):
        return factory()
    if in_scope(filename):
        return cls(f"{filename}:{lineno}", reentrant=reentrant)
    nxt = g.get("_prev_rlock" if reentrant else "_prev_lock")
    if nxt is None or nxt is factory:
        return g["_REAL_RLOCK" if reentrant else "_REAL_LOCK"]()
    return _chained(nxt, reentrant, filename, lineno)


def _lock_factory():
    filename, lineno = _caller_site()
    if not _in_scope(filename):
        return _chained(_prev_lock, False, filename, lineno)
    return InstrumentedLock(f"{filename}:{lineno}", reentrant=False)


def _rlock_factory():
    filename, lineno = _caller_site()
    if not _in_scope(filename):
        return _chained(_prev_rlock, True, filename, lineno)
    return InstrumentedLock(f"{filename}:{lineno}", reentrant=True)


def install(scope: Optional[List[str]] = None) -> None:
    """Monkeypatch ``threading.Lock``/``RLock`` with the recording
    factories. ``scope`` is a list of path prefixes whose lock *creations*
    get instrumented (default: this package). Install EARLY — objects
    constructed before it keep their raw locks and stay invisible.
    Creations outside the scope go to the factories installed before this
    one (:func:`_chained`)."""
    global _scope, _installed, _prev_lock, _prev_rlock
    _scope = tuple(os.path.abspath(p) for p in (scope or [_PKG_ROOT]))
    if threading.Lock is not _lock_factory:
        _prev_lock = threading.Lock
    if threading.RLock is not _rlock_factory:
        _prev_rlock = threading.RLock
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def uninstall() -> None:
    """Hand ``threading.Lock``/``RLock`` back to the factories installed
    before this shim."""
    global _installed
    if threading.Lock is _lock_factory:
        threading.Lock = _prev_lock
    if threading.RLock is _rlock_factory:
        threading.RLock = _prev_rlock
    _installed = False


def _dump_at_exit() -> None:
    try:
        path = dump()
    except OSError as exc:
        sys.stderr.write(f"[lockorder] witness not written: {exc}\n")
        return
    sys.stderr.write(f"[lockorder] witness written to {path}\n")


def install_from_env() -> bool:
    """Under ``LDT_LOCK_SANITIZER=1``: install the shim (once) and dump
    the witness at interpreter exit. Returns whether it is installed."""
    global _atexit_registered
    if os.environ.get(ENV_FLAG) != "1":
        return False
    if not _installed:
        install()
    if not _atexit_registered:
        atexit.register(_dump_at_exit)
        _atexit_registered = True
    return True


def installed() -> bool:
    return _installed


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _acquired.clear()


def snapshot() -> dict:
    """Recorder + shim state, for tests that must exercise
    install/uninstall/reset without clobbering a session-level sanitizer
    (tier-1 runs under ``LDT_LOCK_SANITIZER=1`` collect a witness ACROSS
    the whole suite — a unit test wiping it would silently gut the CI
    cross-check stage)."""
    with _state_lock:
        return {
            "edges": dict(_edges),
            "acquired": dict(_acquired),
            "installed": _installed,
            "scope": _scope,
        }


def restore(state: dict) -> None:
    with _state_lock:
        _edges.clear()
        _edges.update(state["edges"])
        _acquired.clear()
        _acquired.update(state["acquired"])
    if state["installed"]:
        install(list(state["scope"]))
    else:
        uninstall()


def edges() -> Dict[Tuple[str, str], int]:
    with _state_lock:
        return dict(_edges)


def dump(path: Optional[str] = None) -> str:
    """Write the witness JSON (atomically — the CI stage feeds it straight
    into ``ldt check --lock-witness``, and a torn file must fail loudly as
    absent, not parse as an empty witness). Returns the path written."""
    path = path or os.environ.get(ENV_PATH) or DEFAULT_WITNESS_PATH
    with _state_lock:
        edge_list = [
            {"src": src, "dst": dst, "count": count}
            for (src, dst), count in sorted(_edges.items())
        ]
        acquired = dict(sorted(_acquired.items()))
    payload = {
        "version": 1,
        "edges": edge_list,
        "acquired": acquired,
    }
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-witness-")
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
