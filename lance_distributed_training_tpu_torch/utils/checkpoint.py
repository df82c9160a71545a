"""Checkpoint / resume — crash-consistent, step-granular, cursor-carrying.

Counterpart of ``lance_distributed_training_tpu/utils/checkpoint.py`` on
``torch.save`` files instead of orbax. A checkpoint is the unit of crash
consistency for the whole training position:

* **train state** — one ``torch.save`` file per step,
  ``<directory>/<step>/state.pt``: whatever the caller hands in (the
  trainer's model ``state_dict`` with its BatchNorm buffers, the
  optimizer's ``state_dict``, the gradient accumulator and its micro-step
  count, the update count), copied off the card at the call (into pinned
  buffers that the next save refills) and written on one background
  thread to a temporary name in the step directory, then
  ``os.replace``\\ d into place;
* **data-plane cursor** — a small JSON sidecar per step,
  ``<directory>/cursors/<step>.json`` (the loader's ``{"epoch", "step"}``,
  the absolute step, the packed generator states), written by
  :func:`atomic_write_json`: it embeds the SHA-256 of its own canonical
  payload and lands by ``tempfile`` + ``os.replace``.

Write ordering is the crash-consistency argument, as in the JAX package:
the sidecar commits BEFORE the state file is written, and the state file
appears under its name only by an atomic rename. A crash at any point
leaves (a) no trace of the step, (b) a sidecar without a state file —
invisible to :meth:`CheckpointManager.restore_latest` and collected by the
next save — or (c) an intact pair. A step is intact only when both files
are present and the sidecar verifies; a state file whose ``torch.load``
raises (a torn file) makes restore fall back to the step before.

The two JSON helpers are byte-for-byte copies of the JAX package's (same
canonical form, same document); ``pack_rng_key``/``unpack_rng_key`` carry a
``torch.Generator``'s state (a CPU generator's Mersenne Twister state, a
CUDA generator's Philox seed and offset) as a list of ints.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional, Tuple

import torch

__all__ = [
    "CheckpointManager",
    "atomic_write_json",
    "read_verified_json",
    "pack_rng_key",
    "unpack_rng_key",
]

_CURSOR_DIR = "cursors"
_STATE_FILE = "state.pt"


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def atomic_write_json(path: str, payload: dict) -> None:
    """Crash-consistent JSON write: content-hashed manifest, tempfile +
    ``os.replace``. A reader either sees the complete verified document or
    the previous one — never a torn write (the LDT901 contract)."""
    doc = {
        "version": 1,
        "sha256": hashlib.sha256(_canonical(payload)).hexdigest(),
        "payload": payload,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=".tmp-manifest-"
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_verified_json(path: str) -> Optional[dict]:
    """The payload of :func:`atomic_write_json`, or ``None`` when the file
    is absent, unparseable, or fails its content hash — corruption reads as
    "not there", never as an exception a restart would die on."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    payload = doc.get("payload")
    digest = doc.get("sha256")
    if not isinstance(payload, dict) or not isinstance(digest, str):
        return None
    if hashlib.sha256(_canonical(payload)).hexdigest() != digest:
        return None
    return payload


def pack_rng_key(generator: torch.Generator) -> list:
    """JSON-portable form of a generator's state: its ``get_state()`` bytes
    as a flat int list. The checkpoint cursor carries this so a resumed run
    continues the exact draw stream (flips, MLM masks) bit for bit."""
    return generator.get_state().tolist()


def unpack_rng_key(packed, generator: torch.Generator) -> torch.Generator:
    """Set ``generator`` to the state :func:`pack_rng_key` returned; returns
    it."""
    generator.set_state(torch.tensor(packed, dtype=torch.uint8))
    return generator


class CheckpointManager:
    """Train-state files + crash-consistent cursors under ``directory``.

    ``save(step, state, cursor)`` persists both; :meth:`restore_latest`
    returns ``(state, cursor, step)`` from the newest *intact* checkpoint,
    skipping corrupt or partial ones. ``save_ms`` holds each save's time on
    the caller's thread (the copy off the card, plus the file write when
    awaited), ``write_ms`` each file write's time on the writer thread, and
    ``last_success_step`` the newest step whose file committed — the JAX
    package's ``ckpt_save_ms`` and ``ckpt_last_success_step``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self.save_ms: list = []
        self.write_ms: list = []
        self.last_success_step: Optional[int] = None
        # Steps proven unrestorable THIS process (a torn state file, which
        # only an actual load detects). A fallback rerun revisits these
        # ids; save() must treat them as stale occupants, never as
        # already-persisted progress.
        self._poisoned: set = set()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        # Pinned host buffers for the card's tensors, by their place in the
        # state, refilled by each save once the previous write is done.
        self._staging: dict = {}

    # -- layout -------------------------------------------------------------

    def _cursor_path(self, step: int) -> str:
        return os.path.join(self.directory, _CURSOR_DIR, f"{int(step)}.json")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def state_path(self, step: int) -> str:
        """The state file of ``step``."""
        return os.path.join(self._step_dir(step), _STATE_FILE)

    def all_steps(self) -> list:
        """Steps whose state file committed, ascending (numeric order)."""
        try:
            names = os.listdir(self.directory)  # ldt: ignore[LDT003] -- the step numbers are sorted below, numerically
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isfile(self.state_path(int(n))))

    def cursor(self, step: int) -> Optional[dict]:
        """The verified cursor payload saved with ``step``, or ``None``."""
        return read_verified_json(self._cursor_path(step))

    def step_intact(self, step: int) -> bool:
        """True when ``step`` is safe to restore: its state file committed
        and its cursor sidecar is present and passes the content hash — the
        cursor and the model state are never un-paired."""
        if step in self._poisoned:
            return False
        if not os.path.isfile(self.state_path(step)):
            return False
        return self.cursor(step) is not None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> Optional[int]:
        """Newest step whose state file committed and whose cursor
        verifies — the restore candidate order."""
        for step in reversed(self.all_steps()):
            if self.step_intact(step):
                return step
        return None

    # -- save ---------------------------------------------------------------

    def wait_until_finished(self) -> None:
        """Await the background write; re-raise its failure here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            exc, self._write_error = self._write_error, None  # ldt: ignore[LDT1002] -- read and cleared only after join() of the writer thread, which orders its write before this
            raise RuntimeError(f"checkpoint write failed: {exc}") from exc

    def _snapshot(self, obj: Any, place: tuple = ()) -> Any:
        """A copy of ``obj`` with every tensor in host memory: the state a
        background write may read while training goes on. Tensors on the
        card are copied into pinned buffers kept from the last save (a
        pageable copy runs at a fraction of the link's rate); the caller
        synchronises before the write reads them."""
        if isinstance(obj, torch.Tensor):
            tensor = obj.detach()
            if tensor.device.type != "cuda":
                return tensor.to("cpu", copy=True)
            buf = self._staging.get(place)
            if (buf is None or buf.shape != tensor.shape
                    or buf.dtype != tensor.dtype):
                buf = torch.empty(tensor.shape, dtype=tensor.dtype,
                                  pin_memory=True)
                self._staging[place] = buf
            return buf.copy_(tensor, non_blocking=True)
        if isinstance(obj, dict):
            return {k: self._snapshot(v, place + (k,))
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, place + (i,))
                             for i, v in enumerate(obj))
        return obj

    def _clear_step(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step))
        try:
            os.unlink(self._cursor_path(step))
        except OSError:
            pass

    def save(self, step: int, state: Any, cursor: dict,
             wait: bool = False) -> bool:
        """Persist ``state`` and ``cursor`` under ``step``. Returns False
        when an INTACT checkpoint already holds the step (an emergency save
        racing a periodic one must not raise). A stale NON-intact occupant
        is deleted and overwritten (raising when it cannot be cleared).

        The state is copied off the card before this returns, so the caller
        may go on training; the file is written on a background thread,
        awaited before the next save, by :meth:`close`, and here when
        ``wait`` (required before process exit: emergency checkpoints)."""
        step = int(step)
        self.wait_until_finished()
        if os.path.isdir(self._step_dir(step)):
            if self.step_intact(step):
                return False
            try:
                self._clear_step(step)
            except OSError as exc:
                # Loud, not False: a benign-looking skip here would let a
                # SIGTERM drain exit 0 having persisted nothing.
                raise RuntimeError(
                    f"cannot clear stale checkpoint step {step}: {exc}"
                ) from exc
        t0 = time.perf_counter()
        # Sidecar FIRST: if we crash before the state file commits, the step
        # never appears in all_steps() and the orphan sidecar is collected;
        # the reverse order could commit model state with no cursor.
        atomic_write_json(self._cursor_path(step), cursor)
        host = self._snapshot(state)
        if self._staging:
            torch.cuda.synchronize()  # the pinned copies have landed
        self._poisoned.discard(step)  # the id now holds fresh content
        self._writer = threading.Thread(
            target=self._write, args=(step, host), daemon=True,
            name="ldt-ckpt-writer")
        self._writer.start()
        if wait:
            self.wait_until_finished()
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        return True

    def _write(self, step: int, host: Any) -> None:
        t0 = time.perf_counter()
        try:
            directory = self._step_dir(step)
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory, prefix="tmp-state-",
                                       suffix=".pt")
            os.close(fd)
            try:
                # A path, not a file object: torch.save then writes from C++
                # without the GIL, where a Python file object would take it
                # for every chunk and stall the training thread.
                torch.save(host, tmp)
                fd = os.open(tmp, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
                os.replace(tmp, self.state_path(step))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.write_ms.append((time.perf_counter() - t0) * 1e3)
            self.last_success_step = step
            self._collect()
        except BaseException as exc:  # handed to the caller's next wait
            self._write_error = exc  # ldt: ignore[LDT1002] -- the writer's last act; the main thread reads it only after join()

    def _collect(self) -> None:
        """Keep the newest ``max_to_keep`` committed steps; drop sidecars
        whose step was collected or never committed (a crash between the
        sidecar write and the state file's rename)."""
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        live = set(steps[-self.max_to_keep:])
        cursor_dir = os.path.join(self.directory, _CURSOR_DIR)
        try:
            entries = sorted(os.listdir(cursor_dir))
        except OSError:
            return
        for name in entries:
            stem, ext = os.path.splitext(name)
            if ext != ".json" or not stem.isdigit():
                continue
            if int(stem) not in live:
                try:
                    os.unlink(os.path.join(cursor_dir, name))
                except OSError:
                    pass

    # -- restore ------------------------------------------------------------

    def restore_latest(self, map_location="cpu"
                       ) -> Optional[Tuple[Any, dict, int]]:
        """``(state, cursor, step)`` from the newest intact checkpoint.

        Walks steps newest-first; a step that fails intactness OR whose
        ``torch.load`` raises (a state file torn by a crash mid-write) is
        skipped in favour of the previous one — a damaged latest checkpoint
        degrades resume granularity, never the restart itself. Returns
        ``None`` when no step restores (fresh start)."""
        self.wait_until_finished()
        for step in reversed(self.all_steps()):
            if not self.step_intact(step):
                continue
            try:
                state = torch.load(self.state_path(step),
                                   map_location=map_location,
                                   weights_only=True)
            except Exception:  # noqa: BLE001 — any torn step must fall back
                # Poison the id: intactness checks cannot see a torn state
                # file, and the rerun will revisit this step — save() must
                # overwrite it, not mistake it for persisted progress.
                self._poisoned.add(step)
                continue
            return state, self.cursor(step), step
        return None

    def close(self) -> None:
        self.wait_until_finished()
