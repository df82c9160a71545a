"""Deterministic preemption injection for the trainer, and the step trace.

Counterpart of ``lance_distributed_training_tpu/utils/chaos.py``. A chaos
test that kills a run "roughly mid-epoch" can never assert the resume
point, so the preemption is armed at an exact *completed step count* and
fired synchronously from the step loop itself: the k-th completed step is
the k-th hook call, whatever the threads and clocks do.

Three actions, mirroring the real failure shapes:

* ``sigkill`` — preemption without grace: ``os.kill(getpid(), SIGKILL)``
  after exactly N steps. No handler runs, no emergency checkpoint: the
  restart falls back to the newest intact periodic checkpoint.
* ``sigterm`` — orchestrated preemption: SIGTERM to self. The hook runs on
  the main thread, so CPython runs the handler at the next bytecode
  boundary, before the loop polls the ``PreemptionHandler`` flag.
* ``drain`` — the in-process twin of sigterm for tests that must not
  signal the host process: calls the handler's ``request()`` directly.

Armed by ``TrainerChaos.from_env()`` reading ``LDT_CHAOS`` (e.g.
``drain@6``), or in-process.

:class:`StepTrace` is the proof instrument: with ``LDT_STEP_TRACE_PATH``
set, the trainer appends one JSONL record per completed step — absolute
step, epoch, a SHA-256 over the host bytes of the batch the step trained
on (after the transform stage, as the JAX trainer records it; hashed once
for a host batch's echoes) and the loss — so a
preempted-and-resumed run is compared with an uninterrupted control step
for step. Hashing copies the batch to the host and fetches the loss every
step; the trace is a debug and test instrument, never on in production
runs. :func:`batch_digest` hashes numpy arrays and tensors alike (a tensor
is copied to the host first), with the JAX package's byte layout, so both
packages give the same digest for the same batch.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import threading
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "TrainerChaos",
    "StepTrace",
    "batch_digest",
    "read_trace",
    "CHAOS_ENV",
    "TRACE_ENV",
]

CHAOS_ENV = "LDT_CHAOS"
TRACE_ENV = "LDT_STEP_TRACE_PATH"

_ACTIONS = ("sigkill", "sigterm", "drain")


class TrainerChaos:
    """Scripted preemption of THIS training process after exactly
    ``at_step`` completed steps. The trainer calls :meth:`on_step` with its
    this-run completed-step count at each step boundary; the armed action
    fires once, synchronously."""

    def __init__(self, action: str, at_step: int):
        if action not in _ACTIONS:
            raise ValueError(
                f"chaos action must be one of {_ACTIONS}, got {action!r}"
            )
        if at_step < 1:
            raise ValueError(f"chaos step must be >= 1, got {at_step}")
        self.action = action
        self.at_step = int(at_step)
        self.fired = threading.Event()
        # Set by the trainer: the PreemptionHandler.request bound for the
        # drain action.
        self.drain_cb: Optional[Callable[[], None]] = None

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> Optional["TrainerChaos"]:
        """Parse ``LDT_CHAOS=<action>@<step>``; ``None`` when unset. A
        malformed spec raises — a chaos harness silently disarmed would
        make a test pass vacuously."""
        spec = (env if env is not None else os.environ).get(CHAOS_ENV)
        if not spec:
            return None
        action, sep, step = spec.partition("@")
        if not sep or not step.lstrip("-").isdigit():
            raise ValueError(
                f"{CHAOS_ENV}={spec!r}: expected '<action>@<step>', e.g. "
                "'sigkill@7'"
            )
        return cls(action.strip().lower(), int(step))

    def on_step(self, steps_completed: int) -> None:
        """Step-boundary hook. Fires the armed action the first time
        ``steps_completed`` reaches ``at_step``."""
        if self.fired.is_set() or steps_completed < self.at_step:
            return
        self.fired.set()
        if self.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.drain_cb is not None:
            self.drain_cb()


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(leaf))


def batch_digest(batch) -> str:
    """SHA-256 over a batch's host bytes, key-ordered — the bit-identity
    fingerprint resume tests compare across runs. Tensors on the card are
    copied to the host; dict key order is canonicalised."""
    h = hashlib.sha256()
    if isinstance(batch, dict):
        items = sorted(batch.items())
    else:
        items = [("", batch)]
    for key, leaf in items:
        arr = _host_array(leaf)
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class StepTrace:
    """Append-only JSONL of per-step training facts for resume-fidelity
    proofs: ``{"step", "epoch", "batch_sha256", "loss"}`` per completed
    step, flushed line by line so a SIGKILL loses at most the in-flight
    record (appending is crash-safe, which is why this file needs no
    tempfile + replace)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> Optional["StepTrace"]:
        path = (env if env is not None else os.environ).get(TRACE_ENV)
        return cls(path) if path else None

    def record(self, step: int, epoch: int, batch, loss,
               digest: Optional[str] = None) -> None:
        """One step's record; ``digest`` is ``batch_digest(batch)`` when the
        caller already has it (the echoes of one host batch)."""
        self._f.write(json.dumps({
            "step": int(step),
            "epoch": int(epoch),
            "batch_sha256": digest or batch_digest(batch),
            "loss": float(loss),
        }) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_trace(path: str) -> list:
    """Parsed records of a :class:`StepTrace` file; a torn final line (the
    SIGKILL window) is dropped."""
    out = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out
