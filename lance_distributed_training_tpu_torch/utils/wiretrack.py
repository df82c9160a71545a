"""Runtime wire-traffic sanitizer — the witness half of LDT1403.

A copy of ``lance_distributed_training_tpu/utils/wiretrack.py`` for the
port; its witness files read the same under either package. Under the flag
this module dumps its own witness at interpreter exit (``atexit``), to
``wire-witness-torch.json`` unless ``LDT_WIRE_WITNESS_PATH`` says
otherwise, so that it never overwrites the JAX package's
``wire-witness.json``.

The static protocol model (``analysis/protomodel.py``) infers each
message's payload schema from the AST: who writes a field, who reads it.
Like the lock and lease models it has a blind side — a writer routed
through a construct it cannot resolve, or a peer outside the scanned tree.
This module closes the gap with evidence: an opt-in
(``LDT_WIRE_SANITIZER=1``) recorder the protocol module calls on every
control frame sent or received, counting which ``(msg_type, field)``
tuples — and which negotiated versions — actually crossed the loopback
wire. At process exit the recorder dumps a witness JSON (its own ``atexit``
hook, mirroring the lock/leak witnesses) that
``ldt check --wire-witness <path>`` cross-checks:

* a static LDT1403 orphan-read whose ``(msg, field)`` tuple the run
  observed on the wire is ``witness_pruned`` — a writer exists outside
  the static model's view (rendered, not failing, never baselined);
* one whose message WAS exercised while the field never appeared is
  upgraded to *reproduced* — a demonstrably dead read;
* messages the run never carried prove nothing and change nothing — the
  same strict-evidence discipline as the other sanitizers.

The recorder is deliberately dumb and cheap: dict counter bumps under one
raw lock, no I/O until :func:`dump`. The hooks are two-line
``if wiretrack.enabled():`` guards in ``service/protocol.py``'s
``send_msg``/``recv_msg``/``FrameReader.recv_msg`` — cold by default,
harmless at test-suite scale, which is exactly where the witness is
collected (``scripts/ci.sh`` runs tier-1 under the sanitizer and feeds
the witness back into the gate). Batch frames (binary payloads) count as
frames only; field tracking applies to the JSON control schema.

Stdlib-only, no package imports: the analyzer side only ever READS the
JSON this writes, and must do so even when the training package cannot
import.

Knobs::

    LDT_WIRE_SANITIZER=1      # the protocol hooks start recording
    LDT_WIRE_WITNESS_PATH=…   # dump target (default ./wire-witness-torch.json)
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import _thread
from typing import Dict, Optional, Set

__all__ = [
    "enabled",
    "enable",
    "disable",
    "record_frame",
    "frames",
    "fields",
    "reset",
    "snapshot",
    "restore",
    "dump",
    "ENV_FLAG",
    "ENV_PATH",
]

ENV_FLAG = "LDT_WIRE_SANITIZER"
ENV_PATH = "LDT_WIRE_WITNESS_PATH"
DEFAULT_WITNESS_PATH = "wire-witness-torch.json"

# Recorder state under a RAW lock (never the lock sanitizer's shim);
# critical sections are counter bumps only, never I/O.
_state_lock = _thread.allocate_lock()
_frames: Dict[int, int] = {}  # msg_type -> frame count
_fields: Dict[int, Dict[str, int]] = {}  # msg_type -> field -> count
_versions: Dict[int, Set[int]] = {}  # msg_type -> version values seen
_enabled = os.environ.get(ENV_FLAG) == "1"


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the recorder on in-process (tests; production opts in via the
    env flag so every process in a loopback pair inherits it)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def record_frame(msg_type: int, payload: Optional[dict]) -> None:
    """Count one frame. ``payload`` is the JSON control dict (both
    directions record — the witness cares about presence on the wire, not
    which end counted it) or ``None`` for binary/batch frames."""
    version = None
    keys = ()
    if isinstance(payload, dict):
        keys = tuple(payload.keys())
        v = payload.get("version")
        if isinstance(v, int) and not isinstance(v, bool):
            version = v
    with _state_lock:
        _frames[msg_type] = _frames.get(msg_type, 0) + 1
        if keys:
            per = _fields.setdefault(msg_type, {})
            for key in keys:
                per[key] = per.get(key, 0) + 1
        if version is not None:
            _versions.setdefault(msg_type, set()).add(version)


def frames() -> Dict[int, int]:
    with _state_lock:
        return dict(_frames)


def fields() -> Dict[int, Dict[str, int]]:
    with _state_lock:
        return {k: dict(v) for k, v in _fields.items()}


def reset() -> None:
    with _state_lock:
        _frames.clear()
        _fields.clear()
        _versions.clear()


def snapshot() -> dict:
    """Recorder state, for tests that enable/reset without clobbering a
    session-level sanitizer (tier-1 under ``LDT_WIRE_SANITIZER=1``
    collects its witness ACROSS the suite — same discipline as the
    lockorder/leaktrack snapshots)."""
    with _state_lock:
        return {
            "frames": dict(_frames),
            "fields": {k: dict(v) for k, v in _fields.items()},
            "versions": {k: set(v) for k, v in _versions.items()},
            "enabled": _enabled,
        }


def restore(state: dict) -> None:
    global _enabled
    with _state_lock:
        _frames.clear()
        _frames.update(state["frames"])
        _fields.clear()
        _fields.update({k: dict(v) for k, v in state["fields"].items()})
        _versions.clear()
        _versions.update(
            {k: set(v) for k, v in state["versions"].items()}
        )
    _enabled = state["enabled"]


def dump(path: Optional[str] = None) -> str:
    """Write the witness JSON (atomically — the CI stage feeds it straight
    into ``ldt check --wire-witness``, and a torn file must fail loudly as
    absent, not parse as an empty witness). Returns the path written."""
    path = path or os.environ.get(ENV_PATH) or DEFAULT_WITNESS_PATH
    with _state_lock:
        payload = {
            "version": 1,
            "frames": {str(k): v for k, v in sorted(_frames.items())},
            "fields": {
                str(k): dict(sorted(v.items()))
                for k, v in sorted(_fields.items())
            },
            "versions": {
                str(k): sorted(v) for k, v in sorted(_versions.items())
            },
        }
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-wirewitness-")
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
        sys.stderr.write(f"[wiretrack] witness not written: {exc}\n")
        return
    sys.stderr.write(f"[wiretrack] witness written to {path}\n")


if _enabled:
    atexit.register(_dump_at_exit)
