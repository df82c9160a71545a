"""Golden wire corpus — checked-in frame blobs pinning the protocol.

A copy of ``lance_distributed_training_tpu/service/goldens.py`` for the
port. Both packages read one corpus, ``tests/goldens/protocol/``, and must
reproduce its bytes; the port's ``--update`` refuses that directory and
writes only to an explicit ``--dir``.

Versioned-protocol bugs have a miserable failure shape: both builds pass
their own tests, and the break only appears when a v1 peer meets a v3
peer across a deploy boundary. The static analyzer (LDT1401-1404) pins
the *schema*; this corpus pins the *bytes*: one frame blob per
(protocol version × message × feature variant), from the v1 bare HELLO a
PR-1 build sent through the v3 striped / coefficient-page / lineage /
fingerprint frames the current build speaks, plus the fleet control
plane. The gate (``ldt protocol goldens``, a tier-1 test, and a CI
stage) asserts, for every golden:

* **build identity** — the CURRENT encoders (``protocol.hello``,
  ``send_msg`` framing, ``encode_batch``/``send_batch_frame``) reproduce
  the checked-in bytes exactly. Reordering a constructor's keys, adding a
  field, or touching the framing changes bytes → the gate fails and
  ``ldt protocol goldens --update`` regenerates the corpus as a
  reviewable diff;
* **decode tolerance** — the current build parses every golden, including
  the *legacy* frames (frozen dict literals a v1 build emitted — today's
  constructors cannot produce them, which is the point);
* **re-encode identity** — decoding a golden and re-encoding the result
  through the current send path yields the original bytes, per version
  (control frames: JSON round-trip through ``send_msg``; batch frames:
  ``decode_batch`` → ``encode_batch`` with the decoded lineage).

Frozen wire *prose* rides along: the v1 version-mismatch MSG_ERROR golden
carries the exact ``VERSION_MISMATCH_MARKER`` sentence deployed v1
servers say — rewording the marker breaks this golden before it breaks a
fleet.

Everything here is deterministic by construction (fixed literals, seeded
``np.arange`` tensors, no clocks) — the same bytes on every host, every
run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils import wiretrack
from . import protocol as P

__all__ = [
    "GoldenSpec",
    "GOLDEN_SPECS",
    "build_golden",
    "verify_goldens",
    "write_goldens",
    "goldens_main",
    "DEFAULT_GOLDENS_DIR",
]

# The JAX package's checked-in corpus, shared by both packages: the port
# reads it and writes only to an explicit other directory.
DEFAULT_GOLDENS_DIR = "tests/goldens/protocol"
MANIFEST_NAME = "manifest.json"


class _ByteSink:
    """Socket double capturing exactly the bytes the real send path emits
    (``sendall`` for control frames, vectored ``sendmsg`` for batches)."""

    def __init__(self):
        self.chunks: List[bytes] = []

    def sendall(self, data) -> None:
        self.chunks.append(bytes(data))

    def sendmsg(self, views) -> int:
        total = 0
        for v in views:
            b = bytes(v)
            self.chunks.append(b)
            total += len(b)
        return total

    def value(self) -> bytes:
        return b"".join(self.chunks)


@contextlib.contextmanager
def _no_wiretrack():
    """A :class:`_ByteSink` is not a wire: golden encodes must never feed
    the wire witness (legacy golden literals would otherwise count as
    'observed traffic' and falsely prune LDT1403 dead reads under the
    sanitizer-enabled CI run). Replaying goldens against a REAL socket —
    the live-server acceptance test — records normally, which is the
    correct semantics: that traffic genuinely crossed a wire."""
    was = wiretrack.enabled()
    wiretrack.disable()
    try:
        yield
    finally:
        if was:
            wiretrack.enable()


def _frame(msg_type: int, payload: dict) -> bytes:
    """A control frame exactly as ``send_msg`` puts it on the wire."""
    sink = _ByteSink()
    with _no_wiretrack():
        P.send_msg(sink, msg_type, payload)
    return sink.value()


def _batch_frame(step: int, batch: Dict[str, np.ndarray],
                 lineage: Optional[dict],
                 trace: Optional[dict] = None) -> bytes:
    """A MSG_BATCH frame through the real vectored send path
    (``tensor_views`` + ``send_batch_frame`` — byte-identical to
    ``encode_batch``, which the verify pass pins)."""
    metas, views = P.tensor_views(batch)
    meta = P.encode_batch_meta(step, metas, lineage,
                               ragged=P.ragged_meta(batch), trace=trace)
    sink = _ByteSink()
    P.send_batch_frame(sink, meta, views)
    return sink.value()


def _split_frame(frame: bytes):
    """(msg_type, payload_bytes) out of one length-prefixed frame."""
    if len(frame) < P._HEADER.size:
        raise P.ProtocolError("golden shorter than a frame header")
    length, msg_type = P._HEADER.unpack_from(frame, 0)
    payload = frame[P._HEADER.size:]
    if len(payload) != length:
        raise P.ProtocolError(
            f"golden payload length {len(payload)} != header {length}"
        )
    return msg_type, payload


@dataclasses.dataclass(frozen=True)
class GoldenSpec:
    """One corpus entry. ``build`` produces the frame bytes through the
    CURRENT encoders from fixed inputs; ``legacy`` marks frames today's
    constructors no longer emit (frozen literals asserting decode
    tolerance — build identity still holds because the literal itself is
    frozen here)."""

    name: str
    version: int
    msg: str  # MSG_* constant name
    build: Callable[[], bytes]
    note: str = ""
    legacy: bool = False
    batch: bool = False

    @property
    def filename(self) -> str:
        return f"{self.name}.bin"


def _golden_tensors() -> Dict[str, np.ndarray]:
    """The fixed pixel-batch tensors (seedless: pure ``arange``)."""
    return {
        "image": np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(
            2, 4, 4, 3
        ),
        "label": np.array([3, 7], dtype=np.int64),
    }


def _golden_coeff_tensors() -> Dict[str, np.ndarray]:
    """Fixed coefficient-page tensors in the real device-decode batch
    schema (``data/device_decode.py``): half-decoded DCT blocks + dequant
    tables + geometry, the v3 ``--device_decode`` wire shape."""
    return {
        "jpeg_coef_y": np.arange(1 * 2 * 2 * 64, dtype=np.int16).reshape(
            1, 2, 2, 64
        ),
        "jpeg_coef_cb": np.arange(1 * 1 * 1 * 64, dtype=np.int16).reshape(
            1, 1, 1, 64
        ),
        "jpeg_coef_cr": (
            np.arange(1 * 1 * 1 * 64, dtype=np.int16) * 2
        ).reshape(1, 1, 1, 64),
        "jpeg_quant": np.arange(1 * 3 * 64, dtype=np.int32).reshape(
            1, 3, 64
        ) + 1,
        "jpeg_geom": np.array(
            [[16, 16, 2, 2, 1, 1]], dtype=np.int32
        ),
        "label": np.array([5], dtype=np.int64),
    }


def _golden_ragged_tensors() -> Dict[str, np.ndarray]:
    """Fixed ragged-token tensors in the real token-pack batch schema
    (``data/token_pack.py``): a bucket-padded flat values page, offsets,
    and the FFD pack plan — the v4 ``--token_pack`` wire shape. The meta's
    ``ragged`` field is DERIVED from the key convention by the encoder
    (``protocol.ragged_meta``), which is what the round-trip pins."""
    values = np.zeros(32, dtype=np.int32)
    values[:20] = np.arange(2, 22, dtype=np.int32)
    return {
        "input_ids__values": values,
        "input_ids__offsets": np.array([0, 5, 12, 20], dtype=np.int32),
        "_pack_slot": np.array([0, 0, 1], dtype=np.int32),
        "_pack_start": np.array([8, 0, 0], dtype=np.int32),
        "_host_pack_meta": np.array([2, 16, 20, 0], dtype=np.int32),
    }


_GOLDEN_LINEAGE = {
    "batch_seq": 7,
    "created_ns": 1700000000000000000,
    "decode_ms": 3.25,
    "queue_wait_ms": 0.5,
    "sent_ns": 1700000000100000000,
}

_GOLDEN_LEASE = {
    "generation": 3,
    "stripe_index": 1,
    "stripe_count": 4,
    "fragment_lo": 3,
    "fragment_hi": 6,
}

# Fixed trace context (v5 batch meta field, obs/tracectx.py shape). Real
# ids come from os.urandom; the golden pins the FIELD layout, not entropy.
_GOLDEN_TRACE = {
    "trace_id": "00112233445566778899aabbccddeeff",
    "span_id": "0123456789abcdef",
}

# Fixed mergeable queue-wait histogram (v5 heartbeat field): one count per
# DEFAULT_MS_BUCKETS bound + the +Inf slot (17 entries).
_GOLDEN_HIST = {
    "counts": [0, 0, 1, 4, 9, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "sum": 38.75,
    "count": 18,
}


def _hello_current(**overrides) -> dict:
    """The current constructor with every golden-fixed argument."""
    kwargs = dict(
        batch_size=8,
        process_index=0,
        process_count=1,
        sampler_type="batch",
        shuffle=False,
        seed=7,
        epoch=0,
        start_step=0,
        client_id="golden-client",
    )
    kwargs.update(overrides)
    return P.hello(**kwargs)


# What a PR-1 (v1) build actually sent: no stripe, decode-knob, or
# fingerprint keys existed. FROZEN — today's constructor cannot emit this
# shape, which is exactly the decode-tolerance case the corpus pins.
_V1_BARE_HELLO = {
    "version": 1,
    "batch_size": 8,
    "process_index": 0,
    "process_count": 1,
    "sampler_type": "batch",
    "shuffle": False,
    "seed": 7,
    "epoch": 0,
    "start_step": 0,
    "columns": None,
    "client_id": "golden-client",
    "probe": False,
}


GOLDEN_SPECS: List[GoldenSpec] = [
    # -- v1: the original protocol -----------------------------------------
    GoldenSpec(
        "v1_hello_bare", 1, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _V1_BARE_HELLO),
        note="what a PR-1 build sent; current servers must accept it",
        legacy=True,
    ),
    GoldenSpec(
        "v1_hello_ok", 1, "MSG_HELLO_OK",
        lambda: _frame(P.MSG_HELLO_OK, {
            "version": 1, "num_steps": 15, "start_step": 0,
        }),
        note="v1 server reply (no stripe echo existed)",
        legacy=True,
    ),
    GoldenSpec(
        "v1_error_version_mismatch", 1, "MSG_ERROR",
        lambda: _frame(P.MSG_ERROR, {
            "message": "protocol version mismatch: server 1, client 3",
        }),
        note="FROZEN wire prose — deployed v1 servers say exactly this; "
             "the client downgrade retry keys on the marker",
        legacy=True,
    ),
    GoldenSpec(
        "v1_ack", 1, "MSG_ACK",
        lambda: _frame(P.MSG_ACK, {"step": 41}),
    ),
    GoldenSpec(
        "v1_end", 1, "MSG_END",
        lambda: _frame(P.MSG_END, {}),
    ),
    GoldenSpec(
        "v1_batch_pixels", 1, "MSG_BATCH",
        lambda: _batch_frame(4, _golden_tensors(), None),
        note="lineage-less batch meta (the v1 stream shape)",
        batch=True,
    ),
    # -- v2: lineage --------------------------------------------------------
    GoldenSpec(
        "v2_hello", 2, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(version=2)),
        note="the current constructor offering v2",
    ),
    GoldenSpec(
        "v2_batch_lineage", 2, "MSG_BATCH",
        lambda: _batch_frame(4, _golden_tensors(), dict(_GOLDEN_LINEAGE)),
        note="batch meta carrying the v2 lineage field",
        batch=True,
    ),
    # -- v3: striping, device decode, fingerprints, fleet -------------------
    GoldenSpec(
        "v3_hello_full", 3, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(version=3)),
        note="the current constructor offering v3 (all fields, no "
             "features engaged)",
    ),
    GoldenSpec(
        "v3_hello_striped", 3, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(
            version=3, start_step=8, stripe_index=1, stripe_count=4,
        )),
        note="fleet stripe HELLO (residue class 1 of 4 from step 8)",
    ),
    GoldenSpec(
        "v3_hello_coeff", 3, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(
            version=3, task_type="classification", image_size=224,
            device_decode=True,
        )),
        note="device-decode HELLO (coefficient pages, skew-checked)",
    ),
    GoldenSpec(
        "v3_hello_fingerprint", 3, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(
            version=3, dataset_fingerprint="0123abcd" * 8,
        )),
        note="dataset content-identity HELLO (r13 skew check)",
    ),
    GoldenSpec(
        "v3_hello_ok_striped", 3, "MSG_HELLO_OK",
        lambda: _frame(P.MSG_HELLO_OK, {
            "version": 3, "num_steps": 64, "start_step": 8,
            "stripe_index": 1, "stripe_count": 4,
        }),
        note="current server reply with the stripe echo the balancer "
             "validates",
    ),
    GoldenSpec(
        "v3_batch_coeff", 3, "MSG_BATCH",
        lambda: _batch_frame(
            4, _golden_coeff_tensors(), dict(_GOLDEN_LINEAGE)
        ),
        note="half-decoded coefficient-page batch (device-decode wire "
             "shape)",
        batch=True,
    ),
    # -- v4: the ragged token plane -----------------------------------------
    GoldenSpec(
        "v4_hello_full", 4, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(version=4)),
        note="the v4 HELLO (all fields, no features engaged) — pinned at "
             "version=4 since v5 became the default offer",
    ),
    GoldenSpec(
        "v4_hello_token_pack", 4, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(
            version=4, token_pack=True,
        )),
        note="ragged-plane HELLO: packing requested (honoured only at "
             "TOKEN_PACK_MIN_VERSION+; skew-checked against the server's "
             "serving mode)",
    ),
    GoldenSpec(
        "v4_batch_ragged", 4, "MSG_BATCH",
        lambda: _batch_frame(
            4, _golden_ragged_tensors(), dict(_GOLDEN_LINEAGE)
        ),
        note="ragged token batch: values/offsets pages + pack plan + the "
             "derived meta 'ragged' field (capacity buckets)",
        batch=True,
    ),
    # -- v5: causal tracing + fleet SLO histograms --------------------------
    GoldenSpec(
        "v5_hello_full", 5, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(version=5)),
        note="the v5 HELLO (all fields, no features engaged) — pinned at "
             "version=5 since v6 became the default offer",
    ),
    GoldenSpec(
        "v5_batch_trace", 5, "MSG_BATCH",
        lambda: _batch_frame(
            4, _golden_tensors(), dict(_GOLDEN_LINEAGE),
            trace=dict(_GOLDEN_TRACE),
        ),
        note="batch meta carrying the v5 trace field next to lineage "
             "(omitted for older peers exactly like lineage)",
        batch=True,
    ),
    GoldenSpec(
        "v5_fleet_heartbeat_hist", 5, "MSG_FLEET_HEARTBEAT",
        lambda: _frame(P.MSG_FLEET_HEARTBEAT, {
            "server_id": "golden-server", "generation": 3,
            "pressure": {
                "stall_pct": 12.5, "active_clients": 1,
                "queue_depth": 2.0, "batches_sent": 64,
                "window_s": 2.0,
            },
            "queue_wait_hist": dict(
                _GOLDEN_HIST, counts=list(_GOLDEN_HIST["counts"]),
            ),
        }),
        note="heartbeat carrying the v5 mergeable queue-wait histogram "
             "(bucket counts the coordinator sums into fleet-wide "
             "percentiles; pre-v5 coordinators ignore the key)",
    ),
    # -- v6: the multi-tenant job plane --------------------------------------
    GoldenSpec(
        "v6_hello_full", 6, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current()),
        note="the newest default HELLO: job keys present but null (the "
             "implicit default tenant) — at v6+ the keys always ride, "
             "below v6 they are omitted so v1-v5 frames stay "
             "byte-identical",
    ),
    GoldenSpec(
        "v6_hello_job", 6, "MSG_HELLO",
        lambda: _frame(P.MSG_HELLO, _hello_current(
            job_id="tenant-a", job_priority="inference",
        )),
        note="job-bearing HELLO: explicit tenancy + priority class "
             "(admission-gated, weighted-fair scheduled, per-job cursor)",
    ),
    GoldenSpec(
        "v6_error_admission_refused", 6, "MSG_ERROR",
        lambda: _frame(P.MSG_ERROR, {
            "message": "admission refused: job capacity reached (2/2 "
                       "non-read-only jobs admitted); job 'tenant-c' "
                       "must wait for a slot (--admission_max_jobs)",
        }),
        note="FROZEN wire prose — the ADMISSION_REFUSED_MARKER prefix is "
             "what clients and operators key on to distinguish a refusal "
             "from transport failure",
    ),
    GoldenSpec(
        "v3_fleet_register", 3, "MSG_FLEET_REGISTER",
        lambda: _frame(P.MSG_FLEET_REGISTER, {
            "server_id": "golden-server", "addr": "127.0.0.1:8476",
            "num_fragments": 12,
        }),
    ),
    GoldenSpec(
        "v3_fleet_register_ok", 3, "MSG_FLEET_REGISTER_OK",
        lambda: _frame(P.MSG_FLEET_REGISTER_OK, {
            "generation": 3, "heartbeat_interval_s": 2.0,
            "lease_ttl_s": 6.0, "lease": dict(_GOLDEN_LEASE),
        }),
    ),
    GoldenSpec(
        "v3_fleet_heartbeat", 3, "MSG_FLEET_HEARTBEAT",
        lambda: _frame(P.MSG_FLEET_HEARTBEAT, {
            "server_id": "golden-server", "generation": 3,
            "pressure": {
                "stall_pct": 12.5, "active_clients": 1,
                "queue_depth": 2.0, "batches_sent": 64,
                "window_s": 2.0,
            },
        }),
        note="pressure-carrying heartbeat (r9 autotune fleet half)",
    ),
    GoldenSpec(
        "v3_fleet_heartbeat_ok", 3, "MSG_FLEET_HEARTBEAT_OK",
        lambda: _frame(P.MSG_FLEET_HEARTBEAT_OK, {
            "generation": 4, "lease": dict(_GOLDEN_LEASE, generation=4),
        }),
    ),
    GoldenSpec(
        "v3_fleet_deregister", 3, "MSG_FLEET_DEREGISTER",
        lambda: _frame(P.MSG_FLEET_DEREGISTER, {
            "server_id": "golden-server",
        }),
    ),
    GoldenSpec(
        "v3_fleet_deregister_ok", 3, "MSG_FLEET_DEREGISTER_OK",
        lambda: _frame(P.MSG_FLEET_DEREGISTER_OK, {"generation": 5}),
    ),
    GoldenSpec(
        "v3_fleet_resolve", 3, "MSG_FLEET_RESOLVE",
        lambda: _frame(P.MSG_FLEET_RESOLVE, {}),
    ),
    GoldenSpec(
        "v3_fleet_resolve_ok", 3, "MSG_FLEET_RESOLVE_OK",
        lambda: _frame(P.MSG_FLEET_RESOLVE_OK, {
            "generation": 3, "stripe_count": 2,
            "members": [
                {
                    "server_id": "golden-server",
                    "addr": "127.0.0.1:8476",
                    "stripe_index": 0, "fragment_lo": 0,
                    "fragment_hi": 6, "heartbeat_age_s": 0.5,
                    "acked_generation": 3, "pressure": None,
                },
                {
                    "server_id": "golden-server-2",
                    "addr": "127.0.0.1:8477",
                    "stripe_index": 1, "fragment_lo": 6,
                    "fragment_hi": 12, "heartbeat_age_s": 0.25,
                    "acked_generation": 3, "pressure": None,
                },
            ],
            "recommendation": {
                "action": "ok", "code": 0, "stall_pct": 12.5,
                "reason": "pressure within band",
            },
        }),
    ),
]


def build_golden(spec: GoldenSpec) -> bytes:
    return spec.build()


def _roundtrip_errors(spec: GoldenSpec, data: bytes) -> List[str]:
    """Decode + re-encode identity for one golden's bytes."""
    errors: List[str] = []
    try:
        msg_type, payload = _split_frame(data)
    except P.ProtocolError as exc:
        return [f"{spec.name}: unparseable frame: {exc}"]
    expected_type = getattr(P, spec.msg)
    if msg_type != expected_type:
        errors.append(
            f"{spec.name}: frame type {msg_type}, expected "
            f"{spec.msg}={expected_type}"
        )
        return errors
    if spec.batch:
        try:
            step, batch, lineage, trace = P.decode_batch(
                payload, with_lineage=True, with_trace=True
            )
        except P.ProtocolError as exc:
            return [f"{spec.name}: decode_batch failed: {exc}"]
        sink = _ByteSink()
        P.send_frame(sink, P.MSG_BATCH, P.encode_batch(
            step, batch, lineage, trace=trace
        ))
        if sink.value() != data:
            errors.append(
                f"{spec.name}: batch decode -> re-encode is not "
                "byte-identical"
            )
        return errors
    try:
        decoded = json.loads(bytes(payload).decode("utf-8"))
    except ValueError as exc:
        return [f"{spec.name}: undecodable control payload: {exc}"]
    if not isinstance(decoded, dict):
        return [f"{spec.name}: control payload is not a dict"]
    if _frame(msg_type, decoded) != data:
        errors.append(
            f"{spec.name}: control decode -> re-encode is not "
            "byte-identical"
        )
    if spec.name == "v1_error_version_mismatch" and \
            P.VERSION_MISMATCH_MARKER not in decoded.get("message", ""):
        errors.append(
            f"{spec.name}: VERSION_MISMATCH_MARKER no longer matches the "
            "frozen v1 rejection prose — new clients would stop "
            "recognizing old servers' rejections"
        )
    return errors


def verify_goldens(directory: str) -> List[str]:
    """Every corpus assertion over a goldens directory; returns the error
    list (empty = gate passes)."""
    errors: List[str] = []
    manifest_path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        return [f"unreadable manifest {manifest_path}: {exc} — run "
                "`ldt protocol goldens --update`"]
    entries = manifest.get("goldens", {})
    known = {spec.name for spec in GOLDEN_SPECS}
    for name in sorted(set(entries) - known):
        errors.append(
            f"{name}: in the manifest but not in GOLDEN_SPECS — a "
            "removed golden needs --update (a reviewable deletion)"
        )
    for spec in GOLDEN_SPECS:
        entry = entries.get(spec.name)
        if entry is None:
            errors.append(
                f"{spec.name}: missing from the manifest — run "
                "`ldt protocol goldens --update`"
            )
            continue
        path = os.path.join(directory, spec.filename)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as exc:
            errors.append(f"{spec.name}: unreadable blob: {exc}")
            continue
        sha = hashlib.sha256(data).hexdigest()
        if sha != entry.get("sha256"):
            errors.append(
                f"{spec.name}: blob sha256 {sha[:12]}... != manifest "
                f"{str(entry.get('sha256'))[:12]}... — corrupted or "
                "hand-edited golden"
            )
            continue
        rebuilt = build_golden(spec)
        if rebuilt != data:
            errors.append(
                f"{spec.name}: the current encoders produce different "
                f"bytes ({len(rebuilt)} vs {len(data)}) — the v{spec.version} "
                "wire format changed; if intentional, regenerate with "
                "`ldt protocol goldens --update` and review the diff"
            )
            # Still round-trip the checked-in bytes: decode tolerance
            # must hold even while the build identity is broken.
        errors.extend(_roundtrip_errors(spec, data))
    return errors


def write_goldens(directory: str) -> Dict[str, dict]:
    """(Re)generate every golden blob + the manifest. Returns the manifest
    entries for reporting."""
    os.makedirs(directory, exist_ok=True)
    entries: Dict[str, dict] = {}
    for spec in GOLDEN_SPECS:
        data = build_golden(spec)
        with open(os.path.join(directory, spec.filename), "wb") as f:
            f.write(data)
        entries[spec.name] = {
            "file": spec.filename,
            "version": spec.version,
            "msg": spec.msg,
            "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(),
            "legacy": spec.legacy,
            "note": spec.note,
        }
    manifest = {
        "format": 1,
        "protocol_version": P.PROTOCOL_VERSION,
        "goldens": entries,
    }
    with open(os.path.join(directory, MANIFEST_NAME), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    # Stale blobs from removed specs would shadow the manifest check.
    for name in sorted(os.listdir(directory)):
        if name == MANIFEST_NAME or not name.endswith(".bin"):
            continue
        if name[:-4] not in entries:
            os.unlink(os.path.join(directory, name))
    return entries


def goldens_main(argv=None, out=None) -> int:
    """``ldt protocol goldens [--update]`` — the corpus gate. Exit 0 when
    every golden round-trips byte-identically, 1 on any mismatch, 2 on
    usage errors."""
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="ldt protocol",
        description="wire-protocol golden corpus: decode every checked-in "
                    "frame and re-encode it byte-identically per version",
    )
    parser.add_argument("action", choices=["goldens"],
                        help="goldens: verify (or --update) the corpus")
    parser.add_argument("--dir", default=DEFAULT_GOLDENS_DIR,
                        help="corpus directory (default "
                             f"{DEFAULT_GOLDENS_DIR})")
    parser.add_argument("--update", action="store_true",
                        help="regenerate every blob + manifest from the "
                             "current encoders (review the diff!)")
    try:
        args = parser.parse_args(list(argv) if argv is not None else None)
    except SystemExit as exc:
        return int(exc.code or 0)
    if args.update:
        if os.path.abspath(args.dir) == os.path.abspath(DEFAULT_GOLDENS_DIR):
            # The checked-in corpus is the JAX package's; the port holds
            # its bytes and never rewrites them.
            out.write(
                "ldt protocol goldens: --update writes the checked-in "
                f"corpus {DEFAULT_GOLDENS_DIR}, which the port only reads; "
                "pass --dir to write elsewhere\n"
            )
            return 2
        entries = write_goldens(args.dir)
        out.write(
            f"ldt protocol goldens: wrote {len(entries)} goldens to "
            f"{args.dir} (protocol v{P.PROTOCOL_VERSION})\n"
        )
        return 0
    errors = verify_goldens(args.dir)
    if errors:
        for err in errors:
            out.write(f"ldt protocol goldens: {err}\n")
        out.write(
            f"ldt protocol goldens: {len(errors)} failure"
            f"{'s' if len(errors) != 1 else ''} over "
            f"{len(GOLDEN_SPECS)} goldens\n"
        )
        return 1
    versions = sorted({s.version for s in GOLDEN_SPECS})
    out.write(
        f"ldt protocol goldens: {len(GOLDEN_SPECS)} goldens round-trip "
        f"byte-identically (versions {versions})\n"
    )
    return 0
