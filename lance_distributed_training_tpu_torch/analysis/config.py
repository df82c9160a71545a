"""``[tool.ldt-check]`` configuration.

A copy of ``lance_distributed_training_tpu/analysis/config.py``: the
defaults are the JAX package's (so that the port's checker gives the JAX
checker's findings on JAX code), and :func:`load_config` reads the same
``[tool.ldt-check]`` table from any root's ``pyproject.toml`` (stdlib
``tomllib`` on 3.11+, ``tomli`` as the 3.10 fallback). The port's own
configuration is ``ldt-check.toml`` beside this module, the same table with
every path mapped to the port's module (:func:`load_port_config`);
:func:`resolve_config` picks between the two for ``check`` and ``graph``.
Two keys only the port's torch rules read: ``boundary-paths`` (LDT402) and
``launch-sites`` (LDT1713 and the compile witness's join). Both default to
empty, which keeps those rules inert on JAX code.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

__all__ = ["CheckConfig", "PORT_CONFIG", "load_config", "load_port_config",
           "resolve_config"]

# The port's own [tool.ldt-check] table, and the root its paths are
# relative to (the directory holding the port's package).
PORT_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "ldt-check.toml")
PORT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class CheckConfig:
    """Knobs for the analyzer. Paths are root-relative posix."""

    # What to scan.
    paths: List[str] = dataclasses.field(
        default_factory=lambda: ["lance_distributed_training_tpu"]
    )
    exclude: List[str] = dataclasses.field(default_factory=list)  # fnmatch
    disable: List[str] = dataclasses.field(default_factory=list)  # rule ids
    # Baseline of grandfathered findings (``ldt check --update-baseline``).
    baseline: str = ".ldt-baseline.json"
    # LDT401: the one module allowed to import version-moved jax symbols.
    compat_module: str = "lance_distributed_training_tpu/parallel/_compat.py"
    compat_symbols: List[str] = dataclasses.field(
        default_factory=lambda: ["shard_map", "pcast", "axis_size"]
    )
    # LDT202: where an unbounded queue.Queue() is an error (streaming paths
    # whose backpressure contract depends on bounded queues).
    queue_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/service/*",
            "lance_distributed_training_tpu/data/pipeline.py",
            "lance_distributed_training_tpu/data/workers.py",
        ]
    )
    # LDT501: the protocol-constant source of truth. Also the one module
    # allowed to own raw byte-framing (LDT1404) and the schema owner whose
    # internal reads never satisfy the peer-read contract (LDT1401).
    protocol_module: str = "lance_distributed_training_tpu/service/protocol.py"
    # LDT1402: version-gated payload fields — "MSG_X.field" (or a bare
    # field name, gating it in every message) -> gate constant in the
    # protocol module. Any read (or keyword-serve into a schema
    # constructor) of the field outside the protocol module must sit in a
    # function — or under callers — comparing against that constant. TOML:
    # a ``[tool.ldt-check.protocol-versions]`` table.
    protocol_versions: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "MSG_HELLO.stripe_index": "STRIPE_MIN_VERSION",
            "MSG_HELLO.stripe_count": "STRIPE_MIN_VERSION",
        }
    )
    # LDT14xx: messages whose payloads are raw binary (framed tensors),
    # not JSON field dicts — excluded from field-schema tracking.
    protocol_binary: List[str] = dataclasses.field(
        default_factory=lambda: ["MSG_BATCH"]
    )
    # LDT1403 runtime witness (``ldt check --wire-witness``): set by the
    # CLI, never from TOML — {"frames": {msg_value: count}, "fields":
    # {msg_value: {field: count}}} recorded by utils/wiretrack.py under
    # LDT_WIRE_SANITIZER=1.
    wire_witness: Optional[dict] = None
    # LDT601: the instrumented modules (telemetry clock + metric-name
    # hygiene) — no time.time(); metric names must be Prometheus-safe.
    obs_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/obs/*",
            "lance_distributed_training_tpu/utils/metrics.py",
            "lance_distributed_training_tpu/utils/profiling.py",
            "lance_distributed_training_tpu/service/*",
            "lance_distributed_training_tpu/data/pipeline.py",
            "lance_distributed_training_tpu/data/workers.py",
            "lance_distributed_training_tpu/data/buffers.py",
        ]
    )
    # LDT901: state-persisting modules — files a RESTART reads and trusts
    # (checkpoint cursors, lint baselines). Truncating in-place writes here
    # must use tempfile + os.replace.
    state_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/utils/checkpoint.py",
            "lance_distributed_training_tpu/analysis/core.py",
        ]
    )
    # LDT1003: dispatcher exhaustiveness — each dispatcher module's inbound
    # message vocabulary. Every ``MSG_*`` constant in the protocol module
    # must appear in at least one entry, and each listed constant must be
    # behaviorally dispatched (compared against a received message type, or
    # keyed in a handler dict) in that module. TOML: a
    # ``[tool.ldt-check.dispatch]`` table of module-path → constant list.
    dispatch: Dict[str, List[str]] = dataclasses.field(
        default_factory=lambda: {
            "lance_distributed_training_tpu/service/server.py": [
                "MSG_HELLO", "MSG_ACK", "MSG_ERROR",
            ],
            "lance_distributed_training_tpu/service/client.py": [
                "MSG_HELLO_OK", "MSG_BATCH", "MSG_END", "MSG_ERROR",
            ],
            "lance_distributed_training_tpu/fleet/balancer.py": [
                "MSG_HELLO_OK", "MSG_BATCH", "MSG_END", "MSG_ERROR",
                "MSG_FLEET_RESOLVE_OK",
            ],
            "lance_distributed_training_tpu/fleet/coordinator.py": [
                "MSG_FLEET_REGISTER", "MSG_FLEET_HEARTBEAT",
                "MSG_FLEET_DEREGISTER", "MSG_FLEET_RESOLVE",
            ],
            "lance_distributed_training_tpu/fleet/agent.py": [
                "MSG_FLEET_REGISTER_OK", "MSG_FLEET_HEARTBEAT_OK",
                "MSG_FLEET_DEREGISTER_OK", "MSG_ERROR",
            ],
        }
    )
    # LDT1002: constructors whose instances are internally synchronized —
    # a shared attribute holding one is a sanctioned handoff, not a race.
    # Matched as suffixes of the import-resolved constructor qualname;
    # empty list = the built-in default set (concmodel module).
    threadsafe_types: List[str] = dataclasses.field(default_factory=list)
    # LDT1001 runtime witness (``ldt check --lock-witness``): set by the
    # CLI, never from TOML — {"edges": {(src, dst), ...},
    # "acquired": {site: count}} with root-relative "path:line" sites.
    lock_witness: Optional[dict] = None
    # LDT12xx resource vocabulary: kind -> {acquire: [patterns],
    # release: [method names], describe, idempotent}. Acquire patterns
    # match the resolved callee's dotted tail (case/underscore-folded, so
    # ``BufferPool.lease`` also matches ``self.buffer_pool.lease``).
    # Empty dict = the built-in vocabulary (ownermodel.DEFAULT_RESOURCES:
    # pool-page, shm-token, socket, thread, autotuner). TOML: a
    # ``[tool.ldt-check.resources.<kind>]`` table per kind.
    resources: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # LDT1301 content paths: the computations whose outputs must be pure
    # functions of (dataset, plan, seed, epoch, cursor) — plan generation,
    # batch assembly, cursor arithmetic, lineage digests. Entries are
    # ``path-glob[::function-glob]`` (function globs match dotted
    # qualnames). Taint sources found in these functions, or in functions
    # they reach through resolved calls within content modules, are
    # findings.
    content_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/data/samplers.py",
            "lance_distributed_training_tpu/data/decode.py",
            "lance_distributed_training_tpu/utils/chaos.py::*.batch_digest",
            "lance_distributed_training_tpu/*::*.state_dict",
            "lance_distributed_training_tpu/*::*.load_state_dict",
        ]
    )
    # Extra LDT1301 taint sources appended to the built-in set
    # (ownermodel.DEFAULT_TAINT_SOURCES): dotted call qualnames, or bare
    # names matched against the call's function/attribute name.
    taint_sources: List[str] = dataclasses.field(default_factory=list)
    # LDT1201 runtime witness (``ldt check --leak-witness``): set by the
    # CLI, never from TOML — {"sites": {"path:line": {"acquired": n,
    # "released": n, "leaked": n}}} with root-relative sites.
    leak_witness: Optional[dict] = None
    # LDT1701: the declared mesh-axis vocabulary — every literal axis name
    # in a PartitionSpec or collective must come from this list. Seeded
    # from parallel/mesh.py's get_mesh (data, model, seq, pipe). TOML:
    # ``mesh-axes``.
    mesh_axes: List[str] = dataclasses.field(
        default_factory=lambda: ["data", "model", "seq", "pipe"]
    )
    # LDT1703: the quantized funnels — call-name globs (matched against the
    # callee's dotted tail) through which a .shape/len()-derived value may
    # legitimately reach a jit static position, because the funnel clamps
    # it to a short ladder (coeff_chunk actuation, pack_rows_quantum
    # rounding). TOML: ``static-funnels``.
    static_funnels: List[str] = dataclasses.field(
        default_factory=lambda: [
            "coeff_chunk", "pack_rows_quantum", "rows_multiple",
            "*_quantum", "*_bucket",
        ]
    )
    # LDT1704: function-name globs (bare name or dotted-qualname tail)
    # allowed to host-sync deliberately — declared D2H doors. TOML:
    # ``sync-funnels``.
    sync_funnels: List[str] = dataclasses.field(default_factory=list)
    # LDT1704: the compute-plane hot modules where a stray host sync
    # serialises the dispatch stream (hot_paths above is the DATA plane's
    # copy discipline — different contract, different module set). TOML:
    # ``device-hot-paths``.
    device_hot_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/trainer.py",
            "lance_distributed_training_tpu/ops/*",
            "lance_distributed_training_tpu/parallel/*",
        ]
    )
    # LDT1703 runtime witness (``ldt check --compile-witness``): set by the
    # CLI, never from TOML — {"compiles": {"path:line": {"calls": n,
    # "distinct": k, "post_warmup": m}}, "transfers": {...}} recorded by
    # utils/compiletrack.py under LDT_COMPILE_SANITIZER=1.
    compile_witness: Optional[dict] = None
    # LDT701: the hot-path modules where materialising copies
    # (.to_pylist(), bytes(view[...])) undo the zero-copy batch plane.
    # LDT402 (the port's import boundary): modules that may import neither
    # JAX nor the JAX package, nor triton or a kernel build at import.
    # Empty = the rule is inert. TOML: ``boundary-paths``.
    boundary_paths: List[str] = dataclasses.field(default_factory=list)
    # LDT1713 and the torch compile witness: the kernel launchers and
    # cuDNN-benchmarked forwards, ``path-glob::function-glob`` entries.
    # Empty = the torch launch-site scan is inert. TOML: ``launch-sites``.
    launch_sites: List[str] = dataclasses.field(default_factory=list)
    hot_paths: List[str] = dataclasses.field(
        default_factory=lambda: [
            "lance_distributed_training_tpu/data/decode.py",
            "lance_distributed_training_tpu/data/pipeline.py",
            "lance_distributed_training_tpu/data/workers.py",
            "lance_distributed_training_tpu/data/buffers.py",
            "lance_distributed_training_tpu/data/folder.py",
            "lance_distributed_training_tpu/native/jpeg.py",
            "lance_distributed_training_tpu/service/protocol.py",
            "lance_distributed_training_tpu/service/server.py",
            "lance_distributed_training_tpu/service/client.py",
        ]
    )


def _read_toml(path: str) -> Optional[dict]:
    try:
        import tomllib  # Python 3.11+
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            return None
    try:
        with open(path, "rb") as f:
            return tomllib.load(f)
    except (OSError, ValueError):
        return None


def _section(path: str) -> Optional[dict]:
    data = _read_toml(path)
    if not data:
        return None
    return data.get("tool", {}).get("ldt-check")


def load_config(root: str) -> CheckConfig:
    """Defaults overlaid with ``[tool.ldt-check]`` from ``root/pyproject.toml``
    when present and parseable; silently falls back to defaults otherwise
    (no TOML parser must never break the gate)."""
    return _apply(CheckConfig(),
                  _section(os.path.join(root, "pyproject.toml")) or {})


def load_port_config() -> CheckConfig:
    """Defaults overlaid with the port's own table (:data:`PORT_CONFIG`)."""
    return _apply(CheckConfig(), _section(PORT_CONFIG) or {})


def resolve_config(root: Optional[str]):
    """``(root, config)`` for the port's ``check`` and ``graph``: the
    ``[tool.ldt-check]`` table of ``root/pyproject.toml`` when ``root`` is
    given and has one, else the port's own table over ``root`` (default:
    the directory holding the port's package)."""
    if root is not None:
        root = os.path.abspath(root)
        if _section(os.path.join(root, "pyproject.toml")) is not None:
            return root, load_config(root)
    return (root or PORT_ROOT), load_port_config()


def _apply(config: CheckConfig, section: dict) -> CheckConfig:
    mapping = {
        "paths": "paths",
        "exclude": "exclude",
        "disable": "disable",
        "baseline": "baseline",
        "compat-module": "compat_module",
        "compat-symbols": "compat_symbols",
        "queue-paths": "queue_paths",
        "protocol-module": "protocol_module",
        "protocol-versions": "protocol_versions",
        "protocol-binary": "protocol_binary",
        "obs-paths": "obs_paths",
        "hot-paths": "hot_paths",
        "state-paths": "state_paths",
        "dispatch": "dispatch",
        "threadsafe-types": "threadsafe_types",
        "resources": "resources",
        "content-paths": "content_paths",
        "taint-sources": "taint_sources",
        "mesh-axes": "mesh_axes",
        "static-funnels": "static_funnels",
        "sync-funnels": "sync_funnels",
        "device-hot-paths": "device_hot_paths",
        "boundary-paths": "boundary_paths",
        "launch-sites": "launch_sites",
    }
    for key, attr in mapping.items():
        if key in section:
            setattr(config, attr, section[key])
    config.disable = [r.upper() for r in config.disable]
    return config
