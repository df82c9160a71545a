"""Runtime compile/transfer sanitizer — the witness half of LDT1713.

The port's form of ``lance_distributed_training_tpu/utils/compiletrack.py``.
The port has no XLA and no ``jax.jit``, so each JAX notion maps onto what
costs the same on the card:

* a **site** is a kernel launcher — the wrappers of port ``ops/flash.py``
  (forward, dQ, dK/dV), ``ops/image.py`` (K1), ``ops/jpeg_device.py``
  (K2), ``ops/token_device.py`` (K3 pack and unpack) and
  ``ops/ring_attention.py`` (K5, which ``parallel/ring_attention.py``
  drives) — keyed by the wrapper's def site (``abspath:firstlineno``); and
  the model's forward, keyed by its ``forward``'s def site, because the
  trainer sets ``torch.backends.cudnn.benchmark`` for image models and
  cuDNN then autotunes every new convolution input shape. The eval step
  records under its own def site, and every call made inside
  ``with phase("eval"):`` (the trainer's eval loop) under its site with
  ``@eval`` appended, so a re-tune by eval's last batch shows apart from
  the training loop and never joins a static site;
* a **compile** is a new abstract signature (tensor shapes and dtypes,
  plain values by value) at a site after its first call — a new cuDNN
  autotune, or a new launch configuration — and, beside the JAX schema, an
  ``nvcc`` build of ``ops/_build.py`` (``builds``: per kernel source, the
  build's seconds and whether a library built earlier was reused);
* **transfers** are H2D through port ``data/placement.py`` (its staging
  copy of each batch) and D2H at the trainer's drain points (the loss
  drain, the token-count read and eval's total).

The witness JSON has the JAX schema (``compiles`` and ``transfers``, plus
``builds``), so JAX's ``analysis/cli.py`` ``load_compile_witness`` reads
the port's file, and the port's ``check --compile-witness`` joins its
sites onto the static launch sites (``launch-sites`` in the port's
``analysis/ldt-check.toml``):

* a static LDT1713 hazard whose launch site shows post-warmup signatures
  is *reproduced*;
* one whose site was called more than once with one signature is marked
  ``witness_pruned``;
* sites the run never touched prove nothing.

The hooks are two-line ``if compiletrack.enabled():`` guards, cold by
default: a dict update under one raw lock per call, no I/O until
:func:`dump`. Under ``LDT_COMPILE_SANITIZER=1`` the recorder dumps its
witness at interpreter exit (``atexit``).

Stdlib-only, no package imports: the analyzer side only ever READS the
JSON this writes.

Knobs::

    LDT_COMPILE_SANITIZER=1      # the launchers and drain points record
    LDT_COMPILE_WITNESS_PATH=…   # dump target (default
                                 # ./compile-witness-torch.json)
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import _thread
from typing import Callable, Dict, List, Optional

__all__ = [
    "enabled",
    "enable",
    "disable",
    "track_call",
    "track_launch",
    "track_forward",
    "track_build",
    "track_transfer",
    "phase",
    "def_site",
    "sites",
    "transfers",
    "builds",
    "reset",
    "snapshot",
    "restore",
    "dump",
    "ENV_FLAG",
    "ENV_PATH",
]

ENV_FLAG = "LDT_COMPILE_SANITIZER"
ENV_PATH = "LDT_COMPILE_WITNESS_PATH"
DEFAULT_WITNESS_PATH = "compile-witness-torch.json"

# Recorder state. A RAW lock (the sanitizer must never observe itself
# through the lock sanitizer's shim); critical sections are dict updates
# only, never I/O.
_state_lock = _thread.allocate_lock()
# site -> {"calls": int, "keys": [abstract-key str, in first-seen order],
#          "post_warmup": int}
_sites: Dict[str, dict] = {}
# direction ("h2d"|"d2h") -> site -> [count, bytes]
_transfers: Dict[str, Dict[str, List[int]]] = {"h2d": {}, "d2h": {}}
# kernel source stem -> {"seconds": float, "cached": bool}
_builds: Dict[str, dict] = {}
# Evaluated once per process: hooks are two attribute reads when off.
_enabled = os.environ.get(ENV_FLAG) == "1"
# Appended to the compile sites recorded inside phase(...): "" or "@eval".
_suffix = ""


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


def def_site(fn: Callable) -> Optional[str]:
    """``abspath:firstlineno`` of a Python function (``__wrapped__``
    chains unwrapped); None for C callables."""
    seen = 0
    obj = fn
    while hasattr(obj, "__wrapped__") and seen < 8:
        obj = obj.__wrapped__
        seen += 1
    code = getattr(obj, "__code__", None)
    if code is None:
        return None
    return f"{code.co_filename}:{code.co_firstlineno}"


def _abstract_key(obj: object, depth: int = 0) -> object:
    """Duck-typed abstract signature of one argument: tensors and arrays
    collapse to ``(shape, dtype)`` — what an autotune or a launch
    configuration keys on — while plain Python values keep their VALUE.
    Containers recurse; unhashable leftovers collapse to their type
    name."""
    if depth > 6:
        return type(obj).__name__
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    if shape is not None and dtype is not None:
        return ("ary", tuple(shape), str(dtype))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(
            _abstract_key(v, depth + 1) for v in obj
        )
    if isinstance(obj, dict):
        return ("dict",) + tuple(
            (k, _abstract_key(v, depth + 1))
            for k, v in sorted(obj.items(), key=repr)
        )
    fields = getattr(obj, "__dataclass_fields__", None)
    if fields is not None:
        return (type(obj).__name__,) + tuple(
            (name, _abstract_key(getattr(obj, name, None), depth + 1))
            for name in fields
        )
    try:
        hash(obj)
    except TypeError:
        return type(obj).__name__
    return obj


@contextlib.contextmanager
def phase(name: str):
    """Inside the block, compile sites record as ``site@name``: the
    trainer's eval loop, apart from the training loop's sites."""
    global _suffix
    saved, _suffix = _suffix, f"@{name}"
    try:
        yield
    finally:
        _suffix = saved


def track_call(site: str, args: tuple, kwargs: dict) -> None:
    """Record one invocation at ``site``. A new abstract signature
    strictly after the site's first call counts as a post-warmup
    compile."""
    site += _suffix
    key = repr(_abstract_key((args, tuple(sorted(kwargs.items(), key=repr)))))
    with _state_lock:
        rec = _sites.setdefault(
            site, {"calls": 0, "keys": [], "post_warmup": 0}
        )
        first_call = rec["calls"] == 0
        rec["calls"] += 1
        if key not in rec["keys"]:
            rec["keys"].append(key)
            if not first_call:
                rec["post_warmup"] += 1


def track_launch(*args, **kwargs) -> None:
    """Record one call of the kernel launcher that calls this, under its
    def site (the static launch site's join key)."""
    code = sys._getframe(1).f_code
    track_call(f"{code.co_filename}:{code.co_firstlineno}", args, kwargs)


def track_forward(model, *args, **kwargs) -> None:
    """Record one forward of ``model`` (a ``DistributedDataParallel``
    wrapper is looked through) under its ``forward``'s def site: the
    site cuDNN's benchmark mode autotunes per input shape."""
    inner = getattr(model, "module", model)
    site = def_site(type(inner).forward) \
        or f"<opaque:{type(inner).__name__}.forward>"
    track_call(site, args, kwargs)


def track_build(stem: str, seconds: float, cached: bool) -> None:
    """Record a kernel library's build (``nvcc``) or its reuse."""
    with _state_lock:
        _builds[stem] = {"seconds": float(seconds), "cached": bool(cached)}


def track_transfer(direction: str, nbytes: int, depth: int = 2) -> None:
    """Record one host↔device transfer event. ``direction`` is ``"h2d"``
    or ``"d2h"``; ``depth`` names the frame whose line is the transfer
    site (2 = the line invoking this hook)."""
    site = _caller_site(depth)
    with _state_lock:
        rec = _transfers.setdefault(direction, {}).setdefault(site, [0, 0])
        rec[0] += 1
        rec[1] += int(nbytes)


def sites() -> Dict[str, dict]:
    """Per-site compile counters as the witness schema reports them."""
    with _state_lock:
        return {
            site: {
                "calls": rec["calls"],
                "compiles": len(rec["keys"]),
                "post_warmup": rec["post_warmup"],
            }
            for site, rec in _sites.items()
        }


def transfers() -> Dict[str, Dict[str, dict]]:
    with _state_lock:
        return {
            direction: {
                site: {"count": c, "bytes": b} for site, (c, b) in table.items()
            }
            for direction, table in _transfers.items()
        }


def builds() -> Dict[str, dict]:
    with _state_lock:
        return {stem: dict(rec) for stem, rec in _builds.items()}


def reset() -> None:
    with _state_lock:
        _sites.clear()
        _transfers["h2d"].clear()
        _transfers["d2h"].clear()
        _builds.clear()


def snapshot() -> dict:
    """Recorder state, for tests that enable/reset without clobbering a
    process-level sanitizer."""
    with _state_lock:
        return {
            "sites": {
                site: {
                    "calls": rec["calls"],
                    "keys": list(rec["keys"]),
                    "post_warmup": rec["post_warmup"],
                }
                for site, rec in _sites.items()
            },
            "transfers": {
                direction: {site: list(v) for site, v in table.items()}
                for direction, table in _transfers.items()
            },
            "builds": {stem: dict(rec) for stem, rec in _builds.items()},
            "enabled": _enabled,
        }


def restore(state: dict) -> None:
    global _enabled
    with _state_lock:
        _sites.clear()
        for site, rec in state["sites"].items():
            _sites[site] = {
                "calls": rec["calls"],
                "keys": list(rec["keys"]),
                "post_warmup": rec["post_warmup"],
            }
        for direction in ("h2d", "d2h"):
            _transfers[direction].clear()
            _transfers[direction].update(
                {s: list(v)
                 for s, v in state["transfers"].get(direction, {}).items()}
            )
        _builds.clear()
        _builds.update(state.get("builds", {}))
    _enabled = state["enabled"]


def dump(path: Optional[str] = None) -> str:
    """Write the witness JSON (atomically: a torn file must fail loudly as
    absent, not parse as an empty witness). Returns the path written."""
    path = path or os.environ.get(ENV_PATH) or DEFAULT_WITNESS_PATH
    payload = {
        "version": 1,
        "compiles": dict(sorted(sites().items())),
        "transfers": {
            direction: dict(sorted(table.items()))
            for direction, table in transfers().items()
        },
        "builds": dict(sorted(builds().items())),
    }
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-compilewitness-")
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
        sys.stderr.write(f"[compiletrack] witness not written: {exc}\n")
        return
    sys.stderr.write(f"[compiletrack] witness written to {path}\n")


if _enabled:
    atexit.register(_dump_at_exit)
