"""Checkpoint / resume — crash-consistent, step-granular, cursor-carrying,
sharded.

Counterpart of ``lance_distributed_training_tpu/utils/checkpoint.py``,
whose train state is orbax's: sharded writes from every process, restored
onto the live mesh's shardings. Here the same contract on plain files. A
checkpoint is the unit of crash consistency for the whole training
position:

* **train state** — a step directory ``<directory>/<step>/`` holding one
  shard file a writing process, ``shard-<rank>.bin`` (the bytes of its
  tensors, row-major, one after another), and an index, ``index.json``.
  The caller's
  state is a tree of dicts, lists and tuples whose leaves are tensors,
  :class:`Piece`\\ s (a process's block of a leaf that several processes
  hold in parts) and plain values. The index records the tree with its
  plain values, and for each tensor leaf its name (the path of keys and
  indices joined by ``/``), whole shape and dtype, and its pieces: the
  file, the byte offset there, the rank that wrote it, and the block
  (dimension, offset, length, mesh axis) it holds, or ``dim`` ``None``
  for the whole leaf. A
  plain tensor is replicated and written once, by rank 0; a piece by the
  one process whose ``write`` flag is set (the lowest rank that holds it,
  as orbax writes replica 0). Each process copies what it writes off the
  card at the call (into pinned buffers that the next save refills) and
  writes its shard on a background thread, to a temporary name in the
  step directory, then ``os.replace``\\ s it into place;
* **data-plane cursor** — a small JSON sidecar a step,
  ``<directory>/cursors/<step>.json`` (the loader's ``{"epoch", "step"}``,
  the absolute step, every process's packed generator state), written by
  rank 0 through :func:`atomic_write_json`: it embeds the SHA-256 of its
  own canonical payload and lands by ``tempfile`` + ``os.replace``.

Write order is the crash-consistency argument: the sidecar first, then
each process's shard, then the commit: once every process's shard is in
place, rank 0 writes the index (also through :func:`atomic_write_json`),
and only then deletes steps beyond ``max_to_keep``. The commit's
collective — every process's outcome and pieces gathered to rank 0, rank
0's outcome broadcast back — runs on the caller's thread, at the next
:meth:`CheckpointManager.save`, at ``wait=True`` and in
:meth:`CheckpointManager.close`, never on the writer thread, over the
manager's ``group``: the trainer gives it a gloo group of its own, so that
a checkpoint's collectives never pair with a training collective, not even
one that a failing process left half done. A failed write on any
process raises on every process there; it never becomes a gather to one
process. A crash at any point leaves (a) no trace of the step, (b) a
sidecar and shards without an index — invisible to restore, the sidecar
collected by the next commit and the directory cleared when the step is
saved again — or (c) an intact step: its index verifies, every shard it
names is present at its recorded size, and its sidecar verifies.

:meth:`CheckpointManager.restore_latest` walks the steps newest-first.
Each process reads its share through a :class:`StepReader`, whose
:meth:`~StepReader.read` cuts a block of a leaf from the pieces that
overlap it: each piece's bytes from the first element of the overlap to
its last, in reads of at most ``_SPAN_BYTES`` (a piece split along the
same dimension as the block gives exactly the block's bytes; along
another, the rows it crosses), so that the host holds the block and one
such read, never a piece or a file whole. The processes agree: a step
that is torn for any of them is skipped, and its id poisoned, by all. A
step directory holding
the one-file ``state.pt`` of the earlier format (the whole state in the
data-parallel format) still restores, through the same reader.

The two JSON helpers are byte-for-byte copies of the JAX package's (same
canonical form, same document); ``pack_rng_key``/``unpack_rng_key`` carry a
``torch.Generator``'s state (a CPU generator's Mersenne Twister state, a
CUDA generator's Philox seed and offset) as a list of ints.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "CheckpointManager",
    "CheckpointRefused",
    "LeafRef",
    "Piece",
    "StepReader",
    "atomic_write_json",
    "read_verified_json",
    "pack_rng_key",
    "unpack_rng_key",
]

_CURSOR_DIR = "cursors"
_INDEX_FILE = "index.json"
_LEGACY_FILE = "state.pt"  # the earlier format: the whole state, one file
_FORMAT = 1
_SPAN_BYTES = 32 << 20  # the largest read of a piece's bytes at once


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


# ------------------------------------------------------------ the tree


@dataclasses.dataclass
class Piece:
    """A process's block of a leaf that several processes hold in parts:
    ``tensor`` is the block of the whole ``shape`` along ``dim`` from
    ``offset``, over the mesh axis ``axis``. ``write`` is set on the one
    process that writes it."""

    tensor: torch.Tensor
    shape: tuple
    dim: int
    offset: int
    axis: str
    write: bool


class CheckpointRefused(ValueError):
    """The checkpoint's state tree differs from the live state's (another
    model, optimizer or accumulation): a restore refuses the step and says
    why, rather than falling back past it as past a torn step."""


@dataclasses.dataclass(frozen=True)
class LeafRef:
    """A tensor leaf of :meth:`StepReader.tree`, by name."""

    name: str


def _flatten(tree) -> tuple:
    """``(skeleton, leaves)``: the JSON form of ``tree``, each tensor or
    :class:`Piece` replaced by ``{"leaf": name}``, and ``{name: leaf}``."""
    leaves: dict = {}

    def encode(obj, path: tuple):
        where = "/".join(path)
        if isinstance(obj, (torch.Tensor, Piece)):
            if where in leaves:
                raise ValueError(f"two checkpoint leaves are named {where!r}")
            leaves[where] = obj
            return {"leaf": where}
        if isinstance(obj, dict):
            items = []
            for key, value in obj.items():
                if isinstance(key, bool) or not isinstance(key, (str, int)):
                    raise TypeError(f"checkpoint key {key!r} at {where!r} is "
                                    "not a str or an int")
                items.append([key, encode(value, path + (str(key),))])
            return {"dict": items}
        if isinstance(obj, (list, tuple)):
            kind = "list" if isinstance(obj, list) else "tuple"
            return {kind: [encode(v, path + (str(i),))
                           for i, v in enumerate(obj)]}
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return {"value": obj}
        raise TypeError(f"cannot checkpoint a {type(obj).__name__} at "
                        f"{where!r}")

    return encode(tree, ()), leaves


def _unflatten(skeleton: dict, leaf: Callable[[str], Any]):
    """The tree of ``skeleton``, each leaf ``leaf(name)``."""
    (kind, value), = skeleton.items()
    if kind == "leaf":
        return leaf(value)
    if kind == "dict":
        return {k: _unflatten(v, leaf) for k, v in value}
    if kind == "list":
        return [_unflatten(v, leaf) for v in value]
    if kind == "tuple":
        return tuple(_unflatten(v, leaf) for v in value)
    return value


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaf_entry(leaf) -> dict:
    """A written leaf's shape, dtype and piece, as the index records
    them."""
    if isinstance(leaf, Piece):
        t = leaf.tensor
        want = list(leaf.shape)
        want[leaf.dim] = t.shape[leaf.dim]
        if list(t.shape) != want:
            raise ValueError(f"a block of shape {tuple(t.shape)} is not a "
                             f"block of {tuple(leaf.shape)} along dim "
                             f"{leaf.dim}")
        piece = {"dim": leaf.dim, "offset": int(leaf.offset),
                 "length": int(t.shape[leaf.dim]), "axis": leaf.axis}
        return {"shape": list(leaf.shape), "dtype": _dtype_name(t.dtype),
                "piece": piece}
    return {"shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype),
            "piece": {"dim": None, "offset": 0, "length": None,
                      "axis": None}}


def _box(shape, dim, offset, length) -> tuple:
    """The per-dimension ``[lo, hi)`` ranges of a block."""
    lo, hi = [0] * len(shape), list(shape)
    if dim is not None:
        lo[dim], hi[dim] = offset, offset + length
    return lo, hi


def _pread(fd: int, buf: memoryview, offset: int) -> None:
    """Fill ``buf`` from ``fd`` at ``offset``; a file that ends first is
    torn."""
    while buf.nbytes:
        n = os.preadv(fd, [buf], offset)
        if n == 0:
            raise RuntimeError("a shard ends before the bytes its index "
                               "records")
        buf, offset = buf[n:], offset + n


def _unregister(buf: torch.Tensor) -> None:
    """``cudaHostUnregister`` a staging buffer (before it is freed)."""
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
        buf.data_ptr()))


def _write_tensors(f, tensors) -> None:
    """Each tensor's bytes to the open file ``f``, one after another (a
    large buffer goes to ``write`` whole, which releases the interpreter
    lock for the system call)."""
    for t in tensors:
        f.write(t.reshape(-1).view(torch.uint8).numpy())


# ---------------------------------------------------------- the reader


class StepReader:
    """One step's state, read a leaf or a block of a leaf at a time.

    :meth:`tree` is the saved tree with each tensor leaf a
    :class:`LeafRef` (plain values as saved; no tensor is read);
    :meth:`read` is a leaf, or its block ``index`` of ``parts`` along
    ``dim``, assembled on the host from the pieces that overlap it;
    :meth:`whole` is the tree with every leaf read whole. ``bytes_read``
    counts the bytes of what it assembled, ``largest_read`` the largest
    tensor assembled and ``bytes_scanned`` the bytes it read from the
    shards to do so."""

    def __init__(self, directory: str, index: dict,
                 tensors: Optional[dict] = None):
        self.directory = directory
        self.manifest = index  # the step's index document
        self._tensors = tensors  # the earlier format's leaves, in memory
        self._files: dict = {}  # shard name -> an open descriptor
        self.bytes_read = 0
        self.largest_read = 0
        self.bytes_scanned = 0

    @classmethod
    def of_state(cls, state) -> "StepReader":
        """A reader over a whole state already in memory (a step of the
        earlier format), every leaf one whole piece."""
        skeleton, leaves = _flatten(state)
        index = {"format": _FORMAT, "tree": skeleton, "files": {},
                 "leaves": {}}
        for name, t in leaves.items():
            entry = _leaf_entry(t)
            index["leaves"][name] = {
                "shape": entry["shape"], "dtype": entry["dtype"],
                "pieces": [dict(entry["piece"], file=None, rank=0)]}
        return cls("", index, tensors=leaves)

    def __enter__(self) -> "StepReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for fd in self._files.values():
            os.close(fd)
        self._files.clear()

    def shape(self, name: str) -> tuple:
        return tuple(self.manifest["leaves"][name]["shape"])

    def dtype(self, name: str) -> torch.dtype:
        return getattr(torch, self.manifest["leaves"][name]["dtype"])

    def tree(self):
        return _unflatten(self.manifest["tree"], LeafRef)

    def whole(self):
        return _unflatten(self.manifest["tree"], self.read)

    def _fill(self, dst: torch.Tensor, piece: dict, name: str, shape,
              lo, hi) -> None:
        """``dst`` from the region ``[lo, hi)`` of a piece of ``shape``:
        the piece's bytes from the region's first element to its last,
        read ``_SPAN_BYTES`` or one outermost row at a time."""
        if self._tensors is not None:
            src = self._tensors[name]
            for d, (a, b) in enumerate(zip(lo, hi)):
                src = src.narrow(d, a, b - a)
            dst.copy_(src)
            return
        fd = self._files.get(piece["file"])
        if fd is None:
            fd = os.open(os.path.join(self.directory, piece["file"]),
                         os.O_RDONLY)
            self._files[piece["file"]] = fd
        size = dst.element_size()
        strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        if not shape:  # a 0-d leaf
            lo, hi, strides = [0], [1], [1]
            dst = dst.reshape(1)
        rows = max(1, _SPAN_BYTES // (strides[0] * size))
        for row in range(lo[0], hi[0], rows):
            sub_lo = [row] + list(lo[1:])
            sub_hi = [min(row + rows, hi[0])] + list(hi[1:])
            first = sum(a * st for a, st in zip(sub_lo, strides))
            count = sum((b - 1) * st for b, st in zip(sub_hi, strides)) \
                - first + 1
            buf = torch.empty(count * size, dtype=torch.uint8)
            _pread(fd, memoryview(buf.numpy()),
                   piece["at"] + first * size)
            self.bytes_scanned += count * size
            region = buf.view(dst.dtype).as_strided(
                [b - a for a, b in zip(sub_lo, sub_hi)], strides)
            dst.narrow(0, row - lo[0], sub_hi[0] - row).copy_(region)

    def read(self, name: str, dim: Optional[int] = None, index: int = 0,
             parts: int = 1) -> torch.Tensor:
        """Leaf ``name`` whole, or its block ``index`` of ``parts`` equal
        blocks along ``dim``: a new host tensor holding only that block,
        filled from the intersection with each piece."""
        leaf = self.manifest["leaves"][name]
        shape = leaf["shape"]
        length = None
        if dim is not None:
            if shape[dim] % parts:
                raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does "
                                 f"not split into {parts}")
            length = shape[dim] // parts
        lo, hi = _box(shape, dim, None if dim is None else index * length,
                      length)
        out = torch.empty([h - l for l, h in zip(lo, hi)],
                          dtype=self.dtype(name))
        covered = 0
        for piece in leaf["pieces"]:
            plo, phi = _box(shape, piece["dim"], piece["offset"],
                            piece["length"])
            ilo = [max(a, b) for a, b in zip(lo, plo)]
            ihi = [min(a, b) for a, b in zip(hi, phi)]
            if any(a >= b for a, b in zip(ilo, ihi)):
                continue
            dst = out
            for d, (a, b) in enumerate(zip(ilo, ihi)):
                dst = dst.narrow(d, a - lo[d], b - a)
            self._fill(dst, piece, name, [b - a for a, b in zip(plo, phi)],
                       [a - p for a, p in zip(ilo, plo)],
                       [b - p for b, p in zip(ihi, plo)])
            covered += dst.numel()
        if covered != out.numel():
            raise RuntimeError(f"{name}: the pieces cover {covered} of "
                               f"{out.numel()} elements")
        nbytes = out.numel() * out.element_size()
        self.bytes_read += nbytes
        self.largest_read = max(self.largest_read, nbytes)
        return out


# --------------------------------------------------------- the manager


class CheckpointManager:
    """Sharded train-state steps + crash-consistent cursors under
    ``directory``, for this process of the default process group (or a
    lone process).

    Every process calls ``save(step, state, cursor)`` with its own tree
    (the same structure everywhere) and :meth:`restore_latest`, which
    returns ``(state, cursor, step)`` from the newest step intact for
    every process, skipping corrupt or partial ones. ``save_ms`` holds
    each save's time on the caller's thread (the previous step's write
    awaited and committed, the copy off the card, plus the write when
    awaited), ``wait_ms`` the first part of it, ``write_ms``
    each shard write's time on the writer thread, ``bytes_written`` this
    process's shard bytes each committed step (0 when it wrote none),
    ``restore_bytes``, ``restore_largest`` and ``restore_scanned`` what
    the last restore assembled, its largest tensor and the shard bytes it
    read,
    and ``last_success_step`` the newest step whose index committed — the
    JAX package's ``ckpt_save_ms`` and ``ckpt_last_success_step``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, group=None,
                 gate=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        # Every process's groups (None: the default group): ``group``
        # carries the collectives, ``gate`` (gloo, its timeout short)
        # :meth:`peers_present`'s barrier.
        self.group, self.gate = group, gate
        self.save_ms: list = []
        self.wait_ms: list = []
        self.write_ms: list = []
        self.bytes_written: list = []
        self.restore_bytes: Optional[int] = None
        self.restore_largest: Optional[int] = None
        self.restore_scanned: Optional[int] = None
        self.last_success_step: Optional[int] = None
        # Steps proven unrestorable THIS process (a torn shard, which only
        # an actual read detects). A fallback rerun revisits these ids;
        # save() must treat them as stale occupants, never as
        # already-persisted progress.
        self._poisoned: set = set()
        self._writer: Optional[threading.Thread] = None
        self._pending: Optional[dict] = None  # the step awaiting its commit
        # One page-locked host buffer for a save's tensors on the card,
        # refilled by each save once the previous write is done: a plain
        # allocation of their bytes, page-locked by cudaHostRegister (torch's
        # pinned allocator rounds a request up to a power of two, which
        # held 1.17 GB for a 654 MB save on the H100).
        self._staging: Optional[torch.Tensor] = None
        self._unpin = None  # unregisters _staging (a weakref.finalize)

    # -- layout -------------------------------------------------------------

    def _cursor_path(self, step: int) -> str:
        return os.path.join(self.directory, _CURSOR_DIR, f"{int(step)}.json")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def index_path(self, step: int) -> str:
        """The index of ``step``."""
        return os.path.join(self._step_dir(step), _INDEX_FILE)

    def _legacy_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), _LEGACY_FILE)

    def index(self, step: int) -> Optional[dict]:
        """The verified index of ``step``, or ``None``."""
        return read_verified_json(self.index_path(step))

    def shard_paths(self, step: int) -> list:
        """The files that hold ``step``'s tensors, in rank order (a step of
        the earlier format: its ``state.pt``)."""
        index = self.index(step)
        if index is None:
            legacy = self._legacy_path(step)
            return [legacy] if os.path.isfile(legacy) else []
        return [os.path.join(self._step_dir(step), f)
                for f in sorted(index["files"],
                                key=lambda f: index["files"][f]["rank"])]

    def step_bytes(self, step: int) -> Optional[int]:
        """The bytes of ``step``'s files, every process's together."""
        index = self.index(step)
        if index is not None:
            return sum(f["bytes"] for f in index["files"].values())
        legacy = self._legacy_path(step)
        return os.path.getsize(legacy) if os.path.isfile(legacy) else None

    def all_steps(self) -> list:
        """Steps whose index committed (or that hold a ``state.pt`` of the
        earlier format), ascending (numeric order)."""
        try:
            names = os.listdir(self.directory)  # ldt: ignore[LDT003] -- the step numbers are sorted below, numerically
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and (
            os.path.isfile(self.index_path(int(n)))
            or os.path.isfile(self._legacy_path(int(n)))))

    def cursor(self, step: int) -> Optional[dict]:
        """The verified cursor payload saved with ``step``, or ``None``."""
        return read_verified_json(self._cursor_path(step))

    def step_intact(self, step: int) -> bool:
        """True when ``step`` is safe to restore: its index verifies and
        every shard it names is present at its recorded size (or it holds
        a ``state.pt`` of the earlier format), and its cursor sidecar
        passes the content hash — the cursor and the model state are never
        un-paired."""
        if step in self._poisoned:
            return False
        index = self.index(step)
        if index is not None:
            for name, entry in index["files"].items():
                path = os.path.join(self._step_dir(step), name)
                try:
                    if os.path.getsize(path) != entry["bytes"]:
                        return False
                except OSError:
                    return False
        elif not os.path.isfile(self._legacy_path(step)):
            return False
        return self.cursor(step) is not None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> Optional[int]:
        """Newest step that :meth:`step_intact` accepts — the restore
        candidate order."""
        for step in reversed(self.all_steps()):
            if self.step_intact(step):
                return step
        return None

    def reader(self, step: int) -> StepReader:
        """A :class:`StepReader` of ``step`` (raises when it holds
        neither a verified index nor a ``state.pt``)."""
        index = self.index(step)
        if index is not None:
            return StepReader(self._step_dir(step), index)
        state = torch.load(self._legacy_path(step), map_location="cpu",
                           weights_only=True)
        return StepReader.of_state(state)

    def read_state(self, step: int):
        """``step``'s whole state tree, every leaf whole on the host."""
        with self.reader(step) as reader:
            return reader.whole()

    # -- the process group ---------------------------------------------------

    def all_gather(self, obj) -> list:
        """Every process's ``obj``, in rank order, over ``group``."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _broadcast(self, obj):
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def peers_present(self) -> bool:
        """Whether every process reaches this call within ``gate``'s
        timeout of the others (a barrier over ``gate``, which gives up on
        every process that waits): the gate of a save that a failing
        process makes, whose peers may be blocked in a training collective
        and never come."""
        if self.world == 1:
            return True
        try:
            dist.barrier(group=self.gate)
        except RuntimeError:
            return False
        return True

    # -- save ---------------------------------------------------------------

    def _writes(self, leaf) -> bool:
        return leaf.write if isinstance(leaf, Piece) else self.rank == 0

    def _snapshot(self, tensors: list) -> list:
        """Copies of ``tensors`` in host memory, which the background write
        may read while training goes on. Those on the card are copied into
        the pinned buffer kept from the last save, grown when they need
        more (a pageable copy runs at a fraction of the link's rate), and
        synchronised."""
        tensors = [t.detach() for t in tensors]
        spans = [-(-t.numel() * t.element_size() // 16) * 16
                 for t in tensors if t.is_cuda]
        if spans and (self._staging is None
                      or self._staging.numel() < sum(spans)):
            self._release_staging()
            buf = torch.empty(sum(spans), dtype=torch.uint8)
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                buf.data_ptr(), buf.numel(), 0))
            self._staging = buf
            self._unpin = weakref.finalize(self, _unregister, buf)
        out, at = [], 0
        for t in tensors:
            if not t.is_cuda:
                out.append(t.clone(memory_format=torch.contiguous_format))
                continue
            n = t.numel() * t.element_size()
            buf = self._staging[at:at + n].view(t.dtype).view(t.shape)
            out.append(buf.copy_(t, non_blocking=True))
            at += -(-n // 16) * 16
        if spans:
            torch.cuda.synchronize()  # the pinned copies have landed
        return out

    def _release_staging(self) -> None:
        """The staging buffer unregistered and dropped."""
        if self._unpin is not None:
            self._unpin()
        self._staging = self._unpin = None

    def _clear_step(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step))
        try:
            os.unlink(self._cursor_path(step))
        except OSError:
            pass

    def _open_step(self, step: int, cursor: dict) -> Optional[str]:
        """Rank 0's part of a save before any shard is written: ``None``
        to go on (a stale non-intact occupant cleared, the sidecar
        written), ``"duplicate"`` when an intact step holds the id, else
        the error."""
        if os.path.isdir(self._step_dir(step)):
            if self.step_intact(step):
                return "duplicate"
            try:
                self._clear_step(step)
            except OSError as exc:
                # Loud, not False: a benign-looking skip here would let a
                # SIGTERM drain exit 0 having persisted nothing.
                return f"cannot clear stale checkpoint step {step}: {exc}"
        try:
            # Sidecar FIRST: if we crash before the index commits, the step
            # never appears in all_steps() and the orphan sidecar is
            # collected; the reverse order could commit model state with no
            # cursor.
            atomic_write_json(self._cursor_path(step), cursor)
        except OSError as exc:
            return f"cannot write the cursor of checkpoint step {step}: {exc}"
        return None

    def save(self, step: int, state: Any, cursor: dict,
             wait: bool = False) -> bool:
        """Persist this process's share of ``state`` under ``step`` (rank
        0 also writes ``cursor``). Every process calls it, with the same
        step. Returns False when an INTACT checkpoint already holds the
        step (an emergency save racing a periodic one must not raise). A
        stale NON-intact occupant is deleted and overwritten (raising when
        it cannot be cleared).

        What this process writes is copied off the card before this
        returns, so the caller may go on training; the shard is written on
        a background thread and committed at the next save, by
        :meth:`close`, or here when ``wait`` (required before process exit:
        emergency checkpoints)."""
        step = int(step)
        t0 = time.perf_counter()
        self.wait_until_finished()
        waited = (time.perf_counter() - t0) * 1e3
        opened = self._open_step(step, cursor) if self.rank == 0 else None
        opened = self._broadcast(opened)
        if opened == "duplicate":
            return False
        if opened is not None:
            raise RuntimeError(opened)
        skeleton, leaves = _flatten(state)
        mine = {name: leaf for name, leaf in leaves.items()
                if self._writes(leaf)}
        host = dict(zip(mine, self._snapshot([
            leaf.tensor if isinstance(leaf, Piece) else leaf
            for leaf in mine.values()])))
        self._poisoned.discard(step)  # the id now holds fresh content
        file = f"shard-{self.rank:05d}.bin" if mine else None
        pieces, at = {}, 0
        for name, t in host.items():
            pieces[name] = _leaf_entry(mine[name])
            pieces[name]["piece"]["at"] = at
            at += t.numel() * t.element_size()
        outcome: dict = {}
        self._pending = {
            "step": step, "file": file, "outcome": outcome,
            "pieces": pieces,
            "skeleton": skeleton if self.rank == 0 else None,
            "names": list(leaves) if self.rank == 0 else None}
        if mine:
            self._writer = threading.Thread(
                target=self._write,
                args=(step, file, list(host.values()), outcome),
                daemon=True, name="ldt-ckpt-writer")
            self._writer.start()
        if wait:
            self.wait_until_finished()
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        self.wait_ms.append(waited)
        return True

    def _write(self, step: int, file: str, host: list,
               outcome: dict) -> None:
        """The writer thread: this process's shard (the bytes of ``host``
        in order), by temporary name and ``os.replace``; its bytes and
        time, or its error, in ``outcome``."""
        t0 = time.perf_counter()
        try:
            directory = self._step_dir(step)
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory, prefix="tmp-shard-",
                                       suffix=".bin")
            try:
                with os.fdopen(fd, "wb") as f:
                    _write_tensors(f, host)
                    f.flush()
                    os.fsync(f.fileno())
                final = os.path.join(directory, file)
                os.replace(tmp, final)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            outcome.update(bytes=os.path.getsize(final),
                           ms=(time.perf_counter() - t0) * 1e3)
        except BaseException as exc:  # handed to the commit
            outcome["error"] = str(exc) or type(exc).__name__

    def wait_until_finished(self) -> None:
        """Await this process's background write and commit the step with
        every process: raises, on every process, when any write or the
        index failed. Collective when a save is pending."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        pending, self._pending = self._pending, None
        if pending is None:
            return
        outcome = pending["outcome"]
        statuses = self.all_gather({
            "rank": self.rank, "error": outcome.get("error"),
            "file": pending["file"], "bytes": outcome.get("bytes"),
            "pieces": pending["pieces"]})
        failed = [s for s in statuses if s["error"] is not None]
        if failed:
            raise RuntimeError("checkpoint write failed: " + "; ".join(
                s["error"] if self.world == 1 else
                f"rank {s['rank']}: {s['error']}" for s in failed))
        error = None
        if self.rank == 0:
            try:
                self._write_index(pending, statuses)
                self._collect()
            except Exception as exc:  # noqa: BLE001 — every process raises
                error = (f"checkpoint commit of step {pending['step']} "
                         f"failed: {exc}")
        error = self._broadcast(error)
        if error is not None:
            raise RuntimeError(error)
        self.last_success_step = pending["step"]
        if "ms" in outcome:
            self.write_ms.append(outcome["ms"])
        self.bytes_written.append(outcome.get("bytes") or 0)

    def _write_index(self, pending: dict, statuses: list) -> None:
        """Rank 0: the step's index, once every process's shard is in
        place; each leaf's pieces must cover it exactly."""
        leaves: dict = {}
        files: dict = {}
        for status in statuses:
            if status["file"] is not None:
                files[status["file"]] = {"rank": status["rank"],
                                         "bytes": status["bytes"]}
            for name, entry in sorted(status["pieces"].items()):
                leaf = leaves.setdefault(name, {
                    "shape": entry["shape"], "dtype": entry["dtype"],
                    "pieces": []})
                if (leaf["shape"], leaf["dtype"]) != (entry["shape"],
                                                      entry["dtype"]):
                    raise ValueError(f"{name}: the processes disagree on its "
                                     "shape or dtype")
                leaf["pieces"].append(dict(entry["piece"],
                                           file=status["file"],
                                           rank=status["rank"]))
        missing = [n for n in pending["names"] if n not in leaves]
        if missing:
            raise ValueError(f"no process wrote {missing[:5]}")
        for name, leaf in leaves.items():
            whole = math.prod(leaf["shape"])
            held = sum(whole if p["dim"] is None else
                       whole // leaf["shape"][p["dim"]] * p["length"]
                       for p in leaf["pieces"])
            if held != whole:
                raise ValueError(f"{name}: the pieces hold {held} of its "
                                 f"{whole} elements")
        atomic_write_json(self.index_path(pending["step"]), {
            "format": _FORMAT, "step": pending["step"],
            "processes": self.world, "tree": pending["skeleton"],
            "leaves": leaves, "files": files})

    def _collect(self) -> None:
        """Keep the newest ``max_to_keep`` committed steps; drop sidecars
        whose step was collected or never committed (a crash between the
        sidecar write and the index)."""
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

    def restore_latest(self, read: Optional[Callable[[StepReader], Any]]
                       = None) -> Optional[Tuple[Any, dict, int]]:
        """``(state, cursor, step)`` from the newest step intact for every
        process; ``state`` is ``read(reader)`` (this process's share), or
        without ``read`` the whole tree.

        Walks rank 0's steps newest-first; a step that fails intactness OR
        whose read raises (a shard torn by a crash mid-write) on any
        process is skipped by every process in favour of the previous one
        — a damaged latest checkpoint degrades resume granularity, never
        the restart itself. :class:`CheckpointRefused` from ``read`` (a
        state tree that differs) raises on every process. Returns ``None``
        when no step restores (fresh start). Collective."""
        self.wait_until_finished()
        steps = self._broadcast(self.all_steps() if self.rank == 0 else None)
        for step in reversed(steps):
            value, status, reader = None, "ok", None
            if not self.step_intact(step):
                status = "torn"
            else:
                try:
                    reader = self.reader(step)
                    value = read(reader) if read is not None \
                        else reader.whole()
                except CheckpointRefused as exc:
                    status = f"refused: {exc}"
                except Exception:  # noqa: BLE001 — any torn step falls back
                    status = "torn"
                finally:
                    if reader is not None:
                        reader.close()
            statuses = self.all_gather(status)
            refused = [s for s in statuses if s.startswith("refused: ")]
            if refused:
                raise CheckpointRefused(
                    f"checkpoint step {step}: "
                    f"{refused[0][len('refused: '):]}")
            if all(s == "ok" for s in statuses):
                self.restore_bytes = reader.bytes_read
                self.restore_largest = reader.largest_read
                self.restore_scanned = reader.bytes_scanned
                return value, self.cursor(step), step
            # Poison the id on every process: intactness checks cannot see
            # a torn shard, and the rerun will revisit this step — save()
            # must overwrite it, not mistake it for persisted progress.
            self._poisoned.add(step)
        return None

    def close(self, commit: bool = True) -> None:
        """Await the background write and commit it (collective); with
        ``commit`` False (a run failing on one process, whose peers may
        never reach the commit) only await the write, leaving the step
        uncommitted. The staging buffer is released either way."""
        try:
            if commit:
                self.wait_until_finished()
                return
            if self._writer is not None:
                self._writer.join()
                self._writer = None
            self._pending = None
        finally:
            self._release_staging()
