"""K3 — the ragged token pack and unpack, the hand-written kernels and their
plain versions, and the trainer's pack transform.

Counterpart of ``lance_distributed_training_tpu/ops/token_device.py``. The
host half (:mod:`..data.token_pack`) ships a variable-length column as a
flat int32 values page, its ``[n+1]`` offsets and a first-fit-decreasing
plan (``slot``/``start`` per sequence, a ``rows × pack_len`` grid). Here
``csrc/token_pack.cu`` (sm_90a) finishes the job in one launch: each CTA
owns a tile of the grid, intersects every sequence's run
``grid[slot, start:start + len]`` with it and writes each of its cells once,
in the grid and in 1-based ``segment_ids`` (0 = dead padding), 0-based
``position_ids`` and the int8 ``attention_mask``.
:func:`unpack_token_batch` is the exact inverse gather.

Both are integer paths: the kernels equal their plain versions, and the
plain versions equal the JAX functions, bit for bit. The plain versions
repeat the JAX arithmetic (``searchsorted``, ``clamp``, ``where`` and an
``index_put_`` into a grid with one extra trailing cell for the dropped
positions). Values must be int32 (the JAX package without x64 holds token
ids as int32); other types raise.

The wrappers route by the device of their inputs: CPU tensors take the
plain versions, CUDA tensors launch the kernels or raise.
``LAUNCHES["token_pack"]`` and ``LAUNCHES["token_unpack"]`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..data.token_pack import (
    OFFSETS_SUFFIX,
    PACK_MODE_FFD,
    PACK_SLOT_KEY,
    PACK_START_KEY,
    VALUES_SUFFIX,
    is_host_meta_key,
    is_ragged_batch,
    pack_meta,
    ragged_bases,
)
from . import _build
from ..utils import compiletrack

__all__ = [
    "LAUNCHES",
    "PackTransform",
    "is_packed_input",
    "make_pack_transform",
    "pack_token_batch",
    "pack_token_batch_reference",
    "unpack_token_batch",
    "unpack_token_batch_reference",
]

LAUNCHES = {"token_pack": 0, "token_unpack": 0}
# Bytes a grid cell takes in the pack's output: grid, segment ids and
# positions (int32 each) and the mask (int8).
CELL_BYTES = 13

_SOURCE = "token_pack"
_lib: Optional[ctypes.CDLL] = None


def is_packed_input(batch) -> bool:
    """Does this batch carry the ragged convention (needs the pack
    transform before the step)?"""
    return is_ragged_batch(batch)


# ------------------------------------------------------------ plain versions


def _owners(offsets: torch.Tensor, flat: torch.Tensor, n: int,
            pack_len: int):
    """For each flat position: its sequence, JAX's ``clip(searchsorted(
    offsets, flat, side="right") - 1, 0, n - 1)``, its offset ``k`` in that
    sequence and whether it is a live token (before ``offsets[n]`` and
    within the sequence's length capped at ``pack_len``)."""
    seq = torch.clamp(
        torch.searchsorted(offsets, flat, right=True) - 1, 0, n - 1)
    lengths = torch.clamp(offsets[1:] - offsets[:-1], max=pack_len)
    k = flat - offsets[seq]
    return seq, k, (flat < offsets[n]) & (k < lengths[seq])


def pack_token_batch_reference(values, offsets, slot, start, *, rows: int,
                               pack_len: int):
    """Plain ``pack_token_batch``: ``(grid, segment_ids, position_ids,
    attention_mask)``, each ``[rows, pack_len]`` (values' dtype, int32,
    int32, int8)."""
    dev = values.device
    cap, n = values.shape[0], slot.shape[0]
    cells = rows * pack_len
    grid = torch.zeros(cells + 1, dtype=values.dtype, device=dev)
    seg = torch.zeros(cells + 1, dtype=torch.int32, device=dev)
    pos = torch.zeros(cells + 1, dtype=torch.int32, device=dev)
    if n > 0 and cap > 0:
        offsets = offsets.to(torch.int64)
        flat = torch.arange(cap, dtype=torch.int64, device=dev)
        seq, k, valid = _owners(offsets, flat, n, pack_len)
        dest = slot.to(torch.int64)[seq] * pack_len \
            + start.to(torch.int64)[seq] + k
        # A negative index counts from the end, as in JAX's scatter; what
        # is still outside the grid goes to the trailing cell, dropped.
        dest = torch.where(dest < 0, dest + cells, dest)
        dest = torch.where(valid & (dest >= 0) & (dest < cells), dest,
                           torch.full_like(dest, cells))
        grid.index_put_((dest,), values)
        seg.index_put_((dest,), (seq + 1).to(torch.int32))
        pos.index_put_((dest,), k.to(torch.int32))
    shape = (rows, pack_len)
    seg = seg[:cells].reshape(shape)
    return (grid[:cells].reshape(shape), seg, pos[:cells].reshape(shape),
            (seg > 0).to(torch.int8))


def unpack_token_batch_reference(grid, offsets, slot, start, *,
                                 capacity: int):
    """Plain ``unpack_token_batch``: the flat int page ``[capacity]``, zero
    where no live token lies."""
    rows, pack_len = grid.shape
    dev = grid.device
    n = slot.shape[0]
    out = torch.zeros(capacity, dtype=grid.dtype, device=dev)
    if n == 0 or capacity == 0:
        return out
    offsets = offsets.to(torch.int64)
    flat = torch.arange(capacity, dtype=torch.int64, device=dev)
    seq, k, valid = _owners(offsets, flat, n, pack_len)
    src = slot.to(torch.int64)[seq] * pack_len + start.to(torch.int64)[seq] + k
    src = torch.clamp(src, 0, rows * pack_len - 1)
    return torch.where(valid, grid.reshape(-1)[src], out)


# ------------------------------------------------------------ kernels


def _library() -> ctypes.CDLL:
    """Build (once), load and declare the C interface of ``token_pack.cu``."""
    global _lib
    if _lib is None:
        lib = _build.load_library(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ldt_token_pack.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32,
                                       ptr, ptr]
        lib.ldt_token_unpack.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32,
                                         ptr, i32, ptr]
        lib.ldt_token_pack.restype = ctypes.c_int
        lib.ldt_token_unpack.restype = ctypes.c_int
        lib.ldt_token_error_string.argtypes = [ctypes.c_int]
        lib.ldt_token_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_INT32_MAX = 2 ** 31 - 1


def _check(name: str, device, tensors, offsets, slot, start) -> None:
    """Validate a launch's inputs; raise on anything the kernel does not
    take."""
    for t_name, t in (*tensors, ("offsets", offsets), ("slot", slot),
                      ("start", start)):
        if t.device != device:
            raise ValueError(f"{name}: {t_name} on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {t_name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    for t_name, t in (("offsets", offsets), ("slot", slot), ("start", start)):
        if t.dim() != 1:
            raise ValueError(f"{name}: {t_name} must be 1-D, got "
                             f"{tuple(t.shape)}")
    n = slot.shape[0]
    if start.shape[0] != n or offsets.shape[0] != n + 1:
        raise ValueError(f"{name}: offsets [{offsets.shape[0]}], slot [{n}] "
                         f"and start [{start.shape[0]}] must be [n+1], [n], "
                         "[n]")


def _launch(name: str, fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        msg = _library().ldt_token_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (code {code})")
    LAUNCHES[name] += 1


def pack_token_batch(values, offsets, slot, start, *, rows: int,
                     pack_len: int):
    """Ragged runs → ``(grid, segment_ids, position_ids, attention_mask)``,
    each ``[rows, pack_len]``. CUDA: the ``token_pack`` kernel, one launch
    that writes every cell (int32 in; the four outputs are views of one
    buffer). CPU: :func:`pack_token_batch_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(
            values, offsets, slot, start, rows=rows, pack_len=pack_len)
    device = values.device
    if device.type == "cpu":
        return pack_token_batch_reference(values, offsets, slot, start,
                                          rows=rows, pack_len=pack_len)
    if device.type != "cuda":
        raise RuntimeError(f"pack_token_batch has no kernel for device "
                           f"{device}")
    # On the current card (the trainer's case) no device context is
    # entered: the host time of a call is most of this launch's cost.
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        with torch.cuda.device(device):
            return pack_token_batch(values, offsets, slot, start, rows=rows,
                                    pack_len=pack_len)
    _check("token_pack", device, [("values", values)], offsets, slot, start)
    if values.dim() != 1:
        raise ValueError(f"token_pack: values must be 1-D, got "
                         f"{tuple(values.shape)}")
    rows, pack_len = int(rows), int(pack_len)
    cells = rows * pack_len
    if rows <= 0 or pack_len <= 0 or cells * 4 > _INT32_MAX:
        raise ValueError(f"token_pack: grid [{rows}, {pack_len}] out of range")
    if values.shape[0] > _INT32_MAX:
        raise ValueError("token_pack: values page longer than 2^31 - 1")
    # Three int32 planes, then the int8 mask in the words after them; the
    # four views take two strided views, not a slice and reshape each.
    out = torch.empty(3 * cells + (cells + 3) // 4, dtype=torch.int32,
                      device=device)
    _launch("token_pack", _library().ldt_token_pack, values.data_ptr(),
            values.shape[0], offsets.data_ptr(), slot.data_ptr(),
            start.data_ptr(), slot.shape[0], rows, pack_len, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    grid, seg, pos = out.as_strided((3, rows, pack_len),
                                    (cells, pack_len, 1)).unbind(0)
    mask = out.view(torch.int8).as_strided((rows, pack_len), (pack_len, 1),
                                           12 * cells)
    return grid, seg, pos, mask


def unpack_token_batch(grid, offsets, slot, start, *, capacity: int):
    """The inverse gather: packed ``[rows, pack_len]`` grid → the flat page
    ``[capacity]`` (zero tail). CUDA: the ``token_unpack`` kernel. CPU:
    :func:`unpack_token_batch_reference`."""
    if compiletrack.enabled():
        compiletrack.track_launch(
            grid, offsets, slot, start, capacity=capacity)
    if grid.device.type == "cpu":
        return unpack_token_batch_reference(grid, offsets, slot, start,
                                            capacity=capacity)
    if grid.device.type != "cuda":
        raise RuntimeError(f"unpack_token_batch has no kernel for device "
                           f"{grid.device}")
    _check("token_unpack", grid.device, [("grid", grid)], offsets, slot,
           start)
    if grid.dim() != 2:
        raise ValueError(f"token_unpack: grid must be [rows, pack_len], got "
                         f"{tuple(grid.shape)}")
    rows, pack_len = grid.shape
    capacity = int(capacity)
    if not 0 <= capacity <= _INT32_MAX or grid.numel() * 4 > _INT32_MAX:
        raise ValueError("token_unpack: capacity or grid out of range")
    out = torch.empty(capacity, dtype=torch.int32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        _launch("token_unpack", _library().ldt_token_unpack, grid.data_ptr(),
                rows, pack_len, offsets.data_ptr(), slot.data_ptr(),
                start.data_ptr(), slot.shape[0], out.data_ptr(), capacity,
                stream)
    return out


# ------------------------------------------------------------ the transform


class PackTransform:
    """The trainer's pack stage: a ragged batch's values/offsets/plan leaves
    become the packed ``[rows, L]`` grids plus ``attention_mask`` (and, in
    FFD mode, ``segment_ids``/``position_ids``); every other leaf passes
    through. A batch that is not ragged (the padded arm, every eval batch)
    passes through whole.

    ``rows``/``pack_len`` come from the host ``_host_pack_meta`` header, so
    the transform makes no device sync. ``pack_new_shapes_total`` counts
    the distinct ``(rows, pack_len, capacity, n + 1)`` shapes seen."""

    def __init__(self):
        self._seen: set = set()
        self.pack_new_shapes_total = 0

    def __call__(self, batch: Dict) -> Dict:
        if not is_ragged_batch(batch):
            return batch
        rows, pack_len, _payload, mode = pack_meta(batch)
        slot = batch[PACK_SLOT_KEY]
        start = batch[PACK_START_KEY]
        out = {
            k: v for k, v in batch.items()
            if not (
                k.endswith(VALUES_SUFFIX) or k.endswith(OFFSETS_SUFFIX)
                or k in (PACK_SLOT_KEY, PACK_START_KEY)
                or is_host_meta_key(k)
            )
        }
        seg = pos = mask = None
        for base in ragged_bases(batch):
            values = batch[base + VALUES_SUFFIX]
            offsets = batch[base + OFFSETS_SUFFIX]
            shape_key = (rows, pack_len, int(values.shape[0]),
                         int(offsets.shape[0]))
            if shape_key not in self._seen:
                self._seen.add(shape_key)
                self.pack_new_shapes_total += 1
            out[base], seg, pos, mask = pack_token_batch(
                values, offsets, slot, start, rows=rows, pack_len=pack_len)
        if seg is not None:
            out["attention_mask"] = mask
            if mode == PACK_MODE_FFD:
                # Bucket mode holds one sequence a row: positions restart at
                # 0 per row anyway and the mask says the rest.
                out["segment_ids"] = seg
                out["position_ids"] = pos
        return out


def make_pack_transform() -> PackTransform:
    """The pack stage the trainer applies after the H2D copy."""
    return PackTransform()
