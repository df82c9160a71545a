"""ctypes binding and build at first use of the native batch JPEG decoder.

Counterpart of ``lance_distributed_training_tpu/native/jpeg.py``, reduced to
the decode entry points (``ldt_decode_batch``, ``ldt_decode_batch_offsets``).
The library compiles from ``ldt_decode.cpp`` with ``g++ ... -ljpeg`` into
``build/native/`` at the root of the checkout, named by the hash of its
source and flags, never beside the source. Each process links into a temp
name of its own and renames it over the target, so processes that build at
once (test workers) never write the same file. Built without
``-march=native``: the library does not depend on the build machine's CPU,
and the integer-only resize gives the same pixels either way.

When the library cannot be built or loaded (no compiler, no libjpeg
headers), :func:`native_available` is False and the image decoder takes its
PIL arm, as the JAX package's decoder does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa

__all__ = ["BUILD_DIR", "batch_decode_jpeg", "batch_decode_jpeg_arrow",
           "build_error", "build_library", "library_path",
           "native_available"]

_SRC = Path(__file__).resolve().parent / "ldt_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LIBS = ["-ljpeg", "-pthread"]
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library is unavailable, once tried


def library_path(src: Path, flags: list, stem: str) -> Path:
    """Where the library built from ``src`` with ``flags`` lives: under
    :data:`BUILD_DIR`, named by the hash of both."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_library(src: Path, target: Path, flags: list,
                  libs: tuple = ()) -> None:
    """Compile ``src`` into ``target`` with ``g++``: linked under a temp
    name of this process, then renamed over the target. Raises
    ``OSError`` with the compiler's error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")  # ldt: ignore[LDT1301] -- a per-process temp name for the build's output, renamed into place; no decoded value depends on it
    cmd = ["g++", *flags, str(src), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise OSError(f"g++ did not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed (exit {proc.returncode}): "
                      f"{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, target)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ldt_decode_batch.restype = ctypes.c_int
    lib.ldt_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int,
    ]
    lib.ldt_decode_batch_offsets.restype = ctypes.c_int
    lib.ldt_decode_batch_offsets.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, u8p, u8p, ctypes.c_int,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        target = library_path(_SRC, _FLAGS + _LIBS, "ldt_decode")
        try:
            if not target.exists():
                build_library(_SRC, target, _FLAGS, _LIBS)
            lib = ctypes.CDLL(str(target))
            if lib.ldt_decode_abi_version() != _ABI_VERSION:
                raise OSError(f"{target.name}: ABI version "
                              f"{lib.ldt_decode_abi_version()}, expected "
                              f"{_ABI_VERSION}")
            _lib = _bind(lib)
        except OSError as exc:
            _error = str(exc)
        return _lib


def native_available() -> bool:
    """Whether the native library is built (building it on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or ``None`` when it loaded (or has
    not been tried yet)."""
    return _error


def _out(out: Optional[np.ndarray], n: int, out_size: int) -> np.ndarray:
    """A fresh output page, or a caller's page checked for the exact shape:
    the decoder writes ``n * S * S * 3`` bytes whatever it is given."""
    shape = (n, out_size, out_size, 3)
    if out is None:
        return np.empty(shape, dtype=np.uint8)
    if (out.dtype != np.uint8 or tuple(out.shape) != shape
            or not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]):
        raise ValueError(f"out must be a writeable C-contiguous uint8 array "
                         f"of shape {shape}")
    return out


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def batch_decode_jpeg(payloads: Sequence[bytes], out_size: int,
                      n_threads: int = 0,
                      out: Optional[np.ndarray] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """JPEG byte strings → ``([N, S, S, 3] uint8, failed [N] uint8)``;
    failed slots are zero-filled. Raises when the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_error}")
    n = len(payloads)
    out = _out(out, n, out_size)
    failed = np.zeros(n, dtype=np.uint8)
    if n:
        srcs = (ctypes.c_char_p * n)(*payloads)
        lens = (ctypes.c_size_t * n)(*[len(p) for p in payloads])
        lib.ldt_decode_batch(srcs, lens, n, out_size, _u8p(out),
                             _u8p(failed), n_threads)
    return out, failed


def batch_decode_jpeg_arrow(binary_array: pa.Array, out_size: int,
                            n_threads: int = 0,
                            out: Optional[np.ndarray] = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Decode an Arrow binary (or large_binary) array of JPEGs straight from
    its buffers, with no per-row Python bytes. Rows must be non-null."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_error}")
    n = len(binary_array)
    out = _out(out, n, out_size)
    failed = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out, failed
    validity, offsets_buf, values = binary_array.buffers()
    if validity is not None and binary_array.null_count:
        raise ValueError("null image rows are not decodable")
    wide = pa.types.is_large_binary(binary_array.type)
    raw = np.frombuffer(offsets_buf, dtype=np.int64 if wide else np.int32,
                        count=binary_array.offset + n + 1)
    offsets = np.ascontiguousarray(
        raw[binary_array.offset:binary_array.offset + n + 1], dtype=np.int64)
    lib.ldt_decode_batch_offsets(
        ctypes.c_void_p(values.address),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, out_size, _u8p(out), _u8p(failed), n_threads)
    return out, failed
