"""ctypes binding and build at first use of the coefficient extractor.

Counterpart of the entropy-split half of
``lance_distributed_training_tpu/native/jpeg.py`` (``payload_pointers``,
``arrow_pointers``, ``batch_probe_jpeg``, ``batch_extract_coeffs``), with the
same shapes and dtypes. The JAX package's extractor calls libjpeg; this one
(``ldt_coeffs.cpp``) parses the markers and Huffman-decodes by itself, so it
builds with ``g++`` alone, with no ``-l`` flag.

The library builds as the pixel decoder's does (``jpeg.py``): at first use,
into ``build/native/`` at the root of the checkout, named by the hash of its
source and flags, linked by each process into a temp name of its own and
renamed over the target. When it cannot be built, :func:`load` raises with
the compiler's error: device decode has no other arm to fall back to.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa

from .jpeg import build_library, library_path

__all__ = ["arrow_pointers", "batch_extract_coeffs", "batch_probe_jpeg",
           "default_threads", "load", "payload_pointers"]

_SRC = Path(__file__).resolve().parent / "ldt_coeffs.cpp"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    pp = ctypes.POINTER(ctypes.c_char_p)
    sp = ctypes.POINTER(ctypes.c_size_t)
    i32, vp = ctypes.c_int, ctypes.c_void_p
    lib.ldt_probe_batch.restype = i32
    lib.ldt_probe_batch.argtypes = [pp, sp, i32, vp, vp]
    lib.ldt_extract_coeffs.restype = i32
    lib.ldt_extract_coeffs.argtypes = [pp, sp, i32, i32, i32, i32, i32,
                                       vp, vp, vp, vp, vp, vp, i32]
    lib.ldt_coeffs_default_threads.restype = i32
    lib.ldt_coeffs_default_threads.argtypes = []
    return lib


def load() -> ctypes.CDLL:
    """The extractor library, built on first call; raises ``RuntimeError``
    with the build error when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path(_SRC, _FLAGS, "ldt_coeffs")
            try:
                if not target.exists():
                    build_library(_SRC, target, _FLAGS)
            except OSError as exc:
                raise RuntimeError(f"coefficient extractor: {exc}") from exc
            try:
                lib = ctypes.CDLL(str(target))
            except OSError as exc:
                raise RuntimeError(f"coefficient extractor: cannot load "
                                   f"{target}: {exc}") from exc
            if lib.ldt_coeffs_abi_version() != _ABI_VERSION:
                raise RuntimeError(
                    f"coefficient extractor {target.name}: ABI version "
                    f"{lib.ldt_coeffs_abi_version()}, expected {_ABI_VERSION}")
            _lib = _bind(lib)
        return _lib


def default_threads() -> int:
    """The threads :func:`batch_extract_coeffs` takes for ``n_threads=0``:
    one per hardware thread of this machine."""
    return int(load().ldt_coeffs_default_threads())


def payload_pointers(payloads: Sequence[bytes]):
    """Pointer arrays over a list of JPEG byte strings: ``(srcs, lens, n,
    keepalive)``; ``keepalive`` must outlive the call."""
    n = len(payloads)
    srcs = (ctypes.c_char_p * n)(*payloads)
    lens = (ctypes.c_size_t * n)(*[len(p) for p in payloads])
    return srcs, lens, n, payloads


def arrow_pointers(binary_array: pa.Array):
    """Pointer arrays straight over an Arrow binary (or large_binary)
    column's buffers, with no per-row ``bytes``; rows must be non-null."""
    n = len(binary_array)
    validity, offsets_buf, values = binary_array.buffers()
    if validity is not None and binary_array.null_count:
        raise ValueError("null image rows are not decodable")
    wide = pa.types.is_large_binary(binary_array.type)
    raw = np.frombuffer(offsets_buf, dtype=np.int64 if wide else np.int32,
                        count=binary_array.offset + n + 1)
    offsets = raw[binary_array.offset:binary_array.offset + n + 1].astype(
        np.int64)
    base = values.address if values is not None else 0
    srcs = (ctypes.c_char_p * n)(
        *[ctypes.c_char_p(base + int(o)) for o in offsets[:-1]])
    lens = (ctypes.c_size_t * n)(*np.diff(offsets).tolist())
    # The Arrow buffers (and through them the column) stay alive for as
    # long as the pointer arrays are in use.
    return srcs, lens, n, (binary_array, values)


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def batch_probe_jpeg(pointers) -> tuple[np.ndarray, np.ndarray]:
    """Header-only parse of a batch: ``(geom [N, 4] int32, failed [N]
    uint8)``, geom rows ``(width, height, ncomp, coeff_ok)``. ``coeff_ok``
    is 1 when the image is extractable into the canonical page (grayscale
    or YCbCr 4:2:0, Huffman-coded)."""
    lib = load()
    srcs, lens, n, keepalive = pointers
    geom = np.zeros((n, 4), dtype=np.int32)
    failed = np.zeros(n, dtype=np.uint8)
    if n:
        lib.ldt_probe_batch(srcs, lens, n, _ptr(geom), _ptr(failed))
    del keepalive
    return geom, failed


def _check_page(arr: np.ndarray, shape: tuple, dtype, name: str) -> None:
    """The extractor writes through the page's pointer: exact shape and
    dtype, C-contiguous and writeable, or it raises."""
    if arr.dtype != dtype:
        raise ValueError(f"{name} must be {np.dtype(dtype)}, got {arr.dtype}")
    if tuple(arr.shape) != shape:
        raise ValueError(f"{name} shape {tuple(arr.shape)} != {shape}")
    if not arr.flags["C_CONTIGUOUS"] or not arr.flags["WRITEABLE"]:
        raise ValueError(f"{name} must be C-contiguous and writeable")


def batch_extract_coeffs(pointers, yb_h: int, yb_w: int, cb_h: int,
                         cb_w: int, coef_y: np.ndarray, coef_cb: np.ndarray,
                         coef_cr: np.ndarray, quant: np.ndarray,
                         geom: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Entropy-decode a batch into the caller's canonical pages, which must
    be zeroed (padding blocks are never written). Returns the per-image
    ``failed`` mask; a failed row's page contents are unspecified."""
    lib = load()
    srcs, lens, n, keepalive = pointers
    _check_page(coef_y, (n, yb_h, yb_w, 64), np.int16, "coef_y")
    _check_page(coef_cb, (n, cb_h, cb_w, 64), np.int16, "coef_cb")
    _check_page(coef_cr, (n, cb_h, cb_w, 64), np.int16, "coef_cr")
    _check_page(quant, (n, 3, 64), np.int32, "quant")
    _check_page(geom, (n, 6), np.int32, "geom")
    failed = np.zeros(n, dtype=np.uint8)
    if n:
        lib.ldt_extract_coeffs(srcs, lens, n, yb_h, yb_w, cb_h, cb_w,
                               _ptr(coef_y), _ptr(coef_cb), _ptr(coef_cr),
                               _ptr(quant), _ptr(geom), _ptr(failed),
                               n_threads)
    del keepalive
    return failed
