"""K2 — the dense half of device-side JPEG decode: the hand-written kernel
and its plain version.

Counterpart of ``lance_distributed_training_tpu/ops/jpeg_device.py``
(``decode_coeff_batch`` and its helpers ``_idct_plane``, ``_upsample_h2v2``,
``_ycc_to_rgb``, ``_axis_samples``, ``_resize_one``), a jitted JAX function
on the TPU. The host half (``native/ldt_coeffs.cpp`` through
``data/device_decode.py``) stops at the entropy boundary and ships
coefficient pages; this module turns them into pixels:

    dequantize → 8×8 IDCT → 2×2 chroma upsample → YCbCr→RGB → resize(S)

Coefficient-batch layout (the keys of :data:`COEFF_KEYS`)::

    jpeg_coef_y  : int16 [N, YBH, YBW, 64]   natural-order quantized blocks
    jpeg_coef_cb : int16 [N, CBH, CBW, 64]   4:2:0 chroma grid
    jpeg_coef_cr : int16 [N, CBH, CBW, 64]   (zeros for grayscale rows)
    jpeg_quant   : int32 [N, 3, 64]          per-component dequant tables
    jpeg_geom    : int32 [N, 6]              w, h, yb_w, yb_h, cb_w, cb_h

Everything is integer, and :func:`decode_coeff_batch_reference` is the JAX
function bit for bit, int32 wrap-around included: products and sums are
taken in int64 and wrapped to int32 where XLA's int32 arithmetic wraps, the
shifts are arithmetic, the divisions floor, and a sample index is
normalised (negative + extent) and clamped as JAX's gather does. The IDCT's
contractions are broadcast multiplies and sums (CUDA has no integer
matmul), so the plain version also runs on the card, where
``chip_smoke.py`` holds the kernel against it bit for bit.

:func:`decode_coeff_batch` routes by the device of its inputs: CPU tensors
take the plain version, CUDA tensors launch the kernel
(``csrc/jpeg_decode.cu``) or raise. ``LAUNCHES["jpeg_decode"]`` counts its
launches (one per batch: the IDCT and the colour-and-resize kernels).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = [
    "COEFF_KEYS",
    "HOST_PARITY_MAX_ABS_DIFF",
    "IDCT_BASIS_FIX",
    "LAUNCHES",
    "decode_coeff_batch",
    "decode_coeff_batch_reference",
    "is_coeff_batch",
    "make_batch_transform",
]

# The keys a coefficient batch carries instead of "image"; every other key
# (label, _weight) passes through the transform untouched.
COEFF_KEYS = ("jpeg_coef_y", "jpeg_coef_cb", "jpeg_coef_cr", "jpeg_quant",
              "jpeg_geom")

# The JAX package's pinned envelope (max abs uint8 difference) between this
# arm and the host pixel decoder on its corpora: different IDCT, a
# truncated resize product, and the re-encoded rows.
HOST_PARITY_MAX_ABS_DIFF = 16

# 8-point DCT-III basis in 11-bit fixed point, B[x, u] = c(u)/2 ·
# cos((2x+1)uπ/16), computed in float64 and rounded, as the JAX module does.
_x = np.arange(8)
_B = np.cos((2 * _x[:, None] + 1) * _x[None, :] * np.pi / 16) * np.where(
    _x[None, :] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
IDCT_BASIS_FIX = np.round(_B * 2048.0).astype(np.int32)  # [x, u]
del _x, _B

# jdcolor's 16.16 fixed-point YCbCr→RGB constants.
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_34414 = 22554
_FIX_0_71414 = 46802
_ONE_HALF = 32768

LAUNCHES = {"jpeg_decode": 0}

_SOURCE = "jpeg_decode"
_lib: Optional[ctypes.CDLL] = None
_basis_on: dict = {}  # device -> IDCT_BASIS_FIX as an int32 tensor there


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's values wrapped to int32's range, as int32
    arithmetic wraps (still int64, so later products stay exact)."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _idct_plane(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """``[N, BH, BW, 64]`` int16 blocks and ``[N, 64]`` int32 tables →
    ``[N, BH·8, BW·8]`` pixels in [0, 255] (int64): dequantize, the columns
    pass ``s1[u, y] = Σ_v C[u, v]·B[y, v]``, round-half-up ``>> 11``, the
    rows pass ``p[x, y] = Σ_u B[x, u]·s1[u, y]``, ``>> 11``, +128, clip."""
    n, bh, bw = coef.shape[:3]
    b = torch.from_numpy(IDCT_BASIS_FIX).to(device=coef.device,
                                            dtype=torch.int64)
    c = _wrap32(coef.long() * quant.long()[:, None, None, :])
    c = c.reshape(n, bh, bw, 8, 8)  # [.., u, v]
    s1 = torch.zeros_like(c)
    for v in range(8):
        s1 += c[..., :, v:v + 1] * b[:, v]  # [.., u, 1] · [y] → [.., u, y]
    s1 = _wrap32(_wrap32(s1) + 1024) >> 11
    p = torch.zeros_like(c)
    for u in range(8):
        p += b[:, u, None] * s1[..., u:u + 1, :]  # [x, 1] · [.., 1, y]
    p = _wrap32(_wrap32(_wrap32(p) + 1024) >> 11) + 128
    p = _wrap32(p).clamp(0, 255)
    return p.permute(0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)


def _upsample_h2v2(plane: torch.Tensor, yh: int, yw: int) -> torch.Tensor:
    """Non-fancy h2v2: each chroma sample replicated 2×2, cropped to the
    luma plane's padded size."""
    up = plane.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return up[:, :yh, :yw]


def _ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                cr: torch.Tensor) -> torch.Tensor:
    """jdcolor's integer conversion, ``[N, H, W]`` each → ``[N, H, W, 3]``
    clipped to [0, 255]."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((_FIX_1_40200 * cr + _ONE_HALF) >> 16)
    b = y + ((_FIX_1_77200 * cb + _ONE_HALF) >> 16)
    g = y - ((_FIX_0_34414 * cb + _FIX_0_71414 * cr + _ONE_HALF) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255)


def _axis_samples(size: torch.Tensor, out_size: int):
    """The 16.16 source sampling of one axis, per image: ``(idx0, idx1,
    weight)``, each ``[N, S]``. ``size`` (the real extent) is clamped to at
    least 1, so a zeroed geometry samples pixel 0."""
    size = size.long().clamp_min(1)
    ratio = torch.div(_wrap32((size - 1) << 16),
                      out_size - 1 if out_size > 1 else 1,
                      rounding_mode="floor")
    steps = torch.arange(out_size, device=size.device, dtype=torch.int64)
    fix = _wrap32(steps[None, :] * ratio[:, None])
    idx0 = fix >> 16
    weight = fix & 0xFFFF
    idx1 = torch.minimum(idx0 + 1, size[:, None] - 1)
    return idx0, idx1, weight


def _gather_index(idx: torch.Tensor, extent: int) -> torch.Tensor:
    """JAX's gather on an index: a negative one counts from the end, then
    it is clamped into ``[0, extent)``."""
    idx = torch.where(idx < 0, idx + extent, idx)
    return idx.clamp(0, extent - 1)


def _resize(img, sy0, sy1, wy, sx0, sx1, wx):
    """``[N, H, W, 3]`` → ``[N, S, S, 3]`` by 16.16 fixed-point bilinear,
    the vertical mix first and then the horizontal one, as ``_resize_one``
    (vmapped) does."""
    n, h, w, _ = img.shape
    rows = torch.arange(n, device=img.device)[:, None]
    r0 = img[rows, _gather_index(sy0, h)]  # [N, S, W, 3]
    r1 = img[rows, _gather_index(sy1, h)]
    v = r0 + (((r1 - r0) * wy[:, :, None, None]) >> 16)
    rows3 = rows[:, :, None]
    cols = torch.arange(v.shape[1], device=img.device)[None, :, None]
    v0 = v[rows3, cols, _gather_index(sx0, w)[:, None, :]]  # [N, S, S, 3]
    v1 = v[rows3, cols, _gather_index(sx1, w)[:, None, :]]
    return v0 + (((v1 - v0) * wx[:, None, :, None]) >> 16)


def decode_coeff_batch_reference(coef_y: torch.Tensor, coef_cb: torch.Tensor,
                                 coef_cr: torch.Tensor, quant: torch.Tensor,
                                 geom: torch.Tensor,
                                 out_size: int = 224) -> torch.Tensor:
    """The plain PyTorch ``decode_coeff_batch``: coefficient pages →
    ``uint8 [N, S, S, 3]``, on the inputs' device, bit for bit the JAX
    function."""
    yh, yw = coef_y.shape[1] * 8, coef_y.shape[2] * 8
    y = _idct_plane(coef_y, quant[:, 0])
    cb = _idct_plane(coef_cb, quant[:, 1])
    cr = _idct_plane(coef_cr, quant[:, 2])
    rgb = _ycc_to_rgb(y, _upsample_h2v2(cb, yh, yw),
                      _upsample_h2v2(cr, yh, yw))
    sx0, sx1, wx = _axis_samples(geom[:, 0], out_size)
    sy0, sy1, wy = _axis_samples(geom[:, 1], out_size)
    return _resize(rgb, sy0, sy1, wy, sx0, sx1, wx).to(torch.uint8)


def _library() -> ctypes.CDLL:
    """Build (once), load and declare the C interface of
    ``jpeg_decode.cu``."""
    global _lib
    if _lib is None:
        lib = _build.load_library(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ldt_jpeg_decode.argtypes = ([ptr] * 6 + [i32] * 6 + [ptr] * 4
                                        + [ptr])
        lib.ldt_jpeg_decode.restype = ctypes.c_int
        lib.ldt_jpeg_error_string.argtypes = [ctypes.c_int]
        lib.ldt_jpeg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(coef_y, coef_cb, coef_cr, quant, geom, out_size: int) -> None:
    tensors = {"coef_y": coef_y, "coef_cb": coef_cb, "coef_cr": coef_cr,
               "quant": quant, "geom": geom}
    for name, t in tensors.items():
        want = torch.int16 if name.startswith("coef") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != coef_y.device:
            raise ValueError(f"{name} on {t.device}, coef_y on "
                             f"{coef_y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = coef_y.shape[0]
    if coef_y.dim() != 4 or coef_y.shape[3] != 64:
        raise ValueError(f"coef_y must be [N, YBH, YBW, 64], got "
                         f"{tuple(coef_y.shape)}")
    if (coef_cb.shape != coef_cr.shape or coef_cb.dim() != 4
            or coef_cb.shape[0] != n or coef_cb.shape[3] != 64):
        raise ValueError(f"coef_cb/coef_cr must both be [N, CBH, CBW, 64], "
                         f"got {tuple(coef_cb.shape)}, "
                         f"{tuple(coef_cr.shape)}")
    if (2 * coef_cb.shape[1] < coef_y.shape[1]
            or 2 * coef_cb.shape[2] < coef_y.shape[2]):
        raise ValueError(f"chroma grid {tuple(coef_cb.shape[1:3])} does not "
                         f"cover half the luma grid "
                         f"{tuple(coef_y.shape[1:3])}")
    if tuple(quant.shape) != (n, 3, 64) or tuple(geom.shape) != (n, 6):
        raise ValueError(f"quant must be [N, 3, 64] and geom [N, 6], got "
                         f"{tuple(quant.shape)}, {tuple(geom.shape)}")
    if min(coef_y.shape[1:3]) < 1 or min(coef_cb.shape[1:3]) < 1:
        raise ValueError("the block grids must be at least 1 x 1")
    if out_size < 1:
        raise ValueError(f"out_size must be >= 1, got {out_size}")
    for name in ("coef_y", "coef_cb", "coef_cr", "quant"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads it in 16-byte vectors)")


def _basis(device: torch.device) -> torch.Tensor:
    t = _basis_on.get(device)
    if t is None:
        t = torch.from_numpy(IDCT_BASIS_FIX.copy()).to(device)
        _basis_on[device] = t
    return t


def decode_coeff_batch(coef_y: torch.Tensor, coef_cb: torch.Tensor,
                       coef_cr: torch.Tensor, quant: torch.Tensor,
                       geom: torch.Tensor, out_size: int = 224
                       ) -> torch.Tensor:
    """Coefficient pages → ``uint8 [N, S, S, 3]`` RGB. CUDA: the K2 kernel
    (bit-identical to the plain version). CPU: the plain version."""
    if coef_y.device.type == "cpu":
        return decode_coeff_batch_reference(coef_y, coef_cb, coef_cr, quant,
                                            geom, out_size)
    if coef_y.device.type != "cuda":
        raise RuntimeError(f"decode_coeff_batch has no kernel for device "
                           f"{coef_y.device}")
    _check(coef_y, coef_cb, coef_cr, quant, geom, out_size)
    n, ybh, ybw, _ = coef_y.shape
    cbh, cbw = coef_cb.shape[1:3]
    dev = coef_y.device
    out = torch.empty((n, out_size, out_size, 3), dtype=torch.uint8,
                      device=dev)
    if n == 0:
        return out
    planes = [torch.empty((n, h * 8, w * 8), dtype=torch.uint8, device=dev)
              for h, w in ((ybh, ybw), (cbh, cbw), (cbh, cbw))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _library()
        code = lib.ldt_jpeg_decode(
            coef_y.data_ptr(), coef_cb.data_ptr(), coef_cr.data_ptr(),
            quant.data_ptr(), geom.data_ptr(), _basis(dev).data_ptr(),
            n, ybh, ybw, cbh, cbw, out_size,
            *(p.data_ptr() for p in planes), out.data_ptr(), stream)
    if code != 0:
        msg = lib.ldt_jpeg_error_string(code).decode()
        raise RuntimeError(f"jpeg_decode launch failed: {msg} (code {code})")
    LAUNCHES["jpeg_decode"] += 1
    return out


def is_coeff_batch(batch) -> bool:
    """Does this batch carry coefficient pages instead of pixels?"""
    return "jpeg_coef_y" in batch


def make_batch_transform(out_size: int = 224):
    """The trainer's transform stage: replaces a coefficient batch's
    ``jpeg_*`` tensors with the decoded ``image`` and passes every other
    key (``label``, ``_weight``) through. A pixel batch passes through
    whole, so one transform serves both arms."""

    def transform(batch):
        if not is_coeff_batch(batch):
            return batch
        out = {k: v for k, v in batch.items() if k not in COEFF_KEYS}
        out["image"] = decode_coeff_batch(
            batch["jpeg_coef_y"], batch["jpeg_coef_cb"],
            batch["jpeg_coef_cr"], batch["jpeg_quant"], batch["jpeg_geom"],
            out_size=out_size)
        return out

    return transform
