"""K1 — image normalisation and horizontal flip, the hand-written kernel and
its plain version.

Counterpart of ``lance_distributed_training_tpu/ops/image.py``
(``normalize_images`` and ``random_flip``), which run inside the jitted step
on the TPU. Here one CUDA kernel for sm_90a (``csrc/image.cu``) reads the
uint8 NHWC batch and writes the bf16 NHWC batch in one pass, mirroring image
``b`` along W where ``flip_mask[b]`` is set: each element is one load from
a 3 x 256 table of the function's values that every CTA builds in shared
memory, and where W is a multiple of 16 (the path's 224) whole rows reach
shared memory by TMA bulk copies. The result is handed to the
model as ``.permute(0, 3, 1, 2)``: a channels_last NCHW view, no copy.

The arithmetic is the JAX function's: ``x / 255``, ``- mean`` and ``/ std``
on bf16 values with the bf16-rounded ImageNet constants, each step computed
in f32 (a division, not a reciprocal) and rounded to bf16.

:func:`normalize_flip` routes by the device of its input: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
``LAUNCHES["image_normalize"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ..utils import compiletrack

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "LAUNCHES", "normalize_flip",
           "normalize_images_reference", "random_flip_reference",
           "bf16_constants"]

# torchvision's ImageNet constants, as the JAX package uses them.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LAUNCHES = {"image_normalize": 0}

_SOURCE = "image"
_lib: Optional[ctypes.CDLL] = None


def _round_bf16(values: tuple) -> tuple:
    t = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)
    return tuple(t.float().tolist())


# Rounded once, here: every launch passes these as kernel arguments.
_MEAN_BF16 = _round_bf16(IMAGENET_MEAN)
_STD_BF16 = _round_bf16(IMAGENET_STD)


def bf16_constants() -> tuple[tuple, tuple]:
    """The mean and std as the JAX function uses them: rounded to bf16
    (0.485 → 0.484375, …), returned as f32 values."""
    return _MEAN_BF16, _STD_BF16


def normalize_images_reference(images_u8: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``normalize_images``: uint8 NHWC → bf16 NHWC. Each
    operation runs in f32 on bf16 values and rounds to bf16; the constants
    are tensors on the input's device, so every division is a true
    division."""
    dev, bf16 = images_u8.device, torch.bfloat16
    mean_t = torch.tensor(_MEAN_BF16, dtype=torch.float32, device=dev)
    std_t = torch.tensor(_STD_BF16, dtype=torch.float32, device=dev)
    x = images_u8.to(torch.float32)
    x = (x / torch.tensor(255.0, device=dev)).to(bf16).float()
    x = (x - mean_t).to(bf16).float()
    return (x / std_t).to(bf16)


def random_flip_reference(images: torch.Tensor,
                          flip_mask: torch.Tensor) -> torch.Tensor:
    """Plain ``random_flip`` with the draw given: image ``b`` of an NHWC
    batch mirrored along W where ``flip_mask[b]`` is set."""
    keep = flip_mask.to(device=images.device, dtype=torch.bool)
    return torch.where(keep[:, None, None, None], images.flip(2), images)


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``image.cu``."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldt_image_normalize.argtypes = [ptr] * 3 + [i32] * 3 + [f32] * 6 + [ptr]
    lib.ldt_image_normalize.restype = ctypes.c_int
    lib.ldt_image_error_string.argtypes = [ctypes.c_int]
    lib.ldt_image_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    """Build (once), load and declare the C interface of ``image.cu``."""
    global _lib
    if _lib is None:
        _lib = bind_library(_build.load_library(_SOURCE))
    return _lib


def _check(images: torch.Tensor, flip_mask: Optional[torch.Tensor]) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got "
                         f"{tuple(images.shape)}")
    if images.dtype != torch.uint8:
        raise TypeError(f"images must be uint8, got {images.dtype}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous (NHWC)")
    if flip_mask is not None:
        if tuple(flip_mask.shape) != (images.shape[0],):
            raise ValueError(f"flip_mask must be [B] = ({images.shape[0]},), "
                             f"got {tuple(flip_mask.shape)}")
        if flip_mask.device != images.device:
            raise ValueError(f"flip_mask on {flip_mask.device}, images on "
                             f"{images.device}")


def normalize_flip(images_u8: torch.Tensor,
                   flip_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` → bf16 ``[B, H, W, 3]``, normalised and, where
    ``flip_mask`` (``[B]``, bool or uint8) is set, mirrored along W. CUDA:
    the K1 kernel. CPU: the plain versions."""
    if compiletrack.enabled():
        compiletrack.track_launch(images_u8, flip_mask)
    if images_u8.device.type == "cpu":
        out = normalize_images_reference(images_u8)
        return out if flip_mask is None else random_flip_reference(out,
                                                                   flip_mask)
    if images_u8.device.type != "cuda":
        raise RuntimeError(f"normalize_flip has no kernel for device "
                           f"{images_u8.device}")
    _check(images_u8, flip_mask)
    b, h, w, _ = images_u8.shape
    out = torch.empty(images_u8.shape, dtype=torch.bfloat16,
                      device=images_u8.device)
    flip = None
    if flip_mask is not None:
        # A bool mask is read as its bytes (no copy); other types convert.
        flip = (flip_mask.view(torch.uint8) if flip_mask.dtype == torch.bool
                else flip_mask.to(torch.uint8)).contiguous()
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream(images_u8.device).cuda_stream
        lib = _library()
        code = lib.ldt_image_normalize(
            images_u8.data_ptr(), None if flip is None else flip.data_ptr(),
            out.data_ptr(), b, h, w, *_MEAN_BF16, *_STD_BF16, stream)
    if code != 0:
        msg = lib.ldt_image_error_string(code).decode()
        raise RuntimeError(f"image_normalize launch failed: {msg} "
                           f"(code {code})")
    LAUNCHES["image_normalize"] += 1
    return out
