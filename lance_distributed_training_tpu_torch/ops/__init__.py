"""Device kernels: hand-written CUDA for Hopper, each with a plain version.

``LAUNCHES`` reads every kernel's launch count (the flash kernels', K1's
``"image_normalize"``, K2's ``"jpeg_decode"``, K3's ``"token_pack"``
and ``"token_unpack"`` and K5's ``"ring_fwd"``, ``"ring_bwd_dq"`` and
``"ring_bwd_dkv"``) in one mapping; each
module keeps and increments its own counts, and :func:`reset_launches` sets
them all to 0.
"""

from collections import ChainMap

from . import flash, image, jpeg_device, ring_attention, token_device
from .flash import flash_attention, make_flash_attention
from .image import normalize_flip
from .jpeg_device import decode_coeff_batch
from .ring_attention import ring_fold_bwd_dkv, ring_fold_bwd_dq, ring_fold_fwd
from .token_device import pack_token_batch, unpack_token_batch

LAUNCHES = ChainMap(flash.LAUNCHES, image.LAUNCHES, jpeg_device.LAUNCHES,
                    token_device.LAUNCHES, ring_attention.LAUNCHES)


def reset_launches() -> None:
    for counts in LAUNCHES.maps:
        counts.update(dict.fromkeys(counts, 0))


__all__ = ["LAUNCHES", "decode_coeff_batch",
           "flash_attention", "make_flash_attention", "normalize_flip",
           "pack_token_batch", "reset_launches", "ring_fold_bwd_dkv",
           "ring_fold_bwd_dq", "ring_fold_fwd", "unpack_token_batch"]
