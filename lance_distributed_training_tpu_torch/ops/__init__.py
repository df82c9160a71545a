"""Device kernels: hand-written CUDA for Hopper, each with a plain version.

``LAUNCHES`` reads every kernel's launch count (the flash kernels', K1's
``"image_normalize"`` and K2's ``"jpeg_decode"``) in one mapping; each
module keeps and increments its own counts, and :func:`reset_launches` sets
them all to 0.
"""

from collections import ChainMap

from . import flash, image, jpeg_device
from .flash import flash_attention, make_flash_attention
from .image import normalize_flip
from .jpeg_device import decode_coeff_batch

LAUNCHES = ChainMap(flash.LAUNCHES, image.LAUNCHES, jpeg_device.LAUNCHES)


def reset_launches() -> None:
    for counts in LAUNCHES.maps:
        counts.update(dict.fromkeys(counts, 0))


__all__ = ["LAUNCHES", "decode_coeff_batch", "flash_attention",
           "make_flash_attention", "normalize_flip", "reset_launches"]
