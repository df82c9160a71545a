"""Device kernels: hand-written CUDA for Hopper, each with a plain version.

``LAUNCHES`` reads every kernel's launch count (the flash kernels' and K1's
``"image_normalize"``) in one mapping; each module keeps and increments its
own counts, and :func:`reset_launches` sets them all to 0.
"""

from collections import ChainMap

from . import flash, image
from .flash import flash_attention, make_flash_attention
from .image import normalize_flip

LAUNCHES = ChainMap(flash.LAUNCHES, image.LAUNCHES)


def reset_launches() -> None:
    for counts in LAUNCHES.maps:
        counts.update(dict.fromkeys(counts, 0))


__all__ = ["LAUNCHES", "flash_attention", "make_flash_attention",
           "normalize_flip", "reset_launches"]
