"""Native (C++) host code and its ctypes bindings: the batch JPEG decoder
(``jpeg``, libjpeg) and the coefficient extractor of device decode
(``coeffs``, no libjpeg)."""

from .jpeg import batch_decode_jpeg, batch_decode_jpeg_arrow, native_available

__all__ = ["batch_decode_jpeg", "batch_decode_jpeg_arrow", "native_available"]
