"""Decode hooks: Arrow batches → dicts of host numpy arrays.

Counterpart of ``lance_distributed_training_tpu/data/decode.py`` for the
text tasks, image classification and the mixed-modal contrastive task
(:class:`ImageTextDecoder`: images and captions in one batch). The image
decoder turns JPEG bytes
into a uint8 NHWC page through the native batch decoder (``native/``) when
its library builds, else through PIL on a thread pool, as the JAX decoder
does; normalisation and augmentation run on the device (``ops/image.py``).
With ``device_decode`` the host stops at the entropy boundary
(:class:`~.device_decode.CoeffImageDecoder`) and K2 decodes on the card.
With a ``buffer_pool`` (:class:`~.buffers.BufferPool`) every decoder writes
its output pages into leased pages, which the loaders release. Each decoder
states its batch-cache identity (``cache_fingerprint``, the JAX string) and
pickles for a worker process without its pool and native bindings; the
pixel decoders count ``decode_pixel_bytes_total`` in the process registry.
"""

from __future__ import annotations

import atexit
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import pyarrow as pa

from .token_pack import (
    TokenDecoder,
    TokenPackConfig,
    TokenPackPlanner,
    fill_padded,
    list_column_parts,
    primitive_view,
)

__all__ = ["ImageClassificationDecoder", "ImageTextDecoder",
           "decoder_for_task", "numeric_decoder"]


def _pixel_bytes_counter():
    """``decode_pixel_bytes_total``: finished-pixel bytes the host decode
    produces, against the coeff arm's ``decode_coeff_bytes_total``. Looked
    up at each call, so the decoder holds no registry handle."""
    from ..obs.registry import default_registry

    return default_registry().counter("decode_pixel_bytes_total")

_POOL: Optional[ThreadPoolExecutor] = None


def _pool() -> ThreadPoolExecutor:
    """The PIL arm's shared decode threads (PIL releases the GIL while it
    decodes and resizes), shut down at interpreter exit."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=max(4, (os.cpu_count() or 8) // 2),  # ldt: ignore[LDT1201] -- held by the module global for the process's life; the atexit hook below shuts it down
                                   thread_name_prefix="ldt-torch-decode")
        atexit.register(_POOL.shutdown, wait=False, cancel_futures=True)
    return _POOL


class ImageClassificationDecoder:
    """``{image: JPEG bytes, label: int}`` rows → ``{"image": u8
    [B, S, S, 3], "label": i32 [B]}``.

    Two arms, chosen as the JAX decoder chooses: ``"native"`` (the C++
    batch decoder, straight from the column's Arrow buffers) when its
    library builds and ``use_native`` is set, else ``"pil"`` (``draft`` and
    a bilinear resize per image). ``arm`` says which one this decoder took.
    Rows the native decoder cannot read are decoded again through PIL. With
    ``buffer_pool`` the ``image`` page is leased from it. Without a
    ``label_column`` the batch carries the image alone."""

    def __init__(self, image_size: int = 224, use_native: bool = True,
                 buffer_pool=None, image_column: str = "image",
                 label_column: Optional[str] = "label"):
        self.image_size = image_size
        self.image_column = image_column
        self.label_column = label_column
        self.use_native = use_native
        self.buffer_pool = buffer_pool
        self._bind_native()

    @property
    def required_columns(self) -> list[str]:
        cols = [self.image_column]
        if self.label_column is not None:
            cols.append(self.label_column)
        return cols

    def cache_fingerprint(self) -> str:
        """The decoder's batch-cache identity: everything that can change
        the bytes it emits. The arm is part of it: libjpeg and PIL decode
        to slightly different pixels."""
        return (
            f"ImageClassificationDecoder/{self.image_size}/"
            f"{self.image_column}/{self.label_column}/"
            f"native={self._native is not None}"
        )

    def _bind_native(self) -> None:
        self._native = None
        self._native_arrow = None
        if self.use_native:
            from ..native import (
                batch_decode_jpeg,
                batch_decode_jpeg_arrow,
                native_available,
            )

            if native_available():
                self._native = batch_decode_jpeg
                self._native_arrow = batch_decode_jpeg_arrow

    # Picklable for worker processes: the ctypes binding and the pool are
    # process-local; a worker re-binds its own (data/workers._init_worker).
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = None
        state["_native_arrow"] = None
        state["buffer_pool"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._bind_native()

    @property
    def arm(self) -> str:
        return "native" if self._native is not None else "pil"

    def _decode_one(self, payload: bytes) -> np.ndarray:
        from PIL import Image

        img = Image.open(io.BytesIO(payload))
        # DCT-scaled decode at 1/2, 1/4 or 1/8 when the target is smaller.
        img.draft("RGB", (self.image_size, self.image_size))
        if img.mode != "RGB":
            img = img.convert("RGB")
        if img.size != (self.image_size, self.image_size):
            img = img.resize((self.image_size, self.image_size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)

    def _lease_out(self, n: int) -> Optional[np.ndarray]:
        """A pooled ``[n, S, S, 3] u8`` output page, or ``None`` without a
        pool or for an empty batch."""
        if self.buffer_pool is None or n == 0:
            return None
        return self.buffer_pool.lease(
            (n, self.image_size, self.image_size, 3), np.uint8)

    def decode_payloads(self, payloads: list[bytes]) -> np.ndarray:
        """JPEG byte strings → ``[N, S, S, 3] uint8``. Each arm leases its
        page just before the call that fills it, so that a PIL decode that
        raises first strands no page."""
        if self._native is not None:
            images, failed = self._native(
                payloads, self.image_size, out=self._lease_out(len(payloads)))
            for i in np.nonzero(failed)[0]:
                images[i] = self._decode_one(payloads[i])
            return images
        if len(payloads) >= 8:
            images = list(_pool().map(self._decode_one, payloads))
        else:
            images = [self._decode_one(p) for p in payloads]
        if not images:
            return np.empty((0, self.image_size, self.image_size, 3), np.uint8)
        out = self._lease_out(len(images))
        if out is not None:
            return np.stack(images, out=out)
        return np.stack(images)

    def decode_column(self, col) -> np.ndarray:
        """An Arrow (chunked) binary column of JPEGs → ``[N, S, S, 3]``."""
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if self._native_arrow is not None and (
            pa.types.is_binary(col.type) or pa.types.is_large_binary(col.type)
        ):
            images, failed = self._native_arrow(
                col, self.image_size, out=self._lease_out(len(col)))
            for i in np.nonzero(failed)[0]:
                images[i] = self._decode_one(col[int(i)].as_py())
            return images
        return self.decode_payloads(col.to_pylist())  # ldt: ignore[LDT701] -- deliberate PIL fallback arm: tolerant row-by-row decode needs Python bytes; the zero-copy path above handles the native decoder

    def __call__(self, batch: Union[pa.RecordBatch, pa.Table]
                 ) -> dict[str, np.ndarray]:
        images = self.decode_column(batch.column(self.image_column))
        _pixel_bytes_counter().inc(images.nbytes)
        out = {"image": images}
        if self.label_column is not None:
            labels = batch.column(self.label_column).to_numpy(
                zero_copy_only=False)
            out["label"] = np.asarray(labels, dtype=np.int32)
        return out


class ImageTextDecoder:
    """Mixed-modal collate: ``{image: JPEG bytes, <token columns>}`` rows →
    one batch dict (the BASELINE "LAION-subset image+caption → CLIP"
    configuration). Images go through an :class:`ImageClassificationDecoder`
    (no label), the token columns through the ragged plane's
    :class:`~.token_pack.TokenDecoder` in ``bucket`` mode with
    ``token_pack`` (one caption a slot, so caption i stays paired with
    image i, the slot length bucketed to the batch's longest caption; K3
    finishes it on the device), in ``pad`` mode with ``seq_len`` alone, or
    through :func:`numeric_decoder` with neither. Fixed-size caption
    columns pass through the token decoder unchanged in every mode."""

    def __init__(self, image_size: int = 224, image_column: str = "image",
                 buffer_pool=None, token_pack: Optional[TokenPackConfig] = None,
                 seq_len: Optional[int] = None):
        self._image = ImageClassificationDecoder(
            image_size=image_size, image_column=image_column,
            label_column=None, buffer_pool=buffer_pool)
        self.image_column = image_column
        self._text = None
        if token_pack is not None:
            self._text = TokenDecoder(mode="bucket",
                                      seq_len=seq_len or token_pack.pack_len,
                                      planner=TokenPackPlanner(token_pack),
                                      buffer_pool=buffer_pool,
                                      pad_id=token_pack.pad_id)
        elif seq_len is not None:
            self._text = TokenDecoder(mode="pad", seq_len=seq_len,
                                      buffer_pool=buffer_pool)

    @property
    def buffer_pool(self):
        return self._image.buffer_pool

    @buffer_pool.setter
    def buffer_pool(self, pool) -> None:
        self._image.buffer_pool = pool
        if self._text is not None:
            self._text.buffer_pool = pool

    @property
    def arm(self) -> str:
        """The image decoder's arm (``native`` or ``pil``)."""
        return self._image.arm

    def cache_fingerprint(self) -> str:
        text = (self._text.cache_fingerprint() if self._text is not None
                else "numeric")
        return f"ImageTextDecoder/{self._image.cache_fingerprint()}/{text}"

    def tunables(self):
        if self._text is None:
            return []
        return self._text.tunables()

    def counters(self) -> dict:
        """The token decoder's ``pack_*`` counters (none with the numeric
        decoder)."""
        return self._text.counters() if self._text is not None else {}

    def __call__(self, batch: Union[pa.RecordBatch, pa.Table]
                 ) -> dict[str, np.ndarray]:
        table = (pa.Table.from_batches([batch])
                 if isinstance(batch, pa.RecordBatch) else batch)
        text_fn = self._text if self._text is not None else numeric_decoder
        out = text_fn(table.drop_columns([self.image_column]))
        out["image"] = self._image.decode_column(
            table.column(self.image_column))
        _pixel_bytes_counter().inc(out["image"].nbytes)
        return out


def decoder_for_task(task_type: str, seq_len: Optional[int] = None,
                     image_size: int = 224, device_decode: bool = False,
                     token_pack: Optional[TokenPackConfig] = None,
                     buffer_pool=None):
    """The task-type → decode-hook dispatch. ``classification`` gets the
    :class:`ImageClassificationDecoder` at ``image_size``, ``contrastive``
    the :class:`ImageTextDecoder` (captions bucketed with ``token_pack``,
    padded to ``seq_len`` without); for the text
    tasks, ``token_pack`` (a :class:`~.token_pack.TokenPackConfig`) selects
    the ragged FFD-packing :class:`~.token_pack.TokenDecoder`, ``seq_len``
    alone the padded one, and with neither the plain
    :func:`numeric_decoder` runs. With
    ``device_decode`` classification gets the
    :class:`~.device_decode.CoeffImageDecoder` (``arm == "coeff"``), which
    raises when its extractor cannot be built. Every decoder but
    :func:`numeric_decoder` leases its pages from ``buffer_pool``."""
    if task_type == "classification":
        if device_decode:
            from .device_decode import CoeffImageDecoder

            return CoeffImageDecoder(image_size=image_size,
                                     buffer_pool=buffer_pool)
        return ImageClassificationDecoder(image_size=image_size,
                                          buffer_pool=buffer_pool)
    if device_decode:
        raise ValueError(
            "device_decode currently supports task_type='classification' "
            f"only (the JPEG entropy split), got {task_type!r}"
        )
    if task_type in ("masked_lm", "causal_lm"):
        if token_pack is not None:
            return TokenDecoder(mode="pack",
                                seq_len=seq_len or token_pack.pack_len,
                                planner=TokenPackPlanner(token_pack),
                                buffer_pool=buffer_pool,
                                pad_id=token_pack.pad_id)
        if seq_len is not None:
            return TokenDecoder(mode="pad", seq_len=seq_len,
                                buffer_pool=buffer_pool)
        return numeric_decoder
    if task_type == "contrastive":
        return ImageTextDecoder(image_size=image_size,
                                buffer_pool=buffer_pool,
                                token_pack=token_pack, seq_len=seq_len)
    raise ValueError(f"Invalid task type: {task_type}")


def numeric_decoder(
    batch: Union[pa.RecordBatch, pa.Table],
) -> dict[str, np.ndarray]:
    """All-numeric columnar batches: each column straight to numpy,
    fixed-size list columns to 2-D views, variable list columns padded to
    the batch's longest row."""
    table = (
        pa.Table.from_batches([batch])
        if isinstance(batch, pa.RecordBatch) else batch
    )
    out: dict[str, np.ndarray] = {}
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        if isinstance(col, pa.ChunkedArray):
            col = col.chunk(0)
        if pa.types.is_fixed_size_list(col.type):
            values, _ = primitive_view(col.flatten())
            out[name] = values.reshape(len(col), col.type.list_size)
        elif pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            values, offsets, _ = list_column_parts(col)
            lengths = offsets[1:] - offsets[:-1]
            width = int(lengths.max()) if len(lengths) else 0
            page = np.zeros((len(lengths), width), values.dtype)
            fill_padded(page, values, offsets, lengths)
            out[name] = page
        else:
            out[name], _ = primitive_view(col)
    return out
