"""Host half of device-side decode: JPEG bytes → coefficient pages.

Counterpart of ``lance_distributed_training_tpu/data/device_decode.py``.
:class:`CoeffImageDecoder` has the image decoder's hook signature
(RecordBatch/Table → batch dict) but emits half-decoded coefficient pages
(quantized DCT blocks, dequant tables and geometry; the layout is in
:mod:`..ops.jpeg_device`) instead of pixels. The host does only the
Huffman decode (``native/ldt_coeffs.cpp``, on a C++ thread pool that does
not hold the interpreter); K2 does the rest on the card.

Pages are padded to a block grid that grows monotonically to the largest
image seen, rounded up to ``chunk_blocks``. A row the extractor cannot take
(4:4:4 or 4:2:2 sampling, CMYK, bytes it cannot parse)
is decoded by PIL and re-encoded as baseline 4:2:0 at quality 95, then
extracted again; a row that still fails keeps a zeroed page with quant 1
and geometry 0, which decodes to neutral gray.

With a ``buffer_pool`` the five pages of a batch are leased from it and
zero-filled (the extractor never writes padding blocks, and a recycled page
holds an earlier batch); if a later lease or the extraction raises, the
pages already leased go back. The per-batch host entropy time is kept in
:attr:`CoeffImageDecoder.entropy_ms`, which the trainer's ``[metrics]``
lines read as ``decode_entropy_ms``, and observed into the process
registry's ``decode_entropy_ms`` histogram beside the
``decode_coeff_bytes_total``, ``decode_coeff_reencode_total`` and
``decode_coeff_undecodable_total`` counters, as the JAX decoder does; the
entropy time and the re-encode flag also go to an open cost context
(:mod:`..obs.costs`). ``coeff_chunk`` (the grid rounding) is an autotuner
knob. The decoder pickles for a worker process without its pool and its
registry handles, which the worker binds anew; its grid is then the
worker's own (``data/workers.py``).

There is no fallback: when the extractor cannot be built the decoder
raises with the build error (the JAX package warns and decodes pixels with
PIL instead).
"""

from __future__ import annotations

import io
import time
from typing import Optional, Union

import numpy as np
import pyarrow as pa

from ..native import coeffs
from ..obs.costs import note_cost
from ..obs.registry import default_registry

__all__ = ["CoeffImageDecoder"]


def _round_up(blocks: int, chunk: int) -> int:
    chunk = max(1, int(chunk))
    return ((max(1, blocks) + chunk - 1) // chunk) * chunk


class CoeffImageDecoder:
    """JPEG-bytes and label columns → ``jpeg_coef_y/cb/cr``, ``jpeg_quant``,
    ``jpeg_geom`` (:data:`~..ops.jpeg_device.COEFF_KEYS`) and ``label``.

    ``arm`` is ``"coeff"``. ``n_threads`` is the extractor's thread count
    (0: one per hardware thread, :attr:`threads` says how many that is).
    ``buffer_pool`` (a :class:`~.buffers.BufferPool`) leases the pages."""

    arm = "coeff"

    def __init__(self, image_size: int = 224, image_column: str = "image",
                 label_column: Optional[str] = "label",
                 chunk_blocks: int = 4, n_threads: int = 0,
                 buffer_pool=None):
        self.image_size = image_size
        self.buffer_pool = buffer_pool
        self.image_column = image_column
        self.label_column = label_column
        self.chunk_blocks = max(1, int(chunk_blocks))
        self.n_threads = n_threads
        self.threads = (int(n_threads) if n_threads > 0
                        else coeffs.default_threads())  # builds, or raises
        self.entropy_ms: list[float] = []  # host time of each batch
        self.reencoded = 0  # rows re-encoded through PIL so far
        self.undecodable = 0  # rows left as zeroed pages so far
        # The canonical luma grid (blocks), grown monotonically; chroma is
        # always its ceil-half (the 4:2:0 layout).
        self._grid: tuple[int, int] = (0, 0)
        self._bind()

    def _bind(self) -> None:
        reg = default_registry()
        self._entropy_hist = reg.histogram("decode_entropy_ms")
        self._coeff_bytes = reg.counter("decode_coeff_bytes_total")
        self._reencodes = reg.counter("decode_coeff_reencode_total")
        self._undecodable = reg.counter("decode_coeff_undecodable_total")

    # Picklable for worker processes: the pool and the registry handles are
    # process-local; a worker binds its own (data/workers._init_worker
    # re-attaches a pool).
    def __getstate__(self):
        state = dict(self.__dict__)
        for key in ("_entropy_hist", "_coeff_bytes", "_reencodes",
                    "_undecodable"):
            state.pop(key, None)
        state["buffer_pool"] = None
        state["entropy_ms"] = []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._bind()

    @property
    def required_columns(self) -> list[str]:
        cols = [self.image_column]
        if self.label_column is not None:
            cols.append(self.label_column)
        return cols

    def cache_fingerprint(self) -> str:
        """The decoder's identity for a batch cache: ``chunk_blocks`` shapes
        the pages, so it is part of it."""
        return (f"CoeffImageDecoder/{self.image_size}/{self.image_column}/"
                f"{self.label_column}/chunk={self.chunk_blocks}")

    def set_chunk(self, blocks: int) -> int:
        """The grid's rounding, in 8×8 blocks; it takes effect on the next
        growth of the grid, which never shrinks."""
        self.chunk_blocks = max(1, int(blocks))
        return self.chunk_blocks

    def tunables(self):
        from ..tune.tunable import Tunable

        return [Tunable(
            "coeff_chunk",
            lambda: self.chunk_blocks,
            self.set_chunk,
            lo=1, hi=16,
            doc="coefficient-page grid rounding, in 8x8 blocks (coarser = "
                "fewer kernel recompiles / warmer pages, more padding "
                "bytes on the wire). In-process decode only: WorkerPool "
                "workers hold pickled decoder copies made at spawn, so an "
                "actuation there lands on the next respawn, not live",
        )]

    def _ensure_grid(self, yb_h: int, yb_w: int) -> tuple[int, int, int, int]:
        gh, gw = self._grid
        if yb_h > gh or yb_w > gw:
            gh = max(gh, _round_up(yb_h, self.chunk_blocks))
            gw = max(gw, _round_up(yb_w, self.chunk_blocks))
            self._grid = (gh, gw)
        return gh, gw, (gh + 1) // 2, (gw + 1) // 2

    def _lease(self, shape, dtype) -> np.ndarray:
        """A zeroed page: leased (and released again if zeroing raises),
        or fresh without a pool."""
        if self.buffer_pool is None:
            return np.zeros(shape, dtype)
        arr = self.buffer_pool.lease(shape, dtype)
        try:
            arr.fill(0)
        except BaseException:
            self.buffer_pool.release(arr)
            raise
        return arr

    @staticmethod
    def _reencode(payload: bytes) -> Optional[bytes]:
        """A row the extractor refuses, decoded by PIL and re-encoded as
        baseline 4:2:0 JPEG at quality 95; ``None`` when PIL cannot read
        it either."""
        from PIL import Image

        try:
            img = Image.open(io.BytesIO(payload))
            if img.mode != "RGB":
                img = img.convert("RGB")
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=95, subsampling=2)
            return buf.getvalue()
        except (OSError, ValueError, SyntaxError):
            return None

    @staticmethod
    def _payload(source, i: int) -> bytes:
        if isinstance(source, list):
            return source[i]
        return source[int(i)].as_py()

    def _extract(self, pointers, source) -> dict[str, np.ndarray]:
        """The pages of one batch. ``pointers`` from
        :func:`~..native.coeffs.payload_pointers` or ``arrow_pointers``;
        ``source`` (the payloads or the Arrow array) is read only for rows
        that are re-encoded."""
        n = pointers[2]
        if n == 0:
            gh, gw, ch, cw = self._ensure_grid(1, 1)
            return {
                "jpeg_coef_y": np.zeros((0, gh, gw, 64), np.int16),
                "jpeg_coef_cb": np.zeros((0, ch, cw, 64), np.int16),
                "jpeg_coef_cr": np.zeros((0, ch, cw, 64), np.int16),
                "jpeg_quant": np.zeros((0, 3, 64), np.int32),
                "jpeg_geom": np.zeros((0, 6), np.int32),
            }
        geom, probe_failed = coeffs.batch_probe_jpeg(pointers)
        replaced: dict[int, bytes] = {}
        for i in np.nonzero(probe_failed | (geom[:, 3] == 0))[0]:
            alt = self._reencode(self._payload(source, int(i)))
            if alt is not None:
                self.reencoded += 1
                self._reencodes.inc()
                replaced[int(i)] = alt
                alt_geom, alt_failed = coeffs.batch_probe_jpeg(
                    coeffs.payload_pointers([alt]))
                if not alt_failed[0]:
                    geom[int(i)] = alt_geom[0]
        yb_h = int(max(1, (geom[:, 1].max() + 7) // 8))
        yb_w = int(max(1, (geom[:, 0].max() + 7) // 8))
        gh, gw, ch, cw = self._ensure_grid(yb_h, yb_w)
        # The pages go into the dict one by one under the release guard: a
        # later lease or the extraction raising must not strand the
        # earlier pages.
        batch: dict[str, np.ndarray] = {}
        try:
            batch["jpeg_coef_y"] = self._lease((n, gh, gw, 64), np.int16)
            batch["jpeg_coef_cb"] = self._lease((n, ch, cw, 64), np.int16)
            batch["jpeg_coef_cr"] = self._lease((n, ch, cw, 64), np.int16)
            batch["jpeg_quant"] = self._lease((n, 3, 64), np.int32)
            batch["jpeg_geom"] = self._lease((n, 6), np.int32)
            if replaced:
                # Only the re-encoded rows' slots change; ctypes keeps the
                # assigned bytes alive in the array, and `replaced` too.
                srcs, lens, _, keepalive = pointers
                for i, alt in replaced.items():
                    srcs[i] = alt
                    lens[i] = len(alt)
                pointers = (srcs, lens, n, (keepalive, replaced))
            failed = coeffs.batch_extract_coeffs(
                pointers, gh, gw, ch, cw, batch["jpeg_coef_y"],
                batch["jpeg_coef_cb"], batch["jpeg_coef_cr"],
                batch["jpeg_quant"], batch["jpeg_geom"],
                n_threads=self.n_threads)
            for i in np.nonzero(failed)[0]:
                # A zeroed page (the extractor may have written part of
                # one), quant 1 and geometry 0: neutral gray.
                self.undecodable += 1
                self._undecodable.inc()
                for key in ("jpeg_coef_y", "jpeg_coef_cb", "jpeg_coef_cr",
                            "jpeg_geom"):
                    batch[key][i].fill(0)
                batch["jpeg_quant"][i].fill(1)
        except BaseException:
            if self.buffer_pool is not None:
                self.buffer_pool.release_batch(batch)
            raise
        return batch

    def _timed(self, pointers, source) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        reencoded = self.reencoded
        batch = self._extract(pointers, source)
        ms = (time.perf_counter() - t0) * 1e3
        self.entropy_ms.append(ms)
        self._entropy_hist.observe(ms)
        self._coeff_bytes.inc(sum(v.nbytes for v in batch.values()))
        note_cost(entropy_ms=round(ms, 3),
                  reencode=self.reencoded > reencoded)
        return batch

    def decode_payloads(self, payloads: list[bytes]) -> dict[str, np.ndarray]:
        """JPEG byte strings → coefficient pages."""
        return self._timed(coeffs.payload_pointers(payloads), payloads)

    def decode_column(self, col) -> dict[str, np.ndarray]:
        """An Arrow (chunked) binary column → coefficient pages, with the
        pointers taken straight over the column's buffers."""
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if not (pa.types.is_binary(col.type)
                or pa.types.is_large_binary(col.type)):
            raise TypeError(f"image column must be binary, got {col.type}")
        return self._timed(coeffs.arrow_pointers(col), col)

    def __call__(self, batch: Union[pa.RecordBatch, pa.Table]
                 ) -> dict[str, np.ndarray]:
        out = self.decode_column(batch.column(self.image_column))
        if self.label_column is not None:
            out["label"] = np.asarray(
                batch.column(self.label_column).to_numpy(
                    zero_copy_only=False), dtype=np.int32)
        return out
