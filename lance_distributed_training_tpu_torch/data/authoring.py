"""Dataset authoring — tokenised text rows and synthetic image rows.

Counterpart of ``create_text_token_dataset``,
``create_variable_length_token_dataset`` and
``create_synthetic_classification_dataset`` in
``lance_distributed_training_tpu/data/authoring.py``; the rows and the
schemas are the same (the same seed gives the same JPEG bytes and labels),
so either package trains on the other's datasets.
"""

from __future__ import annotations

import io
from typing import Iterator, Sequence

import numpy as np
import pyarrow as pa

from .format import Dataset, write_dataset

__all__ = ["IMAGE_SCHEMA", "create_synthetic_classification_dataset",
           "create_text_token_dataset",
           "create_variable_length_token_dataset"]

# The image-classification schema: JPEG bytes and an integer label.
IMAGE_SCHEMA = pa.schema([("image", pa.binary()), ("label", pa.int64())])

_ROWS_PER_BATCH = 4096


def create_text_token_dataset(
    output_path: str,
    token_ids: Sequence[Sequence[int]],
    seq_len: int,
    fragment_size: int = 50000,
    pad_id: int = 0,
    pack: bool = True,
) -> Dataset:
    """Documents → ``{input_ids, attention_mask}`` fixed-size-list rows.

    ``pack=True`` greedily packs documents into ``seq_len`` windows;
    ``pack=False`` writes one document per row, truncated or padded with
    ``pad_id`` to ``seq_len``."""
    schema = pa.schema(
        [
            ("input_ids", pa.list_(pa.int32(), seq_len)),
            ("attention_mask", pa.list_(pa.int8(), seq_len)),
        ]
    )

    def rows() -> Iterator[tuple[list[int], list[int]]]:
        if pack:
            buf: list[int] = []
            for doc in token_ids:
                buf.extend(doc)
                while len(buf) >= seq_len:
                    yield buf[:seq_len], [1] * seq_len
                    buf = buf[seq_len:]
            if buf:
                mask = [1] * len(buf) + [0] * (seq_len - len(buf))
                yield buf + [pad_id] * (seq_len - len(buf)), mask
        else:
            for doc in token_ids:
                doc = list(doc)[:seq_len]
                mask = [1] * len(doc) + [0] * (seq_len - len(doc))
                yield doc + [pad_id] * (seq_len - len(doc)), mask

    def record_batch(ids, masks) -> pa.RecordBatch:
        return pa.record_batch(
            [
                pa.array(ids, schema.field("input_ids").type),
                pa.array(masks, schema.field("attention_mask").type),
            ],
            schema=schema,
        )

    def gen() -> Iterator[pa.RecordBatch]:
        ids_buf, mask_buf = [], []
        for ids, mask in rows():
            ids_buf.append(ids)
            mask_buf.append(mask)
            if len(ids_buf) >= _ROWS_PER_BATCH:
                yield record_batch(ids_buf, mask_buf)
                ids_buf, mask_buf = [], []
        if ids_buf:
            yield record_batch(ids_buf, mask_buf)

    return write_dataset(
        gen(), output_path, schema=schema, mode="overwrite",
        max_rows_per_file=fragment_size,
    )


def create_variable_length_token_dataset(
    output_path: str,
    rows: int,
    vocab_size: int = 1000,
    max_len: int = 128,
    mean_len: float = 24.0,
    sigma: float = 0.7,
    fragment_size: int = 50000,
    seed: int = 0,
    include_mask: bool = False,
) -> Dataset:
    """Variable-length token rows ``{input_ids: list<int32>}`` (plus an
    all-ones variable ``attention_mask`` with ``include_mask``): lengths
    drawn from a seeded lognormal (``log(mean_len)``, ``sigma``) clipped to
    ``[1, max_len]``, ids uniform in ``[2, vocab_size)``. A pure function of
    its arguments: the same arguments write the same bytes."""
    rng = np.random.default_rng(seed)
    schema_fields = [("input_ids", pa.list_(pa.int32()))]
    if include_mask:
        schema_fields.append(("attention_mask", pa.list_(pa.int8())))
    schema = pa.schema(schema_fields)

    def gen() -> Iterator[pa.RecordBatch]:
        done = 0
        while done < rows:
            n = min(_ROWS_PER_BATCH, rows - done)
            lengths = np.clip(
                rng.lognormal(np.log(mean_len), sigma, n).astype(np.int64),
                1, max_len,
            )
            ids = [
                rng.integers(2, vocab_size, int(L), dtype=np.int32)
                for L in lengths
            ]
            arrays = [pa.array(ids, schema.field("input_ids").type)]
            if include_mask:
                arrays.append(pa.array(
                    [np.ones(int(L), np.int8) for L in lengths],
                    schema.field("attention_mask").type,
                ))
            yield pa.record_batch(arrays, schema=schema)
            done += n

    return write_dataset(
        gen(), output_path, schema=schema, mode="overwrite",
        max_rows_per_file=fragment_size,
    )


def create_synthetic_classification_dataset(
    output_path: str,
    rows: int,
    num_classes: int = 101,
    image_size: int = 224,
    fragment_size: int = 12500,
    unique_images: int = 64,
    seed: int = 0,
    jpeg_quality: int = 85,
) -> Dataset:
    """FOOD101-shaped synthetic dataset: ``unique_images`` seeded uniform
    noise images encoded as JPEG, repeated over ``rows`` rows with seeded
    labels in ``[0, num_classes)``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(min(unique_images, rows)):
        arr = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=jpeg_quality)
        pool.append(buf.getvalue())

    def gen() -> Iterator[pa.RecordBatch]:
        done = 0
        while done < rows:
            n = min(_ROWS_PER_BATCH, rows - done)
            images = [pool[(done + i) % len(pool)] for i in range(n)]
            labels = rng.integers(0, num_classes, n)
            yield pa.record_batch(
                [pa.array(images, pa.binary()), pa.array(labels, pa.int64())],
                schema=IMAGE_SCHEMA,
            )
            done += n

    return write_dataset(
        gen(), output_path, schema=IMAGE_SCHEMA, mode="overwrite",
        max_rows_per_file=fragment_size,
    )
