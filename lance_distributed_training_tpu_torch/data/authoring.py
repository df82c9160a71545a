"""Dataset authoring — tokenised text rows, image rows and image folders.

Counterpart of ``lance_distributed_training_tpu/data/authoring.py``: the
token, synthetic-image and synthetic image-caption writers, an
image-folder tree (or the Food-101
archive) into a columnar dataset, the synthetic image-folder tree of the
file-based control arm, ``ingest_on_process_zero`` and the authoring CLI.
The rows and the schemas are the same (the same seed gives the same JPEG
bytes and labels), so either package trains on the other's datasets::

    python -m lance_distributed_training_tpu_torch.data.authoring folder \
        --root_path /data/food101_files --output_path /data/food101.ldt
    python -m lance_distributed_training_tpu_torch.data.authoring food101 \
        --source /data/food-101.tar.gz --output_root /data/food101
"""

from __future__ import annotations

import io
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import pyarrow as pa

from .format import Dataset, write_dataset

__all__ = ["IMAGE_SCHEMA", "create_dataset_from_image_folder",
           "create_food101_datasets",
           "create_synthetic_classification_dataset",
           "create_synthetic_image_folder",
           "create_synthetic_image_text_dataset", "create_text_token_dataset",
           "create_variable_length_token_dataset", "ingest_on_process_zero",
           "main"]

# The image-classification schema: JPEG bytes and an integer label.
IMAGE_SCHEMA = pa.schema([("image", pa.binary()), ("label", pa.int64())])

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

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


def create_synthetic_image_text_dataset(
    output_path: str,
    rows: int,
    seq_len: int = 16,
    vocab_size: int = 1000,
    image_size: int = 224,
    fragment_size: int = 12500,
    unique_images: int = 64,
    seed: int = 0,
    jpeg_quality: int = 85,
) -> Dataset:
    """LAION-shaped mixed-modal rows ``{image: JPEG bytes, input_ids,
    attention_mask}`` for the CLIP contrastive configuration: a seeded pool
    of ``unique_images`` noise JPEGs over the rows, and per row a caption of
    ``seq_len // 2 .. seq_len`` ids uniform in ``[2, vocab_size)``, stored
    as fixed-size ``seq_len`` lists padded with 0 beside its mask. The
    decode hook is :class:`..decode.ImageTextDecoder`."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(min(unique_images, rows)):
        arr = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=jpeg_quality)
        pool.append(buf.getvalue())
    schema = pa.schema([
        ("image", pa.binary()),
        ("input_ids", pa.list_(pa.int32(), seq_len)),
        ("attention_mask", pa.list_(pa.int8(), seq_len)),
    ])

    def gen() -> Iterator[pa.RecordBatch]:
        done = 0
        while done < rows:
            n = min(_ROWS_PER_BATCH, rows - done)
            images = [pool[(done + i) % len(pool)] for i in range(n)]
            lengths = rng.integers(seq_len // 2, seq_len + 1, n)
            ids = [list(rng.integers(2, vocab_size, length))
                   + [0] * (seq_len - length) for length in lengths]
            mask = [[1] * length + [0] * (seq_len - length)
                    for length in lengths]
            yield pa.record_batch(
                [pa.array(images, pa.binary()),
                 pa.array(ids, schema.field("input_ids").type),
                 pa.array(mask, schema.field("attention_mask").type)],
                schema=schema)
            done += n

    return write_dataset(
        gen(), output_path, schema=schema, mode="overwrite",
        max_rows_per_file=fragment_size,
    )


def _folder_samples(root: str) -> tuple[list[tuple[str, int]], list[str]]:
    """The ImageFolder convention, ``root/<class_name>/<image files>``:
    ``(samples, classes)``, classes and files in sorted walk order, each
    sample ``(path, class index)``."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    samples = []
    for label, cls in enumerate(classes):
        cls_dir = os.path.join(root, cls)
        for name in sorted(os.listdir(cls_dir)):
            if os.path.splitext(name)[1].lower() in _IMAGE_EXTS:
                samples.append((os.path.join(cls_dir, name), label))
    return samples, classes


def _image_batch(images: list, labels: list) -> pa.RecordBatch:
    return pa.record_batch(
        [pa.array(images, pa.binary()), pa.array(labels, pa.int64())],
        schema=IMAGE_SCHEMA,
    )


def create_dataset_from_image_folder(
    root_path: str,
    output_path: str,
    fragment_size: int = 12500,
    batch_size: int = 1024,
    reencode_jpeg_quality: Optional[int] = None,
    shuffle_seed: Optional[int] = None,
) -> Dataset:
    """Image-folder tree → fragmented columnar dataset, in record batches
    of ``batch_size`` rows and fragments of at most ``fragment_size``.
    JPEG files pass through byte for byte unless ``reencode_jpeg_quality``
    is set; other formats are re-encoded as JPEG (quality 85 by default).
    ``shuffle_seed`` permutes the rows."""
    samples, classes = _folder_samples(root_path)
    if not samples:
        raise ValueError(f"no images under {root_path}")
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        samples = [samples[i] for i in rng.permutation(len(samples))]

    def gen() -> Iterator[pa.RecordBatch]:
        images, labels = [], []
        for path, label in samples:
            with open(path, "rb") as f:
                payload = f.read()
            if reencode_jpeg_quality is not None or not path.lower().endswith(
                (".jpg", ".jpeg")
            ):
                from PIL import Image

                img = Image.open(io.BytesIO(payload)).convert("RGB")
                buf = io.BytesIO()
                img.save(buf, format="JPEG",
                         quality=reencode_jpeg_quality or 85)
                payload = buf.getvalue()
            images.append(payload)
            labels.append(label)
            if len(images) >= batch_size:
                yield _image_batch(images, labels)
                images, labels = [], []
        if images:
            yield _image_batch(images, labels)

    ds = write_dataset(
        gen(), output_path, schema=IMAGE_SCHEMA, mode="overwrite",
        max_rows_per_file=fragment_size,
    )
    print(f"wrote {ds.count_rows()} rows in {len(ds.get_fragments())} "
          f"fragments ({len(classes)} classes)")
    return ds


def ingest_on_process_zero(output_path, ingest_fn) -> Dataset:
    """Run ``ingest_fn`` on process 0 only; the other processes wait at a
    barrier (``parallel/mesh.sync_global_devices``), then every process
    opens the finished dataset (the writer's manifest rename is atomic).

    ``output_path`` may be a sequence of paths when ``ingest_fn`` writes
    several datasets (:func:`create_food101_datasets`'s train and test):
    ingestion is skipped only when every manifest exists, so a run killed
    between two writes ingests again. Returns the dataset at the first
    path."""
    from ..parallel.mesh import process_topology, sync_global_devices

    paths = ([str(output_path)]
             if isinstance(output_path, (str, os.PathLike))
             else [str(p) for p in output_path])
    process_index, process_count = process_topology()
    exists = all(os.path.exists(os.path.join(p, "manifest.json"))
                 for p in paths)
    if (process_index == 0 or process_count == 1) and not exists:
        ingest_fn()
    sync_global_devices()
    return Dataset(paths[0])


def create_food101_datasets(
    source: str,
    output_root: str,
    fragment_size: int = 12500,
    batch_size: int = 1024,
) -> tuple[Dataset, Dataset]:
    """The Food-101 archive → ``<output_root>/train`` and ``/test``
    columnar datasets. ``source`` is a local ``food-101.tar.gz`` or an
    extracted ``food-101/`` directory; nothing is downloaded. Images pass
    through byte for byte; ``meta/train.txt`` and ``meta/test.txt`` give
    the splits, and labels index the sorted ``meta/classes.txt`` (the
    torchvision Food101 convention). An archive is extracted into a
    temporary directory, removed after the writes. Across processes wrap
    the call in :func:`ingest_on_process_zero`."""
    root = str(source)
    extract_dir = None
    if os.path.isfile(root):
        import tarfile
        import tempfile

        extract_dir = tempfile.mkdtemp(prefix="food101-extract-")
        with tarfile.open(root) as tar:
            tar.extractall(extract_dir, filter="data")
        root = os.path.join(extract_dir, "food-101")
    if not os.path.isdir(os.path.join(root, "meta")):
        raise FileNotFoundError(
            f"{root} is not a food-101 tree (expected meta/ + images/)"
        )

    with open(os.path.join(root, "meta", "classes.txt")) as f:
        classes = sorted(line.strip() for line in f if line.strip())
    class_index = {c: i for i, c in enumerate(classes)}

    def write_split(split: str) -> Dataset:
        with open(os.path.join(root, "meta", f"{split}.txt")) as f:
            entries = [line.strip() for line in f if line.strip()]

        def gen() -> Iterator[pa.RecordBatch]:
            images, labels = [], []
            for entry in entries:  # "apple_pie/1005649"
                cls = entry.split("/", 1)[0]
                with open(os.path.join(root, "images", entry + ".jpg"),
                          "rb") as fh:
                    images.append(fh.read())
                labels.append(class_index[cls])
                if len(images) >= batch_size:
                    yield _image_batch(images, labels)
                    images, labels = [], []
            if images:
                yield _image_batch(images, labels)

        ds = write_dataset(
            gen(), os.path.join(str(output_root), split),
            schema=IMAGE_SCHEMA, mode="overwrite",
            max_rows_per_file=fragment_size,
        )
        print(f"food101 {split}: {ds.count_rows()} rows, "
              f"{len(ds.get_fragments())} fragments")
        return ds

    try:
        return write_split("train"), write_split("test")
    finally:
        if extract_dir is not None:
            import shutil

            shutil.rmtree(extract_dir, ignore_errors=True)


def create_synthetic_image_folder(
    root: str,
    rows: int,
    num_classes: int = 101,
    image_size: int = 224,
    unique_images: int = 64,
    seed: int = 0,
    jpeg_quality: int = 85,
) -> str:
    """Synthetic ImageFolder tree ``root/class_XXX/NNNNN.jpg``, the
    file-based twin of :func:`create_synthetic_classification_dataset`:
    the same seeded pool of ``unique_images`` noise JPEGs, ``rows //
    num_classes`` files a class (the last class takes the remainder). Each
    pool image is written once and hard-linked into its other slots (a
    copy where links fail), which cuts the tree's writes by the pool's
    duplication factor and reads the same."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(min(unique_images, max(rows, 1))):
        arr = (rng.random((image_size, image_size, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=jpeg_quality)
        pool.append(buf.getvalue())
    first_path: list = [None] * len(pool)
    per_class = max(rows // num_classes, 1)
    done = 0
    for c in range(num_classes):
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir, exist_ok=True)
        take = per_class if c < num_classes - 1 else rows - done
        for i in range(take):
            idx = (done + i) % len(pool)
            path = os.path.join(cdir, f"{i:05d}.jpg")
            if first_path[idx] is None:
                with open(path, "wb") as f:
                    f.write(pool[idx])
                first_path[idx] = path
            else:
                try:
                    os.link(first_path[idx], path)
                except OSError:
                    with open(path, "wb") as f:
                        f.write(pool[idx])
        done += take
        if done >= rows:
            break
    return root


def main(argv=None) -> None:
    """The authoring CLI: ``folder`` (an image-folder tree), ``synthetic``
    (the synthetic classification set), ``tokens`` (variable-length token
    rows) and ``food101`` (the Food-101 archive or tree)::

        python -m lance_distributed_training_tpu_torch.data.authoring \
            folder --root_path /data/food101_files \
            --output_path /data/food101.ldt --fragment_size 12500
    """
    import argparse

    p = argparse.ArgumentParser(description="Author a columnar dataset")
    sub = p.add_subparsers(dest="kind", required=True)

    folder = sub.add_parser("folder", help="image-folder tree → dataset")
    folder.add_argument("--root_path", required=True)
    folder.add_argument("--output_path", required=True)
    folder.add_argument("--fragment_size", type=int, default=12500)
    folder.add_argument("--batch_size", type=int, default=1024)
    folder.add_argument("--reencode_jpeg_quality", type=int, default=None)
    folder.add_argument("--shuffle_seed", type=int, default=None)

    synth = sub.add_parser("synthetic",
                           help="synthetic classification dataset")
    synth.add_argument("--output_path", required=True)
    synth.add_argument("--rows", type=int, required=True)
    synth.add_argument("--num_classes", type=int, default=101)
    synth.add_argument("--image_size", type=int, default=224)
    synth.add_argument("--fragment_size", type=int, default=12500)

    tokens = sub.add_parser(
        "tokens", help="variable-length synthetic token dataset (long-tail "
                       "lengths; the ragged token plane's corpus)"
    )
    tokens.add_argument("--output_path", required=True)
    tokens.add_argument("--rows", type=int, required=True)
    tokens.add_argument("--vocab_size", type=int, default=1000)
    tokens.add_argument("--max_len", type=int, default=128)
    tokens.add_argument("--mean_len", type=float, default=24.0)
    tokens.add_argument("--seed", type=int, default=0)
    tokens.add_argument("--fragment_size", type=int, default=50000)

    food = sub.add_parser(
        "food101", help="food-101 archive/tree → train + test datasets"
    )
    food.add_argument("--source", required=True,
                      help="food-101.tar.gz or extracted food-101/ dir")
    food.add_argument("--output_root", required=True)
    food.add_argument("--fragment_size", type=int, default=12500)

    args = p.parse_args(argv)
    if args.kind == "synthetic":
        create_synthetic_classification_dataset(
            args.output_path, args.rows, num_classes=args.num_classes,
            image_size=args.image_size, fragment_size=args.fragment_size,
        )
    elif args.kind == "tokens":
        create_variable_length_token_dataset(
            args.output_path, args.rows, vocab_size=args.vocab_size,
            max_len=args.max_len, mean_len=args.mean_len, seed=args.seed,
            fragment_size=args.fragment_size,
        )
    elif args.kind == "food101":
        create_food101_datasets(
            args.source, args.output_root, fragment_size=args.fragment_size
        )
    else:  # "folder", the only other subcommand
        create_dataset_from_image_folder(
            args.root_path, args.output_path,
            fragment_size=args.fragment_size, batch_size=args.batch_size,
            reencode_jpeg_quality=args.reencode_jpeg_quality,
            shuffle_seed=args.shuffle_seed,
        )


if __name__ == "__main__":
    main()
