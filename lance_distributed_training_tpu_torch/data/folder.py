"""The file-based control arm: an image-folder tree read file by file.

Counterpart of ``lance_distributed_training_tpu/data/folder.py``: the
reference's ``torch_version/`` scripts (``ImageFolder`` read straight from
files) as a loader rather than a second training script.
:func:`read_sample_batch` returns the columnar schema ``{image: binary,
label: int64}``, so the same decoders (pixels on the host, or coefficient
pages for the device) take a folder batch as they take a columnar one, and
``--data_format folder`` is a one-flag A/B of files against the columnar
store.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import pyarrow as pa
import torch

from .authoring import _folder_samples
from .pipeline import EpochLoader
from .samplers import distributed_index_batches, sharded_batch_plan

__all__ = ["FolderDataPipeline", "read_sample_batch"]


def read_sample_batch(samples, idx_batch: np.ndarray) -> pa.Table:
    """Read files ``samples[i] for i in idx_batch`` into the columnar batch
    schema ``{image: binary, label: int64}``: the file read of both the
    train loader and the full-coverage eval loader."""
    payloads, labels = [], []
    for i in idx_batch:
        path, label = samples[int(i)]
        with open(path, "rb") as f:
            payloads.append(f.read())
        labels.append(label)
    return pa.table({"image": pa.array(payloads, pa.binary()),
                     "label": pa.array(labels, pa.int64())})


class FolderDataPipeline(EpochLoader):
    """Distributed file-reading loader over an image-folder tree, in the
    two styles of the reference's torchvision twins (``loader_style``):

    - ``"map"``: ``DistributedSampler`` sharding of the walk-ordered files
      (:func:`~.samplers.distributed_index_batches`), reshuffled each
      epoch;
    - ``"iterable"``: contiguous batches of the walk-ordered file list dealt
      round-robin across processes (the columnar iterable arm's batch plan,
      so the A/B isolates storage, not sampling); ``shuffle`` permutes the
      batch order only.

    The cursor and ``set_epoch`` behave as the map-style loader's;
    ``device``, ``producers`` and ``buffer_pool`` as
    :class:`~.pipeline.TrainLoader`'s. The batches are the JAX package's
    ``FolderDataPipeline``'s."""

    def __init__(self, root: str, batch_size: int, process_index: int,
                 process_count: int, decode_fn: Callable,
                 device: Optional[torch.device], *,
                 loader_style: str = "map", shuffle: bool = True,
                 seed: int = 0, epoch: int = 0, drop_last: bool = True,
                 prefetch: int = 2, producers: int = 1, buffer_pool=None):
        self.samples, self.classes = _folder_samples(root)
        if not self.samples:
            raise ValueError(f"no images under {root}")
        if loader_style not in ("map", "iterable"):
            raise ValueError(
                f"loader_style must be 'map' or 'iterable', got "
                f"{loader_style!r}"
            )
        super().__init__(None, None, decode_fn, device, prefetch, epoch,
                         producers=producers, buffer_pool=buffer_pool)
        self.loader_style = loader_style
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def _plan(self) -> list[np.ndarray]:
        if self.loader_style == "iterable":
            plan = sharded_batch_plan(
                [len(self.samples)], self.batch_size, self.process_index,
                self.process_count, shuffle=self.shuffle, seed=self.seed,
                epoch=self.epoch)
            return [np.concatenate([np.arange(r.start, r.stop)
                                    for r in ranges]) for ranges in plan]
        return distributed_index_batches(
            len(self.samples), self.batch_size, self.process_index,
            self.process_count, shuffle=self.shuffle, seed=self.seed,
            epoch=self.epoch, drop_last=self.drop_last)

    def _read(self, item):
        return read_sample_batch(self.samples, item)
