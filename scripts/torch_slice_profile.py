#!/usr/bin/env python3
"""Where the time of one train step of a ported path goes, on the card.

Builds the port's path exactly as ``chip_smoke.py`` trains it, with random
weights from seed 0, and feeds it random batches already on the device (the
loader is not in this measurement):

* ``--task masked_lm`` (default): BERT-base, seq 512, batch 32, AdamW,
  flash attention;
* ``--task classification``: ResNet-50, 224 px, 101 classes, batch 512, SGD
  lr 0.05 momentum 0.9, flips drawn per step (K1 normalises and flips).
  With ``--loader decode`` the batches come instead from the trainer's
  pipeline over a synthetic FOOD-101-shaped JPEG dataset (host decode,
  pinned H2D), so that the trace shows what the loader costs the card;
  ``--loader stage`` runs the same pipeline with the decode replaced by
  one batch decoded ahead (reads, staging and H2D only); ``--loader
  coeff`` is the ``--device_decode`` arm (host entropy decode into
  coefficient pages, pinned H2D, K2 on the card before each step).

It warms up and traces a few steps with ``torch.profiler``. Prints one JSON
line: the step time between CUDA events (no profiler), then, from a
profiled run of the same steps, the kernel time per step split by kind
(the port's kernels, convolutions, BatchNorm, matrix products, the rest),
the device's idle share over the traced window, and the top kernels. Run
from the root of a checkout on a machine with a card:

    python3 scripts/torch_slice_profile.py [--task classification
        [--loader decode|stage|coeff]]
        [--steps 5] [--batch N] [--out DIR]

``--out`` also writes the profiler's table and a Chrome trace there.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lance_distributed_training_tpu_torch.data import (  # noqa: E402
    Dataset,
    create_synthetic_classification_dataset,
    decoder_for_task,
    make_train_pipeline,
)
from lance_distributed_training_tpu_torch.models.tasks import get_task  # noqa: E402
from lance_distributed_training_tpu_torch.ops.jpeg_device import (  # noqa: E402
    make_batch_transform,
)
from lance_distributed_training_tpu_torch.ops.flash import (  # noqa: E402
    make_flash_attention,
)
from lance_distributed_training_tpu_torch.trainer import (  # noqa: E402
    TrainConfig,
    make_optimizer,
    make_train_step,
)

BATCH, SEQ, VOCAB = 32, 512, 30522
IMAGE_BATCH, IMAGE_SIZE, CLASSES = 512, 224, 101


def _kind(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "image_normalize", "jpeg_idct", "jpeg_color_resize"):
        if kernel + "_kernel" in name:
            return kernel
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if "batch_norm" in low or "batchnorm" in low:
        return "batch_norm"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
        # cuBLAS names its f32 SIMT kernels *f32f32* / *sgemm*: the tied
        # vocab head, which runs in f32 without TF32.
        return "matmul_f32" if "f32f32" in low or "sgemm" in low else "matmul"
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", default="masked_lm",
                        choices=["masked_lm", "classification"])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default: the path's own)")
    parser.add_argument("--loader", choices=["decode", "stage", "coeff"],
                        default=None,
                        help="classification: feed the steps from the "
                             "trainer's JPEG pipeline, decoding each batch "
                             "on the host, re-staging one decoded ahead, or "
                             "extracting coefficient pages for K2")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    init = torch.Generator().manual_seed(0)
    if args.task == "classification":
        torch.backends.cudnn.benchmark = True  # as the trainer sets it
        batch_size = args.batch or IMAGE_BATCH
        config = TrainConfig(dataset_path="-", batch_size=batch_size)
        task = get_task("classification", num_classes=CLASSES,
                        model_name="resnet50", device=dev, generator=init)
        shape = (batch_size, IMAGE_SIZE, IMAGE_SIZE, 3)
        batch = {
            "image": torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
            "label": torch.from_numpy(
                rng.integers(0, CLASSES, batch_size).astype(np.int32)).to(dev),
        }
    else:
        batch_size = args.batch or BATCH
        config = TrainConfig(dataset_path="-", task_type="masked_lm",
                             optimizer="adamw", lr=1e-4, seq_len=SEQ,
                             batch_size=batch_size, flash_attention=True)
        task = get_task("masked_lm", model_name="bert_base", seq_len=SEQ,
                        attention_fn=make_flash_attention(), device=dev,
                        generator=init)
        lengths = rng.integers(128, SEQ + 1, batch_size)
        mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int8)
        ids = (2 + (rng.zipf(1.2, (batch_size, SEQ)) - 1) % (VOCAB - 2)) * mask
        batch = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev),
                 "attention_mask": torch.from_numpy(mask).to(dev)}
    optimizer, lr = make_optimizer(config, task.model.parameters())
    train_step = make_train_step(task, optimizer, lr)
    batches = itertools.repeat(batch)
    decoder_arm = tmp = None
    transform = None
    if args.loader and args.task == "classification":
        tmp = tempfile.TemporaryDirectory()
        path = os.path.join(tmp.name, "food")
        create_synthetic_classification_dataset(
            path, rows=batch_size * (3 + 2 * args.steps),
            num_classes=CLASSES, image_size=IMAGE_SIZE)
        decode = decoder_for_task("classification", image_size=IMAGE_SIZE,
                                  device_decode=args.loader == "coeff")
        decoder_arm = decode.arm
        if args.loader == "coeff":
            transform = make_batch_transform(IMAGE_SIZE)
        dataset = Dataset(path)
        if args.loader == "stage":
            decoder_arm = "none"
            ahead = decode(dataset.read_range(0, 0, batch_size))
            decode = lambda table: ahead  # noqa: E731
        batches = iter(make_train_pipeline(dataset, "batch", batch_size, 0,
                                           1, decode, dev))

    def step():
        # Each task draws its mask (MLM positions, flips) from gen.
        batch = next(batches)
        if transform is not None:
            batch = transform(batch)
        train_step(batch, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.steps):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    # Kernel events only: operator events and annotations on the device
    # timeline repeat their kernels' device time.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kinds: dict = {}
    by_name: dict = {}
    intervals = []
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        kinds[_kind(e.name)] = kinds.get(_kind(e.name), 0.0) + us
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + us, count + 1)
        intervals.append((e.time_range.start, e.time_range.end))
    intervals.sort()
    busy, cur_start, cur_end = 0.0, None, None
    for lo, hi in intervals:
        if cur_end is None or lo > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = lo, hi
        else:
            cur_end = max(cur_end, hi)
    if cur_end is not None:
        busy += cur_end - cur_start
    window = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "task": args.task,
        "loader": decoder_arm,
        "batch": batch_size,
        "steps": args.steps,
        "step_ms": step_ms,
        "kernel_ms_per_step": sum(kinds.values()) / 1e3 / args.steps,
        "device_idle_pct_in_trace": (
            100.0 * (1.0 - busy / window) if window else None),
        "kernel_ms_per_step_by_kind": {
            k: v / 1e3 / args.steps for k, v in sorted(kinds.items())},
        "top_kernels": [
            {"name": n[:120], "ms_per_step": us / 1e3 / args.steps,
             "calls_per_step": c / args.steps}
            for n, (us, c) in top],
        "device": torch.cuda.get_device_name(0),
        "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                              row_limit=60))
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    if tmp is not None:
        batches.close()
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
