#!/usr/bin/env python3
"""Where the time of one train step of a ported path goes, on the card.

Builds the port's path exactly as ``chip_smoke.py`` trains it, with random
weights from seed 0, and feeds it random batches already on the device (the
loader is not in this measurement):

* ``--task masked_lm`` (default): BERT-base, seq 512, batch 32, AdamW,
  flash attention, or with ``--seq_parallelism N`` ring attention over N
  sequence blocks held on the one card (K5);
* ``--task masked_lm --num_experts 8``: the same with switch-MoE blocks
  on every second layer (``MOE_EVERY``), the queues gathered by index;
* ``--task classification``: ResNet-50, 224 px, 101 classes, batch 512, SGD
  lr 0.05 momentum 0.9, flips drawn per step (K1 normalises and flips);
  ``--model_name vit_base`` (with ``--batch 256``) trains ViT-B/16 instead.
  With ``--loader decode`` the batches come instead from the trainer's
  pipeline over a synthetic FOOD-101-shaped JPEG dataset (host decode, then
  the trainer's way to the card), so that the trace shows what the loader
  costs the card;
  ``--loader stage`` runs the same pipeline with the decode replaced by
  one batch decoded ahead (reads, staging and H2D only); ``--loader
  coeff`` is the ``--device_decode`` arm (host entropy decode into
  coefficient pages, pinned H2D, K2 on the card before each step);
* ``--task causal_lm``: GPT-2 124M's shape (``gpt_base``), context 1024,
  64 sequences a batch, AdamW, causal flash attention, fed by the
  trainer's pipeline over a seeded corpus of lognormal lengths (log-mean
  log 256, sigma 0.7, 1-1024) and Zipf(1.2) ids: ``--loader packed``
  (default; FFD plan on the host, K3 on the card before each step) or
  ``--loader padded`` (every row padded to 1024);
* ``--task contrastive``: CLIP (``clip_resnet50_bert``), 224 px, captions
  of up to 77 tokens (lengths from ``chip_smoke.caption_lengths``, padded
  to 77), batch 512,
  AdamW lr 1e-4, flips drawn per step.

A ``--loader`` pipeline takes the trainer's defaults: pooled page-locked
decode pages, ``--producer_threads 4`` and the placement plane (a ring of
two batches copied on a side stream); ``--no_global_batch`` places each
batch on the consumer thread instead (the synchronous control arm), and
``--no_buffer_pool`` decodes into fresh pages.

It warms up and traces a few steps with ``torch.profiler``. Prints one JSON
line: the step time between CUDA events (no profiler), then, from a
profiled run of the same steps, the kernel time per step split by kind
(the port's kernels, convolutions, BatchNorm, matrix products, softmax,
the gathers, scatters and index kernels (the MoE dispatch among them), the
rest),
the device's idle share over the traced window, and the top kernels; with
``--seq_parallelism``, also the milliseconds a step of the ring backward's
plain ``delta = rowsum(dO * O)``, timed alone between CUDA events. Run
from the root of a checkout on a machine with a card:

    python3 scripts/torch_slice_profile.py [--seq_parallelism 4]
        [--num_experts 8]
        [--task classification [--loader decode|stage|coeff]
                               [--model_name vit_base]]
        [--task causal_lm [--loader packed|padded]] [--task contrastive]
        [--no_global_batch] [--producer_threads N] [--no_buffer_pool]
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
    PlacementPlane,
    TokenPackConfig,
    create_synthetic_classification_dataset,
    decoder_for_task,
    default_buffer_pool,
    make_train_pipeline,
    write_dataset,
)
from lance_distributed_training_tpu_torch.models.tasks import get_task  # noqa: E402
from lance_distributed_training_tpu_torch.ops.jpeg_device import (  # noqa: E402
    make_batch_transform,
)
from lance_distributed_training_tpu_torch.ops.flash import (  # noqa: E402
    make_flash_attention,
)
from lance_distributed_training_tpu_torch.ops.token_device import (  # noqa: E402
    make_pack_transform,
)
from lance_distributed_training_tpu_torch.parallel.ring_attention import (  # noqa: E402
    make_ring_attention,
)
from lance_distributed_training_tpu_torch.trainer import (  # noqa: E402
    TrainConfig,
    make_optimizer,
    make_train_step,
)
from chip_smoke import CLIP_SEQ, caption_lengths  # noqa: E402

BATCH, SEQ, VOCAB = 32, 512, 30522
IMAGE_BATCH, IMAGE_SIZE, CLASSES = 512, 224, 101
GPT_BATCH, GPT_CONTEXT, GPT_VOCAB = 64, 1024, 50257
MOE_EVERY = 2  # as chip_smoke.py's moe phase


def _causal_corpus(path: str, rows: int) -> None:
    """Seeded lognormal lengths and Zipf(1.2) ids, one document a row."""
    import pyarrow as pa

    rng = np.random.default_rng(6)
    lengths = np.clip(rng.lognormal(np.log(256.0), 0.7, rows).astype(np.int64),
                      1, GPT_CONTEXT)
    docs = [(2 + (rng.zipf(1.2, int(m)) - 1) % (GPT_VOCAB - 2)).astype(
        np.int32) for m in lengths]
    table = pa.table({"input_ids": pa.array(docs, pa.list_(pa.int32()))})
    write_dataset(table, path, schema=table.schema, mode="create")


def _kind(name: str) -> str:
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "image_normalize", "jpeg_decode",
                   "token_pack", "token_unpack", "ring_fold_fwd",
                   "ring_fold_bwd_dq", "ring_fold_bwd_dkv"):
        if kernel + "_kernel" in name:
            return kernel
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if "batch_norm" in low or "batchnorm" in low:
        return "batch_norm"
    if "softmax" in low:
        return "softmax"
    if any(t in low for t in ("index", "scatter", "gather")):
        return "index_gather_scatter"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
        # cuBLAS names its f32 SIMT kernels *f32f32* / *sgemm*: the tied
        # vocab head, which runs in f32 without TF32.
        return "matmul_f32" if "f32f32" in low or "sgemm" in low else "matmul"
    return "other"


def _ring_delta_ms(batch_size: int, dev) -> float:
    """The ring backward's plain ``delta = rowsum(dO * O)``
    (``parallel/ring_attention.py``), as it runs once a layer on bf16
    ``[B, 12, 512, 64]``: the median between CUDA events over 20 calls,
    times BERT-base's 12 layers."""
    gen = torch.Generator(device=dev).manual_seed(2)
    do, out = (torch.randn((batch_size, 12, SEQ, 64), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(2))
    times = []
    for i in range(23):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        (do.float() * out.float()).sum(-1)
        end.record()
        end.synchronize()
        if i >= 3:
            times.append(start.elapsed_time(end))
    return float(np.median(times)) * 12


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", default="masked_lm",
                        choices=["masked_lm", "classification",
                                 "causal_lm", "contrastive"])
    parser.add_argument("--model_name", default=None,
                        help="classification: resnet50 (default) or a ViT")
    parser.add_argument("--num_experts", type=int, default=0,
                        help="masked_lm: switch-MoE blocks")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default: the path's own)")
    parser.add_argument("--loader",
                        choices=["decode", "stage", "coeff", "packed",
                                 "padded"],
                        default=None,
                        help="classification: feed the steps from the "
                             "trainer's JPEG pipeline, decoding each batch "
                             "on the host, re-staging one decoded ahead, or "
                             "extracting coefficient pages for K2; "
                             "causal_lm: packed (default) or padded rows")
    parser.add_argument("--seq_parallelism", type=int, default=1,
                        help="masked_lm: ring attention over N sequence "
                             "blocks instead of flash attention")
    parser.add_argument("--no_global_batch", action="store_true",
                        help="--loader: place each batch on the consumer "
                             "thread (the synchronous control arm)")
    parser.add_argument("--producer_threads", type=int, default=4,
                        help="--loader: decode-producer threads")
    parser.add_argument("--no_buffer_pool", action="store_true",
                        help="--loader: decode into fresh pages")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if (args.seq_parallelism > 1 or args.num_experts) \
            and args.task != "masked_lm":
        parser.error("--seq_parallelism and --num_experts need --task "
                     "masked_lm")
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
                        model_name=args.model_name or "resnet50",
                        image_size=IMAGE_SIZE, device=dev, generator=init)
        shape = (batch_size, IMAGE_SIZE, IMAGE_SIZE, 3)
        batch = {
            "image": torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)).to(dev),
            "label": torch.from_numpy(
                rng.integers(0, CLASSES, batch_size).astype(np.int32)).to(dev),
        }
    elif args.task == "causal_lm":
        batch_size = args.batch or GPT_BATCH
        config = TrainConfig(dataset_path="-", task_type="causal_lm",
                             optimizer="adamw", lr=1e-4, seq_len=GPT_CONTEXT,
                             batch_size=batch_size, flash_attention=True)
        task = get_task("causal_lm", model_name="gpt_base",
                        seq_len=GPT_CONTEXT,
                        attention_fn=make_flash_attention(causal=True),
                        device=dev, generator=init)
        batch = None
    elif args.task == "contrastive":
        torch.backends.cudnn.benchmark = True
        batch_size = args.batch or IMAGE_BATCH
        config = TrainConfig(dataset_path="-", task_type="contrastive",
                             optimizer="adamw", lr=1e-4, seq_len=CLIP_SEQ,
                             batch_size=batch_size)
        task = get_task("contrastive", model_name="clip_resnet50_bert",
                        image_size=IMAGE_SIZE, seq_len=CLIP_SEQ, device=dev,
                        generator=init)
        lengths = caption_lengths(rng, batch_size)
        mask = (np.arange(CLIP_SEQ)[None] < lengths[:, None]).astype(np.int8)
        ids = rng.integers(2, VOCAB, (batch_size, CLIP_SEQ)) * mask
        batch = {
            "image": torch.from_numpy(rng.integers(
                0, 256, (batch_size, IMAGE_SIZE, IMAGE_SIZE, 3),
                dtype=np.uint8)).to(dev),
            "input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev),
            "attention_mask": torch.from_numpy(mask).to(dev)}
    else:
        batch_size = args.batch or BATCH
        ring = args.seq_parallelism > 1
        config = TrainConfig(dataset_path="-", task_type="masked_lm",
                             optimizer="adamw", lr=1e-4, seq_len=SEQ,
                             batch_size=batch_size, flash_attention=not ring,
                             seq_parallelism=args.seq_parallelism,
                             num_experts=args.num_experts,
                             moe_every=MOE_EVERY)
        attention_fn = (make_ring_attention(args.seq_parallelism) if ring
                        else make_flash_attention())
        task = get_task("masked_lm", model_name="bert_base", seq_len=SEQ,
                        attention_fn=attention_fn,
                        num_experts=args.num_experts,
                        moe_every=MOE_EVERY, device=dev,
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
    pool = (None if args.no_buffer_pool
            else default_buffer_pool(pin_memory=True))
    plane = None

    def pipeline(dataset, decode):
        """The trainer's way from the loader to the card."""
        nonlocal plane
        if args.no_global_batch:
            return make_train_pipeline(dataset, "batch", batch_size, 0, 1,
                                       decode, dev,
                                       producers=args.producer_threads,
                                       buffer_pool=pool)
        plane = PlacementPlane(dev, depth=2, buffer_pool=pool)
        return plane.wrap(make_train_pipeline(
            dataset, "batch", batch_size, 0, 1, decode, None,
            producers=args.producer_threads, buffer_pool=pool))
    if args.loader and args.task == "classification":
        tmp = tempfile.TemporaryDirectory()
        path = os.path.join(tmp.name, "food")
        create_synthetic_classification_dataset(
            path, rows=batch_size * (3 + 2 * args.steps),
            num_classes=CLASSES, image_size=IMAGE_SIZE)
        decode = decoder_for_task("classification", image_size=IMAGE_SIZE,
                                  device_decode=args.loader == "coeff",
                                  buffer_pool=pool)
        decoder_arm = decode.arm
        if args.loader == "coeff":
            transform = make_batch_transform(IMAGE_SIZE)
        dataset = Dataset(path)
        if args.loader == "stage":
            decoder_arm = "none"
            ahead = decoder_for_task("classification", image_size=IMAGE_SIZE)(
                dataset.read_range(0, 0, batch_size))
            decode = lambda table: dict(ahead)  # noqa: E731
        batches = iter(pipeline(dataset, decode))
    if args.task == "causal_lm":
        loader = args.loader or "packed"
        tmp = tempfile.TemporaryDirectory()
        path = os.path.join(tmp.name, "tokens")
        _causal_corpus(path, batch_size * (3 + 2 * args.steps))
        packing = TokenPackConfig(pack_len=GPT_CONTEXT) \
            if loader == "packed" else None
        decode = decoder_for_task("causal_lm", seq_len=GPT_CONTEXT,
                                  token_pack=packing, buffer_pool=pool)
        decoder_arm = loader
        transform = make_pack_transform() if packing else None
        batches = iter(pipeline(Dataset(path), decode))

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
        "model_name": args.model_name,
        "num_experts": args.num_experts,
        "seq_parallelism": args.seq_parallelism,
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
    if args.loader:
        result.update(global_batch=not args.no_global_batch,
                      producer_threads=args.producer_threads,
                      buffer_pool=not args.no_buffer_pool,
                      placement_ms_median=(float(np.median(plane.h2d_ms))
                                           if plane and plane.h2d_ms
                                           else None))
    if args.seq_parallelism > 1:
        result["ring_delta_ms_per_step"] = _ring_delta_ms(batch_size, dev)
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
