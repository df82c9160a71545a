#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. probe   — torch/CUDA versions, the card and its power limit; requires
             compute capability 9.0; turns TF32 off for f32 matmuls.
2. build   — compiles ``ops/csrc/flash_attn.cu``, ``ops/csrc/image.cu``,
             ``ops/csrc/jpeg_decode.cu``, ``ops/csrc/token_pack.cu`` and
             ``ops/csrc/ring_attn.cu`` for sm_90a, the native JPEG
             decoder and the coefficient extractor (``native/ldt_coeffs.cpp``,
             g++ alone), all at once, and prints the build times and, from
             the ``-Xptxas -v`` reports, registers, spills and shared memory
             of all six flash kernel builds (three kernels, head dims 64 and
             128), of K1's two routes, of K2, of K3's two kernels and of K5's
             three; fails on any spill of any of the three flash kernels at
             head dim 64, of K1, K2, K3 or K5, and when the extractor does
             not build.
3. kernels — runs the fwd, bwd_dq and bwd_dkv kernels at the BERT-base
             shapes [32, 12, 512, 64] bf16, (a) non-causal with padding
             segments and (b) causal, against their plain PyTorch versions
             in f32 on the same inputs, checks that a second launch on the
             same inputs gives the same bits; then (c) causal with packed
             segments from a real first-fit-decreasing plan of the
             causal-LM corpus, at [rows, 12, 1024, 64] and at S = 64, the
             same way; and times them (mode a) beside the
             plain versions and ``scaled_dot_product_attention``; the
             backward's sum (dQ + dK/dV + the plain di op) is printed beside
             SDPA's backward alone (its fwd+bwd less its fwd, one call),
             which the dQ and dK/dV rows also carry as ``library_bwd_ms``
             beside ``pair_ms``, the two kernels' sum: the one call
             computes both rows' work.
4. slice   — trains BERT-base masked-LM (768/12/12/3072, S = 512, batch 32)
             for 20 steps through ``cli train --flash_attention`` on a seeded
             token dataset, after checking flash attention against the dense
             attention path on a small model.
5. trainer — the trainer beyond the main path on the slice phase's corpus
             (its first 12 batches): BERT-base masked-LM through ``cli train
             --flash_attention --grad_accum 4`` (micro-batch 32, 128 rows an
             update, AdamW lr 1e-4 on a cosine schedule over 3 updates,
             ``--log_grad_norm``): first 12 micro-steps untraced with one
             progress line (the timed run); then, with ``--log_every 1`` and
             the step trace on, three runs in one checkpoint directory on
             the machine's disk: a control of 12 micro-steps with
             ``--profile_dir``; a run with
             ``--checkpoint_every_steps 4`` drained at micro-step 6
             (``LDT_CHAOS=drain@6``, mid-window: the emergency checkpoint
             holds a half-full accumulator); and the same flags again, which
             resumes. Checks that the resumed run starts at absolute step 7
             and ends at 12, that its losses and batch digests equal the
             control's for steps 7-12 and its final parameters the
             control's, bit for bit (and the timed run's losses too), that
             each run applied its updates
             (AdamW's step 3 at the end of both), that flash launched 12
             fwd, 12 dQ and 12 dK/dV a micro-step and K5 never, that every
             progress line has a finite ``grad_norm`` and the schedule's
             ``lr`` in updates, and that the profiler's trace names the
             three flash kernels; prints the timed run's micro-step median
             (steps 2-12) beside the slice phase's step, each run's
             micro-steps, the accumulator fold's time, each save's
             time on the training thread and its write, the checkpoint's
             bytes, the restore time and the peak memory.
6. image_kernels — K1 (``ops/csrc/image.cu``) against its plain PyTorch
             version on the card, bit for bit, on every uint8 value, at
             [512, 224, 224, 3] and at other shapes of both routes (W = 16,
             17, 48, 224, 2048, 4096 and 8192, batches 1 byte off 16-byte
             alignment), with no, a random and an all-set flip mask; times
             it (CUDA events around 20 launches back to back, median of 5)
             beside the plain version and a device-to-device copy of the
             same bytes; the bound takes the card's published memory rate.
7. jpeg_kernels — K2 (``ops/csrc/jpeg_decode.cu``) against its plain
             PyTorch version on the card, bit for bit: at the path's shape
             (pages ``int16 [512, 28, 28, 64]`` and ``[512, 14, 14, 64]``
             extracted here from the seeded classification set →
             ``uint8 [512, 224, 224, 3]``) and at ragged cases (odd sizes,
             grayscale, progressive, re-encoded 4:4:4, a zero-geometry
             row; out sizes 224, 32 and 40), and on a repeat launch; times
             its one launch (between CUDA events, median of 20, and 20
             launches back to back, median of 5) beside the plain version;
             the bound is the larger of its bytes over 3.35 TB/s and its
             integer operations that this data needs (the even/odd IDCT of
             each block that holds a sampled pixel, the colour conversion
             of each sampled source pixel, each mix whose weight is not 0)
             over 33.45 T/s, the card's 32-bit integer rate (64 lanes
             an SM to the f32 rate's 128, at the 1.98 GHz boost clock that
             the published 67 TFLOP/s of f32 implies). Prints
             the extractor's time for the 512 images and its threads.
8. classification — trains ResNet-50 (224 px, 101 classes, global batch
             512, SGD lr 0.05 momentum 0.9, flips, eval at the end) for 20
             steps through ``cli train`` on a seeded FOOD-101-shaped JPEG
             dataset (``create_synthetic_classification_dataset``, 20
             batches of rows; each row labelled by its image, so that
             there is something to learn), host-decoded by the native
             decoder or PIL; the eval pass covers every row once.
9. device_decode — the same run through ``cli train --device_decode``:
             the host extracts coefficient pages, K2 decodes them on the
             card for each of the 20 train and 20 eval batches; checks the
             decoder arm, K2's 40 launches, the falling loss and the eval
             over every row, and prints the step, the rates, the stall and
             the entropy and K2 times.
10. token_kernels — K3 (``ops/csrc/token_pack.cu``, pack and unpack)
             against its plain PyTorch version on the card, bit for bit: at
             the path's shape (a batch of 64 sequences of the causal-LM
             corpus, pack_len 1024), at ragged cases (empty sequences, one
             sequence, sequences truncated at pack_len, a values tail past
             offsets[n], padding rows from rows_multiple, bucket mode), on
             a repeat launch, and the round trip unpack(pack(x)) == x; and
             plans made by hand (600 sequences, runs across a row's end,
             destinations below, past and partly past the grid, a nonzero
             offsets[0]); times both beside the plain versions: device
             time, CUDA events around 20 launches queued behind a spin of
             the card (median of 5; the host takes longer per launch than
             the card), with the host's queueing time a call, and back to
             back as a caller meets them, beside the launch floor (an
             empty launch timed the same way); the bound is their bytes
             over 3.35 TB/s.
11. causal_lm — trains GPT-2 124M's shape (``gpt_base``: 768/12/12/3072,
             vocab 50257, context 1024) for 20 steps through ``cli train
             --task_type causal_lm --token_pack --flash_attention`` (64
             sequences a batch, pack_rows_multiple 8, AdamW lr 1e-4, eval
             at the end) on a seeded corpus of lognormal lengths (mean
             parameter 256, sigma 0.7, 1-1024) and Zipf(1.2) ids, then the
             same run with ``--no_token_pack`` (the padded arm); checks K3's
             20 launches, the flash launches, the falling loss, the eval
             over every row and finite losses, and prints each arm's step,
             grid and valid tokens/s and pad_waste_pct (steps 5-20, from
             each step's own payload), pack_device_ms and peak memory.
12. ring_kernels — K5 (``ops/csrc/ring_attn.cu``: the fold, dQ and dK/dV)
             over a whole in-process ring as the path launches it (each
             kernel once over all four ring steps) against the plain
             versions on the card (flash's
             tolerances: out 0.02 and 4e-3, lse 1e-3, gradients 2% of the
             largest; rows with no valid key 0, with 0 gradients) and
             against four one-step launches of the same kernels, bit for
             bit: at [32, 12, 512, 64] bf16 in four positions with key
             masks from the slice corpus's lengths (fully masked blocks
             among them), and at ragged cases (empty rows, blocks of 50 and
             of 256, one position); then a repeat that must give the same
             bits. Times each kernel as the path launches it (one launch
             between CUDA events, and 20 back to back) and the one ring
             step of each that a process ring launches
             beside the plain versions, the whole
             ring forward and forward + backward beside SDPA over the whole
             sequence with the same key mask (a yardstick, never called by
             the port, also timed back to back; its backward beside the
             dQ + dK/dV pair); the bound
             is the larger of each launch's bytes over 3.35 TB/s and its
             products over the bf16 peak.
13. ring_lm — trains BERT-base masked-LM through ``cli train
             --seq_parallelism 4`` (every ring position on the card) for 20
             steps on the slice phase's corpus, with the eval at the end;
             checks 12 forward, 12 dQ and 12 dK/dV launches a step (one a
             layer) and 12 forward launches an eval batch,
             no flash launch, the falling loss and the eval over every row,
             and prints the step beside the slice phase's flash step,
             tokens/s and peak memory.
14. map_style — ResNet-50 as in the classification phase through ``cli
             train --loader_style map --filter "label < 48" --val_fraction
             0.1 --eval_every 1 --epochs 1 --device_decode`` on a learnable
             set of 15,360 rows (label = image index mod 64): the filter
             keeps 11,520 rows, the seeded split holds out 1,152 and leaves
             10,368, 20 steps of 512 gathered by ``take`` from a new
             permutation; the eval at the epoch's end and at the end each
             cover the val split (3 padded batches). The counts come from
             the pools (``Dataset.filter_indices``, the trainer's
             ``_split_val_pool``). Checks the 20 finite, falling losses,
             both evals' rows, that no val row is a train row, the coeff
             arm and K1 and K2 launched once a train step and once an eval
             batch; prints the step, images/s, stall, entropy and K2 times
             beside the device_decode phase's (range reads against
             random-access gathers).
15. folder  — the file-based control arm: ResNet-50 through ``cli train
             --data_format folder --loader_style map`` over an image-folder
             tree of 64 class directories, each holding 160 hard links to
             one seeded 224 px noise JPEG (the classification set's image
             of that label), host-decoded, eval at the end over the 10,240
             files. Checks the 20 finite, falling losses, the eval's rows,
             K1 once a train step and an eval batch and K2 never; prints
             the same figures beside the classification phase's (files
             against the columnar store).

16. pretrained_placement — the JAX package's default way from host to
             card, on the reference's fine-tuning task: the port's ResNet-50
             with 1000 classes from a seeded generator is written as a
             torchvision checkpoint (``{"state_dict": {"module." + k: v}}``
             with zero ``num_batches_tracked`` entries); imported with
             ``load_torchvision_resnet`` into a 101-class ResNet-50 on the
             card, every backbone tensor must equal the file's bit for bit
             and the head a same-seed model's fresh ``[101, 2048]`` one.
             Then, on one authored set (the classification phase's recipe,
             10,240 rows), in each decoder arm (PIL on the host, and the
             coefficient pages with K2): the first 20 batches of the
             iterable loader through the placement plane (a ring of 2, 4
             producers, page-locked pool pages), each followed by K1 (after
             K2) and a ResNet-50 forward and backward so that the copies of
             the next batches overlap its kernels, must equal the
             synchronous arm's batches and K1 outputs bit for bit (int64
             digests taken on the card); and four runs of ``cli train
             --pretrained`` (224 px, batch 512, 20 steps, eval at the end):
             each decoder arm at the defaults and with ``--no_global_batch
             --producer_threads 1 --no_buffer_pool``. Checks the falling
             losses, K1's 40 launches a run and K2's 40 (coeff) or 0 (PIL),
             the eval over every row, that the decoders leased pool pages
             under the defaults and that no ``ldt-placement`` or
             ``ldt-producer-*`` thread outlives ``cli.main``; prints each
             run's median step, images/s over steps 6-20, stall,
             ``h2d_pct``, placement ms a batch (median and the first three),
             pool hits, misses and the time spent allocating missed pages,
             peak memory and the host's CPU count.

Every check that fails raises, so the script exits non-zero. After the
phases a ``done`` line gives the seconds since the script's ``main`` began
(the phases run, the kernels built). The last three lines are the card's ``nvidia-smi`` name and power limit, the kernel table
as JSON (the three flash kernels, K1 and K2, each with its launches on its
path; K3's pack and unpack with their launches on the causal-LM path; K5's
three kernels with theirs on the seq-parallel path; K1 and K2 add their
launches under the map_style and folder loaders as
``launches_map_style`` and ``launches_folder``, and their sums over the four
runs of the pretrained_placement phase as
``launches_pretrained_placement``), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PHASES = ("probe", "build", "kernels", "slice", "trainer", "image_kernels",
          "jpeg_kernels", "classification", "device_decode", "token_kernels",
          "causal_lm", "ring_kernels", "ring_lm", "map_style", "folder",
          "pretrained_placement")
SHAPE = (32, 12, 512, 64)  # B, H, S, D at BERT-base, seq 512
STEPS = 20
LAYERS = 12
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_O, TOL_LSE, TOL_GRAD_REL = 2e-2, 1e-3, 2e-2
SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/flash_attn.cu"
IMAGE_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/image.cu"
IMAGE_REPLACES = "lance_distributed_training_tpu/ops/image.py:24,37"
IMAGE_SHAPE = (512, 224, 224, 3)  # B, H, W, C of the classification path
IMAGE_OPS = 3  # f32 operations a K1 element takes: divide, subtract, divide
IMAGE_CASES = (IMAGE_SHAPE, (1, 224, 224, 3), (3, 5, 16, 3), (1, 33, 17, 3),
               (3, 33, 17, 3), (2, 7, 48, 3), (2, 3, 2048, 3),
               (1, 3, 4096, 3), (1, 2, 8192, 3))
IMAGE_UNALIGNED_CASES = ((4, 224, 224, 3), (2, 9, 16, 3))
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# 32-bit integer operations (a multiply-add counts 2): 132 SMs x 64 INT32
# lanes x 2 at the 1.98 GHz boost clock, half the f32 rate's 128 lanes (the
# Hopper white paper; the CUDA programming guide's throughput table, 9.0).
PEAK_INT32_OPS = 132 * 64 * 2 * 1.98e9
IMAGE_BATCH, IMAGE_CLASSES = 512, 101
JPEG_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/jpeg_decode.cu"
JPEG_REPLACES = "lance_distributed_training_tpu/ops/jpeg_device.py:180"
UNIQUE_IMAGES = 64  # distinct images (and labels) of the classification set
TOKEN_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/token_pack.cu"
TOKEN_REPLACES = {
    "token_pack": "lance_distributed_training_tpu/ops/token_device.py:67",
    "token_unpack": "lance_distributed_training_tpu/ops/token_device.py:117",
}
GPT_VOCAB, GPT_CONTEXT, GPT_BATCH = 50257, 1024, 64  # GPT-2 small's n_ctx
RING_SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/ring_attn.cu"
RING_REPLACES = "lance_distributed_training_tpu/parallel/ring_attention.py:37,62"
RING_SP = 4  # ring positions of the seq-parallel path (one card)
# K5 rounds where the plain fold does, so their outputs agree to a bf16 ulp
# or two (flash's 0.02 alone would pass a kernel that rounds elsewhere).
RING_TOL_O_CLOSE = 4e-3
RING_KERNELS = ("ring_fwd", "ring_bwd_dq", "ring_bwd_dkv")
GPT_MEAN_LEN, GPT_SIGMA = 256.0, 0.7  # lognormal lengths of the corpus
PACK_ROWS_MULTIPLE = 8
TRAINER_STEPS, TRAINER_ACCUM, TRAINER_DRAIN = 12, 4, 6  # micro-steps
UPSTREAM = "jax/experimental/pallas/ops/tpu/flash_attention.py"
REPLACES = {
    "fwd": f"{UPSTREAM}:758",
    "bwd_dq": f"{UPSTREAM}:1456",
    "bwd_dkv": f"{UPSTREAM}:1121",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median over ``iters`` runs of ``fn``, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_back_to_back_ms(fn, launches: int = 20, reps: int = 5,
                         warmup: int = 3) -> float:
    """Per-launch time of ``fn``: CUDA events around ``launches`` calls made
    back to back, divided by ``launches``; the median over ``reps``. The
    card's queue stays full, so a wrapper's host work between launches does
    not count as the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def time_queued_ms(fn, launches: int = 20, reps: int = 5,
                   warmup: int = 3) -> dict:
    """Device time per launch of ``fn`` where the host, not the card, would
    set the pace back to back: the card first spins (``torch.cuda._sleep``)
    while the host queues ``launches`` calls, then runs them between two
    CUDA events; the median over ``reps``. A rep whose queueing outlasted
    the spin (the card waited on the host) is run again with a spin twice
    as long. Also returns the host's longest queueing time and the
    shortest spin; ``host_queue_ms_per_call`` is that longest queueing
    time over ``launches``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host, spin = [], [], []
    cycles = 40_000_000
    while len(times) < reps:
        before = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        queued = 1e3 * (time.perf_counter() - t0)
        end.record()
        end.synchronize()
        spun = before.elapsed_time(start)
        if queued >= spun:
            if cycles >= 640_000_000:
                raise RuntimeError(f"queueing {launches} launches took "
                                   f"{queued} ms, longer than a {spun} ms "
                                   "spin of the card")
            cycles *= 2
            continue
        host.append(queued)
        spin.append(spun)
        times.append(start.elapsed_time(end) / launches)
    return {"ms": statistics.median(times), "host_queue_ms": max(host),
            "host_queue_ms_per_call": max(host) / launches,
            "spin_ms": min(spin)}


def probe() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("probe", torch=torch.__version__, cuda=torch.version.cuda,
         device=name, capability=list(cap), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"need compute capability 9.0 (Hopper), got {cap}")
    return {"name": name, "smi": smi}


KERNEL_IDS = {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 2}  # ldt_flash_smem_bytes


def _ptxas_kernels(report: str, pattern: str = r"flash_(fwd|bwd_dq|bwd_dkv)"
                   r"_kernelILi(\d+)E") -> list:
    """Per kernel build in a ``-Xptxas -v`` report whose mangled name
    matches ``pattern`` (group 1 the kernel, group 2, if any, the head
    dim): registers, spill bytes and static shared memory."""
    rows, row = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(pattern, entry.group(1))
            row = None
            if name:
                row = {"kernel": name.group(1)}
                if name.lastindex and name.lastindex >= 2:
                    row["head_dim"] = int(name.group(2))
                rows.append(row)
            continue
        if row is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            row["spill_stores"] = int(spill.group(1))
            row["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            row["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            row["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def _spilled(row: dict) -> bool:
    return bool(row.get("spill_stores", 0) or row.get("spill_loads", 0))


def build() -> dict:
    """Build the two kernel libraries and the native decoder at once (one
    compiler process each), then check their reports."""
    from concurrent.futures import ThreadPoolExecutor

    from lance_distributed_training_tpu_torch.native import coeffs, jpeg
    from lance_distributed_training_tpu_torch.ops import (
        _build,
        flash,
        image,
        jpeg_device,
        ring_attention,
        token_device,
    )

    t0 = time.monotonic()
    with ThreadPoolExecutor(7) as pool:
        futures = [pool.submit(_build.build_library, stem)
                   for stem in ("flash_attn", "image", "jpeg_decode",
                                "token_pack", "ring_attn")]
        native = pool.submit(jpeg.native_available)
        extractor = pool.submit(coeffs.default_threads)
        for future in futures:
            future.result()
        native_ok = native.result()
        extractor_threads = extractor.result()  # raises if it did not build
    lib = flash._library()
    image._library()
    jpeg_device._library()
    token_device._library()
    ring_attention._library()
    report = _build.build_report("flash_attn")
    kernels = _ptxas_kernels(report["ptxas"])
    for row in kernels:
        row["dynamic_smem_bytes"] = lib.ldt_flash_smem_bytes(
            KERNEL_IDS[row["kernel"]], row["head_dim"])
    image_report = _build.build_report("image")
    image_rows = _ptxas_kernels(image_report["ptxas"],
                                r"image_normalize_(rows|groups)_kernel")
    jpeg_report = _build.build_report("jpeg_decode")
    jpeg_rows = _ptxas_kernels(jpeg_report["ptxas"],
                               r"(jpeg_decode)_kernel")
    token_report = _build.build_report("token_pack")
    token_rows = _ptxas_kernels(token_report["ptxas"],
                                r"(token_pack|token_unpack)_kernel")
    ring_report = _build.build_report("ring_attn")
    ring_rows = _ptxas_kernels(
        ring_report["ptxas"],
        r"(ring_fold_fwd|ring_fold_bwd_dq|ring_fold_bwd_dkv)_kernel")
    emit("build", seconds=time.monotonic() - t0,
         nvcc_seconds=report["seconds"], cached=report["cached"],
         kernels=kernels, image_nvcc_seconds=image_report["seconds"],
         image_kernels=image_rows,
         jpeg_nvcc_seconds=jpeg_report["seconds"], jpeg_kernels=jpeg_rows,
         token_nvcc_seconds=token_report["seconds"], token_kernels=token_rows,
         ring_nvcc_seconds=ring_report["seconds"], ring_kernels=ring_rows,
         native_decoder=native_ok, native_decoder_error=jpeg.build_error(),
         coefficient_extractor_threads=extractor_threads)
    builds = {(r["kernel"], r["head_dim"]) for r in kernels}
    want = {(k, d) for k in KERNEL_IDS for d in flash.HEAD_DIMS}
    if builds != want or not all("registers" in r for r in kernels):
        raise RuntimeError(f"ptxas report covers {sorted(builds)}, "
                           f"expected {sorted(want)}")
    spills = [r for r in kernels if r["head_dim"] == 64 and _spilled(r)]
    if spills:
        raise RuntimeError(f"ptxas spills at head dim 64: {spills}")
    if (sorted(r["kernel"] for r in image_rows) != ["groups", "rows"]
            or not all("registers" in r for r in image_rows)):
        raise RuntimeError(f"ptxas report of image.cu: {image_rows}")
    if any(_spilled(r) for r in image_rows):
        raise RuntimeError(f"ptxas spills in K1: {image_rows}")
    if ([r["kernel"] for r in jpeg_rows] != ["jpeg_decode"]
            or not all("registers" in r for r in jpeg_rows)):
        raise RuntimeError(f"ptxas report of jpeg_decode.cu: {jpeg_rows}")
    if any(_spilled(r) for r in jpeg_rows):
        raise RuntimeError(f"ptxas spills in K2: {jpeg_rows}")
    if (sorted(r["kernel"] for r in token_rows)
            != ["token_pack", "token_unpack"]
            or not all("registers" in r for r in token_rows)):
        raise RuntimeError(f"ptxas report of token_pack.cu: {token_rows}")
    if any(_spilled(r) for r in token_rows):
        raise RuntimeError(f"ptxas spills in K3: {token_rows}")
    if (sorted(r["kernel"] for r in ring_rows)
            != ["ring_fold_bwd_dkv", "ring_fold_bwd_dq", "ring_fold_fwd"]
            or not all("registers" in r for r in ring_rows)):
        raise RuntimeError(f"ptxas report of ring_attn.cu: {ring_rows}")
    if any(_spilled(r) for r in ring_rows):
        raise RuntimeError(f"ptxas spills in K5: {ring_rows}")
    return {"image_ptxas": image_rows, "jpeg_ptxas": jpeg_rows,
            "token_ptxas": token_rows, "ring_ptxas": ring_rows}


def _bounds(b: int, h: int, s: int, d: int) -> dict:
    """Least time for each kernel at these shapes: the larger of its
    matrix-product operations over the bf16 peak and its compulsory bytes
    (each input read once, each output written once) over the HBM rate."""
    bhsd, bhs = b * h * s * d, b * h * s
    seg = b * s * 4
    work = {
        # fwd: S = QK^T, O = PV; reads q, k, v, seg; writes o (bf16), lse.
        "fwd": (4 * bhsd * s, 3 * bhsd * 2 + seg + bhsd * 2 + bhs * 4),
        # dq: S, dP = dO V^T, dQ = dS K; reads q, k, v, do, lse, di, seg.
        "bwd_dq": (6 * bhsd * s, 4 * bhsd * 2 + 2 * bhs * 4 + seg + bhsd * 2),
        # dkv: S^T, dP^T, dV = P^T dO, dK = dS^T Q; writes dk, dv.
        "bwd_dkv": (8 * bhsd * s,
                    4 * bhsd * 2 + 2 * bhs * 4 + seg + 2 * bhsd * 2),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = {
            "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def _check_flash_case(mode, q, k, v, do, seg, causal, scale, errors) -> None:
    """fwd, dQ and dK/dV on the card against their plain versions in f32
    (the tolerances of the kernels phase), then a repeat launch that must
    give the same bits; ``errors`` keeps each kernel's largest error."""
    import torch
    from lance_distributed_training_tpu_torch.ops import flash

    o, lse = flash.flash_attention_fwd(q, k, v, seg, causal, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = flash.flash_attention_reference(qf, kf, vf, seg,
                                                     causal, scale)
    di = (o_ref * dof).sum(-1)
    dq = flash.flash_attention_bwd_dq(q, k, v, seg, lse_ref, do, di,
                                      causal, scale)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, seg, lse_ref, do, di,
                                           causal, scale)
    dq_ref = flash.flash_attention_bwd_dq_reference(
        qf, kf, vf, seg, lse_ref, dof, di, causal, scale)
    dk_ref, dv_ref = flash.flash_attention_bwd_dkv_reference(
        qf, kf, vf, seg, lse_ref, dof, di, causal, scale)
    torch.cuda.synchronize()
    err = {
        "o": (o.float() - o_ref).abs().max().item(),
        "lse": (lse - lse_ref).abs().max().item(),
    }
    tol = {"o": TOL_O, "lse": TOL_LSE}
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        err[name] = (got.float() - ref).abs().max().item()
        tol[name] = TOL_GRAD_REL * ref.abs().max().item()
    emit("kernels", mode=mode, causal=causal, max_abs_err=err,
         tolerance=tol)
    bad = [n for n in err if not err[n] <= tol[n]]
    if bad:
        raise RuntimeError(f"kernels {mode}: {bad} above tolerance")
    # The same inputs again must give the same bits (no atomics).
    o2, lse2 = flash.flash_attention_fwd(q, k, v, seg, causal, scale)
    dq2 = flash.flash_attention_bwd_dq(q, k, v, seg, lse_ref, do, di,
                                       causal, scale)
    dk2, dv2 = flash.flash_attention_bwd_dkv(q, k, v, seg, lse_ref, do,
                                             di, causal, scale)
    same = {
        "fwd": torch.equal(o, o2) and torch.equal(lse, lse2),
        "bwd_dq": torch.equal(dq, dq2),
        "bwd_dkv": torch.equal(dk, dk2) and torch.equal(dv, dv2),
    }
    emit("kernels", mode=mode, bit_identical_on_repeat=same)
    if not all(same.values()):
        raise RuntimeError(f"kernels {mode}: a second launch differs: "
                           f"{same}")
    del o2, lse2, dq2, dk2, dv2
    errors["fwd"] = max(errors["fwd"], err["o"])
    errors["bwd_dq"] = max(errors["bwd_dq"], err["dq"])
    errors["bwd_dkv"] = max(errors["bwd_dkv"], err["dk"], err["dv"])
    del o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref


def kernels() -> dict:
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.ops import flash

    b, h, s, d = SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = randn(), randn(), randn(), randn()
    scale = 1.0 / d ** 0.5
    lengths = np.random.default_rng(0).integers(128, s + 1, b)
    valid = np.arange(s)[None, :] < lengths[:, None]
    seg_a = torch.from_numpy(valid.astype(np.int32)).to(dev)
    errors: dict = {"fwd": 0.0, "bwd_dq": 0.0, "bwd_dkv": 0.0}
    for mode, seg, causal in (("a_padded", seg_a, False),
                              ("b_causal", None, True)):
        _check_flash_case(mode, q, k, v, do, seg, causal, scale, errors)
    # (c): causal with packed segments, ids from real FFD plans of the
    # causal-LM corpus at pack_len 1024 and at 64.
    for pack_len in (GPT_CONTEXT, 64):
        seg_c = _corpus_segment_ids(pack_len).to(dev)
        shape_c = (seg_c.shape[0], h, seg_c.shape[1], d)

        def randn_c():
            return torch.randn(shape_c, generator=gen, device=dev).to(
                torch.bfloat16)

        qc, kc, vc, doc = randn_c(), randn_c(), randn_c(), randn_c()
        _check_flash_case(f"c_packed_causal_{pack_len}", qc, kc, vc, doc,
                          seg_c, True, scale, errors)
        del qc, kc, vc, doc

    # Timings at the main path's inputs (mode a: padding segments).
    _, lse = flash.flash_attention_fwd(q, k, v, seg_a, False, scale)
    o, _ = flash.flash_attention_fwd(q, k, v, seg_a, False, scale)
    di = (o.float() * do.float()).sum(-1)
    ms = {
        "fwd": time_ms(lambda: flash.flash_attention_fwd(
            q, k, v, seg_a, False, scale)),
        "bwd_dq": time_ms(lambda: flash.flash_attention_bwd_dq(
            q, k, v, seg_a, lse, do, di, False, scale)),
        "bwd_dkv": time_ms(lambda: flash.flash_attention_bwd_dkv(
            q, k, v, seg_a, lse, do, di, False, scale)),
    }
    plain_ms = {
        "fwd": time_ms(lambda: flash.flash_attention_reference(
            q, k, v, seg_a, False, scale)),
        "bwd_dq": time_ms(lambda: flash.flash_attention_bwd_dq_reference(
            q, k, v, seg_a, lse, do, di, False, scale)),
        "bwd_dkv": time_ms(lambda: flash.flash_attention_bwd_dkv_reference(
            q, k, v, seg_a, lse, do, di, False, scale)),
    }
    # Yardstick only: the library's fused attention with the same mask.
    attn_mask = (seg_a[:, None, :, None] == seg_a[:, None, None, :])
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, scale=scale))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                             scale=scale)
        out.backward(do)

    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    di_ms = time_ms(lambda: (o.float() * do.float()).sum(-1))
    bounds = _bounds(b, h, s, d)
    library = {"fwd": sdpa_fwd, "bwd_dq": None, "bwd_dkv": None}
    table = {n: {
        "ms": ms[n], "plain_ms": plain_ms[n], "library_ms": library[n],
        "bound_ms": bounds[n]["bound_ms"], "bound_by": bounds[n]["bound_by"],
        "tflops": bounds[n]["flops"] / (ms[n] * 1e-3) / 1e12,
        "share_of_bound": bounds[n]["bound_ms"] / ms[n],
    } for n in ms}
    # No library call computes dQ or dK/dV alone; SDPA's backward (its
    # forward + backward less its forward, one call) computes both rows'
    # work, and stands beside the pair's kernel time on both rows.
    backward = {"dq_dkv_di_plain_op_ms": ms["bwd_dq"] + ms["bwd_dkv"] + di_ms,
                "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd}
    for n in ("bwd_dq", "bwd_dkv"):
        table[n].update(library_bwd_ms=backward["sdpa_bwd_ms"],
                        pair_ms=ms["bwd_dq"] + ms["bwd_dkv"])
    emit("kernels", timing="a_padded", table=table,
         library_ms={"sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd_ms},
         di_plain_op_ms=di_ms, backward=backward)
    return {"errors": errors, "table": table}


def _dense_vs_flash_check() -> None:
    """A small bf16 encoder with flash attention against the same weights
    with the dense attention path, at valid positions."""
    import torch
    from lance_distributed_training_tpu_torch.models.transformer import (
        TransformerEncoder,
    )
    from lance_distributed_training_tpu_torch.ops.flash import (
        make_flash_attention,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    bsz, seq, vocab = 4, 200, 1000
    ids = torch.from_numpy(rng.integers(2, vocab, (bsz, seq))).to(dev)
    lengths = np.array([200, 150, 77, 128])
    mask = torch.from_numpy(
        (np.arange(seq)[None] < lengths[:, None]).astype(np.int8)).to(dev)
    kwargs = dict(vocab_size=vocab, hidden_size=128, num_layers=2,
                  num_heads=2, mlp_dim=256, max_len=seq, device=dev)
    dense = TransformerEncoder(**kwargs)
    fast = TransformerEncoder(attention_fn=make_flash_attention(), **kwargs)
    fast.load_state_dict(dense.state_dict())
    with torch.no_grad():
        ref = dense(ids, mask)
        got = fast(ids, mask)
    keep = mask.bool()
    err = (got[keep] - ref[keep]).abs().max().item()
    tol = 2e-2 * ref[keep].abs().max().item()
    emit("slice", check="flash_vs_dense_logits", max_abs_err=err,
         tolerance=tol, finite=bool(torch.isfinite(got).all().item()))
    if not err <= tol or not torch.isfinite(got).all():
        raise RuntimeError("flash attention disagrees with dense attention")


def _slice_docs():
    """The BERT corpus: ``batch * STEPS`` seeded documents of 128-512
    tokens, Zipf(1.2) ranks folded onto ids 2..vocab-1 (0 is padding, 1
    the mask); returns ``(lengths, docs)``."""
    b, _, s, _ = SHAPE
    vocab = 30522
    rng = np.random.default_rng(0)
    lengths = rng.integers(128, s + 1, b * STEPS)
    docs = [2 + (rng.zipf(1.2, int(n)) - 1) % (vocab - 2) for n in lengths]
    return lengths, docs


def slice_run() -> dict:
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import flash

    _dense_vs_flash_check()
    b, _, s, _ = SHAPE
    lengths, docs = _slice_docs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        t0 = time.monotonic()
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--flash_attention", "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda", "--no_eval_at_end",
        ])
        launches = {k: ops.LAUNCHES[k] for k in flash.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        valid_tokens = int(sum(min(int(n), s) for n in lengths))
    losses = result["losses"]
    steps = result["steps"]
    step_ms = statistics.median(result["step_ms"][4:])
    fields = {
        "steps": steps, "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "tokens_per_sec": b * s / (step_ms / 1e3),
        "valid_tokens_per_sec": valid_tokens / steps / (step_ms / 1e3),
        "peak_memory_allocated_bytes": peak, "launches": launches,
        "dataset_seconds": author_s, "train_seconds": result["total_time"],
        "model_params": result["model_params"],
    }
    emit("slice", **fields)
    if steps != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"ran {steps} steps, expected {STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError("loss did not fall over the run")
    want = LAYERS * steps
    if any(launches[k] != want for k in launches):
        raise RuntimeError(f"launch counts {launches}, expected {want} each")
    return {"launches": launches, "step_ms": step_ms}


def _trainer_runs(path: str, tmp: str) -> dict:
    """The trainer phase's three ``cli train`` runs; for each, ``(result,
    step trace, progress records, launches, peak bytes)``."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.utils import chaos

    b, _, s, _ = SHAPE
    base = [
        "train", "--dataset_path", path, "--task_type", "masked_lm",
        "--model_name", "bert_base", "--seq_len", str(s),
        "--flash_attention", "--batch_size", str(b),
        "--grad_accum", str(TRAINER_ACCUM), "--optimizer", "adamw",
        "--lr", "1e-4", "--lr_schedule", "cosine",
        "--total_steps", str(TRAINER_STEPS), "--epochs", "1",
        "--log_every", "1", "--log_grad_norm", "--no_eval_at_end",
        "--device", "cuda",
    ]
    ckpt = ["--checkpoint_dir", os.path.join(tmp, "ckpt"),
            "--checkpoint_every_steps", str(TRAINER_ACCUM)]
    runs = {}
    for name, extra, spec in (
            # Untraced, one progress line: the host runs ahead of the card
            # as in the slice phase, so its micro-steps time like its steps.
            ("timed", ["--log_every", str(TRAINER_STEPS)], None),
            ("control", ["--profile_dir", os.path.join(tmp, "profile")],
             None),
            ("preempted", ckpt, f"drain@{TRAINER_DRAIN}"),
            ("resumed", ckpt, None)):
        trace = os.path.join(tmp, f"{name}.trace.jsonl")
        metrics = os.path.join(tmp, f"{name}.metrics.jsonl")
        os.environ["LDT_METRICS_PATH"] = metrics
        if name != "timed":
            os.environ[chaos.TRACE_ENV] = trace
        if spec:
            os.environ[chaos.CHAOS_ENV] = spec
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        try:
            result = cli.main(base + extra)
        finally:
            os.environ.pop(chaos.TRACE_ENV, None)
            os.environ.pop(chaos.CHAOS_ENV, None)
        launches = {k: ops.LAUNCHES[k] for k in ops.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        with open(metrics, encoding="utf-8") as f:
            records = [r for r in map(json.loads, f) if "loss" in r]
        runs[name] = (result, chaos.read_trace(trace), records, launches,
                      peak)
        if name == "timed":
            del result["model"], result["optimizer"]  # free the card
    return runs


def _profile_kernels(events: list, top: int = 12) -> dict:
    """Device time in a profiler window's Chrome trace: the kernels' summed
    time, the window from the first kernel's start to the last one's end,
    the idle share between, and the ``top`` kernels by summed time (name
    cut to 120 characters, ms, launches)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler's trace holds no device kernel")
    busy = sum(e["dur"] for e in kernels) / 1e3
    span = (max(e["ts"] + e["dur"] for e in kernels)
            - min(e["ts"] for e in kernels)) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernel_ms": busy, "window_ms": span,
            "idle_pct": 100.0 * (1.0 - busy / span),
            "top": [[name[:120], ms, n] for name, (ms, n) in ranked]}


def trainer_run(card: dict, slice_step_ms) -> dict:
    """BERT-base through the trainer beyond the main path: gradient
    accumulation, a drain mid-window, an emergency checkpoint and a resume
    that must equal the uninterrupted control bit for bit (module
    docstring, phase 5)."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.trainer import (
        TrainConfig,
        lr_schedule_fn,
    )
    from lance_distributed_training_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    b, _, s, _ = SHAPE
    _, docs = _slice_docs()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs[:b * TRAINER_STEPS], seq_len=s,
                                  pack=False)
        runs = _trainer_runs(path, tmp)
        timed, _, _, tlaunch, tpeak = runs["timed"]
        control, ctrace, crecords, claunch, cpeak = runs["control"]
        pre, ptrace, precords, plaunch, ppeak = runs["preempted"]
        res, rtrace, rrecords, rlaunch, rpeak = runs["resumed"]
        manager = CheckpointManager(os.path.join(tmp, "ckpt"))
        # The emergency checkpoint's accumulator count, read without
        # loading its tensors.
        emergency = torch.load(manager.state_path(TRAINER_DRAIN),
                               mmap=True, weights_only=True)
        emergency_micro = emergency["train_step"]["micro_step"]
        del emergency
        ckpt_bytes = os.path.getsize(manager.state_path(TRAINER_DRAIN))
        profile = control["profile_trace"]
        with open(profile, encoding="utf-8") as f:
            text = f.read()
        profile_names = {k: text.count(f"flash_{k}_kernel")
                         for k in ("fwd", "bwd_dq", "bwd_dkv")}
        profile_bytes = len(text)
        window = _profile_kernels(json.loads(text)["traceEvents"])
        del text
    params = control["model_params"]
    fold_bytes = 3 * 4 * params  # read acc and g, write acc (f32)
    schedule = lr_schedule_fn(
        TrainConfig(dataset_path="-", lr=1e-4, lr_schedule="cosine",
                    grad_accum=TRAINER_ACCUM), TRAINER_STEPS)
    fields = {
        "nvidia_smi": card["smi"], "micro_steps": TRAINER_STEPS,
        "grad_accum": TRAINER_ACCUM, "rows_per_update": b * TRAINER_ACCUM,
        "micro_step_ms_median_2_12": statistics.median(
            timed["step_ms"][1:]),
        "micro_step_ms": timed["step_ms"],
        "slice_step_ms_median_5_20": slice_step_ms,
        # With the step trace and a progress line each micro-step, the host
        # syncs every step; the control's steps 2-12 are also profiled.
        "traced_micro_step_ms": {"control": control["step_ms"],
                                 "preempted": pre["step_ms"],
                                 "resumed": res["step_ms"]},
        "accum_fold_ms": {k: r["accum_fold_ms"] for k, r in
                          (("timed", timed), ("control", control),
                           ("preempted", pre), ("resumed", res))},
        "accum_fold_bytes": fold_bytes,
        "accum_fold_bound_ms": fold_bytes / PEAK_BYTES * 1e3,
        "ckpt_save_ms": {"preempted": pre["ckpt_save_ms"],
                         "resumed": res["ckpt_save_ms"]},
        "ckpt_write_ms": {"preempted": pre["ckpt_write_ms"],
                          "resumed": res["ckpt_write_ms"]},
        "ckpt_bytes": ckpt_bytes, "ckpt_restore_ms": res["ckpt_restore_ms"],
        "emergency_micro_step": emergency_micro,
        "peak_memory_allocated_bytes": {"timed": tpeak, "control": cpeak,
                                        "preempted": ppeak,
                                        "resumed": rpeak},
        "launches": {"timed": tlaunch, "control": claunch,
                     "preempted": plaunch, "resumed": rlaunch},
        "losses": {"timed": timed["losses"], "control": control["losses"],
                   "preempted": pre["losses"], "resumed": res["losses"]},
        "resumed_steps": [t["step"] for t in rtrace],
        "profile_kernel_mentions": profile_names,
        "profile_window": window,
        "profile_trace_bytes": profile_bytes, "model_params": params,
    }
    emit("trainer", **fields)
    runs_steps = {"timed": (timed, TRAINER_STEPS, 0),
                  "control": (control, TRAINER_STEPS, 0),
                  "preempted": (pre, TRAINER_DRAIN, 0),
                  "resumed": (res, TRAINER_STEPS - TRAINER_DRAIN,
                              TRAINER_DRAIN)}
    for name, (result, steps, start) in runs_steps.items():
        if result["steps"] != steps or result["global_step"] != start + steps:
            raise RuntimeError(f"{name}: ran {result['steps']} steps to "
                               f"{result['global_step']}, expected {steps} "
                               f"to {start + steps}")
        if not all(np.isfinite(result["losses"])):
            raise RuntimeError(f"{name}: non-finite loss")
        want = {k: LAYERS * steps for k in ("fwd", "bwd_dq", "bwd_dkv")}
        want.update(dict.fromkeys(RING_KERNELS, 0))
        got = runs[name][3]
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        if wrong:
            raise RuntimeError(f"{name}: launches (got, expected) {wrong}")
        records = runs[name][2]
        logged = list(range(1, steps + 1)) if name != "timed" else [steps]
        if [r["step"] for r in records] != logged:
            raise RuntimeError(f"{name}: progress lines at "
                               f"{[r['step'] for r in records]}")
        for r in records:
            norm = r.get("grad_norm")
            if norm is None or not np.isfinite(norm) or norm <= 0:
                raise RuntimeError(f"{name}: grad_norm {norm} at {r['step']}")
            want_lr = schedule((start + r["step"]) // TRAINER_ACCUM)
            if abs(r["lr"] - want_lr) > 1e-12:
                raise RuntimeError(f"{name}: lr {r['lr']} at micro-step "
                                   f"{start + r['step']}, schedule {want_lr}")
        if name in ("control", "resumed"):
            adam = {float(v["step"]) for v in
                    result["optimizer"].state_dict()["state"].values()}
            if adam != {TRAINER_STEPS // TRAINER_ACCUM}:
                raise RuntimeError(f"{name}: AdamW steps {adam}")
    if not pre.get("preempted") or emergency_micro != (
            TRAINER_DRAIN % TRAINER_ACCUM):
        raise RuntimeError(f"the drained run's emergency checkpoint holds "
                           f"micro-step {emergency_micro}")
    if res["start_epoch"] != 0 or [t["step"] for t in rtrace] != list(
            range(TRAINER_DRAIN + 1, TRAINER_STEPS + 1)):
        raise RuntimeError(f"resumed at {[t['step'] for t in rtrace]}")
    by_step = {t["step"]: t for t in ctrace}
    for t in rtrace:
        ref = by_step[t["step"]]
        if (t["batch_sha256"], t["loss"]) != (ref["batch_sha256"],
                                              ref["loss"]):
            raise RuntimeError(f"step {t['step']}: resumed {t} != control "
                               f"{ref}")
    if res["losses"] != control["losses"][TRAINER_DRAIN:] or \
            pre["losses"] != control["losses"][:TRAINER_DRAIN] or \
            timed["losses"] != control["losses"]:
        raise RuntimeError("the losses differ from the control's")
    for (key, got), want in zip(res["model"].state_dict().items(),
                                control["model"].state_dict().values()):
        if not torch.equal(got, want):
            raise RuntimeError(f"final parameter {key} differs from the "
                               "control's")
    if min(profile_names.values()) < 1:
        raise RuntimeError(f"the profiler's trace names the flash kernels "
                           f"{profile_names} times")
    return {"micro_step_ms": fields["micro_step_ms_median_2_12"]}


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int16),
                                              b.view(torch.int16))


def image_kernels() -> dict:
    """K1 against its plain version, bit for bit, then timed."""
    import torch
    from lance_distributed_training_tpu_torch.ops import image

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def plain(x, mask):
        out = image.normalize_images_reference(x)
        return out if mask is None else image.random_flip_reference(out, mask)

    # Every uint8 value in every channel, then the path's shape and others:
    # W = 16, 48 and 224 (rows route), W = 17 (groups route, bytes), rows
    # that do not fill the last chunk (H = 7), rows too wide for a full
    # chunk (W = 2048: one row a chunk) or for any (W = 4096 and 8192:
    # groups route, 16-byte vectors), and batches sliced off a larger
    # buffer 1 byte in, so not 16-byte aligned (groups route, bytes); each
    # with no mask, a random mask and an all-set mask.
    every = torch.arange(256, dtype=torch.uint8, device=dev)
    every = every.repeat_interleave(3).reshape(1, 16, 16, 3)
    cases = [("every_value", every)]
    for shape in IMAGE_CASES:
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        cases.append(("x".join(map(str, shape)), x))
    for shape in IMAGE_UNALIGNED_CASES:
        flat = torch.randint(0, 256, (1 + int(np.prod(shape)),), generator=gen,
                             device=dev, dtype=torch.uint8)
        x = flat[1:].view(shape)
        assert x.data_ptr() % 16 != 0
        cases.append(("unaligned_" + "x".join(map(str, shape)), x))
    checked = []
    for label, x in cases:
        b = x.shape[0]
        masks = {"none": None,
                 "random": torch.rand(b, generator=gen, device=dev) < 0.5,
                 "all": torch.ones(b, dtype=torch.bool, device=dev)}
        for mask_name, mask in masks.items():
            got = image.normalize_flip(x, mask)
            want = plain(x, mask)
            torch.cuda.synchronize()
            same = _bits_equal(got, want)
            checked.append({"shape": label, "mask": mask_name,
                            "bit_identical": same})
            if not same:
                diff = (got.float() - want.float()).abs().max().item()
                emit("image_kernels", failed=checked[-1], max_abs_err=diff)
                raise RuntimeError(f"K1 differs from its plain version at "
                                   f"{label}, mask {mask_name}")
    emit("image_kernels", checks=checked, max_abs_err=0.0)

    x = cases[1][1]
    mask = torch.rand(x.shape[0], generator=gen, device=dev) < 0.5
    ms = time_back_to_back_ms(lambda: image.normalize_flip(x, mask))
    plain_ms = time_back_to_back_ms(lambda: plain(x, mask))
    # Bytes K1 must move: the input and the mask read once, the bf16 output
    # written once. The bound takes the card's published memory rate; a
    # device-to-device copy of as many bytes is measured beside it.
    moved = x.numel() * (1 + 2) + mask.numel()
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_back_to_back_ms(lambda: dst.copy_(src))
    t_bytes = moved / PEAK_BYTES
    t_ops = IMAGE_OPS * x.numel() / PEAK_F32_FLOPS
    fields = {
        "shape": list(x.shape), "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bytes": moved, "copy_ms": copy_ms,
        "measured_bytes_per_s": 2 * (moved // 2) / (copy_ms * 1e-3),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    fields["share_of_bound"] = fields["bound_ms"] / ms
    emit("image_kernels", timing="path_shape", **fields)
    del src, dst
    return fields


def _learnable_dataset(drawn: str, path: str, rows: int) -> None:
    """The FOOD-101-shaped synthetic dataset (101 classes, 224 px JPEG,
    ``UNIQUE_IMAGES`` seeded noise images over ``rows`` rows), with each
    row's label replaced by the index of its image: the authoring function
    draws labels independently of the images, which leaves nothing to learn
    and the loss nothing to fall by."""
    import pyarrow as pa
    from lance_distributed_training_tpu_torch.data import (
        IMAGE_SCHEMA,
        Dataset,
        create_synthetic_classification_dataset,
        write_dataset,
    )

    create_synthetic_classification_dataset(
        drawn, rows=rows, num_classes=IMAGE_CLASSES, image_size=224,
        unique_images=UNIQUE_IMAGES)
    table = Dataset(drawn).take(np.arange(rows))
    labels = pa.array(np.arange(rows) % UNIQUE_IMAGES, pa.int64())
    table = table.set_column(1, "label", labels)
    write_dataset(table, path, schema=IMAGE_SCHEMA, mode="create")


def _resnet_run(source: str, flags: list, author_s: float,
                tmp: str) -> tuple:
    """ResNet-50 classification through ``cli train`` for STEPS steps at
    the path's width over ``source`` with ``flags``: ``(result, launches,
    fields)``, the fields every ResNet phase prints."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = cli.main([
        "train", "--dataset_path", source, "--task_type", "classification",
        "--model_name", "resnet50", "--image_size", "224",
        "--num_classes", str(IMAGE_CLASSES), "--batch_size", str(IMAGE_BATCH),
        "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
        "--device", "cuda", *flags,
    ])
    launches = dict(ops.LAUNCHES)
    losses = result["losses"]
    fields = {
        "batch": IMAGE_BATCH, "steps": result["steps"],
        "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": statistics.median(result["step_ms"][4:]),
        "images_per_sec_steps_6_20": result["images_per_sec"],
        "images_per_sec_whole_run": result["images_per_sec_whole_run"],
        "loader_stall_pct": result["loader_stall_pct"],
        "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "eval_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"),
        "decoder": result["decoder_arm"],
        "image_normalize_launches": launches["image_normalize"],
        "jpeg_decode_launches": launches["jpeg_decode"],
        "dataset_seconds": author_s, "train_seconds": result["train_time"],
        "total_seconds": result["total_time"],
        "model_params": result["model_params"],
        **{k: result.get(k) for k in ("decode_entropy_ms",
                                      "decode_device_ms", "decode_threads")},
    }
    return result, launches, fields


def _check_trained(phase: str, fields: dict) -> None:
    """STEPS finite losses whose last five average below the first."""
    losses = fields["losses"]
    if fields["steps"] != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"{phase}: ran {fields['steps']} steps, expected "
                           f"{STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{phase}: non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError(f"{phase}: loss did not fall over the run")


def classification_run(device_decode: bool = False) -> dict:
    """ResNet-50 classification through ``cli train`` for STEPS steps, fed
    pixels decoded on the host or, with ``device_decode``, coefficient
    pages that K2 decodes on the card."""
    phase = "device_decode" if device_decode else "classification"
    rows = IMAGE_BATCH * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        _, launches, fields = _resnet_run(
            path, ["--device_decode"] if device_decode else [], author_s,
            tmp)
    eval_batches = -(-rows // IMAGE_BATCH)
    fields.update(dataset_rows=rows, eval_batches=eval_batches)
    emit(phase, **fields)
    _check_trained(phase, fields)
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"eval covered {fields['eval_rows']} rows of "
                           f"{rows}")
    if launches["image_normalize"] != STEPS + eval_batches:
        raise RuntimeError(f"K1 launched {launches['image_normalize']} "
                           f"times, expected {STEPS + eval_batches}")
    k2_want = STEPS + eval_batches if device_decode else 0
    if launches["jpeg_decode"] != k2_want:
        raise RuntimeError(f"K2 launched {launches['jpeg_decode']} times, "
                           f"expected {k2_want}")
    if device_decode:
        if fields["decoder"] != "coeff":
            raise RuntimeError(f"decoder arm {fields['decoder']!r}, "
                               f"expected 'coeff'")
        missing = [k for k in ("decode_entropy_ms", "decode_device_ms",
                               "decode_threads") if not fields[k]]
        if missing:
            raise RuntimeError(f"device_decode run reported no {missing}")
        return {"launches": {"jpeg_decode": launches["jpeg_decode"]},
                "fields": fields}
    return {"launches": {"image_normalize": launches["image_normalize"]},
            "fields": fields}


# The figures the loader phases print beside their paired phase's.
PAIRED = ("step_ms_median_5_20", "images_per_sec_steps_6_20",
          "images_per_sec_whole_run", "loader_stall_pct",
          "peak_memory_allocated_bytes", "dataset_seconds", "train_seconds",
          "decode_entropy_ms", "decode_device_ms")
MAP_ROWS, MAP_FILTER, MAP_VAL_FRACTION = IMAGE_BATCH * 30, "label < 48", 0.1
FOLDER_FILES = 160  # hard links a class directory of the folder phase


def _learnable_tree(root: str) -> None:
    """An ImageFolder tree of ``UNIQUE_IMAGES`` class directories: class
    ``c`` holds ``FOLDER_FILES`` hard links to one 224 px noise JPEG, the
    image ``c`` of the classification set (the authoring pool's recipe and
    seed), so that the label can be learnt and the bytes are the columnar
    phases' bytes."""
    import io

    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(UNIQUE_IMAGES):
        arr = (rng.random((224, 224, 3)) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=85)
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir)
        first = os.path.join(cdir, "00000.jpg")
        with open(first, "wb") as f:
            f.write(buf.getvalue())
        for i in range(1, FOLDER_FILES):
            os.link(first, os.path.join(cdir, f"{i:05d}.jpg"))


def _read_ms(read, items) -> float:
    """Host time of ``read(item)``, median over ``items`` (ms)."""
    times = []
    for item in items:
        t0 = time.perf_counter()
        read(item)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _filesystem(path: str) -> str:
    """The type of the filesystem that holds ``path`` (/proc/mounts)."""
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if path.startswith(mount) and len(mount) > len(best):
                best, kind = mount, fstype
    return kind


def _emit_paired(phase: str, fields: dict, paired_phase: str,
                 paired) -> None:
    emit(phase, **fields, paired_phase=paired_phase,
         paired={k: paired.get(k) for k in PAIRED} if paired else None)


def map_style_run(paired) -> dict:
    """ResNet-50 through the map-style loader with a filter, a seeded val
    split and device decode (the module's docstring, phase 14)."""
    from lance_distributed_training_tpu_torch import trainer
    from lance_distributed_training_tpu_torch.data import Dataset

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, MAP_ROWS)
        author_s = time.monotonic() - t0
        dataset = Dataset(path)
        pool = dataset.filter_indices(MAP_FILTER)
        train_pool, val_pool = trainer._split_val_pool(
            trainer.TrainConfig(dataset_path=path, batch_size=IMAGE_BATCH,
                                val_fraction=MAP_VAL_FRACTION), dataset, pool)
        result, launches, fields = _resnet_run(
            path,
            ["--loader_style", "map", "--filter", MAP_FILTER,
             "--val_fraction", str(MAP_VAL_FRACTION), "--eval_every", "1",
             "--device_decode"], author_s, tmp)
        # The host's read of a batch, apart from its decode: a gather of
        # a permuted batch (record batch by record batch, as the loader
        # reads), the same gather over the whole chunked fragment (which
        # concatenates its chunks first), and a contiguous range read.
        columns = ["image", "label"]
        rng = np.random.default_rng(1)
        gathers = [rng.choice(train_pool, IMAGE_BATCH, replace=False)
                   for _ in range(5)]
        whole = dataset._reader(0).table().select(columns)
        fields.update(
            take_read_ms=_read_ms(
                lambda idx: dataset.take(idx, columns=columns), gathers),
            whole_fragment_take_ms=_read_ms(
                lambda idx: whole.take(idx), gathers),
            range_read_ms=_read_ms(
                lambda s: dataset.read_range(0, s, s + IMAGE_BATCH,
                                             columns=columns),
                [b * IMAGE_BATCH for b in range(5)]),
            fragments=len(dataset.fragment_rows()),
            tmp_filesystem=_filesystem(tmp))
    steps = len(train_pool) // IMAGE_BATCH
    eval_batches = -(-len(val_pool) // IMAGE_BATCH)
    evals = len([h for h in result["history"] if "val_rows" in h]) + (
        "eval_rows" in result)
    val_rows = [h.get("val_rows") for h in result["history"]]
    fields.update(dataset_rows=MAP_ROWS, filter_rows=len(pool),
                  train_rows=len(train_pool), val_rows=len(val_pool),
                  plan_steps=steps, eval_batches=eval_batches, evals=evals,
                  history_val_rows=val_rows)
    _emit_paired("map_style", fields, "device_decode", paired)
    _check_trained("map_style", fields)
    if steps != STEPS:
        raise RuntimeError(f"the train pool holds {steps} steps, expected "
                           f"{STEPS}")
    if np.intersect1d(train_pool, val_pool).size:
        raise RuntimeError("a val row is a train row")
    if val_rows != [len(val_pool)] or fields["eval_rows"] != len(val_pool):
        raise RuntimeError(f"the evals covered {val_rows} and "
                           f"{fields['eval_rows']} rows, expected "
                           f"{len(val_pool)} each")
    # The eval at the epoch's end (--eval_every 1) and the eval at the end
    # both run: K1 and K2 launch once a train step and once an eval batch.
    want = STEPS + 2 * eval_batches
    if evals != 2:
        raise RuntimeError(f"{evals} evals ran, expected 2")
    for name in ("image_normalize", "jpeg_decode"):
        if launches[name] != want:
            raise RuntimeError(f"{name} launched {launches[name]} times "
                               f"under the map-style loader, expected {want}")
    if fields["decoder"] != "coeff":
        raise RuntimeError(f"decoder arm {fields['decoder']!r}, expected "
                           f"'coeff'")
    return {"launches": {k: launches[k] for k in ("image_normalize",
                                                  "jpeg_decode")}}


def folder_run(paired) -> dict:
    """ResNet-50 through the folder arm, map style, host decode (the
    module's docstring, phase 15)."""
    from lance_distributed_training_tpu_torch.data import (
        distributed_index_batches,
        read_sample_batch,
    )
    from lance_distributed_training_tpu_torch.data.authoring import (
        _folder_samples,
    )

    files = UNIQUE_IMAGES * FOLDER_FILES
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tree")
        t0 = time.monotonic()
        _learnable_tree(root)
        author_s = time.monotonic() - t0
        result, launches, fields = _resnet_run(
            root, ["--data_format", "folder", "--loader_style", "map"],
            author_s, tmp)
        # The host's read of a batch of files, apart from its decode.
        samples = _folder_samples(root)[0]
        batches = distributed_index_batches(files, IMAGE_BATCH, 0, 1,
                                            seed=1)[:5]
        fields.update(
            file_read_ms=_read_ms(
                lambda idx: read_sample_batch(samples, idx), batches),
            tmp_filesystem=_filesystem(tmp))
    eval_batches = -(-files // IMAGE_BATCH)
    fields.update(tree_files=files, eval_batches=eval_batches)
    _emit_paired("folder", fields, "classification", paired)
    _check_trained("folder", fields)
    if fields["eval_rows"] != files:
        raise RuntimeError(f"eval covered {fields['eval_rows']} files of "
                           f"{files}")
    if launches["image_normalize"] != STEPS + eval_batches:
        raise RuntimeError(f"K1 launched {launches['image_normalize']} "
                           f"times, expected {STEPS + eval_batches}")
    if launches["jpeg_decode"]:
        raise RuntimeError(f"K2 launched {launches['jpeg_decode']} times "
                           f"under host decode")
    return {"launches": {k: launches[k] for k in ("image_normalize",
                                                  "jpeg_decode")}}


# The synchronous control arm of the placement phase: today's path.
PLACEMENT_CONTROL = ["--no_global_batch", "--producer_threads", "1",
                     "--no_buffer_pool"]
PRODUCERS, RING_DEPTH = 4, 2  # the JAX trainer's defaults
PRETRAINED_CLASSES = 1000  # the checkpoint's head, torchvision's


def _loader_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(("ldt-placement", "ldt-producer")))


def _write_pretrained(path: str) -> dict:
    """The port's ResNet-50 with 1000 classes from a seeded generator,
    written as a torchvision checkpoint behind a DDP wrapper:
    ``{"state_dict": {"module." + k: v}}`` with torchvision's zero
    ``num_batches_tracked`` entries. Returns the plain state_dict."""
    import torch
    from lance_distributed_training_tpu_torch.models.resnet import resnet50

    model = resnet50(num_classes=PRETRAINED_CLASSES,
                     generator=torch.Generator().manual_seed(13))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    saved = {}
    for key, value in state.items():
        saved["module." + key] = value
        if key.endswith("running_var"):
            saved["module." + key.replace("running_var",
                                          "num_batches_tracked")] = (
                torch.zeros((), dtype=torch.int64))
    torch.save({"state_dict": saved, "epoch": 90}, path)
    return state


def _import_check(path: str, state: dict) -> dict:
    """``load_torchvision_resnet`` into a 101-class ResNet-50 on the card:
    every backbone tensor equals the file's bit for bit, and the head is a
    same-seed model's fresh ``[101, 2048]`` one."""
    import torch
    from lance_distributed_training_tpu_torch.models.pretrained import (
        load_torch_state_dict,
        load_torchvision_resnet,
    )
    from lance_distributed_training_tpu_torch.models.resnet import resnet50

    seed = torch.Generator().manual_seed(14)
    model = resnet50(num_classes=IMAGE_CLASSES, device="cuda", generator=seed)
    fresh = resnet50(num_classes=IMAGE_CLASSES,
                     generator=torch.Generator().manual_seed(14))
    t0 = time.monotonic()
    load_torchvision_resnet(model, load_torch_state_dict(path), "resnet50")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    got = model.state_dict()
    backbone = [k for k in got if not k.startswith("fc.")]
    differ = [k for k in backbone if not torch.equal(got[k].cpu(), state[k])]
    head_fresh = (tuple(model.fc.weight.shape) == (IMAGE_CLASSES, 2048)
                  and torch.equal(got["fc.weight"].cpu(), fresh.fc.weight)
                  and torch.equal(got["fc.bias"].cpu(), fresh.fc.bias))
    fields = {"backbone_tensors": len(backbone), "differ": differ,
              "head_shape": list(model.fc.weight.shape),
              "head_fresh": head_fresh, "load_seconds": load_s,
              "channels_last": model.conv1.weight.is_contiguous(
                  memory_format=torch.channels_last)}
    emit("pretrained_placement", check="import", **fields)
    if differ or not head_fresh:
        raise RuntimeError(f"pretrained import: {len(differ)} backbone "
                           f"tensors differ, head fresh: {head_fresh}")
    return fields


def _digest(t, weights: dict):
    """An int64 digest of a tensor's bytes, on the card: the sum of its
    32-bit (or 16-bit, or 8-bit) words, each times a fixed odd weight,
    modulo 2^64 (integer sums do not depend on their order)."""
    import torch

    flat = t.contiguous().view(-1)
    nbytes = flat.numel() * flat.element_size()
    word = (torch.int32 if nbytes % 4 == 0 else
            torch.int16 if nbytes % 2 == 0 else torch.uint8)
    words = flat.view(torch.uint8).view(word)
    n = words.numel()
    if n not in weights:
        weights[n] = torch.arange(n, dtype=torch.int64,
                                  device=t.device) * 2654435761 + 1
    return (words.to(torch.int64) * weights[n]).sum()


def _overlap_run(path: str, device_decode: bool, placed: bool) -> dict:
    """The first STEPS batches of the iterable loader over ``path``: placed
    by the plane (depth 2, 4 producers, pooled page-locked pages), each
    followed by K1 (after K2 in the coeff arm) and a ResNet-50 forward and
    backward, so that the copies of batches n + 1 and n + 2 overlap batch
    n's kernels; or through the synchronous arm (one producer, no pool),
    K1 only. Each batch's leaves are digested after the step, K1's output
    before it."""
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.data import (
        Dataset,
        PlacementPlane,
        decoder_for_task,
        default_buffer_pool,
        make_train_pipeline,
    )
    from lance_distributed_training_tpu_torch.models.resnet import resnet50
    from lance_distributed_training_tpu_torch.ops import image
    from lance_distributed_training_tpu_torch.ops.jpeg_device import (
        make_batch_transform,
    )

    dev = torch.device("cuda")
    pool = default_buffer_pool(pin_memory=True) if placed else None
    decode = decoder_for_task("classification", image_size=224,
                              device_decode=device_decode, buffer_pool=pool)
    loader = make_train_pipeline(
        Dataset(path), "batch", IMAGE_BATCH, 0, 1, decode,
        None if placed else dev, producers=PRODUCERS if placed else 1,
        buffer_pool=pool)
    plane = None
    if placed:
        plane = PlacementPlane(dev, depth=RING_DEPTH, buffer_pool=pool)
        loader = plane.wrap(loader)
    model = None
    if placed:
        model = resnet50(num_classes=IMAGE_CLASSES, device=dev,
                         generator=torch.Generator().manual_seed(15))
    transform = make_batch_transform(224)
    flips = torch.Generator().manual_seed(16)
    weights: dict = {}
    digests = []
    t0 = time.monotonic()
    it = iter(loader)
    try:
        for _ in range(STEPS):
            batch = next(it)
            flip = (torch.rand(IMAGE_BATCH, generator=flips) < 0.5).to(dev)
            images = transform(batch)["image"]
            x = image.normalize_flip(images, flip)
            out_digest = _digest(x, weights)
            if model is not None:
                logits = model(x.permute(0, 3, 1, 2))
                F.cross_entropy(logits.float(),
                                batch["label"].long()).backward()
                del logits
            digests.append(([_digest(v, weights) for k, v in
                             sorted(batch.items())
                             if isinstance(v, torch.Tensor)], out_digest))
            del batch, images, x
    finally:
        it.close()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    return {"digests": [([int(d) for d in leaves], int(out))
                        for leaves, out in digests],
            "seconds": seconds, "decoder": decode.arm,
            "placement_ms": plane.h2d_ms if plane is not None else None}


def _run_fields(result: dict, fields: dict, launches: dict) -> dict:
    """The figures each fine-tuning run prints."""
    placement = result.get("placement_ms") or []
    return {
        "decoder": fields["decoder"],
        "step_ms_median_5_20": fields["step_ms_median_5_20"],
        "images_per_sec_steps_6_20": fields["images_per_sec_steps_6_20"],
        "loader_stall_pct": fields["loader_stall_pct"],
        "h2d_pct": result.get("h2d_pct"),
        "placement_ms_median": (statistics.median(placement)
                                if placement else None),
        "placement_ms_first3": placement[:3],
        "bufpool_hits": result["bufpool_hits"],
        "bufpool_misses": result["bufpool_misses"],
        "bufpool_miss_ms": result["bufpool_miss_ms"],
        "peak_memory_allocated_bytes": fields["peak_memory_allocated_bytes"],
        "first_loss": fields["first_loss"],
        "last5_mean_loss": fields["last5_mean_loss"],
        "losses": fields["losses"], "steps": fields["steps"],
        "eval_accuracy": fields["eval_accuracy"],
        "eval_rows": fields["eval_rows"],
        "image_normalize_launches": launches["image_normalize"],
        "jpeg_decode_launches": launches["jpeg_decode"],
        "decode_entropy_ms": fields["decode_entropy_ms"],
        "decode_device_ms": fields["decode_device_ms"],
        "train_seconds": fields["train_seconds"],
        "total_seconds": fields["total_seconds"],
        "host_cpu_count": os.cpu_count(),
    }


def pretrained_placement_run() -> dict:
    """ResNet-50 fine-tuning from a seeded torchvision checkpoint through
    the placement plane and its synchronous control arm, in both decoder
    arms (the module's docstring, phase 16)."""
    rows = IMAGE_BATCH * STEPS
    eval_batches = -(-rows // IMAGE_BATCH)
    totals = {"image_normalize": 0, "jpeg_decode": 0}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "resnet50_torchvision.pt")
        state = _write_pretrained(ckpt)
        _import_check(ckpt, state)
        del state
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        for coeff in (False, True):
            arm = "coeff" if coeff else "pixel"
            placed = _overlap_run(path, coeff, placed=True)
            sync = _overlap_run(path, coeff, placed=False)
            same = placed["digests"] == sync["digests"]
            emit("pretrained_placement", check="overlap", arm=arm,
                 decoder=placed["decoder"], batches=len(placed["digests"]),
                 bit_identical=same, placed_seconds=placed["seconds"],
                 sync_seconds=sync["seconds"],
                 placement_ms=placed["placement_ms"])
            if not same:
                bad = [i for i, (a, b) in enumerate(zip(placed["digests"],
                                                        sync["digests"]))
                       if a != b]
                raise RuntimeError(f"{arm} arm: placed batches {bad} differ "
                                   f"from the synchronous arm's")
            if _loader_threads():
                raise RuntimeError(f"loader threads outlived the overlap "
                                   f"check: {_loader_threads()}")
        for coeff in (False, True):
            for control in (False, True):
                name = ("coeff" if coeff else "pixel") + (
                    "_control" if control else "_plane")
                flags = ["--pretrained", ckpt]
                flags += ["--device_decode"] if coeff else []
                flags += PLACEMENT_CONTROL if control else []
                result, launches, fields = _resnet_run(path, flags, author_s,
                                                       tmp)
                left = _loader_threads()
                run = _run_fields(result, fields, launches)
                run.update(flags=flags, loader_threads_after=left,
                           dataset_seconds=author_s)
                emit("pretrained_placement", run=name, **run)
                _check_trained(f"pretrained_placement {name}", fields)
                if left:
                    raise RuntimeError(f"{name}: loader threads outlived "
                                       f"train(): {left}")
                if fields["eval_rows"] != rows:
                    raise RuntimeError(f"{name}: eval covered "
                                       f"{fields['eval_rows']} rows of {rows}")
                want = {"image_normalize": STEPS + eval_batches,
                        "jpeg_decode": STEPS + eval_batches if coeff else 0}
                for kernel, count in want.items():
                    if launches[kernel] != count:
                        raise RuntimeError(
                            f"{name}: {kernel} launched {launches[kernel]} "
                            f"times, expected {count}")
                    totals[kernel] += launches[kernel]
                if not control and not (result["bufpool_hits"]
                                        + result["bufpool_misses"]):
                    raise RuntimeError(f"{name}: the decoders leased no page")
                runs[name] = run
    return {"launches": totals, "runs": runs}


def _ragged_payloads() -> list:
    """JPEGs unlike the path's: odd sizes, grayscale, progressive,
    restart markers, 4:4:4 (which the decoder re-encodes) and bytes no
    decoder reads (a zeroed page with zero geometry)."""
    import io

    from PIL import Image

    rng = np.random.default_rng(5)

    def jpeg(shape, **kw):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
            buf, format="JPEG", **kw)
        return buf.getvalue()

    return [jpeg((97, 225, 3), quality=85), jpeg((33, 17, 3), quality=10),
            jpeg((40, 33), quality=90), jpeg((224, 224, 3), quality=95,
                                             progressive=True),
            jpeg((61, 80, 3), quality=85, restart_marker_blocks=3),
            jpeg((48, 40, 3), quality=85, subsampling=0),
            bytes(rng.integers(0, 256, 300, dtype=np.uint8)),
            jpeg((300, 260, 3), quality=85)]


def _k2_ops(pages: dict, size: int) -> int:
    """Integer operations that K2's function needs on these pages (a
    multiply-add counts 2), counting only what this data samples:
    per 8x8 block that a sampled source pixel lies in (luma, and chroma of
    both planes) a dequantizing multiply for each of its 64 coefficients
    and two passes in the even/odd form, each of 8 rows by 4 output pairs
    of 8 multiply-adds and a sum and a difference; per sampled source pixel
    (the first index of each axis, and the second where its weight is not
    0) jdcolor's conversion, 22 operations (two offsets, four multiply-adds,
    three shifts, three adds and three clamps of two); and per channel each
    mix whose weight is not 0, 4 operations (a subtract, a multiply, a
    shift and an add): the vertical mix of both columns where the column's
    weight is not 0, of the first only where it is, then the horizontal."""
    import torch
    from lance_distributed_training_tpu_torch.ops import jpeg_device as jd

    geom = torch.from_numpy(pages["jpeg_geom"])
    yh, yw = (8 * n for n in pages["jpeg_coef_y"].shape[1:3])
    blocks = sampled = mixes = 0
    for n in range(geom.shape[0]):
        used, weighted = [], []
        for axis, extent in ((0, yw), (1, yh)):
            i0, i1, w = jd._axis_samples(geom[n:n + 1, axis], size)
            idx = torch.cat([i0[0], i1[0][w[0] != 0]])
            used.append(torch.unique(jd._gather_index(idx, extent)))
            weighted.append(int((w[0] != 0).sum()))
        sampled += len(used[0]) * len(used[1])
        blocks += len(torch.unique(used[0] >> 3)) * len(
            torch.unique(used[1] >> 3))
        blocks += 2 * len(torch.unique(used[0] >> 4)) * len(
            torch.unique(used[1] >> 4))
        nwx, nwy = weighted
        mixes += size * nwy + nwx * nwy + size * nwx
    return (blocks * (64 + 2 * 8 * 4 * (8 * 2 + 2)) + sampled * 22
            + mixes * 3 * 4)


def jpeg_kernels() -> dict:
    """K2 against its plain version, bit for bit, then timed, at pages
    extracted here from the classification set."""
    import torch
    from lance_distributed_training_tpu_torch.data import (
        CoeffImageDecoder,
        Dataset,
        create_synthetic_classification_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import jpeg_device

    dev = torch.device("cuda")

    def on_card(pages: dict) -> list:
        return [torch.from_numpy(pages[k]).to(dev)
                for k in jpeg_device.COEFF_KEYS]

    def kernel(args, size):
        return jpeg_device.decode_coeff_batch(*args, out_size=size)

    def plain(args, size):
        return jpeg_device.decode_coeff_batch_reference(*args, out_size=size)

    with tempfile.TemporaryDirectory() as tmp:
        create_synthetic_classification_dataset(
            os.path.join(tmp, "food"), rows=IMAGE_BATCH,
            num_classes=IMAGE_CLASSES, image_size=224,
            unique_images=UNIQUE_IMAGES)
        table = Dataset(os.path.join(tmp, "food")).take(
            np.arange(IMAGE_BATCH))
    decoder = CoeffImageDecoder(image_size=224)
    for _ in range(3):
        pages = decoder(table)
    entropy_ms = decoder.entropy_ms
    jpeg_bytes = sum(len(v) for v in table.column("image").to_pylist())
    cases = [("path", on_card(pages), 224)]
    ragged = CoeffImageDecoder(image_size=224).decode_payloads(
        _ragged_payloads())
    for size in (224, 32, 40):
        cases.append((f"ragged_{size}", on_card(ragged), size))
    checked = []
    for label, args, size in cases:
        got = kernel(args, size)
        want = plain(args, size)
        again = kernel(args, size)
        torch.cuda.synchronize()
        row = {"case": label, "pages": list(args[0].shape),
               "out": list(got.shape),
               "bit_identical": torch.equal(got, want),
               "bit_identical_on_repeat": torch.equal(got, again)}
        checked.append(row)
        if not (row["bit_identical"] and row["bit_identical_on_repeat"]):
            diff = (got.int() - want.int()).abs().max().item()
            emit("jpeg_kernels", failed=row, max_abs_err=diff)
            raise RuntimeError(f"K2 differs from its plain version at "
                               f"{label}")
    emit("jpeg_kernels", checks=checked, max_abs_err=0.0,
         ragged_geometry=ragged["jpeg_geom"].tolist())

    args = cases[0][1]
    if list(args[0].shape) != [IMAGE_BATCH, 28, 28, 64]:
        raise RuntimeError(f"path pages {list(args[0].shape)}, expected "
                           f"[{IMAGE_BATCH}, 28, 28, 64]")
    ms = time_ms(lambda: kernel(args, 224))
    back_to_back_ms = time_back_to_back_ms(lambda: kernel(args, 224))
    plain_ms = time_back_to_back_ms(lambda: plain(args, 224), launches=3,
                                    reps=3, warmup=1)
    moved = sum(t.numel() * t.element_size() for t in args)
    moved += IMAGE_BATCH * 224 * 224 * 3
    ops_count = _k2_ops(pages, 224)
    t_bytes = moved / PEAK_BYTES
    t_ops = ops_count / PEAK_INT32_OPS
    fields = {
        "pages": list(args[0].shape), "ms": ms,
        "back_to_back_ms": back_to_back_ms, "plain_ms": plain_ms,
        "library_ms": None, "bytes": moved, "int_ops": ops_count,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "entropy_ms_512": entropy_ms, "extractor_threads": decoder.threads,
        "jpeg_bytes_512": jpeg_bytes,
    }
    fields["share_of_bound"] = fields["bound_ms"] / ms
    emit("jpeg_kernels", timing="path_shape", **fields)
    return fields


# ------------------------------------------------------------ causal LM


_CORPUS: dict = {}


def _corpus_docs() -> list:
    """The causal-LM corpus: ``GPT_BATCH * STEPS`` documents with seeded
    lognormal lengths (log-mean ``log(GPT_MEAN_LEN)``, sigma ``GPT_SIGMA``,
    clipped to 1-1024, as ``create_variable_length_token_dataset`` draws
    them) and Zipf(1.2) ids folded onto 2..vocab-1, as the slice phase's
    BERT corpus is (uniform ids would leave nothing to learn)."""
    if "docs" not in _CORPUS:
        rng = np.random.default_rng(6)
        n = GPT_BATCH * STEPS
        lengths = np.clip(
            rng.lognormal(np.log(GPT_MEAN_LEN), GPT_SIGMA, n).astype(np.int64),
            1, GPT_CONTEXT)
        _CORPUS["docs"] = [
            (2 + (rng.zipf(1.2, int(m)) - 1) % (GPT_VOCAB - 2)).astype(
                np.int32) for m in lengths]
    return _CORPUS["docs"]


def _token_table(docs):
    import pyarrow as pa

    return pa.table({"input_ids": pa.array(list(docs),
                                           type=pa.list_(pa.int32()))})


def _decode_tokens(docs, pack_len: int,
                   rows_multiple: int = PACK_ROWS_MULTIPLE,
                   mode: str = "pack") -> dict:
    """``docs`` through the port's TokenDecoder (an FFD or bucket plan)."""
    from lance_distributed_training_tpu_torch.data import (
        TokenDecoder,
        TokenPackConfig,
        TokenPackPlanner,
    )

    planner = TokenPackPlanner(TokenPackConfig(pack_len=pack_len,
                                               rows_multiple=rows_multiple))
    return TokenDecoder(mode=mode, seq_len=pack_len, planner=planner)(
        _token_table(docs))


def _pack_args(batch: dict, device) -> tuple:
    """``(values, offsets, slot, start)`` tensors and ``(rows, pack_len)``
    of a decoded ragged batch."""
    import torch

    args = tuple(torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                 for k in ("input_ids__values", "input_ids__offsets",
                           "_pack_slot", "_pack_start"))
    rows, pack_len = (int(x) for x in batch["_host_pack_meta"][:2])
    return args, rows, pack_len


def _corpus_segment_ids(pack_len: int):
    """The segment ids of the corpus's first batch packed at ``pack_len``
    (by the plain pack, on the CPU)."""
    from lance_distributed_training_tpu_torch.ops import token_device

    args, rows, pl = _pack_args(
        _decode_tokens(_corpus_docs()[:GPT_BATCH], pack_len), "cpu")
    return token_device.pack_token_batch_reference(
        *args, rows=rows, pack_len=pl)[1]


def _token_cases() -> list:
    """``(label, decoded batch, values tail, made by hand)`` for K3's
    checks: the path's batch, ragged ones and ``_hand_plans``."""
    rng = np.random.default_rng(7)

    def docs(lengths):
        return [rng.integers(2, GPT_VOCAB, int(m), dtype=np.int32)
                for m in lengths]

    path = _decode_tokens(_corpus_docs()[:GPT_BATCH], GPT_CONTEXT)
    cases = [("path", path, None)]
    cases.append(("empty_sequences", _decode_tokens(
        docs([0, 5, 0, 0, 40, 17, 0, 3, 64, 0]), 64), None))
    cases.append(("one_sequence", _decode_tokens(docs([37]), GPT_CONTEXT),
                  None))
    cases.append(("truncated_at_pack_len", _decode_tokens(
        docs(rng.integers(1, 300, 23)), 64), None))
    cases.append(("rows_multiple_padding", _decode_tokens(
        docs([9, 200, 31]), 256, rows_multiple=8), None))
    cases.append(("bucket_mode", _decode_tokens(
        docs(rng.integers(1, 90, 16)), 128, mode="bucket"), None))
    # A values tail past offsets[n] that holds nonzero tokens: the kernels
    # must leave it alone.
    cases.append(("values_tail", path, rng.integers(
        2, GPT_VOCAB, 4096, dtype=np.int32)))
    # More sequences than the pack's plan chunk (256) takes at once.
    cases.append(("many_sequences", _decode_tokens(
        docs(rng.integers(0, 6, 600)), 64, rows_multiple=1), None))
    return [case + (False,) for case in cases] + [
        (label, plan, None, True) for label, plan in _hand_plans(rng).items()]


def _hand_plans(rng) -> dict:
    """Plans no planner makes, as ragged batches: runs that cross a row's
    end, and destinations below 0 (counted from the grid's end), partly
    below the grid, past it and partly past it, and sequences before a
    nonzero offsets[0]."""

    def batch(lengths, slot, start, rows, pack_len, first=0):
        offsets = np.concatenate([[first], first + np.cumsum(lengths)])
        return {"input_ids__values": rng.integers(
                    2, GPT_VOCAB, int(offsets[-1]) + 5, dtype=np.int32),
                "input_ids__offsets": offsets.astype(np.int32),
                "_pack_slot": np.asarray(slot, np.int32),
                "_pack_start": np.asarray(start, np.int32),
                "_host_pack_meta": np.asarray([rows, pack_len])}

    return {
        # 4 x 64 cells: [50, 80), [138, 202), [210, 250), truncated at 64.
        "row_crossing": batch([30, 100, 40], [0, 2, 3], [50, 10, 18], 4, 64),
        # 4 x 32 = 128 cells: slot -1 wraps to cells [99, 119); slot -5
        # start 8 starts 24 cells below the grid's -128, so only its last 8
        # tokens wrap in, to [0, 8); slot 4 is past the grid; slot 3 start
        # 24 runs 12 cells past it.
        "negative_and_past_grid": batch(
            [20, 40, 10, 20, 12], [-1, -5, 4, 3, 1], [3, 8, 0, 24, 0], 4, 32),
        # offsets[0] = 6: positions 0-5 fall to sequence 0 with k < 0.
        "nonzero_first_offset": batch([10, 0, 7], [1, 0, 2], [7, 0, 30], 3,
                                      64, first=6),
    }


def token_kernels() -> dict:
    """K3 pack and unpack against their plain versions, bit for bit, then
    timed at the path's batch."""
    import torch
    from lance_distributed_training_tpu_torch.ops import token_device as td

    dev = torch.device("cuda")
    checked = []
    for label, batch, tail, hand in _token_cases():
        (values, offsets, slot, start), rows, pack_len = _pack_args(batch,
                                                                    dev)
        if tail is not None:
            values = torch.cat([values, torch.from_numpy(tail).to(dev)])
        got = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                  pack_len=pack_len)
        want = td.pack_token_batch_reference(values, offsets, slot, start,
                                             rows=rows, pack_len=pack_len)
        again = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                    pack_len=pack_len)
        cap = values.shape[0]
        back = td.unpack_token_batch(got[0], offsets, slot, start,
                                     capacity=cap)
        back_want = td.unpack_token_batch_reference(want[0], offsets, slot,
                                                    start, capacity=cap)
        back_again = td.unpack_token_batch(got[0], offsets, slot, start,
                                           capacity=cap)
        # The round trip returns every live token (where the unpacked
        # segment ids are nonzero) and zero elsewhere: the page itself
        # where nothing was truncated and the tail is zero. Hand-made plans
        # drop tokens past the grid, which the unpack cannot tell: for them
        # only the bits of each direction are checked.
        live = td.unpack_token_batch_reference(want[1], offsets, slot, start,
                                               capacity=cap) != 0
        expected = torch.where(live, values, torch.zeros_like(values))
        torch.cuda.synchronize()
        lengths = (offsets[1:] - offsets[:-1]).cpu()
        exact = bool((lengths <= pack_len).all()) and tail is None
        row = {
            "case": label, "n": int(slot.shape[0]), "capacity": cap,
            "grid": [rows, pack_len],
            "pack_bit_identical": all(torch.equal(g, w)
                                      for g, w in zip(got, want)),
            "pack_bit_identical_on_repeat": all(
                torch.equal(g, a) for g, a in zip(got, again)),
            "unpack_bit_identical": torch.equal(back, back_want),
            "unpack_bit_identical_on_repeat": torch.equal(back, back_again),
            "round_trip_exact": exact and not hand,
            "round_trip_ok": hand or torch.equal(back, expected) and (
                not exact or torch.equal(back, values)),
        }
        checked.append(row)
        if not all(v for k, v in row.items() if k.endswith(
                ("identical", "on_repeat", "_ok"))):
            emit("token_kernels", failed=row)
            raise RuntimeError(f"K3 differs from its plain version at "
                               f"{label}")
    emit("token_kernels", checks=checked, max_abs_err=0)

    (values, offsets, slot, start), rows, pack_len = _pack_args(
        _token_cases()[0][1], dev)
    cap, n = values.shape[0], slot.shape[0]
    cells = rows * pack_len
    grid = td.pack_token_batch(values, offsets, slot, start, rows=rows,
                               pack_len=pack_len)[0]

    def pack():
        return td.pack_token_batch(values, offsets, slot, start, rows=rows,
                                   pack_len=pack_len)

    def pack_plain():
        return td.pack_token_batch_reference(values, offsets, slot, start,
                                             rows=rows, pack_len=pack_len)

    def unpack():
        return td.unpack_token_batch(grid, offsets, slot, start,
                                     capacity=cap)

    def unpack_plain():
        return td.unpack_token_batch_reference(grid, offsets, slot, start,
                                               capacity=cap)

    before = dict(td.LAUNCHES)
    # The card runs each launch in microseconds, the wrapper takes longer
    # on the host: time the launches queued behind a spin (device time),
    # and back to back as a caller meets them (host-bound).
    queued = {"token_pack": time_queued_ms(pack),
              "token_unpack": time_queued_ms(unpack),
              "token_pack_plain": time_queued_ms(pack_plain),
              "token_unpack_plain": time_queued_ms(unpack_plain),
              # The least time any launch takes: an empty one, the same way.
              "launch_floor": time_queued_ms(lambda: torch.cuda._sleep(1))}
    ms = {k: queued[k]["ms"] for k in ("token_pack", "token_unpack")}
    plain_ms = {k: queued[k + "_plain"]["ms"] for k in ms}
    back_to_back = {"token_pack": time_back_to_back_ms(pack),
                    "token_unpack": time_back_to_back_ms(unpack)}
    # Bytes each must move: pack reads the live tokens it places (the
    # plain version's mask count; the page's tail past them is not read),
    # the offsets and the plan, and writes 13 bytes a cell; unpack reads
    # the grid cells holding those tokens, the offsets and the plan, and
    # writes the page.
    plan_bytes = 4 * (n + 1) + 8 * n
    payload = int(offsets[-1].item())
    live = int(torch.count_nonzero(pack_plain()[3]).item())
    moved = {"token_pack": 4 * live + plan_bytes + td.CELL_BYTES * cells,
             "token_unpack": 4 * live + plan_bytes + 4 * cap}
    table = {}
    for name in ms:
        bound = 1e3 * moved[name] / PEAK_BYTES
        table[name] = {"ms": ms[name], "plain_ms": plain_ms[name],
                       "ms_back_to_back": back_to_back[name],
                       "launch_floor_ms": queued["launch_floor"]["ms"],
                       "host_queue_ms_per_call":
                           queued[name]["host_queue_ms_per_call"],
                       "library_ms": None, "bytes": moved[name],
                       "bound_ms": bound, "bound_by": "bytes",
                       "share_of_bound": bound / ms[name]}
    check_launches = {k: td.LAUNCHES[k] for k in td.LAUNCHES}
    emit("token_kernels", timing="path_shape", n=n, capacity=cap,
         grid=[rows, pack_len], payload_tokens=payload, live_tokens=live,
         table=table,
         queued=queued, launches_in_this_phase=check_launches,
         timing_launches={k: td.LAUNCHES[k] - before[k] for k in before})
    return {"table": table, "check_launches": check_launches}


def _write_corpus(path: str) -> None:
    from lance_distributed_training_tpu_torch.data import write_dataset

    table = _token_table(_corpus_docs())
    write_dataset(table, path, schema=table.schema, mode="create")


def causal_lm_run() -> dict:
    """GPT-2 124M's shape through ``cli train --task_type causal_lm``,
    packed (K3) and then padded, STEPS steps each with the eval."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops

    rows = GPT_BATCH * STEPS
    eval_batches = -(-rows // GPT_BATCH)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        t0 = time.monotonic()
        _write_corpus(path)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        for arm in ("packed", "padded"):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            result = cli.main([
                "train", "--dataset_path", path, "--task_type", "causal_lm",
                "--model_name", "gpt_base", "--seq_len", str(GPT_CONTEXT),
                "--flash_attention", "--batch_size", str(GPT_BATCH),
                "--optimizer", "adamw", "--lr", "1e-4",
                "--max_steps", str(STEPS), "--epochs", "1",
                "--log_every", "5", "--device", "cuda",
                "--pack_rows_multiple", str(PACK_ROWS_MULTIPLE),
                "--token_pack" if arm == "packed" else "--no_token_pack",
            ])
            launches = dict(ops.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            losses = result["losses"]
            steps = result["steps"]
            # Steps 5-20: their grid and payload tokens over their CUDA-event
            # time.
            step_ms = result["step_ms"][4:]
            grid = sum(result["grid_tokens"][4:])
            payload = sum(result["payload_tokens"][4:])
            device_s = sum(step_ms) / 1e3
            fields = {
                "arm": arm, "steps": steps, "first_loss": losses[0],
                "last5_mean_loss": statistics.fmean(losses[-5:]),
                "losses": losses,
                "step_ms_median_5_20": statistics.median(step_ms),
                "grid_tokens_per_step": result["grid_tokens"],
                "payload_tokens_per_step": result["payload_tokens"],
                "grid_tokens_per_sec": grid / device_s,
                "valid_tokens_per_sec": payload / device_s,
                "pad_waste_pct": 100 * (1 - payload / grid),
                "grid_tokens_per_sec_wall": result["tokens_per_sec"],
                "valid_tokens_per_sec_wall": result["valid_tokens_per_sec"],
                "pad_waste_pct_wall": result["pad_waste_pct"],
                "pack_device_ms": result.get("pack_device_ms"),
                "pack_new_shapes_total": result.get("pack_new_shapes_total"),
                "counters": {k: result[k] for k in (
                    "pack_payload_tokens_total", "pack_grid_tokens_total",
                    "pack_sequences_total", "pack_truncated_tokens_total",
                    "pack_batches_total")},
                "peak_memory_allocated_bytes": peak,
                "eval_next_token_accuracy": result.get("eval_accuracy"),
                "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
                "launches": launches, "dataset_seconds": author_s,
                "train_seconds": result["train_time"],
                "total_seconds": result["total_time"],
                "model_params": result["model_params"],
            }
            emit("causal_lm", **fields)
            if steps != STEPS or len(losses) != STEPS:
                raise RuntimeError(f"{arm}: ran {steps} steps, expected "
                                   f"{STEPS}")
            if not all(np.isfinite(losses)):
                raise RuntimeError(f"{arm}: non-finite loss")
            if not fields["last5_mean_loss"] < losses[0]:
                raise RuntimeError(f"{arm}: loss did not fall over the run")
            if fields["eval_rows"] != rows:
                raise RuntimeError(f"{arm}: eval covered "
                                   f"{fields['eval_rows']} rows of {rows}")
            want = {
                "token_pack": STEPS if arm == "packed" else 0,
                "token_unpack": 0,
                "fwd": LAYERS * (STEPS + eval_batches),
                "bwd_dq": LAYERS * STEPS, "bwd_dkv": LAYERS * STEPS,
            }
            wrong = {k: (launches[k], v) for k, v in want.items()
                     if launches[k] != v}
            if wrong:
                raise RuntimeError(f"{arm}: launches (got, expected) {wrong}")
            out[arm] = fields
    return {"launches": {"token_pack": out["packed"]["launches"]["token_pack"],
                         "token_unpack": out["packed"]["launches"][
                             "token_unpack"]}, "arms": out}

# ------------------------------------------------------------ ring attention


def _ring_forward(fold, q, k, v, mask, sp: int, fused: bool):
    """The forward over an in-process ring of ``sp`` positions with
    ``fold`` (K5's forward or its plain version): one call over all ``sp``
    steps from fresh carries (``fused``, the path's launch), or ``sp``
    one-step calls on carries in memory; returns ``(out, m, l)``."""
    import torch

    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if fused:
        m = torch.empty((b, h, s), device=q.device)
        l = torch.empty_like(m)
        fold(q, k, v, mask, m, l, None, sp, 0, out=out, steps=sp)
        return out, m, l
    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for t in range(sp):
        fold(q, k, v, mask, m, l, acc, sp, t,
             out=out if t == sp - 1 else None)
    return out, m, l


def _ring_backward(fold_dq, fold_dkv, q, k, v, mask, lse, delta, do,
                   sp: int, fused: bool):
    """dQ and dK/dV: one call each over all ``sp`` steps into q's type
    (``fused``, the path's launches), or ``sp`` one-step calls each on f32
    totals (a process ring's); returns ``(dq, dk, dv)``."""
    import torch

    if fused:
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        fold_dq(q, k, v, mask, lse, delta, do, None, sp, 0, steps=sp, out=dq)
        fold_dkv(q, k, v, mask, lse, delta, do, None, None, sp, 0, steps=sp,
                 out=(dk, dv))
        return dq, dk, dv
    dq, dk, dv = (torch.zeros(q.shape, device=q.device) for _ in range(3))
    for t in range(sp):
        fold_dq(q, k, v, mask, lse, delta, do, dq, sp, t)
        fold_dkv(q, k, v, mask, lse, delta, do, dk, dv, sp, t)
    return dq, dk, dv


def _ring_case(label, q, k, v, do, mask, sp, errors) -> dict:
    """K5 over a whole in-process ring as the path launches it (each kernel
    once over all ``sp`` steps) against the plain folds on the same inputs
    (flash's tolerances: out 0.02, lse 1e-3, gradients 2% of the largest;
    and out within ``RING_TOL_O_CLOSE``) and
    against ``sp`` one-step launches of the same kernels, bit for bit (and
    a fused dQ launch into f32 totals against the one-step totals); then a
    repeat that must give the same bits; rows with no valid key must come
    out 0 with 0 gradients."""
    import torch
    from lance_distributed_training_tpu_torch.ops import ring_attention as ra

    out, m, l = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, True)
    out_ref, m_ref, l_ref = _ring_forward(ra.ring_fold_fwd_reference, q, k,
                                          v, mask, sp, False)
    lse = ra.row_lse(m_ref, l_ref)
    delta = (do.float() * out_ref.float()).sum(-1)
    grads = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv, q, k,
                           v, mask, lse, delta, do, sp, True)
    grads_ref = _ring_backward(ra.ring_fold_bwd_dq_reference,
                               ra.ring_fold_bwd_dkv_reference, q, k, v, mask,
                               lse, delta, do, sp, False)
    torch.cuda.synchronize()
    err = {"out": (out.float() - out_ref.float()).abs().max().item(),
           "lse": (ra.row_lse(m, l) - lse).abs().max().item()}
    tol = {"out": TOL_O, "lse": TOL_LSE}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        err[name] = (got.float() - ref).abs().max().item()
        tol[name] = TOL_GRAD_REL * ref.abs().max().item()
    empty = ~mask.bool().any(dim=1)  # rows with no valid key
    zero_rows = bool((out[empty] == 0).all().item()
                     and all((g[empty] == 0).all().item() for g in grads))
    emit("ring_kernels", case=label, shape=list(q.shape), sp=sp,
         empty_rows=int(empty.sum().item()), max_abs_err=err, tolerance=tol,
         out_close_tolerance=RING_TOL_O_CLOSE, empty_rows_zero=zero_rows)
    bad = [n for n in err if not err[n] <= tol[n]]
    if not err["out"] <= RING_TOL_O_CLOSE:
        bad.append("out (close)")
    if bad or not zero_rows:
        raise RuntimeError(f"K5 {label}: {bad} above tolerance or nonzero "
                           f"empty rows ({zero_rows})")
    # The fused launches against sp one-step launches of the same kernels.
    out1, m1, l1 = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, False)
    dq1, dk1, dv1 = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv,
                                   q, k, v, mask, lse, delta, do, sp, False)
    dq3 = torch.zeros(q.shape, device=q.device)
    ra.ring_fold_bwd_dq(q, k, v, mask, lse, delta, do, dq3, sp, 0, steps=sp)
    same_steps = {
        "ring_fwd": torch.equal(out, out1) and torch.equal(m, m1)
        and torch.equal(l, l1),
        "ring_bwd_dq": torch.equal(grads[0], dq1.to(q.dtype))
        and torch.equal(dq3, dq1),
        "ring_bwd_dkv": torch.equal(grads[1], dk1.to(k.dtype))
        and torch.equal(grads[2], dv1.to(v.dtype)),
    }
    out2, m2, l2 = _ring_forward(ra.ring_fold_fwd, q, k, v, mask, sp, True)
    grads2 = _ring_backward(ra.ring_fold_bwd_dq, ra.ring_fold_bwd_dkv, q, k,
                            v, mask, lse, delta, do, sp, True)
    same = {"ring_fwd": torch.equal(out, out2) and torch.equal(m, m2)
            and torch.equal(l, l2),
            "ring_bwd_dq": torch.equal(grads[0], grads2[0]),
            "ring_bwd_dkv": torch.equal(grads[1], grads2[1])
            and torch.equal(grads[2], grads2[2])}
    emit("ring_kernels", case=label, fused_equals_one_step=same_steps,
         bit_identical_on_repeat=same)
    if not all(same_steps.values()):
        raise RuntimeError(f"K5 {label}: the fused launch differs from "
                           f"{sp} one-step launches: {same_steps}")
    if not all(same.values()):
        raise RuntimeError(f"K5 {label}: a second launch differs: {same}")
    errors["ring_fwd"] = max(errors["ring_fwd"], err["out"])
    errors["ring_bwd_dq"] = max(errors["ring_bwd_dq"], err["dq"])
    errors["ring_bwd_dkv"] = max(errors["ring_bwd_dkv"], err["dk"],
                                 err["dv"])
    return {"lse": lse, "delta": delta}


def _ring_bounds(b: int, h: int, s: int, sb: int, d: int) -> dict:
    """Least time of K5's launches over all positions: the larger of each
    launch's products at the bf16 peak and its bytes over the HBM rate,
    each input read once and each output written once. ``fused``: the
    forward, dQ and dK/dV over the whole ring from fresh carries (q, k, v
    (and dO, lse, delta) in; out, m and l, a bf16 dq, or bf16 dk and dv
    out). ``step``: one
    ring step of each kernel, which also reads and writes its f32 carries
    or gradients."""
    bf16_in = b * h * s * d * 2  # one of q, k, v, dO
    rows = b * h * s * 4  # one f32 per row: m, l, lse or delta
    full = b * h * s * d * 4  # one f32 [B, H, S, D]: acc, dq, dk or dv
    mask = b * s
    macs = b * h * s * sb * d  # one product over one step's pairs
    ring = s // sb
    work = {
        "fused": {
            "ring_fwd": (4 * macs * ring, 4 * bf16_in + mask + 2 * rows),
            "ring_bwd_dq": (6 * macs * ring, 5 * bf16_in + mask + 2 * rows),
            "ring_bwd_dkv": (8 * macs * ring,
                             6 * bf16_in + mask + 2 * rows),
        },
        "step": {
            "ring_fwd": (4 * macs, 3 * bf16_in + mask + 4 * rows + 2 * full),
            "ring_bwd_dq": (6 * macs,
                            4 * bf16_in + mask + 2 * rows + 2 * full),
            "ring_bwd_dkv": (8 * macs,
                             4 * bf16_in + mask + 2 * rows + 4 * full),
        },
    }
    out = {}
    for mode, kernels in work.items():
        out[mode] = {}
        for name, (flops, nbytes) in kernels.items():
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            out[mode][name] = {
                "flops": flops, "bytes": nbytes,
                "bound_ms": 1e3 * max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


def ring_kernels(ptxas: dict) -> dict:
    """K5 at the seq-parallel path's shape ([32, 12, 512, 64] bf16, four
    positions, key masks from the corpus lengths) and at ragged ones
    against the plain versions and against one-step launches, then timed:
    each kernel as the path launches it (once over the ring) and one ring
    step of each between CUDA events, the whole ring through
    ``ring_attention``, and
    SDPA with the same key mask (yardstick only)."""
    import torch
    import torch.nn.functional as F
    from lance_distributed_training_tpu_torch.ops import ring_attention as ra
    from lance_distributed_training_tpu_torch.parallel.ring_attention import (
        InProcessRing,
        ring_attention,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    errors = dict.fromkeys(RING_KERNELS, 0.0)
    b, h, s, d = SHAPE
    lengths = _slice_docs()[0][:b]
    mask = torch.from_numpy(
        (np.arange(s)[None] < np.minimum(lengths, s)[:, None]).astype(
            np.uint8)).to(dev)
    sb = s // RING_SP
    blocks = mask.bool().reshape(b, RING_SP, sb).any(-1).cpu().numpy()
    q, k, v, do = (randn(SHAPE) for _ in range(4))
    path = _ring_case("path", q, k, v, do, mask, RING_SP, errors)
    emit("ring_kernels", case="path", fully_masked_last_blocks=[
        int((~blocks[:, -n:]).all(-1).sum()) for n in (1, 2)])
    # Ragged: rows with no valid key, block lengths that are no multiple of
    # the tiles (50, 96) or longer than one (256), and one position a
    # launch (the process ring's layout).
    for label, shape, sp in (("empty_rows", (4, 2, 512, 64), 4),
                             ("ragged_block_50", (3, 2, 200, 64), 4),
                             ("block_256", (2, 3, 512, 64), 2),
                             ("one_position", (2, 3, 96, 64), 1)):
        keep = rng.random((shape[0], shape[2])) < 0.6
        keep[0] = False
        if label == "empty_rows":
            keep[2] = False
        elif sp > 1:
            keep[1, :shape[2] // sp] = False  # a fully masked first block
        m_case = torch.from_numpy(keep.astype(np.uint8)).to(dev)
        _ring_case(label, *(randn(shape) for _ in range(4)), m_case, sp,
                   errors)

    # Timing at the path's inputs: each kernel as the path launches it, and
    # one ring step (shift 1, carries or totals in memory) of each.
    lse, delta = path["lse"], path["delta"]
    f32 = dict(device=dev)
    m, l = torch.zeros((b, h, s), **f32), torch.zeros((b, h, s), **f32)
    acc, dq, dk, dv = (torch.zeros(SHAPE, **f32) for _ in range(4))
    out, dq_b, dk_b, dv_b = (torch.empty_like(t) for t in (q, q, k, v))
    ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP)),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b)),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b))),
    }
    # The same launches 20 back to back (median of 5): the card's queue
    # stays full, so the wrapper's host work before each launch, which a
    # single launch between events includes, does not count.
    back_to_back_ms = {
        "ring_fwd": time_back_to_back_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP)),
        "ring_bwd_dq": time_back_to_back_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b)),
        "ring_bwd_dkv": time_back_to_back_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b))),
    }
    one_step_ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd(
            q, k, v, mask, m, l, acc, RING_SP, 1)),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq(
            q, k, v, mask, lse, delta, do, dq, RING_SP, 1)),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv(
            q, k, v, mask, lse, delta, do, dk, dv, RING_SP, 1)),
    }
    plain_ms = {
        "ring_fwd": time_ms(lambda: ra.ring_fold_fwd_reference(
            q, k, v, mask, m, l, None, RING_SP, 0, out=out, steps=RING_SP),
            warmup=1, iters=5),
        "ring_bwd_dq": time_ms(lambda: ra.ring_fold_bwd_dq_reference(
            q, k, v, mask, lse, delta, do, None, RING_SP, 0, steps=RING_SP,
            out=dq_b), warmup=1, iters=5),
        "ring_bwd_dkv": time_ms(lambda: ra.ring_fold_bwd_dkv_reference(
            q, k, v, mask, lse, delta, do, None, None, RING_SP, 0,
            steps=RING_SP, out=(dk_b, dv_b)), warmup=1, iters=5),
    }
    # The whole ring (the launches and the plain ops around them) beside
    # the library's fused attention over the whole sequence with the same
    # key mask: the same work on both sides.
    key_mask = mask.bool()[:, None, None, :]
    ring = InProcessRing(RING_SP)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def ring_fwd_bwd():
        ring_attention(qg, kg, vg, key_mask, ring).backward(do)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, attn_mask=key_mask,
                                       scale=1.0 / d ** 0.5).backward(do)

    with torch.no_grad():
        ring_ms = time_ms(lambda: ring_attention(q, k, v, key_mask, ring))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=key_mask, scale=1.0 / d ** 0.5))
        sdpa_back_to_back_ms = time_back_to_back_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=key_mask, scale=1.0 / d ** 0.5))
    ring_fwd_bwd_ms = time_ms(ring_fwd_bwd)
    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    bounds = _ring_bounds(b, h, s, sb, d)
    registers = {r["kernel"].replace("_fold", ""): r["registers"]
                 for r in ptxas["ring_ptxas"]}
    # One library call computes dQ, dK and dV together: SDPA's backward
    # over the whole ring's work (its forward + backward less its forward),
    # beside the pair's kernel time over the ring (one dQ and one dK/dV
    # launch).
    library_bwd_ms = sdpa_fwd_bwd_ms - sdpa_ms
    pair_ms = ms["ring_bwd_dq"] + ms["ring_bwd_dkv"]
    table = {}
    for n in RING_KERNELS:
        bound = bounds["fused"][n]
        table[n] = {
            "ms": ms[n], "back_to_back_ms": back_to_back_ms[n],
            "plain_ms": plain_ms[n],
            "library_ms": sdpa_ms if n == "ring_fwd" else None,
            "library_back_to_back_ms": (sdpa_back_to_back_ms
                                        if n == "ring_fwd" else None),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bytes": bound["bytes"], "flops": bound["flops"],
            "share_of_bound": bound["bound_ms"] / ms[n],
            "ring_steps_a_launch": RING_SP,
            "registers": registers[n],
        }
        if n in one_step_ms:
            step = bounds["step"][n]
            table[n].update(one_step_ms=one_step_ms[n],
                            one_step_bound_ms=step["bound_ms"],
                            one_step_share_of_bound=step["bound_ms"]
                            / one_step_ms[n])
        if n != "ring_fwd":
            table[n].update(library_bwd_ms=library_bwd_ms,
                            pair_ms=pair_ms)
    emit("ring_kernels", timing="path_shape", sp=RING_SP, table=table,
         whole_ring={"ring_fwd_ms": ring_ms, "sdpa_fwd_ms": sdpa_ms,
                     "ring_fwd_bwd_ms": ring_fwd_bwd_ms,
                     "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
                     "sdpa_bwd_ms": library_bwd_ms,
                     "dq_dkv_pair_ms": pair_ms})
    return {"errors": errors, "table": table}


def ring_lm_run(slice_step_ms) -> dict:
    """BERT-base masked-LM through ``cli train --seq_parallelism 4`` (the
    in-process ring on one card, K5 in every attention) for STEPS steps on
    the slice phase's corpus, with the eval at the end."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )

    b, _, s, _ = SHAPE
    lengths, docs = _slice_docs()
    rows = len(docs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tokens")
        create_text_token_dataset(path, docs, seq_len=s, pack=False)
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--seq_parallelism", str(RING_SP), "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda",
        ])
        launches = {k: ops.LAUNCHES[k] for k in ops.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    steps = result["steps"]
    step_ms = statistics.median(result["step_ms"][4:])
    valid_tokens = int(sum(min(int(n), s) for n in lengths))
    eval_batches = -(-rows // b)
    fields = {
        "sp": RING_SP, "steps": steps, "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "flash_slice_step_ms_median_5_20": slice_step_ms,
        "tokens_per_sec": b * s / (step_ms / 1e3),
        "valid_tokens_per_sec": valid_tokens / steps / (step_ms / 1e3),
        "peak_memory_allocated_bytes": peak,
        "eval_masked_token_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
        "launches": launches, "train_seconds": result["train_time"],
        "model_params": result["model_params"],
    }
    emit("ring_lm", **fields)
    if steps != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"ran {steps} steps, expected {STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError("loss did not fall over the run")
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"eval covered {fields['eval_rows']} rows of "
                           f"{rows}")
    # Each kernel folds the whole ring in one launch a layer.
    want = {"ring_fwd": LAYERS * (STEPS + eval_batches),
            "ring_bwd_dq": LAYERS * STEPS,
            "ring_bwd_dkv": LAYERS * STEPS,
            "fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    wrong = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if wrong:
        raise RuntimeError(f"launches (got, expected) {wrong}")
    return {"launches": {k: launches[k] for k in RING_KERNELS}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args(argv).phases.split(",")
    t0 = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import lance_distributed_training_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = probe()
    ptxas = build() if set(phases) - {"probe"} else None
    timing = kernels() if "kernels" in phases else None
    sliced = slice_run() if "slice" in phases else None
    if "trainer" in phases:
        trainer_run(card, sliced["step_ms"] if sliced else None)
    launches = sliced["launches"] if sliced else None
    k1 = image_kernels() if "image_kernels" in phases else None
    k2 = jpeg_kernels() if "jpeg_kernels" in phases else None
    pixel = coeff = None  # the classification phases' figures
    if "classification" in phases:
        pixel = classification_run()
        launches = {**(launches or {}), **pixel["launches"]}
    if "device_decode" in phases:
        coeff = classification_run(device_decode=True)
        launches = {**(launches or {}), **coeff["launches"]}
    k3 = token_kernels() if "token_kernels" in phases else None
    if "causal_lm" in phases:
        launches = {**(launches or {}), **causal_lm_run()["launches"]}
    k5 = ring_kernels(ptxas) if "ring_kernels" in phases else None
    if "ring_lm" in phases:
        ring = ring_lm_run(sliced["step_ms"] if sliced else None)
        launches = {**(launches or {}), **ring["launches"]}
    loaders = {}  # K1's and K2's launches under the loader phases
    if "map_style" in phases:
        loaders["map_style"] = map_style_run(
            coeff["fields"] if coeff else None)["launches"]
    if "folder" in phases:
        loaders["folder"] = folder_run(
            pixel["fields"] if pixel else None)["launches"]
    if "pretrained_placement" in phases:
        loaders["pretrained_placement"] = pretrained_placement_run()[
            "launches"]
    emit("done", phases=phases, seconds=time.monotonic() - t0)
    if set(phases) != set(PHASES):
        return 0  # a partial run prints no result
    print(card["smi"], flush=True)
    table = [{
        "name": f"flash_attention_{name}", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": timing["errors"][name], **timing["table"][name],
    } for name in ("fwd", "bwd_dq", "bwd_dkv")]
    table.append({
        "name": "image_normalize", "route": "cuda", "source": IMAGE_SOURCE,
        "replaces": IMAGE_REPLACES, "launches": launches["image_normalize"],
        **{f"launches_{phase}": counts["image_normalize"]
           for phase, counts in loaders.items()},
        "max_abs_err": 0.0, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None, "share_of_bound": k1["share_of_bound"],
        "copy_ms": k1["copy_ms"],
        "registers": {r["kernel"]: r["registers"]
                      for r in ptxas["image_ptxas"]},
    })
    table.append({
        "name": "jpeg_decode", "route": "cuda", "source": JPEG_SOURCE,
        "replaces": JPEG_REPLACES, "launches": launches["jpeg_decode"],
        **{f"launches_{phase}": counts["jpeg_decode"]
           for phase, counts in loaders.items()},
        "max_abs_err": 0.0, "ms": k2["ms"],
        "back_to_back_ms": k2["back_to_back_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "share_of_bound": k2["share_of_bound"],
        "registers": {r["kernel"]: r["registers"]
                      for r in ptxas["jpeg_ptxas"]},
    })
    for name in ("token_pack", "token_unpack"):
        row = k3["table"][name]
        table.append({
            "name": name, "route": "cuda", "source": TOKEN_SOURCE,
            "replaces": TOKEN_REPLACES[name], "launches": launches[name],
            "check_launches": k3["check_launches"][name],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "share_of_bound": row["share_of_bound"],
            "launch_floor_ms": row["launch_floor_ms"],
            "registers": {r["kernel"]: r["registers"]
                          for r in ptxas["token_ptxas"]}[name],
        })
    for name in RING_KERNELS:
        table.append({
            "name": name, "route": "cuda", "source": RING_SOURCE,
            "replaces": RING_REPLACES, "launches": launches[name],
            "max_abs_err": k5["errors"][name], **k5["table"][name],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
