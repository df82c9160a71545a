#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. probe   — torch/CUDA versions, the card and its power limit; requires
             compute capability 9.0; turns TF32 off for f32 matmuls.
2. build   — compiles ``ops/csrc/flash_attn.cu`` and ``ops/csrc/image.cu``
             for sm_90a and the native JPEG decoder, all at once, and prints
             the build times and, from the ``-Xptxas -v`` reports,
             registers, spills and shared memory of all six flash kernel
             builds (three kernels, head dims 64 and 128) and of K1; fails
             on any spill of any of the three flash kernels at head dim 64
             and on any spill of K1.
3. kernels — runs the fwd, bwd_dq and bwd_dkv kernels at the BERT-base
             shapes [32, 12, 512, 64] bf16, (a) non-causal with padding
             segments and (b) causal, against their plain PyTorch versions
             in f32 on the same inputs, checks that a second launch on the
             same inputs gives the same bits, and times them beside the
             plain versions and ``scaled_dot_product_attention``; the
             backward's sum (dQ + dK/dV + the plain di op) is printed beside
             SDPA's backward alone (its fwd+bwd less its fwd, one call).
4. slice   — trains BERT-base masked-LM (768/12/12/3072, S = 512, batch 32)
             for 20 steps through ``cli train --flash_attention`` on a seeded
             token dataset, after checking flash attention against the dense
             attention path on a small model.
5. image_kernels — K1 (``ops/csrc/image.cu``) against its plain PyTorch
             version on the card, bit for bit, at [512, 224, 224, 3] and at
             ragged shapes, with and without a flip mask; times it (CUDA
             events around 20 launches back to back, median of 5) beside the
             plain version and a device-to-device copy of the same bytes;
             the bound takes the card's published memory rate.
6. classification — trains ResNet-50 (224 px, 101 classes, global batch
             512, SGD lr 0.05 momentum 0.9, flips, eval at the end) for 20
             steps through ``cli train`` on a seeded FOOD-101-shaped JPEG
             dataset (``create_synthetic_classification_dataset``, 20
             batches of rows; each row labelled by its image, so that
             there is something to learn), host-decoded by the native
             decoder or PIL; the eval pass covers every row once.

Every check that fails raises, so the script exits non-zero. The last three
lines are the card's ``nvidia-smi`` name and power limit, the kernel table
as JSON (the three flash kernels and K1, each with its launches on its
path), and ``{"ok": true, "device": {...}}``.
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

PHASES = ("probe", "build", "kernels", "slice", "image_kernels",
          "classification")
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
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
IMAGE_BATCH, IMAGE_CLASSES = 512, 101
UNIQUE_IMAGES = 64  # distinct images (and labels) of the classification set
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

    from lance_distributed_training_tpu_torch.native import jpeg
    from lance_distributed_training_tpu_torch.ops import _build, flash, image

    t0 = time.monotonic()
    with ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(_build.build_library, stem)
                   for stem in ("flash_attn", "image")]
        native = pool.submit(jpeg.native_available)
        for future in futures:
            future.result()
        native_ok = native.result()
    lib = flash._library()
    image._library()
    report = _build.build_report("flash_attn")
    kernels = _ptxas_kernels(report["ptxas"])
    for row in kernels:
        row["dynamic_smem_bytes"] = lib.ldt_flash_smem_bytes(
            KERNEL_IDS[row["kernel"]], row["head_dim"])
    image_report = _build.build_report("image")
    image_rows = _ptxas_kernels(image_report["ptxas"],
                                r"(image_normalize)_kernel")
    emit("build", seconds=time.monotonic() - t0,
         nvcc_seconds=report["seconds"], cached=report["cached"],
         kernels=kernels, image_nvcc_seconds=image_report["seconds"],
         image_kernels=image_rows, native_decoder=native_ok,
         native_decoder_error=jpeg.build_error())
    builds = {(r["kernel"], r["head_dim"]) for r in kernels}
    want = {(k, d) for k in KERNEL_IDS for d in flash.HEAD_DIMS}
    if builds != want or not all("registers" in r for r in kernels):
        raise RuntimeError(f"ptxas report covers {sorted(builds)}, "
                           f"expected {sorted(want)}")
    spills = [r for r in kernels if r["head_dim"] == 64 and _spilled(r)]
    if spills:
        raise RuntimeError(f"ptxas spills at head dim 64: {spills}")
    if len(image_rows) != 1 or "registers" not in image_rows[0]:
        raise RuntimeError(f"ptxas report of image.cu: {image_rows}")
    if _spilled(image_rows[0]):
        raise RuntimeError(f"ptxas spills in K1: {image_rows}")
    return {"image_ptxas": image_rows[0]}


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
    # Yardstick only: no single library call computes dQ or dK/dV alone.
    backward = {"dq_dkv_di_plain_op_ms": ms["bwd_dq"] + ms["bwd_dkv"] + di_ms,
                "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd}
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


def slice_run() -> dict:
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_text_token_dataset,
    )
    from lance_distributed_training_tpu_torch.ops import flash

    _dense_vs_flash_check()
    b, _, s, _ = SHAPE
    vocab = 30522
    rng = np.random.default_rng(0)
    n_docs = b * STEPS
    lengths = rng.integers(128, s + 1, n_docs)
    # Zipf(1.2) ranks folded onto ids 2..vocab-1 (0 is padding, 1 the mask).
    docs = [2 + (rng.zipf(1.2, int(n)) - 1) % (vocab - 2) for n in lengths]
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
            "--device", "cuda",
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
    return {"launches": launches}


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

    # Every uint8 value in every channel, then the path's shape and ragged
    # ones, each with no mask, a random mask and an all-set mask.
    every = torch.arange(256, dtype=torch.uint8, device=dev)
    every = every.repeat_interleave(3).reshape(1, 16, 16, 3)
    cases = [("every_value", every)]
    for shape in (IMAGE_SHAPE, (1, 224, 224, 3), (1, 33, 17, 3),
                  (3, 33, 17, 3), (2, 7, 48, 3)):
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        cases.append(("x".join(map(str, shape)), x))
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


def classification_run() -> dict:
    """ResNet-50 classification through ``cli train`` for STEPS steps."""
    import torch
    from lance_distributed_training_tpu_torch import cli, ops
    from lance_distributed_training_tpu_torch.data import (
        create_synthetic_classification_dataset,
    )

    rows = IMAGE_BATCH * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "food")
        t0 = time.monotonic()
        _learnable_dataset(os.path.join(tmp, "drawn"), path, rows)
        author_s = time.monotonic() - t0
        os.environ["LDT_METRICS_PATH"] = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "classification",
            "--model_name", "resnet50", "--image_size", "224",
            "--num_classes", str(IMAGE_CLASSES),
            "--batch_size", str(IMAGE_BATCH), "--max_steps", str(STEPS),
            "--epochs", "1", "--log_every", "5", "--device", "cuda",
        ])
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    steps = result["steps"]
    step_ms = statistics.median(result["step_ms"][4:])
    eval_batches = -(-rows // IMAGE_BATCH)
    fields = {
        "batch": IMAGE_BATCH, "steps": steps, "first_loss": losses[0],
        "last5_mean_loss": statistics.fmean(losses[-5:]), "losses": losses,
        "step_ms_median_5_20": step_ms,
        "images_per_sec_steps_6_20": result["images_per_sec"],
        "images_per_sec_whole_run": result["images_per_sec_whole_run"],
        "loader_stall_pct": result["loader_stall_pct"],
        "peak_memory_allocated_bytes": peak,
        "eval_accuracy": result.get("eval_accuracy"),
        "eval_rows": result.get("eval_rows"), "dataset_rows": rows,
        "eval_batches": eval_batches,
        "decoder": result["decoder_arm"],
        "image_normalize_launches": launches["image_normalize"],
        "dataset_seconds": author_s, "train_seconds": result["train_time"],
        "total_seconds": result["total_time"],
        "model_params": result["model_params"],
    }
    emit("classification", **fields)
    if steps != STEPS or len(losses) != STEPS:
        raise RuntimeError(f"ran {steps} steps, expected {STEPS}")
    if not all(np.isfinite(losses)):
        raise RuntimeError("non-finite loss")
    if not fields["last5_mean_loss"] < losses[0]:
        raise RuntimeError("loss did not fall over the run")
    if fields["eval_rows"] != rows:
        raise RuntimeError(f"eval covered {fields['eval_rows']} rows of "
                           f"{rows}")
    if launches["image_normalize"] != STEPS + eval_batches:
        raise RuntimeError(f"K1 launched {launches['image_normalize']} "
                           f"times, expected {STEPS + eval_batches}")
    return {"launches": {"image_normalize": launches["image_normalize"]}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args(argv).phases.split(",")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import lance_distributed_training_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = probe()
    ptxas = build() if set(phases) - {"probe"} else None
    timing = kernels() if "kernels" in phases else None
    launches = slice_run()["launches"] if "slice" in phases else None
    k1 = image_kernels() if "image_kernels" in phases else None
    if "classification" in phases:
        launches = {**(launches or {}), **classification_run()["launches"]}
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
        "max_abs_err": 0.0, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None, "share_of_bound": k1["share_of_bound"],
        "registers": ptxas["image_ptxas"]["registers"],
    })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
