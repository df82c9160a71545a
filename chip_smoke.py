#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing one JSON line:

1. probe   — torch/CUDA versions, the card and its power limit; requires
             compute capability 9.0; turns TF32 off for f32 matmuls.
2. build   — compiles ``ops/csrc/flash_attn.cu`` for sm_90a and prints the
             build time and, from the ``-Xptxas -v`` report, registers,
             spills and shared memory of all six kernel builds (three
             kernels, head dims 64 and 128); fails on any spill of any
             of the three kernels (fwd, bwd_dq, bwd_dkv) at head dim 64.
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

Every check that fails raises, so the script exits non-zero. The last three
lines are the card's ``nvidia-smi`` name and power limit, the kernel table
as JSON, and ``{"ok": true, "device": {...}}``.
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

PHASES = ("probe", "build", "kernels", "slice")
SHAPE = (32, 12, 512, 64)  # B, H, S, D at BERT-base, seq 512
STEPS = 20
LAYERS = 12
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
TOL_O, TOL_LSE, TOL_GRAD_REL = 2e-2, 1e-3, 2e-2
SOURCE = "lance_distributed_training_tpu_torch/ops/csrc/flash_attn.cu"
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


def _ptxas_kernels(report: str) -> list:
    """Per kernel build in a ``-Xptxas -v`` report: registers, spill bytes
    and static shared memory."""
    rows, row = [], None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernelILi(\d+)E",
                             entry.group(1))
            row = None
            if name:
                row = {"kernel": name.group(1), "head_dim": int(name.group(2))}
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


def build() -> None:
    from lance_distributed_training_tpu_torch.ops import _build, flash

    t0 = time.monotonic()
    lib = flash._library()
    report = _build.build_report("flash_attn")
    kernels = _ptxas_kernels(report["ptxas"])
    for row in kernels:
        row["dynamic_smem_bytes"] = lib.ldt_flash_smem_bytes(
            KERNEL_IDS[row["kernel"]], row["head_dim"])
    emit("build", seconds=time.monotonic() - t0,
         nvcc_seconds=report["seconds"], cached=report["cached"],
         kernels=kernels)
    builds = {(r["kernel"], r["head_dim"]) for r in kernels}
    want = {(k, d) for k in KERNEL_IDS for d in flash.HEAD_DIMS}
    if builds != want or not all("registers" in r for r in kernels):
        raise RuntimeError(f"ptxas report covers {sorted(builds)}, "
                           f"expected {sorted(want)}")
    spills = [r for r in kernels if r["head_dim"] == 64
              and (r.get("spill_stores", 0) or r.get("spill_loads", 0))]
    if spills:
        raise RuntimeError(f"ptxas spills at head dim 64: {spills}")


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
    from lance_distributed_training_tpu_torch import cli
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
        for key in flash.LAUNCHES:
            flash.LAUNCHES[key] = 0
        result = cli.main([
            "train", "--dataset_path", path, "--task_type", "masked_lm",
            "--model_name", "bert_base", "--seq_len", str(s),
            "--flash_attention", "--batch_size", str(b),
            "--optimizer", "adamw", "--lr", "1e-4",
            "--max_steps", str(STEPS), "--epochs", "1", "--log_every", "5",
            "--device", "cuda",
        ])
        launches = dict(flash.LAUNCHES)
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
    if "build" in phases or "kernels" in phases or "slice" in phases:
        build()
    timing = kernels() if "kernels" in phases else None
    launches = slice_run()["launches"] if "slice" in phases else None
    if set(phases) != set(PHASES):
        return 0  # a partial run prints no result
    print(card["smi"], flush=True)
    table = [{
        "name": f"flash_attention_{name}", "route": "cuda",
        "source": SOURCE, "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": timing["errors"][name], **timing["table"][name],
    } for name in ("fwd", "bwd_dq", "bwd_dkv")]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
