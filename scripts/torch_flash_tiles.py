#!/usr/bin/env python3
"""Try other tiles or another source of the flash-attention kernels on the card, beside the stock build.

Copies ``ops/csrc/flash_attn.cu`` (or ``--source``, another version of it
with the same C interface) with ``constexpr int`` members of its config
structs rewritten, builds the copy with the port's ``nvcc`` flags beside
the stock source, and prints both builds' ``-Xptxas -v`` figures.
Then it runs ``chip_smoke.py``'s kernels phase (every kernel against its
plain version in both modes, the bit-identical repeat, the timings at
``[32, 12, 512, 64]`` bf16) once per library in turns: stock, variant,
variant, stock. The last line is one JSON object with each run's times.
Run from the root of a checkout on a machine with a card:

    python3 scripts/torch_flash_tiles.py --set 'DqCfg.BN=D == 64 ? 128 : 64'
    python3 scripts/torch_flash_tiles.py --source old/flash_attn.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from lance_distributed_training_tpu_torch.ops import _build, flash  # noqa: E402


def rewrite(source: str, assignment: str) -> str:
    """``STRUCT.MEMBER=EXPR``: replace that ``constexpr int`` member's value."""
    target, expr = assignment.split("=", 1)
    struct, member = target.split(".")
    body = re.search(rf"struct {struct} {{(.*?)\n}};", source, re.S)
    if body is None:
        raise ValueError(f"no struct {struct} in the source")
    new_body, n = re.subn(rf"(constexpr int {member} = )[^;]+;",
                          lambda m: m.group(1) + expr.strip() + ";", body.group(1))
    if n != 1:
        raise ValueError(f"{struct} has {n} members named {member}")
    return source[:body.start(1)] + new_body + source[body.end(1):]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--set", action="append", default=[],
                        metavar="STRUCT.MEMBER=EXPR")
    parser.add_argument("--source", default=None,
                        help="the variant's source (default: the stock one)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    source = Path(args.source or _build.CSRC_DIR / "flash_attn.cu").read_text()
    for assignment in args.set:
        source = rewrite(source, assignment)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    variant_cu = out_dir / "flash_attn_variant.cu"
    variant_cu.write_text(source)
    variant_so = out_dir / f"libflash_attn_variant_{os.getpid()}.so"
    nvcc = subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(variant_so), str(variant_cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    card = chip_smoke.probe()
    stock = flash._library()  # builds the stock source meanwhile
    report, _ = nvcc.communicate()
    if nvcc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variant:\n{report}")
    variant = flash.bind_library(ctypes.CDLL(str(variant_so)))
    ptxas = {"stock": chip_smoke._ptxas_kernels(_build.build_report("flash_attn")["ptxas"]),
             "variant": chip_smoke._ptxas_kernels(report)}
    for name, lib in (("stock", stock), ("variant", variant)):
        for row in ptxas[name]:
            row["dynamic_smem_bytes"] = lib.ldt_flash_smem_bytes(
                chip_smoke.KERNEL_IDS[row["kernel"]], row["head_dim"])
    chip_smoke.emit("tiles", set=args.set, source=args.source, ptxas=ptxas)
    runs = []
    for name, lib in (("stock", stock), ("variant", variant), ("variant", variant),
                      ("stock", stock)):
        flash._lib = lib
        result = chip_smoke.kernels()
        runs.append({"library": name, "errors": result["errors"],
                     "ms": {k: row["ms"] for k, row in result["table"].items()}})
    flash._lib = stock
    print(card["smi"], flush=True)
    print(json.dumps({"set": args.set, "source": args.source, "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
