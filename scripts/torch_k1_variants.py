#!/usr/bin/env python3
"""Time variants of K1 (``ops/csrc/image.cu``) on the card, beside the stock build.

Each ``--variant NAME:K1Cfg.MEMBER=EXPR[;K1Cfg.MEMBER=EXPR...]`` is a copy
of the source with those ``constexpr int`` members of ``struct K1Cfg``
rewritten (the rows route's threads, rows a chunk, stages, CTAs an SM);
each ``--source NAME:PATH`` is another version of ``image.cu`` built as it
is (an earlier commit's, for one). All are built at once with the port's
``nvcc`` flags; each is held against the plain version bit for bit at the
timed shapes and at ``(2, 7, 48, 3)``, each with a random flip mask, then
timed back to back (CUDA events around 20 launches, median of 5) in
turns: stock, the others, the others in reverse, stock. The timed shapes
are the classification path's ``[512, 224, 224, 3]`` (beside a
device-to-device copy of the same bytes) and ``WIDE_SHAPE``, rows too wide
for the rows route's chunk. The last line is one JSON object with each
build's ``-Xptxas -v`` figures and each turn's times. Run from the root of
a checkout on a machine with a card:

    python3 scripts/torch_k1_variants.py --variant 'rows16:K1Cfg.kRows=16' \
        --source parent:old/image.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from lance_distributed_training_tpu_torch.ops import _build, image  # noqa: E402
from torch_flash_tiles import rewrite  # noqa: E402

WIDE_SHAPE = (8, 128, 4096, 3)  # W % 16 == 0, too wide a row for a chunk


def build_variants(sources: dict) -> dict:
    """``{name: (library, ptxas rows)}``, one nvcc process a source."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in sources.items():
        cu = out_dir / f"image_{name}.cu"
        cu.write_text(source)
        so = out_dir / f"libimage_{name}_{os.getpid()}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        built[name] = (image.bind_library(ctypes.CDLL(str(so))),
                       chip_smoke._ptxas_kernels(
                           report, r"(image_normalize\w*)_kernel"))
    return built


def check_and_time(lib, gen, dev, timed: dict, copy: tuple) -> dict:
    """Bits against the plain version, then each timed shape's time, and
    the copy's."""
    import torch

    image._lib = lib
    checks = [(tuple(x.shape), x, mask) for x, mask in timed.values()]
    x = torch.randint(0, 256, (2, 7, 48, 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    checks.append((tuple(x.shape), x, torch.rand(2, generator=gen,
                                                 device=dev) < 0.5))
    for shape, x, mask in checks:
        got = image.normalize_flip(x, mask)
        want = image.random_flip_reference(
            image.normalize_images_reference(x), mask)
        torch.cuda.synchronize()
        if not chip_smoke._bits_equal(got, want):
            raise RuntimeError(f"K1 build differs from the plain version at "
                               f"{shape}")
    src, dst = copy
    row = {f"{name}_ms": chip_smoke.time_back_to_back_ms(
        lambda x=x, mask=mask: image.normalize_flip(x, mask))
        for name, (x, mask) in timed.items()}
    row["copy_ms"] = chip_smoke.time_back_to_back_ms(lambda: dst.copy_(src))
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME:K1Cfg.MEMBER=EXPR[;...]")
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME:PATH")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    stock = (_build.CSRC_DIR / "image.cu").read_text()
    sources, specs = {"stock": stock}, {"stock": []}
    for spec in args.variant:
        name, sets = spec.split(":", 1)
        specs[name] = sets.split(";")
        sources[name] = stock
        for assignment in specs[name]:
            sources[name] = rewrite(sources[name], assignment)
    for spec in args.source:
        name, path = spec.split(":", 1)
        specs[name] = path
        sources[name] = Path(path).read_text()
    card = chip_smoke.probe()
    built = build_variants(sources)
    chip_smoke.emit("k1_variants", variants=specs,
                    ptxas={k: rows for k, (_, rows) in built.items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = {}
    for name, shape in (("path", chip_smoke.IMAGE_SHAPE), ("wide", WIDE_SHAPE)):
        x = torch.randint(0, 256, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
        timed[name] = (x, torch.rand(shape[0], generator=gen, device=dev) < 0.5)
    x, mask = timed["path"]
    moved = x.numel() * 3 + mask.numel()  # as the image_kernels phase counts
    src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
    copy = (src, torch.empty_like(src))
    runs = []
    for name in list(specs) + list(specs)[::-1]:
        row = {"variant": name, **check_and_time(built[name][0], gen, dev,
                                                 timed, copy)}
        row["share_of_bound"] = (1e3 * moved / chip_smoke.PEAK_BYTES
                                 / row["path_ms"])
        runs.append(row)
        chip_smoke.emit("k1_variants", **row)
    print(card["smi"], flush=True)
    print(json.dumps({"variants": specs, "wide_shape": list(WIDE_SHAPE),
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
