#!/usr/bin/env python3
"""Can ``chip_smoke.py``'s parallel phase see a wrong layout? A check on the CPU.

Copies the port and ``chip_smoke.py`` into a work directory and runs the
phase's layouts there at a small size (``bert_small``, sequence 256,
global batch 4, two gloo ranks on the CPU, eight for ``tp8``) through the
phase's own
functions: ``_parallel_ranks`` (the ranks' ``cli train`` runs),
``_dp_reference`` (the in-process data-parallel step) and
``_cosine_fields``. It runs the tree as it is (every layout), then one
copy for each entry of ``MUTATIONS``, a layout broken on purpose by a
one-line edit (its layout only). Each run prints one JSON line a layout:
the first loss, the loss after the first update and the first global
gradient norm against the data-parallel step (relative), the least update
cosine over the parameters of ``PARALLEL_COS_NUMEL`` elements or more,
and which of the phase's limits the layout breaks. A sound tree breaks
none; a mutation should break at least one. Run from the root of a
checkout (no card needed; about fifteen minutes):

    python3 scripts/torch_parallel_mutations.py [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "lance_distributed_training_tpu_torch"

# name -> (layout, file in the copy, line as it is, line broken)
MUTATIONS = {
    "tp_backward_all_reduce_dropped": (
        "tp", f"{PACKAGE}/parallel/comm.py",
        "        return all_reduce(grad, ctx.group), None\n",
        "        return grad, None\n"),
    "zero_gather_after_update_dropped": (
        "zero2", f"{PACKAGE}/parallel/layout.py",
        "        for e in self.entries:\n            if e.view:\n",
        "        for e in ():\n            if e.view:\n"),
    "ep_other_ranks_experts": (
        "ep", f"{PACKAGE}/parallel/layout.py",
        '                module.expert_start = (topo.index["model"]\n',
        '                module.expert_start = ((1 - topo.index["model"])\n'),
    # tp8's whole attention: each rank's gradient of the attention output
    # is its own block's, repeated, instead of the blocks all-gathered.
    "tp8_scatter_backward_not_gathered": (
        "tp8", f"{PACKAGE}/parallel/comm.py",
        "        return all_gather(grad, ctx.group, grad.dim() - 1), None\n",
        "        return torch.cat([grad] * dist.get_world_size(ctx.group), "
        "-1), None\n"),
}

# Runs in the copy: the phase's functions at the small size.
_PHASE_RUN = r"""
import json, os, sys, tempfile
import chip_smoke as cs
from lance_distributed_training_tpu_torch.data import (
    create_text_token_dataset)

cs.SHAPE = (4, 4, 256, 64)
cs.PARALLEL_MODEL, cs.PARALLEL_DEVICE = "bert_small", "cpu"
names = sys.argv[1].split(",")
cs.PARALLEL_LAYOUTS = {k: cs.PARALLEL_LAYOUTS[k] for k in names}
cs.PARALLEL_BATCH = {k: cs.SHAPE[0] for k in cs.PARALLEL_BATCH}
_, docs = cs._slice_docs()
with tempfile.TemporaryDirectory() as tmp:
    for name in names:
        path = cs._layout_data(tmp, name)
        if not os.path.exists(path):
            rows = cs._layout_steps(name) * cs._layout_batch(name)
            create_text_token_dataset(path, docs[:rows],
                                      seq_len=cs.SHAPE[2], pack=False)
    every = cs._parallel_ranks(tmp)
    for name in names:
        ranks = every[name]
        ref = cs._dp_reference(name, tmp, ranks)
        after = cs._grad_accum(name)
        losses = ranks[0]["losses"]
        row = {"layout": name,
               "first_loss": cs._rel(losses[0], ref["losses"][0]),
               "updated_loss": cs._rel(losses[after], ref["losses"][after]),
               "grad_norm": max(cs._rel(r["grad_norm"], ref["grad_norm"])
                                for r in ranks)}
        row.update(cs._cosine_fields(ref["cosines"]))
        row["breaks"] = [k for k, tol in (
            ("first_loss", cs.PARALLEL_LOSS_TOL),
            ("updated_loss", cs.PARALLEL_LOSS_TOL),
            ("grad_norm", cs.PARALLEL_NORM_TOL)) if not row[k] <= tol]
        if not row["update_cosine_min"] >= cs.PARALLEL_COS_MIN:
            row["breaks"].append("update_cosine_min")
        print("ROW " + json.dumps(row), flush=True)
"""


def _copy(dest: Path) -> None:
    shutil.copytree(ROOT / PACKAGE, dest / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dest / "chip_smoke.py")


def _run(tree: Path, layouts: str) -> list:
    proc = subprocess.run([sys.executable, "-c", _PHASE_RUN, layouts],
                          cwd=tree, capture_output=True, text=True,
                          timeout=1200)
    rows = [json.loads(line[4:]) for line in proc.stdout.splitlines()
            if line.startswith("ROW ")]
    if proc.returncode or not rows:
        raise RuntimeError(f"{tree.name}: exit {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", default=None,
                        help="where the copies go (default: a temporary "
                             "directory, removed after)")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(dir=args.workdir) as work:
        work = Path(work)
        runs = [("sound", ",".join(("tp", "fsdp", "zero2", "ep", "pp",
                                    "tp8")), None)]
        runs += [(name, layout, (path, old, new))
                 for name, (layout, path, old, new) in MUTATIONS.items()]
        failed = []
        for name, layouts, edit in runs:
            tree = work / name
            _copy(tree)
            if edit is not None:
                path, old, new = edit
                source = (tree / path).read_text()
                if source.count(old) != 1:
                    raise RuntimeError(f"{name}: the line to break is not "
                                       f"in {path} once")
                (tree / path).write_text(source.replace(old, new))
            for row in _run(tree, layouts):
                row["tree"] = name
                print(json.dumps(row), flush=True)
                if (name == "sound") == bool(row["breaks"]):
                    failed.append(f"{name} {row['layout']}")
        print(json.dumps({"ok": not failed, "unexpected": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
