"""The port's compile/transfer sanitizer and its join with LDT1713.

A site is a kernel launcher or a model forward (its def line); a new
abstract signature after the first call is a post-warmup compile. The
witness has JAX's schema, so JAX's loader reads it, and the port's
``check --compile-witness`` marks an LDT1713 hazard reproduced (a second
shape after warmup) or ``witness_pruned`` (one shape, many calls).
"""

import importlib.util
import io
import json
import os
from pathlib import Path

import pytest
import torch

from lance_distributed_training_tpu.analysis.cli import load_compile_witness
from lance_distributed_training_tpu_torch.analysis import check_main
from lance_distributed_training_tpu_torch.utils import compiletrack
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def recorder():
    saved = compiletrack.snapshot()
    compiletrack.reset()
    compiletrack.enable()
    yield compiletrack
    compiletrack.restore(saved)


_PYPROJECT = """\
[tool.ldt-check]
paths = ["pkg"]
disable = []
baseline = ".ldt-baseline.json"
queue-paths = []
content-paths = []
mesh-axes = ["data"]
device-hot-paths = []
hot-paths = []
static-funnels = ["*_quantum"]
launch-sites = ["pkg/ops.py::launch_*"]

[tool.ldt-check.dispatch]
"""

_OPS = """\
import torch

from lance_distributed_training_tpu_torch.utils import compiletrack


def launch_kernel(x, rows=None):
    if compiletrack.enabled():
        compiletrack.track_launch(x, rows=rows)
    return x * 2
"""

_STEP = """\
import torch

from .ops import launch_kernel


def step(batch, lengths):
    return launch_kernel(batch["x"][:len(lengths)])
"""


def _tree(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (tmp_path / "pkg" / "ops.py").write_text(_OPS)
    (tmp_path / "pkg" / "step.py").write_text(_STEP)
    (tmp_path / "pyproject.toml").write_text(_PYPROJECT)
    spec = importlib.util.spec_from_file_location(
        "ldt_probe_ops", tmp_path / "pkg" / "ops.py")
    ops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ops)
    return ops


def _check(tmp_path, witness) -> tuple:
    out = io.StringIO()
    rc = check_main(["--root", str(tmp_path), "--compile-witness",
                     str(witness)], out=out)
    return rc, out.getvalue()


def test_a_second_shape_after_warmup_reproduces_the_hazard(recorder,
                                                           tmp_path):
    ops = _tree(tmp_path)
    for n in (4, 4, 3):
        ops.launch_kernel(torch.zeros(n, 8))
    site = f"{tmp_path}/pkg/ops.py:6"
    assert recorder.sites() == {site: {"calls": 3, "compiles": 2,
                                       "post_warmup": 1}}
    path = recorder.dump(str(tmp_path / "w.json"))
    rc, text = _check(tmp_path, path)
    assert rc == 1, text
    assert "pkg/step.py:7:12: LDT1713" in text
    assert "[witness: this launch site saw a new signature" in text
    assert "1/1 runtime jit sites match static jit sites, 1 recompiled" \
        in text


def test_one_shape_marks_the_hazard_witness_pruned(recorder, tmp_path):
    ops = _tree(tmp_path)
    for _ in range(3):
        ops.launch_kernel(torch.zeros(4, 8), rows=4)
    path = recorder.dump(str(tmp_path / "w.json"))
    rc, text = _check(tmp_path, path)
    assert rc == 0, text
    assert "LDT1713" in text and "[witness-pruned]" in text
    assert "0 recompiled post-warmup" in text


def test_the_witness_has_jax_schema_and_jax_loader_reads_it(recorder,
                                                            tmp_path):
    ops = _tree(tmp_path)
    ops.launch_kernel(torch.zeros(2, 2))
    compiletrack.track_transfer("h2d", 128)
    compiletrack.track_transfer("d2h", 8)
    compiletrack.track_build("image", 3.5, False)
    path = recorder.dump(str(tmp_path / "w.json"))
    data = json.loads(Path(path).read_text())
    assert set(data) == {"version", "compiles", "transfers", "builds"}
    assert data["builds"] == {"image": {"seconds": 3.5, "cached": False}}
    loaded = load_compile_witness(path, str(tmp_path))
    assert loaded["compiles"] == {"pkg/ops.py:6": {
        "calls": 1, "compiles": 1, "post_warmup": 0}}
    assert [e["count"] for e in loaded["transfers"]["h2d"].values()] == [1]
    assert [e["bytes"] for e in loaded["transfers"]["d2h"].values()] == [8]
    assert compiletrack.DEFAULT_WITNESS_PATH == "compile-witness-torch.json"


def test_the_port_launchers_record_under_their_static_launch_sites(
        recorder):
    from lance_distributed_training_tpu_torch.analysis.concmodel import (
        build_program,
    )
    from lance_distributed_training_tpu_torch.analysis.config import (
        resolve_config,
    )
    from lance_distributed_training_tpu_torch.analysis.core import (
        parse_modules,
    )
    from lance_distributed_training_tpu_torch.analysis.meshmodel import (
        build_mesh_model,
    )
    from lance_distributed_training_tpu_torch.ops import (
        flash_attention,
        normalize_flip,
    )

    images = torch.randint(0, 255, (2, 8, 8, 3), dtype=torch.uint8)
    for _ in range(2):
        normalize_flip(images, torch.tensor([True, False]))
    q = torch.randn(1, 2, 16, 8, dtype=torch.bfloat16, requires_grad=True)
    flash_attention(q, q, q).float().sum().backward()
    witness = {"compiles": recorder.sites()}
    root, config = resolve_config(None)
    rel = {}
    for site, entry in witness["compiles"].items():
        path, _, line = site.rpartition(":")
        rel[f"{os.path.relpath(path, root)}:{line}"] = entry
    names = {k.split("/")[-1] for k in rel}
    assert {n.split(":")[0] for n in names} == {"image.py", "flash.py"}
    modules, _, _ = parse_modules(root, config)
    model = build_mesh_model(build_program(modules, config), config)
    receipt = model.witness_receipt({"compiles": rel, "transfers": {}})
    assert receipt["runtime_sites"] == 4  # K1, FA fwd, dQ, dK/dV
    assert receipt["matched_sites"] == 4
    assert receipt["recompiled_sites"] == 0


def test_disabled_records_nothing(recorder):
    compiletrack.disable()
    compiletrack.track_launch(torch.zeros(1))
    compiletrack.track_forward(torch.nn.Linear(2, 2), torch.zeros(1, 2))
    # The hooks are guarded by enabled(); the recorder itself counts.
    assert set(compiletrack.sites()) == {
        compiletrack.def_site(torch.nn.Linear.forward),
        f"{__file__}:{test_disabled_records_nothing.__code__.co_firstlineno}",
    }
