"""The port's static checker against JAX's, rule by rule, and its torch
forms.

Every test of ``tests/test_analysis.py`` that runs the analyzer on a
snippet or a fixture tree (``tests/fixtures/*``) runs again here with
``analyze`` replaced by a comparison: each call runs JAX's
``lance_distributed_training_tpu.analysis.analyze`` and the port's
``lance_distributed_training_tpu_torch.analysis.analyze`` on the same
root and configuration, and their findings must be equal (rule id, path,
line, column, message and the witness flag). The JAX test's own
assertions then run on JAX's findings, so a case passes only when the two
checkers agree and the JAX test holds. The torch forms (LDT402, LDT802,
LDT1711, LDT1713, LDT1714) get snippets where they fire and where they do
not (a funnel, a reasoned ignore, JAX code).
"""

import ast
import textwrap
from pathlib import Path

import pytest

import lance_distributed_training_tpu.analysis as jax_analysis
import test_analysis as jax_tests
from lance_distributed_training_tpu.analysis import analyze as jax_analyze
from lance_distributed_training_tpu_torch.analysis import (
    CheckConfig,
    all_rules,
)
from lance_distributed_training_tpu_torch.analysis import (
    analyze as port_analyze,
)
from test_torch_threads import _one_torch_thread  # noqa: F401

JAX_TESTS = Path(jax_tests.__file__)


def _analyzer_tests() -> list:
    """The tests of test_analysis.py whose call graph reaches
    ``analyze``, that take no fixture beyond tmp_path/monkeypatch/capsys
    and that do not scan the whole repo (the repo-wide parity is
    tests/test_torch_analysis_repo.py's)."""
    tree = ast.parse(JAX_TESTS.read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def names(fn):
        out = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Name):
                out.add(n.id)
            elif isinstance(n, ast.Attribute):
                out.add(n.attr)
        return out

    memo: dict = {}

    def reaches(name, stack=()):
        if name not in memo:
            ns = names(funcs[name])
            memo[name] = "analyze" in ns or any(
                reaches(n, stack + (name,)) for n in ns
                if n in funcs and n not in stack and n != name
                and not n.startswith("test_"))
        return memo[name]

    out = []
    for name, fn in funcs.items():
        args = {a.arg for a in fn.args.args}
        if name.startswith("test_") and "_repo_" not in name \
                and args <= {"tmp_path", "monkeypatch", "capsys"} \
                and reaches(name):
            out.append(name)
    return out


def _key(f) -> tuple:
    return (f.rule, f.path, f.line, f.col, f.message, f.witness_pruned)


@pytest.mark.parametrize("name", _analyzer_tests())
def test_port_rules_equal_jax_rules_on_the_jax_fixtures(
        name, tmp_path, monkeypatch, capsys):
    compared = []

    def both(root, config):
        expected = jax_analyze(root, config)
        got = port_analyze(root, config)
        assert [_key(f) for f in got] == [_key(f) for f in expected], name
        compared.append(len(expected))
        return expected

    # The module's name and the package's (tests that import it locally).
    monkeypatch.setattr(jax_tests, "analyze", both)
    monkeypatch.setattr(jax_analysis, "analyze", both)
    fn = getattr(jax_tests, name)
    kwargs = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
              "capsys": capsys}
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    fn(**{p: kwargs[p] for p in params})
    assert compared, f"{name} never reached analyze"


def test_port_registry_is_jax_registry_plus_the_torch_forms():
    from lance_distributed_training_tpu.analysis import all_rules as jax_rules

    jax_ids = set(jax_rules())
    port = all_rules()
    assert jax_ids <= set(port)
    assert set(port) - jax_ids == {"LDT402", "LDT802", "LDT1711", "LDT1713",
                                   "LDT1714"}
    for rid in jax_ids:
        mine, theirs = port[rid], jax_rules()[rid]
        assert (mine.name, mine.description, mine.family) == (
            theirs.name, theirs.description, theirs.family)
    assert port["LDT402"].family == port["LDT401"].family
    assert port["LDT802"].family == port["LDT801"].family
    for rid in ("LDT1711", "LDT1713", "LDT1714"):
        assert port[rid].family == port["LDT1701"].family


# -- the torch forms ---------------------------------------------------------


def _torch_config(**kwargs):
    """Only the torch forms' knobs; every other family neutralised."""
    kwargs.setdefault("paths", ["."])
    kwargs.setdefault("queue_paths", [])
    kwargs.setdefault("content_paths", [])
    kwargs.setdefault("dispatch", {})
    kwargs.setdefault("resources", {})
    kwargs.setdefault("mesh_axes", ["data", "model", "seq", "pipe"])
    kwargs.setdefault("static_funnels", ["*_quantum"])
    kwargs.setdefault("sync_funnels", [])
    kwargs.setdefault("device_hot_paths", ["hot/*"])
    kwargs.setdefault("hot_paths", ["hot/*"])
    kwargs.setdefault("boundary_paths", ["port/*"])
    kwargs.setdefault("launch_sites", ["ops.py::launch_*",
                                       "net.py::*.forward"])
    return CheckConfig(**kwargs)


def run_torch(tmp_path, files, **kwargs):
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
    return port_analyze(str(tmp_path), _torch_config(**kwargs))


def ids(findings, prefix=""):
    return [(f.rule, f.path, f.line) for f in findings
            if f.rule.startswith(prefix)]


# LDT402: the import boundary.

def test_ldt402_flags_jax_imports_and_import_time_builds(tmp_path):
    got = run_torch(tmp_path, {"port/m.py": """\
        import jax
        import jax.numpy as jnp
        from flax import linen
        from lance_distributed_training_tpu.data import format
        import lance_distributed_training_tpu
        import triton
        from . import _build
        LIB = _build.load_library("image")

        def launch():
            import triton.language as tl
            return _build.load_library("image"), tl
    """})
    assert ids(got, "LDT402") == [("LDT402", "port/m.py", n)
                                  for n in (1, 2, 3, 4, 5, 6, 8)]


def test_ldt402_is_inert_outside_the_boundary_and_on_the_port_package(
        tmp_path):
    got = run_torch(tmp_path, {
        "jaxside/m.py": "import jax\nimport triton\n",
        "port/ok.py": """\
            import torch
            import lance_distributed_training_tpu_torch.ops
            from .ops import flash

            def launch():
                import triton
                return triton
        """})
    assert ids(got, "LDT402") == []


# LDT802: placement.

def test_ldt802_flags_h2d_copies_on_hot_paths(tmp_path):
    got = run_torch(tmp_path, {"hot/loader.py": """\
        import torch

        def put(batch, device):
            x = batch["image"].cuda()
            y = batch["label"].to(device, non_blocking=True)
            z = torch.as_tensor(batch["ids"], device="cuda")
            w = torch.from_numpy(batch["w"]).to(torch.device("cuda", 0))
            return x, y, z, w
    """})
    assert ids(got, "LDT802") == [("LDT802", "hot/loader.py", n)
                                  for n in (4, 5, 6, 7)]


def test_ldt802_silent_in_placement_cold_modules_dtype_casts_and_ignores(
        tmp_path):
    got = run_torch(tmp_path, {
        "hot/data/placement.py": """\
            import torch

            def put(batch, device):
                return batch["image"].to(device)
        """,
        "cold/model.py": """\
            import torch

            def put(x):
                return x.cuda()
        """,
        "hot/cast.py": """\
            import torch

            def cast(x, device):
                a = x.to(torch.bfloat16)
                b = x.to(device)  # ldt: ignore[LDT802] -- a constant table
                return a, b
        """,
        "hot/jaxside.py": """\
            import jax

            def put(x):
                return x.cuda()
        """})
    assert ids(got, "LDT802") == []


# LDT1711: undeclared axis.

def test_ldt1711_flags_undeclared_topology_keys_and_axis_keywords(tmp_path):
    got = run_torch(tmp_path, {"m.py": """\
        import torch

        def layout(topo, plan):
            g = topo.group["dtaa"]
            i, n = topo.index["data"], topo.size["modle"]
            plan.shard(fsdp_axis="sequence", axis="seq")
            return g, i, n
    """})
    assert ids(got, "LDT1711") == [("LDT1711", "m.py", 4), ("LDT1711", "m.py", 5),
                                   ("LDT1711", "m.py", 6)]
    messages = [f.message for f in got if f.rule == "LDT1711"]
    assert "'dtaa'" in messages[0] and "'modle'" in messages[1]
    assert "'sequence'" in messages[2]


def test_ldt1711_declared_keys_variables_reasoned_ignores_and_jax_silent(
        tmp_path):
    got = run_torch(tmp_path, {
        "m.py": """\
            import torch

            def layout(topo, axis):
                a = topo.group["seq"], topo.ranks["pipe"]
                b = topo.size[axis]
                c = topo.index["batch"]  # ldt: ignore[LDT1711] -- the batch group is data x seq
                return a, b, c
        """,
        "jaxside.py": """\
            import jax

            def f(topo):
                return topo.size["dtaa"]
        """})
    assert ids(got, "LDT1711") == []


def test_ldt1711_ignore_without_reason_stays_live(tmp_path):
    got = run_torch(tmp_path, {"m.py": """\
        import torch

        def f(topo):
            return topo.size["dtaa"]  # ldt: ignore[LDT1711]
    """})
    assert ids(got, "LDT1711") == [("LDT1711", "m.py", 4)]


# LDT1713: recompile hazard.

_OPS = """\
    import torch

    def launch_kernel(x, rows=None):
        return x
"""


def test_ldt1713_flags_shape_derived_sizes_reaching_a_launch_site(tmp_path):
    got = run_torch(tmp_path, {"ops.py": _OPS, "step.py": """\
        import torch
        from ops import launch_kernel

        def step(batch, lengths):
            n = len(lengths)
            x = batch["x"][:n]
            y = launch_kernel(x)
            z = launch_kernel(batch["x"], rows=len(lengths) * 2)
            w = launch_kernel(torch.zeros(n, 8, device="cuda"))
            return y, z, w
    """})
    assert ids(got, "LDT1713") == [("LDT1713", "step.py", n)
                                   for n in (7, 8, 9)]
    assert "launch site 'launch_kernel'" in got[0].message


def test_ldt1713_passthrough_shapes_funnels_ignores_and_other_calls_clean(
        tmp_path):
    got = run_torch(tmp_path, {"ops.py": _OPS, "step.py": """\
        import torch
        from ops import launch_kernel

        def rows_quantum(n):
            return -(-n // 64) * 64

        def step(batch, lengths):
            x = batch["x"]
            b, s = x.shape[:2]
            acc = torch.zeros(x.shape, device=x.device)
            y = launch_kernel(acc, rows=x.shape[0])
            z = launch_kernel(x, rows=rows_quantum(len(lengths)))
            n = len(lengths)
            w = launch_kernel(x[:n])  # ldt: ignore[LDT1713] -- eval's last batch, padded upstream
            v = torch.relu(x[:n])
            return y, z, w, v, b, s
    """})
    assert ids(got, "LDT1713") == []


def test_ldt1713_compile_witness_reproduces_and_prunes(tmp_path):
    files = {"ops.py": _OPS, "step.py": """\
        import torch
        from ops import launch_kernel

        def step(batch, lengths):
            return launch_kernel(batch["x"][:len(lengths)])
    """}
    site = f"ops.py:{3}"
    hot = {"compiles": {site: {"calls": 5, "compiles": 2,
                               "post_warmup": 1}}, "transfers": {}}
    steady = {"compiles": {site: {"calls": 5, "compiles": 1,
                                  "post_warmup": 0}}, "transfers": {}}
    reproduced = run_torch(tmp_path, files, compile_witness=hot)
    pruned = run_torch(tmp_path, files, compile_witness=steady)
    assert [f.witness_pruned for f in reproduced if f.rule == "LDT1713"] \
        == [False]
    assert "[witness:" in reproduced[0].message
    assert [f.witness_pruned for f in pruned if f.rule == "LDT1713"] == [True]


# LDT1714: hot-path host sync.

def test_ldt1714_flags_host_syncs_on_torch_values(tmp_path):
    got = run_torch(tmp_path, {"hot/step.py": """\
        import numpy as np
        import torch

        def step(model, batch, loss: torch.Tensor):
            out = model(batch).sum()
            a = out.item()
            b = loss.tolist()
            c = float(out)
            d = np.asarray(out.cpu())
            torch.cuda.synchronize()
            return a, b, c, d
    """})
    assert ids(got, "LDT1714") == [("LDT1714", "hot/step.py", n)
                                   for n in (6, 7, 8, 9, 9, 10)]


def test_ldt1714_funnels_metadata_host_tensors_cold_modules_and_ignores(
        tmp_path):
    got = run_torch(tmp_path, {
        "hot/step.py": """\
            import torch

            def drain(losses):
                return torch.stack(losses).tolist()

            def step(model, batch, device):
                out = model(batch)
                n = int(out.shape[0]) + out.size(1) + out.numel()
                t = torch.tensor([1.0, 2.0]).tolist()
                m = float(out.sum())  # ldt: ignore[LDT1714] -- once, at the end
                return n, t, m
        """,
        "cold/report.py": """\
            import torch

            def report(model, batch):
                return model(batch).sum().item()
        """,
        "hot/jaxside.py": """\
            import jax

            def f(x):
                torch_like = jax.numpy.sum(x)
                return torch_like.item()
        """}, sync_funnels=["drain"])
    assert ids(got, "LDT1714") == []


def test_ldt1714_ignore_without_reason_stays_live(tmp_path):
    got = run_torch(tmp_path, {"hot/step.py": """\
        import torch

        def step():
            torch.cuda.synchronize()  # ldt: ignore[LDT1714]
    """})
    assert ids(got, "LDT1714") == [("LDT1714", "hot/step.py", 4)]


def test_compile_witness_receipt_counts_d2h_at_declared_funnels(tmp_path):
    from lance_distributed_training_tpu_torch.analysis.concmodel import (
        build_program,
    )
    from lance_distributed_training_tpu_torch.analysis.core import (
        parse_modules,
    )
    from lance_distributed_training_tpu_torch.analysis.meshmodel import (
        build_mesh_model,
    )

    (tmp_path / "ops.py").write_text(textwrap.dedent(_OPS))
    (tmp_path / "trainer.py").write_text(textwrap.dedent("""\
        import torch

        def drain(losses):
            record()
            return torch.stack(losses).tolist()

        def loop(x):
            record()
            return x
    """))
    config = _torch_config(sync_funnels=["drain"])
    modules, _, _ = parse_modules(str(tmp_path), config)
    model = build_mesh_model(build_program(modules, config), config)
    witness = {
        "compiles": {"ops.py:3": {"calls": 4, "compiles": 1,
                                  "post_warmup": 0}},
        "transfers": {"d2h": {"trainer.py:4": {"count": 3, "bytes": 12},
                              "trainer.py:8": {"count": 1, "bytes": 4}},
                      "h2d": {}},
    }
    receipt = model.witness_receipt(witness)
    assert receipt == {"runtime_sites": 1, "matched_sites": 1,
                       "recompiled_sites": 0, "h2d_events": 0,
                       "d2h_events": 4, "d2h_at_funnels": 3}
