"""``check`` and ``graph`` through the port's CLI against JAX's.

Over the JAX package (``--root`` the repo, its ``pyproject.toml``
table), ``python -m lance_distributed_training_tpu_torch.cli check`` and
``graph`` print what the JAX CLI prints. Over the port, ``graph --dot
--mesh --loader`` renders its launch sites, and ``check --list-rules``
lists the torch forms; neither subcommand raises "not yet ported".
"""

from pathlib import Path

import pytest

from lance_distributed_training_tpu.cli import main as jax_main
from lance_distributed_training_tpu_torch.cli import main as port_main
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _run(main, argv, capsys) -> tuple:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_check_through_both_clis_prints_the_same(capsys):
    argv = ["check", "--root", str(ROOT), "--no-baseline"]
    jax = _run(jax_main, argv, capsys)
    port = _run(port_main, argv, capsys)
    assert port == jax
    assert jax[0] == 0 and "ldt check: clean" in jax[1]


@pytest.mark.parametrize("flags", [
    ["--ownership", "--protocol", "--loader", "--mesh"],
    ["--dot", "--loader", "--mesh"],
])
def test_graph_through_both_clis_prints_the_same(flags, capsys):
    argv = ["graph", "--root", str(ROOT)] + flags
    jax = _run(jax_main, argv, capsys)
    port = _run(port_main, argv, capsys)
    assert port == jax
    assert jax[0] == 0 and "loader" in jax[1]


def test_port_graph_renders_the_port(capsys):
    rc, text = _run(port_main, ["graph", "--mesh", "--loader"], capsys)
    assert rc == 0
    assert "torch forms:" in text
    for site in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "normalize_flip",
                 "decode_coeff_batch", "pack_token_batch",
                 "ring_fold_fwd"):
        assert f"launch {site} " in text, site
    assert "[UNDECLARED]" not in text
    assert "loader train-iterable:" in text
    rc, dot = _run(port_main, ["graph", "--dot", "--mesh", "--loader"],
                   capsys)
    assert rc == 0 and dot.startswith("digraph ldt_concurrency {")
    assert "shape=box3d" in dot and "cluster_loader_" in dot


def test_port_list_rules_has_the_torch_forms(capsys):
    rc, text = _run(port_main, ["check", "--list-rules"], capsys)
    assert rc == 0
    for rid in ("LDT402", "LDT802", "LDT1711", "LDT1713", "LDT1714",
                "LDT1703", "LDT1704"):
        assert any(line.startswith(f"{rid}  ") for line in text.splitlines())
