"""The port's checker over the JAX package and over the port.

Both analyzers run once over the JAX package with the repo's
``pyproject.toml`` table (a module-scoped fixture: each run takes tens of
seconds); their ``--json`` reports must be equal but for the timing
fields. The port's checker over the port, with its own
``analysis/ldt-check.toml`` and its empty baseline, must exit 0.
"""

import io
import json
from pathlib import Path

import pytest

from lance_distributed_training_tpu.analysis import check_main as jax_check
from lance_distributed_training_tpu_torch.analysis import (
    check_main as port_check,
)
from lance_distributed_training_tpu_torch.analysis.config import (
    PORT_CONFIG,
    load_port_config,
    resolve_config,
)
from test_torch_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# What varies from run to run.
TIMING = ("wall_time_ms", "parse_ms", "model_build_ms")


def _json_report(check, argv) -> tuple:
    out = io.StringIO()
    rc = check(argv, out=out)
    report = json.loads(out.getvalue())
    return rc, {k: v for k, v in report.items() if k not in TIMING}


@pytest.fixture(scope="module")
def jax_package_reports():
    argv = ["--root", str(ROOT), "--json", "--no-baseline"]
    return _json_report(jax_check, argv), _json_report(port_check, argv)


def test_both_checkers_report_the_same_over_the_jax_package(
        jax_package_reports):
    (jax_rc, jax_report), (port_rc, port_report) = jax_package_reports
    assert (port_rc, port_report) == (jax_rc, jax_report)
    assert jax_report["files_checked"] > 100


def test_the_torch_forms_are_inert_on_the_jax_package(jax_package_reports):
    (_, jax_report), (_, port_report) = jax_package_reports
    torch_ids = {"LDT402", "LDT802", "LDT1711", "LDT1713", "LDT1714"}
    assert not [f for f in port_report["findings"]
                if f["rule"] in torch_ids]
    assert port_report["findings"] == jax_report["findings"]


def test_the_port_check_over_the_port_is_clean_against_an_empty_baseline():
    root, config = resolve_config(None)
    baseline = json.loads((Path(root) / config.baseline).read_text())
    assert baseline == {"version": 1, "findings": []}
    out = io.StringIO()
    rc = port_check([], out=out)
    assert rc == 0, out.getvalue()
    assert out.getvalue().startswith("ldt check: clean")


def test_the_port_table_maps_every_jax_key_to_the_port():
    """Every key of the repo's [tool.ldt-check] table is in the port's,
    with each path pointing into the port's package."""
    import tomllib

    jax_table = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["ldt-check"]
    port_table = tomllib.loads(Path(PORT_CONFIG).read_text())[
        "tool"]["ldt-check"]
    assert set(jax_table) <= set(port_table)
    assert set(port_table) - set(jax_table) == {"boundary-paths",
                                                 "launch-sites"}

    def paths(value):
        if isinstance(value, str):
            return [value] if "/" in value else []
        if isinstance(value, list):
            return [p for v in value for p in paths(v)]
        if isinstance(value, dict):
            return [p for k, v in value.items()
                    for p in paths(k) + paths(v)]
        return []

    for key, value in port_table.items():
        for path in paths(value):
            assert path.startswith("lance_distributed_training_tpu_torch/"), \
                (key, path)
    config = load_port_config()
    for pattern in config.hot_paths + config.device_hot_paths:
        assert list(ROOT.glob(pattern)), pattern
    assert set(config.dispatch) == {
        k.replace("lance_distributed_training_tpu/",
                  "lance_distributed_training_tpu_torch/")
        for k in jax_table["dispatch"]}


def test_resolve_config_reads_a_root_table_else_the_port_table(tmp_path):
    root, config = resolve_config(str(ROOT))
    assert root == str(ROOT)
    assert config.paths == ["lance_distributed_training_tpu"]
    root, config = resolve_config(str(tmp_path))
    assert root == str(tmp_path)
    assert config.paths == ["lance_distributed_training_tpu_torch"]
    root, config = resolve_config(None)
    assert root == str(ROOT)
    assert config.launch_sites and config.boundary_paths
