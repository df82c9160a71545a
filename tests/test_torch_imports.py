"""The port imports neither JAX nor the JAX package.

Every module of ``lance_distributed_training_tpu_torch`` (and
``chip_smoke.py``, which drives it on the card, where JAX is not
installed) is imported in a fresh interpreter; neither ``jax`` nor
``lance_distributed_training_tpu`` may enter ``sys.modules`` on the way.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = textwrap.dedent(r'''
    import importlib, json, pkgutil, sys
    before = set(sys.modules)  # what the interpreter's start-up brought
    import lance_distributed_training_tpu_torch as port
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401
    banned = sorted(m for m in set(sys.modules) - before
                    if m == "jax" or m.startswith("jax.")
                    or m.startswith("jaxlib")
                    or m == "lance_distributed_training_tpu"
                    or m.startswith("lance_distributed_training_tpu."))
    print(json.dumps({"imported": names, "banned": banned}))
''')


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {
        "lance_distributed_training_tpu_torch.data.device_decode",
        "lance_distributed_training_tpu_torch.native.coeffs",
        "lance_distributed_training_tpu_torch.ops.jpeg_device",
        "lance_distributed_training_tpu_torch.ops.token_device",
        "lance_distributed_training_tpu_torch.data.token_pack",
        "lance_distributed_training_tpu_torch.ops.ring_attention",
        "lance_distributed_training_tpu_torch.parallel.ring_attention",
        "lance_distributed_training_tpu_torch.trainer",
        "lance_distributed_training_tpu_torch.cli",
        "lance_distributed_training_tpu_torch.data.filters",
        "lance_distributed_training_tpu_torch.data.folder",
        "lance_distributed_training_tpu_torch.data.authoring",
        "lance_distributed_training_tpu_torch.data.pipeline",
        "lance_distributed_training_tpu_torch.models.pretrained",
        "lance_distributed_training_tpu_torch.data.buffers",
        "lance_distributed_training_tpu_torch.data.placement",
        "lance_distributed_training_tpu_torch.data.workers",
        "lance_distributed_training_tpu_torch.data.cache",
        "lance_distributed_training_tpu_torch.obs.registry",
        "lance_distributed_training_tpu_torch.obs.spans",
        "lance_distributed_training_tpu_torch.obs.costs",
        "lance_distributed_training_tpu_torch.tune.tunable",
        "lance_distributed_training_tpu_torch.tune.policy",
        "lance_distributed_training_tpu_torch.tune.controller",
        "lance_distributed_training_tpu_torch.utils.leaktrack",
        "lance_distributed_training_tpu_torch.models.moe",
        "lance_distributed_training_tpu_torch.models.vit",
        "lance_distributed_training_tpu_torch.models.clip",
        "lance_distributed_training_tpu_torch.data.decode",
        "lance_distributed_training_tpu_torch.data.graph",
        "lance_distributed_training_tpu_torch.data.schedule",
        "lance_distributed_training_tpu_torch.utils.wiretrack",
        "lance_distributed_training_tpu_torch.utils.retry",
        "lance_distributed_training_tpu_torch.obs.tracectx",
        "lance_distributed_training_tpu_torch.obs.lineage",
        "lance_distributed_training_tpu_torch.obs.slo",
        "lance_distributed_training_tpu_torch.obs.http",
        "lance_distributed_training_tpu_torch.obs.critpath",
        "lance_distributed_training_tpu_torch.service.protocol",
        "lance_distributed_training_tpu_torch.service.goldens",
        "lance_distributed_training_tpu_torch.service.server",
        "lance_distributed_training_tpu_torch.service.client",
        "lance_distributed_training_tpu_torch.fleet.jobs",
        "lance_distributed_training_tpu_torch.fleet.coordinator",
        "lance_distributed_training_tpu_torch.fleet.agent",
        "lance_distributed_training_tpu_torch.fleet.balancer",
        "lance_distributed_training_tpu_torch.fleet.chaos",
        "lance_distributed_training_tpu_torch.parallel.comm",
        "lance_distributed_training_tpu_torch.parallel.sharding",
        "lance_distributed_training_tpu_torch.parallel.layout",
        "lance_distributed_training_tpu_torch.parallel.pipeline_parallel",
        "lance_distributed_training_tpu_torch.utils.lockorder",
        "lance_distributed_training_tpu_torch.utils.compiletrack",
        "lance_distributed_training_tpu_torch.analysis",
        "lance_distributed_training_tpu_torch.analysis.cli",
        "lance_distributed_training_tpu_torch.analysis.concmodel",
        "lance_distributed_training_tpu_torch.analysis.config",
        "lance_distributed_training_tpu_torch.analysis.core",
        "lance_distributed_training_tpu_torch.analysis.meshmodel",
        "lance_distributed_training_tpu_torch.analysis.ownermodel",
        "lance_distributed_training_tpu_torch.analysis.protomodel",
        "lance_distributed_training_tpu_torch.analysis.reporters",
        "lance_distributed_training_tpu_torch.analysis.rules",
    } | {f"lance_distributed_training_tpu_torch.analysis.rules.{name}"
         for name in _RULE_FILES}
    assert expected <= set(result["imported"])
    assert result["banned"] == []


_RULE_FILES = ("compat", "concurrency", "copies", "determinism", "dispatch",
               "graph", "jit_purity", "lockorder", "meshrules", "obs",
               "ownership", "padding", "persistence", "placement",
               "protocol", "purity", "resources", "sharedstate", "tunables",
               "wireproto")


def test_every_jax_module_has_a_counterpart_in_the_port():
    """The two package trees hold the same modules, but for JAX's version
    shim (``parallel/_compat.py``), which has nothing to port."""
    def modules(package):
        root = ROOT / package
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if "__pycache__" not in p.parts}

    missing = modules("lance_distributed_training_tpu") - modules(
        "lance_distributed_training_tpu_torch")
    assert missing == {"parallel/_compat.py"}
