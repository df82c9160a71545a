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
    }
    assert expected <= set(result["imported"])
    assert result["banned"] == []
