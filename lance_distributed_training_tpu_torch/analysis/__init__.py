"""Static analysis for distributed-training invariants (``ldt check``).

The PyTorch port's copy of ``lance_distributed_training_tpu/analysis``:
every module and rule of the JAX checker, which give the JAX checker's
findings on JAX code, plus the torch forms of the rules that only make
sense for JAX (LDT402 import boundary, LDT802 placement, LDT1711 axes,
LDT1713 recompiles, LDT1714 host syncs), inert on JAX code. Its witnesses
are the port's ``utils/lockorder.py``, ``leaktrack.py``, ``wiretrack.py``
and ``compiletrack.py``. The port's own configuration is
``ldt-check.toml`` beside this file (:func:`~.config.resolve_config`);
run it with ``python -m lance_distributed_training_tpu_torch.cli check``.

An AST-based lint subsystem with project-specific rules: plan determinism
(LDT001-003), jit purity (LDT101-102), concurrency hygiene (LDT201-203),
resource ownership (LDT301), jax-compat enforcement (LDT401), cross-module
wire-protocol consistency (LDT501), the whole-program concurrency model
(``concmodel.py``): lock-order deadlock cycles (LDT1001), cross-thread
unsynchronized shared state (LDT1002), dispatcher exhaustiveness over the
protocol's MSG_* vocabulary (LDT1003) — and, layered on the same
ProgramInfo without a second parse (``ownermodel.py``), the
ownership/lifecycle dataflow (LDT1201 leak-on-path, LDT1202
double-release, LDT1203 use-after-release over the
``[tool.ldt-check.resources]`` vocabulary) and the content-purity taint
rule (LDT1301 over ``[tool.ldt-check.content-paths]``). Two runtime
witnesses close the evidence loop: the lock-order sanitizer
(``utils/lockorder.py`` + ``ldt check --lock-witness``) and the
resource-lease sanitizer (``utils/leaktrack.py`` + ``ldt check
--leak-witness``), each corroborating or pruning its static family.
``ldt graph --dot`` renders the thread/lock topology, ``--ownership``
adds resource nodes and leak edges. Configured under ``[tool.ldt-check]``
in pyproject.toml; per-line suppression via ``# ldt: ignore[LDTxxx]``
(LDT10xx/12xx/13xx ignores require a ``-- reason``); grandfathered
findings live in a baseline file.

Programmatic surface::

    from lance_distributed_training_tpu_torch.analysis import (
        analyze, resolve_config)
    root, config = resolve_config(None)  # the port, its own table
    findings = analyze(root, config)
"""

from .config import (  # noqa: F401
    CheckConfig,
    load_config,
    load_port_config,
    resolve_config,
)
from .core import (  # noqa: F401
    Finding,
    ModuleInfo,
    Rule,
    all_rules,
    analyze,
    analyze_project,
    register,
)
from .cli import check_main, graph_main  # noqa: F401
from .concmodel import ProgramInfo, build_program  # noqa: F401
from .ownermodel import OwnerModel, build_owner_model  # noqa: F401

__all__ = [
    "CheckConfig",
    "Finding",
    "ModuleInfo",
    "OwnerModel",
    "ProgramInfo",
    "Rule",
    "all_rules",
    "analyze",
    "analyze_project",
    "build_owner_model",
    "build_program",
    "check_main",
    "graph_main",
    "load_config",
    "load_port_config",
    "register",
    "resolve_config",
]
