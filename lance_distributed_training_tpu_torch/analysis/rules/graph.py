"""Graph-hygiene rule (LDT1601).

The unified loader graph (``data/graph.py``) exists because five
parallel source→decode→batch pipelines each had to be re-wired for every
new plane (cache, device-decode, token-pack, placement). The cheapest way
to regress to that world is one innocent-looking construction: a hot-path
module building a ``DataPipeline``/``MapStylePipeline``/
``FolderDataPipeline``/``RemoteLoader``/``FleetLoader`` directly instead of
composing a ``LoaderGraph`` — a sixth parallel loader nobody notices until
the next plane has to be wired six times.

Scoped to the ``hot-paths`` modules from ``[tool.ldt-check]``, with the
engine home modules exempt: ``data/pipeline.py`` and ``data/folder.py``
legitimately build inner ``DataPipeline`` instances (the per-epoch engine
beneath the map-style/folder loaders), ``service/client.py`` and
``fleet/balancer.py`` ARE the transport engines, and ``data/graph.py`` is
the one compile seam allowed to construct all five. Everywhere else, a
loader is a ``LoaderGraph`` composition; a deliberate exception can still
be grandfathered in the baseline or carry a reasoned
``# ldt: ignore[LDT1601]``.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from ..core import Finding, ModuleInfo, Rule, register

# The five engine classes whose direct construction means "a new parallel
# loader is being written".
_ENGINES = frozenset({
    "DataPipeline",
    "MapStylePipeline",
    "FolderDataPipeline",
    "RemoteLoader",
    "FleetLoader",
})

# Engine home modules (see module docstring) + the graph compile seam.
_EXEMPT = (
    "*data/pipeline.py",
    "*data/folder.py",
    "*data/graph.py",
    "*service/client.py",
    "*fleet/balancer.py",
)


@register
class GraphHygiene(Rule):
    id = "LDT1601"
    family = "graph"
    name = "graph-hygiene"
    description = (
        "hot-path modules: no direct construction of the five loader "
        "engines (DataPipeline/MapStylePipeline/FolderDataPipeline/"
        "RemoteLoader/FleetLoader) outside their home modules and "
        "data/graph.py — source→decode→batch compositions are LoaderGraph "
        "assemblies, so every new plane is wired exactly once"
    )

    def check_module(self, module: ModuleInfo, config) -> Iterable[Finding]:
        hot_paths = getattr(config, "hot_paths", [])
        if not any(fnmatch.fnmatch(module.relpath, p) for p in hot_paths):
            return
        if any(fnmatch.fnmatch(module.relpath, p) for p in _EXEMPT):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = None
            if isinstance(func, ast.Name):
                name = func.id
            elif isinstance(func, ast.Attribute):
                name = func.attr
            if name in _ENGINES:
                yield Finding(
                    self.id, module.relpath, node.lineno, node.col_offset,
                    f"{name}(...) constructed outside the loader graph — "
                    "compose a data/graph.py LoaderGraph (Source → Decode "
                    "→ Cache/Pool/Buffers/Prefetch → Transport → Place) "
                    "instead of wiring a parallel pipeline; the engines "
                    "are the graph's compile targets, not an API",
                )
