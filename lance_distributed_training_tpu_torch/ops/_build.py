"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/torch_kernels/`` at the root
of the checkout, named by the hash of its source and flags, and is loaded
with ``ctypes``. A build happens at the first CUDA use of a kernel and not
at import. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from ..utils import compiletrack

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "load_library",
           "build_library", "find_nvcc", "build_report"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
# Per source stem: {"seconds", "cached", "ptxas"} of the build this process did.
_reports: dict[str, dict] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the path, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels build from source at first use"
    )


def _target(stem: str) -> Path:
    source = CSRC_DIR / f"{stem}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.h")) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_library(stem: str) -> Path:
    """Compile ``csrc/<stem>.cu`` unless a library of the same hash exists;
    returns its path. The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside the library and for
    :func:`build_report`."""
    target = _target(stem)
    report = target.with_suffix(".ptxas.txt")
    if target.exists():
        ptxas = report.read_text() if report.exists() else ""
        _reports.setdefault(stem, {"seconds": 0.0, "cached": True, "ptxas": ptxas})
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")  # ldt: ignore[LDT1301] -- a per-process temp name for the nvcc output, renamed into place; no kernel result depends on it
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
    t0 = time.monotonic()  # ldt: ignore[LDT1301] -- times the build for its report; no kernel result depends on it
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0  # ldt: ignore[LDT1301] -- times the build for its report; no kernel result depends on it
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {stem}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    ptxas = proc.stdout + proc.stderr
    report.write_text(ptxas)
    os.replace(tmp, target)
    _reports[stem] = {"seconds": seconds, "cached": False, "ptxas": ptxas}
    return target


def load_library(stem: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<stem>.cu``; cached per process."""
    with _lock:
        lib = _libraries.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(stem)))
            _libraries[stem] = lib
            if compiletrack.enabled():
                report = _reports.get(stem, {})
                compiletrack.track_build(stem, report.get("seconds", 0.0),
                                         report.get("cached", True))
        return lib


def build_report(stem: str) -> Optional[dict]:
    """``{"seconds", "cached", "ptxas"}`` for a library this process built
    or found, else ``None``."""
    return _reports.get(stem)
