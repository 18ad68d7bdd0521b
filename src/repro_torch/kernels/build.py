"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source compiles on first use into its own shared library with a plain C
interface, loaded with :mod:`ctypes`. Libraries are named by a hash of their
source and the shared headers (``csrc/*.cuh``), so an edited kernel rebuilds
and an unchanged one loads at once.
Nothing here runs at import time.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` when that is set, else
``build/repro_torch/`` at the root of the source checkout that holds this
package (listed in ``.gitignore``). An installed copy outside a checkout has
no such root and must be given the variable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["CSRC_DIR", "NVCC_FLAGS", "BUILD_SECONDS", "build_dir", "sources", "build",
           "build_all", "load"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each source's nvcc run in this process (builds run together).
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    """Where kernel libraries are built: ``$REPRO_TORCH_BUILD_DIR``, else
    ``<checkout>/build/repro_torch`` when this package lies in a checkout's
    ``src/``. Raises otherwise rather than write outside the package."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    raise RuntimeError(
        f"{pkg} is not in a source checkout: set REPRO_TORCH_BUILD_DIR to a "
        "writable directory for the CUDA kernel builds"
    )


def sources() -> Sequence[str]:
    """Kernel names: one per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only on a machine "
            "with the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    # The shared headers (csrc/*.cuh) are part of every kernel's source.
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu",
                                            *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name (every source by default)
    whose library does not exist yet: one ``nvcc`` per source, all started
    together. The compiler's report (registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``."""
    names = sources() if names is None else names
    libs = {name: _lib_path(name) for name in names}
    jobs = []
    t0 = time.perf_counter()
    for name, lib in libs.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        with open(lib.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, lib, tmp, proc))
    pending = {name for name, *_ in jobs}
    while pending:
        for name, _, _, proc in jobs:
            if name in pending and proc.poll() is not None:
                BUILD_SECONDS[name] = time.perf_counter() - t0
                pending.discard(name)
        time.sleep(0.05)
    failed = []
    for name, lib, tmp, proc in jobs:
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                          + lib.with_suffix(".log").read_text())
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
