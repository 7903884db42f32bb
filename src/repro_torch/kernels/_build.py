"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into a shared library under ``build/kernels/`` at the repository
root, named by a hash of its source, the shared headers beside it
(``csrc/*.cuh``) and the flags, so an edited source or header never
loads a stale build. All missing libraries are compiled at once, one
``nvcc`` process per source, and loaded with :mod:`ctypes`; each build's
compiler output, with ptxas's registers and spills of every kernel, is
kept in :data:`LOGS`. Nothing happens at import: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
]

_loaded: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each source built by this process, by name
LOGS: Dict[str, str] = {}


def sources() -> List[Path]:
    """Every CUDA source of the port."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's kernels are built from source with the "
        "CUDA toolkit on the machine that has the card"
    )


def _library_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of its bytes, of every
    header (``*.cuh``) beside it (a source may include any of them) and
    of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: library path}``. Raises ``RuntimeError`` with the
    compiler's output when a source does not build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _library_path(src) for src in sources()}
    jobs = []
    for src in sources():
        lib = libs[src.stem]
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, tmp, lib, proc))
    failed = []
    for src, tmp, lib, proc in jobs:
        out, _ = proc.communicate()
        LOGS[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
