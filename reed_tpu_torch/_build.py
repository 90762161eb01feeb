"""Build the port's CUDA sources and load them with ctypes.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, `_build/lib<name>-<hash>.so`, at first use.
The hash covers the source and the flags, so an edited source is rebuilt and
a stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "port's CUDA kernels are built from source")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that have no current library.

    One nvcc per source, all started together. Returns each compiled
    source's compiler output (ptxas register and shared-memory report);
    raises RuntimeError naming the source when nvcc fails."""
    todo = [n for n in (sources() if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))  # atomic: readers never see half a file
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
