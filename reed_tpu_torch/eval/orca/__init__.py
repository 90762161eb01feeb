"""ORCA graphlet node-orbit counting: the C++ core (orca.cpp and
orbit5_table.h, copied from reed_tpu/eval/orca/) and a ctypes binding.

Replaces the reference's vendored ORCA
(molecule/eval_src/evaluation/orca/orca.cpp + orcamodule.cpp): the same
CLI contract (`orca node 4 in.txt std`) and a direct in-process API. g++
builds the shared library and the binary at first use into the port's
gitignored `_build/` directory, each named by a hash of the sources and
flags and written under a temporary name, then renamed, so processes that
build at once never load half a file. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from reed_tpu_torch._build import BUILD_DIR

_SRC_DIR = Path(__file__).resolve().parent
_SOURCES = ("orca.cpp", "orbit5_table.h")
_FLAGS = {"lib": ("-O2", "-std=c++17", "-shared", "-fPIC", "-DORCA_SHARED"),
          "bin": ("-O2", "-std=c++17")}

NUM_ORBITS_4 = 15
NUM_ORBITS_5 = 73


def _target(kind: str) -> Path:
    digest = hashlib.sha256(b"".join((_SRC_DIR / s).read_bytes() for s in _SOURCES))
    digest.update(" ".join(_FLAGS[kind]).encode())
    name = "liborca" if kind == "lib" else "orca"
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{'.so' if kind == 'lib' else ''}"


def _build(kind: str) -> str:
    """The library ('lib') or the binary ('bin'), compiled if missing."""
    out = _target(kind)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *_FLAGS[kind], "-o", str(tmp), str(_SRC_DIR / "orca.cpp")],
                           check=True)
            os.replace(tmp, out)  # atomic: readers never see half a file
        finally:
            tmp.unlink(missing_ok=True)
    return str(out)


@functools.cache
def _lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(_build("lib"))
    handle.orca_count_node_orbits.restype = ctypes.c_int
    handle.orca_count_node_orbits.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    return handle


def orca_binary_path() -> str:
    """Path to the compiled CLI (subprocess-compatible with the reference)."""
    return _build("bin")


def _count(max_k: int, num_orbits: int, n: int, edges) -> np.ndarray:
    edges = np.ascontiguousarray(np.asarray(edges, np.int32).reshape(-1, 2))
    out = np.zeros((n, num_orbits), np.int64)
    rc = _lib().orca_count_node_orbits(max_k, int(n), len(edges), edges.reshape(-1),
                                       out.reshape(-1))
    if rc != 0:
        raise ValueError(f"orca failed with code {rc}")
    return out


def count_node_orbits4(n: int, edges) -> np.ndarray:
    """Node orbit counts for graphlets up to 4 nodes: [n, 15] int64.

    edges: [m, 2] int array of undirected edges (duplicates/self-loops
    ignored)."""
    return _count(4, NUM_ORBITS_4, n, edges)


def count_node_orbits5(n: int, edges) -> np.ndarray:
    """Node orbit counts for graphlets up to 5 nodes: [n, 73] int64
    (Przulj atlas orbits 0..72, matching `orca node 5`)."""
    return _count(5, NUM_ORBITS_5, n, edges)
