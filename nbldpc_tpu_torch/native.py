"""ctypes binding to the repository's native host library, native/nbldpc_host.cpp.

The library is host C++ (GF tables, GF row reduction, PEG BFS), the same
source the JAX package builds with the same g++ flags. The port builds its
own copy, build/nbldpc_tpu_torch/libnbldpc_host.so, so it never loads a
file that another package's build is writing. `build` is safe to call from
many processes at once: it holds an exclusive lock on a lock file beside
the library, skips the build when the library is newer than its source, and
otherwise compiles into a file of its own process and renames it into
place, so no process ever loads a half-written library.

    from nbldpc_tpu_torch import native
    exp, log, inv, mul = native.gf_tables(16)
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

from nbldpc_tpu_torch.gf import PRIM_POLY

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "nbldpc_host.cpp"
BUILD_DIR = ROOT / "build" / "nbldpc_tpu_torch"
LIBRARY = BUILD_DIR / "libnbldpc_host.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _fresh() -> bool:
    return LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime


def build() -> Path:
    """Build the library unless a fresh one exists; return its path. Raises
    subprocess.CalledProcessError when g++ fails, OSError without g++."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libnbldpc_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh():
            tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, LIBRARY)
            finally:
                tmp.unlink(missing_ok=True)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.nb_gf_tables.argtypes = [ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p]
    lib.nb_gf_tables.restype = ctypes.c_int
    return lib


def gf_tables(q: int) -> tuple:
    """(exp [2(q-1)], log [q], inv [q], mul [q, q]) int32 of GF(q) over the
    port's primitive polynomial, from the native library (log[0] is 0)."""
    if q not in PRIM_POLY:
        raise ValueError(f"q={q} unsupported; need a power of two in 2..256")
    exp = np.zeros(2 * (q - 1), np.int32)
    log = np.zeros(q, np.int32)
    inv = np.zeros(q, np.int32)
    mul = np.zeros(q * q, np.int32)
    if library().nb_gf_tables(q, PRIM_POLY[q], exp, log, inv, mul) != 0:
        raise ValueError(f"polynomial {PRIM_POLY[q]:#b} is not primitive for q={q}")
    return exp, log, inv, mul.reshape(q, q)
