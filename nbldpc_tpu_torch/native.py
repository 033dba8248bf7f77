"""ctypes binding to the repository's native host library, native/nbldpc_host.cpp.

The library is host C++ (GF tables, GF row reduction, PEG BFS, syndrome), the same
source the JAX package builds with the same g++ flags. The port builds its
own copy, build/nbldpc_tpu_torch/libnbldpc_host.so, so it never loads a
file that another package's build is writing. `build` is safe to call from
many processes at once: it holds an exclusive lock on a lock file beside
the library, skips the build when the library is newer than its source, and
otherwise compiles into a file of its own process and renames it into
place, so no process ever loads a half-written library.

    from nbldpc_tpu_torch import native
    exp, log, inv, mul = native.gf_tables(16)
    R, rank, pivots = native.gf_row_reduce(H, 16, mul, inv)

Every wrapper checks its arguments' shapes and ranges before it passes a
pointer, and calls the library or raises: there is no fallback. The numpy
loops that the library replaces live beside their callers as plain
versions (encode.gf_row_reduce_plain, codegen.bfs_dist_plain), which the
tests hold equal to it.
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
    lib.nb_gf_row_reduce.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i32p]
    lib.nb_gf_row_reduce.restype = ctypes.c_int
    lib.nb_peg_bfs.argtypes = [
        ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, ctypes.c_int, i32p]
    lib.nb_peg_bfs.restype = None
    lib.nb_syndrome.argtypes = [
        ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, i32p, i32p]
    lib.nb_syndrome.restype = None
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


def _symbols(a, q: int, what: str, shape: tuple | None = None) -> np.ndarray:
    """a as a contiguous int32 array of GF(q) symbols (of `shape` if given),
    checked before the library indexes its tables with it."""
    a = np.ascontiguousarray(a, dtype=np.int32)
    if shape is not None and a.shape != shape:
        raise ValueError(f"{what}: shape {a.shape}, expected {shape}")
    if a.size and (a.min() < 0 or a.max() >= q):
        raise ValueError(f"{what}: values outside GF({q})")
    return a


def gf_row_reduce(H: np.ndarray, q: int, mul: np.ndarray, inv: np.ndarray) -> tuple:
    """Row reduction of H [m, n] over GF(q), pivoting on the first nonzero
    row of each column: (R [m, n] int32, rank, pivot columns [rank] int32).
    R's pivots are 1 with zeros above and below them."""
    R = _symbols(H, q, "H").copy()
    if R.ndim != 2:
        raise ValueError(f"H must be a matrix, got shape {R.shape}")
    mul, inv = _symbols(mul, q, "mul", (q, q)), _symbols(inv, q, "inv", (q,))
    m, n = R.shape
    piv = np.zeros(m, np.int32)
    rank = library().nb_gf_row_reduce(q, m, n, R.reshape(-1), mul.reshape(-1), inv, piv)
    return R, int(rank), piv[:rank].copy()


def peg_bfs(vn_ptr, vn_adj, cn_ptr, cn_adj, n: int, m: int, v: int) -> np.ndarray:
    """Distance [m] int32 from variable v to every check over a Tanner graph
    in CSR form (vn_ptr [n + 1] / vn_adj: each variable's checks, cn_ptr
    [m + 1] / cn_adj: each check's variables); INT32_MAX where unreachable."""
    vn_ptr, cn_ptr = (np.ascontiguousarray(a, np.int32) for a in (vn_ptr, cn_ptr))
    vn_adj, cn_adj = (np.ascontiguousarray(a, np.int32) for a in (vn_adj, cn_adj))
    for ptr, adj, rows, cols, what in ((vn_ptr, vn_adj, n, m, "vn"),
                                       (cn_ptr, cn_adj, m, n, "cn")):
        if (ptr.shape != (rows + 1,) or ptr[0] != 0 or np.any(np.diff(ptr) < 0)
                or ptr[-1] != adj.size):
            raise ValueError(f"{what}_ptr is no CSR row pointer of {adj.size} entries")
        if adj.size and (adj.min() < 0 or adj.max() >= cols):
            raise ValueError(f"{what}_adj: node ids outside [0, {cols})")
    if not 0 <= v < n:
        raise ValueError(f"variable {v} outside [0, {n})")
    dist = np.zeros(m, np.int32)
    library().nb_peg_bfs(n, m, vn_ptr, vn_adj, cn_ptr, cn_adj, v, dist)
    return dist


def syndrome(q: int, n: int, row_cols, row_vals, mul: np.ndarray, cw) -> np.ndarray:
    """H c over GF(q) for H given by its rows (row_cols, row_vals, as
    CodeSpec holds them) and words cw [..., n]: the syndromes [..., m]
    int32, 0 where a check is satisfied."""
    mul = _symbols(mul, q, "mul", (q, q))
    row_ptr = np.cumsum([0] + [len(c) for c in row_cols]).astype(np.int32)
    row_col = np.ascontiguousarray(np.concatenate(row_cols), np.int32)
    row_val = _symbols(np.concatenate(row_vals), q, "row_vals")
    if row_col.size and (row_col.min() < 0 or row_col.max() >= n):
        raise ValueError(f"row_cols: columns outside [0, {n})")
    cw = _symbols(cw, q, "cw")
    if cw.shape[-1:] != (n,):
        raise ValueError(f"cw must be [..., {n}], got {cw.shape}")
    words = cw.reshape(-1, n)
    out = np.zeros((words.shape[0], len(row_cols)), np.int32)
    for b in range(words.shape[0]):
        library().nb_syndrome(q, len(row_cols), row_ptr, row_col, row_val,
                              mul.reshape(-1), np.ascontiguousarray(words[b]), out[b])
    return out.reshape(cw.shape[:-1] + (len(row_cols),))
