"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The library lands in
build/nbldpc_tpu_torch/ under the repository root, named by a hash of the
sources and flags: the first CUDA use builds it, and a changed source
builds a new one. Every C entry point returns cudaGetLastError() (or the
first CUDA error it met), and `check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nbldpc_tpu_torch"

# -fmad=false: no fused multiply-adds, so the kernels round like their
# plain PyTorch versions; no --use_fast_math, so expf/logf stay accurate.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every entry returns int, a cudaError_t)
SIGNATURES = {
    "cn_qspa_update": [_P, _P, _I, _I, _I, _I, _P],
    "qspa_resident_decode": [_P, _P, _P, _P,            # llr, hard, done, iters
                             _I, _I, _I, _I, _I, _I,    # B N M dc dv q
                             _P, _P, _P, _P, _P, _P,    # tables
                             _I, _I, _I, _P],           # iters, modes, stream
}

def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbldpc_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, file=sys.stderr, flush=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nbldpc_error_string.argtypes = [_I]
    lib.nbldpc_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().nbldpc_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
