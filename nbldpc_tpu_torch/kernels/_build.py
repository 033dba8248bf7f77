"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own nvcc process for sm_90a, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes. The library lands in
build/nbldpc_tpu_torch/ under the repository root, named by a hash of the
sources, the headers they share (csrc/*.cuh) and the flags: the first CUDA
use builds it, and a changed source builds a new one. Every C entry point
returns cudaGetLastError() (or the first CUDA error it met), and `check`
raises on a nonzero code.
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
_F = ctypes.c_float
# C signatures: name -> argtypes (every entry returns int, a cudaError_t)
SIGNATURES = {
    "cn_qspa_update": [_P, _P, _I, _I, _I, _I, _P],
    # U, out, M, dc, q, B, nm, offset, stream
    "cn_ems_update": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    "cn_ems_update_bubble": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    # U, out, M, dc, q, B, n_r, offset, active (or null), n_active, stream
    "cn_tems_update": [_P, _P, _I, _I, _I, _I, _I, _F, _P, _I, _P],
    "qspa_resident_decode": [_P, _P, _P, _P, _P,        # llr, hard, done, iters, scratch
                             _I, _I, _I, _I, _I, _I,    # B N M dc dv q
                             _P, _P, _P, _P, _P,        # tables
                             _I, _I, _I, _P],           # iters, modes, stream
    # B N M dc dv q bf16, out [5]: K0's frames and threads a block, blocks
    # an SM, grid and shared bytes a block for B frames
    "qspa_resident_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    # q, out: K0's compiled exp-order basis of GF(q) [q]
    "qspa_resident_field": [_I, _P],
    # out (device), stream: positive normal floats where K0's log differs from logf
    "qspa_resident_log_mismatches": [_P, _P],
    "qspa_resident_cl_decode": [_P, _P, _P, _P, _P,      # llr, outs, scratch
                                _I,                      # clusters of the grid
                                _I, _I, _I, _I, _I, _I,  # B N M dc dv q
                                _I, _I, _I, _I, _I, _I,  # plan: C rows checks round warps smem
                                _I,                      # posterior in shared memory
                                _P, _P, _P,              # edge_info row_src row_var
                                _P, _P, _P,              # n2e gf_log gf_exp
                                _I, _I, _I, _P],         # iters, modes, stream
    # q dc dv C rows checks round warps smem post_shared, out: clusters at once
    "qspa_scratch_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "qspa_cluster_decode": [_P, _P, _P, _P,             # llr, hard, done, iters
                            _P, _I,                     # prior scratch, its clusters
                            _I, _I, _I, _I, _I, _I,     # B N M dc dv q
                            _I, _I, _I, _I, _I, _I, _I,  # plan: C rows checks round
                                                        # warps in_place smem
                            _P, _P, _P,                 # edge_info row_src row_var
                            _P, _P, _P,                 # n2e gf_log gf_exp
                            _I, _I, _I,                 # iters, modes
                            ctypes.POINTER(_I), ctypes.POINTER(_I),  # out: the grid's
                            _P],                        # blocks and clusters; stream
    # q dc dv C rows checks round warps in_place smem, out: clusters that
    # run at once
    "qspa_cluster_occupancy": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "ems_resident_decode": [_P, _P, _P, _P,             # llr, hard, done, iters
                            _I, _I, _I, _I, _I, _I,     # B N M dc dv q
                            _I, _F,                     # nm, offset
                            _P, _P, _P, _P, _P,         # tables
                            _I, _I, _I, _P],            # iters, modes, stream
    # decode_bl's routing (kernels/route.py): route_down(posterior, Cv, U,
    # down_idx, cn_mask, M dc, dv, q, B), route_up(Chat, llr, Cv, posterior,
    # up_idx, vn_mask, N, dv, q, B), stream
    "route_down": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "route_up": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the sim step around the decode (kernels/sim_step.py): channel_llr(noise,
    # sig, scale, cw, llr, S, B, N, q), prior_bl(llr, prior, hard, N, q, B),
    # count_errors(hard, cw, iters, done, out, S, B, N, p), stream
    "channel_llr": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "prior_bl": [_P, _P, _P, _I, _I, _I, _P],
    "count_errors": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the probes of kernels/micro.py (P1-P7): x, out, tables, shapes, iters, stream
    "micro_flat_gather": [_P, _P, _P, _I, _I, _I, _P],               # perm; R BT
    "micro_row_moves": [_P, _P, _P, _P, _I, _I, _I, _I, _P],         # pi perms; E Q BT
    "micro_onehot_gemm": [_P, _P, _P, _I, _I, _I, _P],               # A B C; M N K
    "micro_cn_iteration": [_P, _P, _I, _I, _I, _I, _P],              # E Q BT
    "micro_rot_softmax": [_P, _P, _P, _I, _I, _I, _I,                # rb; Q DC M TB
                          _I, _I, _I, _I, _I, _P],                   # sq sj sm sb
    "micro_route": [_P, _P, _P, _P, _I, _I, _I, _I, _I,              # vn nbr; Q N TB E D
                    _I, _I, _I, _I, _P],                             # sq sn sb
}

# the bf16 builds of K0 and K0-cl (mm_precision="bf16"): the same arguments
SIGNATURES.update({f"{name}_bf16": SIGNATURES[name] for name in (
    "qspa_resident_decode", "qspa_resident_cl_decode", "qspa_scratch_occupancy",
    "qspa_cluster_decode", "qspa_cluster_occupancy")})

# the field sizes the check-node kernels (cn_ems, cn_tems) take, and their
# largest check degree (32-bit column masks, 32-entry column tables)
QS = (2, 4, 8, 16, 32, 64, 128, 256)
MAX_DC = 32


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnbldpc_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    if verbose:
        compile_flags.insert(0, "-Xptxas=-v")
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc_path(), *compile_flags, "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors, logs = [], []
    for src, proc in zip(_sources(), procs):
        _, err = proc.communicate()
        logs.append(f"--- {src.name}\n{err}")
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        if not errors:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                errors.append(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    if verbose:
        print("\n".join(logs), file=sys.stderr, flush=True)
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


def check_cn_input(name: str, U, min_dc: int) -> tuple:
    """Validate a check-node kernel's input U [M, dc, q, B] and return its
    shape. Raises ValueError for a tensor off the card, a dtype other than
    float32, a non-contiguous tensor, q outside QS or dc outside
    [min_dc, MAX_DC]."""
    import torch

    if U.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {U.device}")
    if U.dtype != torch.float32 or U.ndim != 4 or not U.is_contiguous():
        raise ValueError(f"{name}: U must be a contiguous [M, dc, q, B] float32 tensor")
    M, dc, q, B = U.shape
    if q not in QS:
        raise ValueError(f"{name}: q={q} unsupported")
    if not min_dc <= dc <= MAX_DC:
        raise ValueError(f"{name}: dc={dc} outside [{min_dc}, {MAX_DC}]")
    return M, dc, q, B


def launch(wrapper, name: str, device, *args, counter: str = "launches") -> None:
    """Call the C entry point `name`(*args, stream) on `device`'s current
    stream, raise on a CUDA error and count the launch on
    `wrapper.<counter>`."""
    import torch

    with torch.cuda.device(device):
        rc = getattr(library(), name)(*args, stream_ptr(device))
    check(rc, name)
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def launch_cn(wrapper, name: str, U, *args, out=None):
    """Launch the C entry point `name`(U, out, M, dc, q, B, *args, stream) on
    a checked U, count the launch on `wrapper.launches` and return out: a
    new tensor, or `out` (U's shape, float32, contiguous, on U's device)."""
    import torch

    if out is None:
        out = torch.empty_like(U)
    elif out.shape != U.shape or out.dtype != U.dtype or out.device != U.device \
            or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous tensor of U's shape, type "
                         "and device")
    if U.numel():
        launch(wrapper, name, U.device, U.data_ptr(), out.data_ptr(), *U.shape, *args)
    return out
