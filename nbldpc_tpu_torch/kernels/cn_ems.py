"""One EMS check-node phase on [M, dc, q, B] (CUDA kernels + plain versions).

Two entry points, one per merge of decoders/ems.py:
  cn_update(U, nm, offset)        - classic: csrc/cn_ems.cu, cn_ems_update;
  cn_update_bubble(U, nm, offset) - bubble:  csrc/cn_ems.cu, cn_ems_update_bubble.
Each launches its kernel for a CUDA tensor and runs its plain version
(decoders/ems.ems_cn_update_bl) for a CPU tensor. EMS has only adds and
max, and the kernels add in the plain version's association, so they agree
exactly.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import ems

# largest check degree the kernels take (their per-thread masks are 32 bits)
MAX_DC = 32
QS = (2, 4, 8, 16, 32, 64, 128, 256)


def cn_update_plain(U: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Plain PyTorch classic EMS check-node update: U [M, dc, q, B] -> same."""
    cn_update_plain.calls += 1
    return ems.ems_cn_update_bl(U, None, nm, offset, merge="classic")


def cn_update_bubble_plain(U: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Plain PyTorch bubble EMS check-node update: U [M, dc, q, B] -> same."""
    cn_update_bubble_plain.calls += 1
    return ems.ems_cn_update_bl(U, None, nm, offset, merge="bubble")


cn_update_plain.calls = 0
cn_update_bubble_plain.calls = 0


def _launch(wrapper, name: str, U: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Check U, launch the C entry point `name`, count the launch on `wrapper`."""
    if U.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {U.device}")
    if U.dtype != torch.float32 or U.ndim != 4 or not U.is_contiguous():
        raise ValueError(f"{name}: U must be a contiguous [M, dc, q, B] float32 tensor")
    M, dc, q, B = U.shape
    if q not in QS:
        raise ValueError(f"{name}: q={q} unsupported")
    if not 2 <= dc <= MAX_DC:
        raise ValueError(f"{name}: dc={dc} outside [2, {MAX_DC}]")
    if nm < 1:
        raise ValueError(f"{name}: nm={nm} must be >= 1")
    from nbldpc_tpu_torch.kernels import _build

    lib = _build.library()
    out = torch.empty_like(U)
    if U.numel() == 0:
        return out
    with torch.cuda.device(U.device):
        rc = getattr(lib, name)(U.data_ptr(), out.data_ptr(), M, dc, q, B,
                                min(int(nm), q), float(offset),
                                _build.stream_ptr(U.device))
    _build.check(rc, name)
    wrapper.launches += 1
    return out


def cn_update(U: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Classic EMS check-node update U [M, dc, q, B] f32 -> same: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if U.device.type == "cpu":
        return cn_update_plain(U, nm, offset)
    return _launch(cn_update, "cn_ems_update", U, nm, offset)


def cn_update_bubble(U: torch.Tensor, nm: int, offset: float) -> torch.Tensor:
    """Bubble EMS check-node update U [M, dc, q, B] f32 -> same: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if U.device.type == "cpu":
        return cn_update_bubble_plain(U, nm, offset)
    return _launch(cn_update_bubble, "cn_ems_update_bubble", U, nm, offset)


cn_update.launches = 0
cn_update_bubble.launches = 0
