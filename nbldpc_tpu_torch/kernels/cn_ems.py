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
from nbldpc_tpu_torch.kernels import _build


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
    q = _build.check_cn_input(name, U, min_dc=2)[2]
    if nm < 1:
        raise ValueError(f"{name}: nm={nm} must be >= 1")
    return _build.launch_cn(wrapper, name, U, min(int(nm), q), float(offset))


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
