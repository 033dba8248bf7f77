"""One T-EMS check-node phase on [M, dc, q, B] (CUDA kernel + plain version).

cn_update(U, offset, n_r) launches csrc/cn_tems.cu's cn_tems_update for a
CUDA tensor and runs the plain version (decoders/tems.tems_cn_update_bl)
for a CPU tensor. Every candidate is one add and the rest is max and
select, so the kernel agrees with the plain version exactly.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import tems
from nbldpc_tpu_torch.kernels import _build


def cn_update_plain(U: torch.Tensor, offset: float, n_r: int) -> torch.Tensor:
    """Plain PyTorch T-EMS check-node update: U [M, dc, q, B] -> same."""
    cn_update_plain.calls += 1
    return tems.tems_cn_update_bl(U, None, offset, n_r)


cn_update_plain.calls = 0


def _launch(U: torch.Tensor, offset: float, n_r: int) -> torch.Tensor:
    """Check U and launch the kernel; raises ValueError on anything it does
    not take, a CPU tensor included (the top-3 scheme needs dc >= 3)."""
    name = "cn_tems_update"
    q = _build.check_cn_input(name, U, min_dc=3)[2]
    if not 0 <= n_r < q:
        raise ValueError(f"{name}: n_r={n_r} outside [0, q={q})")
    return _build.launch_cn(cn_update, name, U, int(n_r), float(offset))


def cn_update(U: torch.Tensor, offset: float, n_r: int) -> torch.Tensor:
    """T-EMS check-node update U [M, dc, q, B] f32 -> same: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. n_r = 0 is the
    exact scan; the kernel takes 0 <= n_r < q."""
    if U.device.type == "cpu":
        return cn_update_plain(U, offset, n_r)
    return _launch(U, offset, n_r)


cn_update.launches = 0
