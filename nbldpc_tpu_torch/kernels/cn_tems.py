"""One T-EMS check-node phase on [M, dc, q, B] (CUDA kernel + plain version).

cn_update(U, offset, n_r) launches csrc/cn_tems.cu's cn_tems_update for a
CUDA tensor and runs the plain version (decoders/tems.tems_cn_update_bl)
for a CPU tensor. Every candidate is one add and the rest is max and
select, so the kernel agrees with the plain version exactly.

Both take a frame list: with `active` (ascending int32 frame indices, on
U's device) they compute only the listed frames' columns and write them
into `out`, whose other columns keep what they held (zeros where `out` is
None; decoders/common.decode_bl lists the frames not yet done and passes
the previous output). Each frame is computed alone, so a listed column is
bit for bit what the full width gives. cn_update.frame_iterations counts
the frames computed, summed over the kernel's launches and the plain
version's calls.
"""

from __future__ import annotations

import torch

from nbldpc_tpu_torch.decoders import tems
from nbldpc_tpu_torch.kernels import _build


def _frames(U: torch.Tensor, active) -> int:
    """The frames a call computes; raises ValueError for a list that is no
    1-D int32 tensor of at most B frames on U's device."""
    if active is None:
        return U.shape[-1]
    if active.dtype != torch.int32 or active.ndim != 1 or active.device != U.device \
            or active.numel() > U.shape[-1]:
        raise ValueError("cn_tems: active must be a 1-D int32 tensor of at most B frames "
                         "on U's device")
    return active.numel()


def cn_update_plain(U: torch.Tensor, offset: float, n_r: int, active=None,
                    out=None) -> torch.Tensor:
    """Plain PyTorch T-EMS check-node update: U [M, dc, q, B] -> same, or
    the listed frames' columns written into `out`."""
    cn_update_plain.calls += 1
    n = _frames(U, active)
    cn_update.frame_iterations += n
    if active is None:
        return tems.tems_cn_update_bl(U, None, offset, n_r)
    out = torch.zeros_like(U) if out is None else out
    if n:
        idx = active.long()
        out.index_copy_(3, idx, tems.tems_cn_update_bl(U.index_select(3, idx), None,
                                                       offset, n_r))
    return out


cn_update_plain.calls = 0


def _launch(U: torch.Tensor, offset: float, n_r: int, active=None,
            out=None) -> torch.Tensor:
    """Check U and launch the kernel; raises ValueError on anything it does
    not take, a CPU tensor included (the top-3 scheme needs dc >= 3). An
    empty list launches nothing."""
    name = "cn_tems_update"
    q = _build.check_cn_input(name, U, min_dc=3)[2]
    if not 0 <= n_r < q:
        raise ValueError(f"{name}: n_r={n_r} outside [0, q={q})")
    n = _frames(U, active)
    if active is None:
        out = None
    else:
        out = torch.zeros_like(U) if out is None else out
        if not n:
            return out
        active = active.contiguous()
    out = _build.launch_cn(cn_update, name, U, int(n_r), float(offset),
                           None if active is None else active.data_ptr(), n, out=out)
    if U.numel():                                  # launch_cn launched
        cn_update.frame_iterations += n
    return out


def cn_update(U: torch.Tensor, offset: float, n_r: int, active=None,
              out=None) -> torch.Tensor:
    """T-EMS check-node update U [M, dc, q, B] f32 -> same: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. n_r = 0 is the
    exact scan; the kernel takes 0 <= n_r < q. Without `active` a new
    tensor is returned and `out` is ignored; with it (ascending int32 frame
    indices in [0, B)) only those frames' columns of `out` (a new zero
    tensor where None) are computed, and `out` is returned."""
    if U.device.type == "cpu":
        return cn_update_plain(U, offset, n_r, active, out)
    return _launch(U, offset, n_r, active, out)


cn_update.launches = 0
cn_update.frame_iterations = 0
